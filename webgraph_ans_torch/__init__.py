"""webgraph-ans-torch: the PyTorch/CUDA port of webgraph-ans-tpu.

Same artifacts (.ans/.states/.pointers), same host runtime (its own copy
of the native C++ library), and a lane-parallel encoder and decoders
whose hot loops are CUDA kernels built for sm_90a on first use:

    from webgraph_ans_torch import (ANSBvGraph, TorchGraphDecoder,
                                    reconstruct, store, to_dense_csr)
    store("cnr-2000", "out")                      # 3-pass compression (host)
    store("cnr-2000", "out_b512", encode_blocks=512,   # model search and
          use_tpu_model_search=True)                   # encode on device
    g = ANSBvGraph.load("out")
    vals, comps = TorchGraphDecoder(g).decode_tokens(num_lanes=4096)
    offsets, succs = reconstruct(vals, comps, g.num_nodes,
                                 g.prelude.min_interval_length)
    # merged-emit path: decode and reconstruction in one kernel, on device
    succs2d, starts, degs = TorchGraphDecoder(g).decode_to_adjacency_device()
    offsets_d, succs_d = to_dense_csr(succs2d, starts, degs, g.num_arcs)

Entry points run on CUDA unless given device="cpu" (the plain PyTorch
versions of the kernels). The package imports neither jax nor
webgraph_ans_tpu.
"""

from .bvgraph.random_access import ANSBvGraph
from .bvgraph.store import store
from .ops.emit_post import to_dense_csr, to_host_lists
from .ops.graph_decode import TorchGraphDecoder
from .ops.reconstruct_torch import reconstruct

__all__ = ["ANSBvGraph", "TorchGraphDecoder", "reconstruct", "store",
           "to_dense_csr", "to_host_lists"]
__version__ = "0.1.0"
