"""webgraph-ans-torch: the PyTorch/CUDA port of webgraph-ans-tpu.

Same artifacts (.ans/.states/.pointers), same host runtime (its own copy
of the native C++ library), and a lane-parallel token decoder whose hot
loop is a CUDA kernel built for sm_90a on first use:

    from webgraph_ans_torch import ANSBvGraph, TorchGraphDecoder, reconstruct, store
    store("cnr-2000", "out")                      # 3-pass compression (host)
    g = ANSBvGraph.load("out")
    vals, comps = TorchGraphDecoder(g).decode_tokens(num_lanes=4096)
    offsets, succs = reconstruct(vals, comps, g.num_nodes,
                                 g.prelude.min_interval_length)

Entry points run on CUDA unless given device="cpu" (the plain PyTorch
versions of the kernels). The package imports neither jax nor
webgraph_ans_tpu.
"""

from .bvgraph.random_access import ANSBvGraph
from .bvgraph.store import store
from .ops.graph_decode import TorchGraphDecoder
from .ops.reconstruct_torch import reconstruct

__all__ = ["ANSBvGraph", "TorchGraphDecoder", "reconstruct", "store"]
__version__ = "0.1.0"
