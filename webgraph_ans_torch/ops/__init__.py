"""Device layer: lane-parallel token decode and merged-emit decode (CUDA
kernels + plain PyTorch versions), successor reconstruction on the host
and on the device (the sort path), batch random access, the encode kernel
and the device model search."""

from .graph_decode import TorchGraphDecoder
from .random_torch import (TorchCsrServer, TorchEmitRandomAccess,
                           TorchRandomAccess)
from .reconstruct_torch import reconstruct

__all__ = ["TorchCsrServer", "TorchEmitRandomAccess", "TorchGraphDecoder",
           "TorchRandomAccess", "reconstruct"]
