"""CUDA dirty-chain fixup of the merged-emit post-pass (csrc/emit_fixup.cu),
its plain PyTorch version and the dispatching wrapper.

The fixup finishes the nodes that the merged-emit kernel left dirty: each
gets its elements (its own rows, placeholders resolved from its parent's
list) sorted into its rows of the [S, G] channel, patched in place. Every
post-pass call runs it: the planning calls (emit_post.postprocess) and the
steady state (emit_post.post_steady). The kernel replaces no TPU kernel:
the JAX package's fixup is XLA (its post_steady: a gather, a sort and a
scatter a chain level), the reference the plain version is held to on the
CPU; the kernel is held to the plain version on the card. It runs every
chain in one launch: a block takes a path and follows it, each node
reading its parent's list from shared memory (rows of up to 64 elements
in batches, which the block's other warps prepare while one warp finishes
the batch before; a two-run row merges its copies with its known values,
sorted ahead); a path's first node waits on its parent's ready flag, which
a batch publishes once, after its last row. It is built with nvcc for
sm_90a into `webgraph_ans_torch/build/` on first use and loaded with
ctypes.

The node layout (emit_post.build_fixup_cache, from a plan's first decode)
cuts the dirty nodes that read a dirty parent's list into paths, each
following a node's child of the deepest subtree:

- nodes [nd, 6] int32, a path's rows one after another, the paths in the
  order of their first nodes' (chain depth, node): element base, degree,
  flat index of the first output row, link (-2 when the parent is the row
  before, else the row of the parent whose list the node reads, always an
  earlier row, or -1), publish (1 when a row of another path reads this
  one) and copies (in a two-run row, the number of its first sources
  that copy the parent's list, in ascending position; else -1);
- srcs [E] int32, each row's elements, a row's right after the row
  before's: a flat index into val (the node's own row, or a clean
  parent's row), or ~j for the parent's j-th successor; a two-run row's
  copies first (emit_post.two_run_layout).

`emit_fixup` dispatches on the tensors' device only: CPU tensors go to the
plain version (emit_fixup_plain, row by row in the same order), CUDA
tensors to the kernel; anything else raises. `emit_fixup.launches` counts
the kernel's launches that run: a launch recorded into a CUDA graph
capture is not counted but adds one to `emit_fixup.captured`, and each
replay of that graph counts what its capture recorded (graph_decode);
each counted launch is also a `fixup_kernel_launches` trace counter, and
adds its layout's elements to the `fixup_elements` counter
(`emit_fixup.captured_elements` sums a capture's).
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from ..utils import trace
from . import cuda_build

SOURCE = os.path.join(cuda_build.CSRC_DIR, "emit_fixup.cu")
LIB_PATH = os.path.join(cuda_build.BUILD_DIR, "libemit_fixup.so")

FOLLOWS = -2     # a row's link: its parent is the row before

_lock = threading.Lock()
_lib = None


def build(force: bool = False) -> dict:
    """Compiles the kernel into LIB_PATH unless an up-to-date build exists
    (see cuda_build.build)."""
    return cuda_build.build(SOURCE, LIB_PATH, force)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(LIB_PATH)
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.wgt_emit_fixup.argtypes = [vp, vp, vp, ci, ci, ci, vp, vp]
            lib.wgt_emit_fixup.restype = ci
            lib.wgt_fixup_error_string.argtypes = [ci]
            lib.wgt_fixup_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def emit_fixup_plain(val, nodes, srcs):
    """The fixup row by row, in the layout's order: each node's elements
    gathered from val and from the rows its dirty parent already wrote,
    sorted, written to its rows. Patches val in place and returns it."""
    G = val.shape[1]
    out = val.view(-1)
    table = nodes.tolist()
    for q, (ebase, deg, start, link, *_) in enumerate(table):
        s = srcs[ebase:ebase + deg].long()
        parent = table[q - 1 if link == FOLLOWS else max(link, 0)][2]
        v = torch.where(s >= 0, out[s.clamp(min=0)],
                        out[(parent + (~s) * G).clamp(min=0)])
        rows = start + torch.arange(deg, device=val.device) * G
        out[rows] = torch.sort(v).values
    return val


def _launch(val, nodes, srcs):
    dev = val.device
    S, G = val.shape
    nd, E = nodes.shape[0], srcs.shape[0]
    check = cuda_build.check
    check(val, "val", torch.int32, (S, G), dev)
    check(nodes, "nodes", torch.int32, (nd, 6), dev)
    check(srcs, "srcs", torch.int32, (E,), dev)
    lib = _load()
    # ready flags and the row counter (zeroed), then the spill region
    work = torch.empty(nd + 1 + 2 * E, dtype=torch.int32, device=dev)
    work[:nd + 1].zero_()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.wgt_emit_fixup(val.data_ptr(), nodes.data_ptr(),
                             srcs.data_ptr(), nd, E, G, work.data_ptr(),
                             stream)
    if err != 0:
        raise cuda_build.KernelError(
            "emit_fixup kernel launch failed: "
            + lib.wgt_fixup_error_string(err).decode())
    if torch.cuda.is_current_stream_capturing():
        emit_fixup.captured += 1
        emit_fixup.captured_elements += E
    else:
        count_launch(1, E)
    return val


def count_launch(n: int = 1, elements: int = 0):
    """n launches of the kernel that ran (eager launches or the ones a
    replayed graph holds), over `elements` layout elements in all."""
    if n:
        emit_fixup.launches += n
        trace.count("fixup_kernel_launches", n)
        trace.count("fixup_elements", elements)


def emit_fixup(val, nodes, srcs):
    """The fixed-up channel: val ([S, G] int32, contiguous), patched in
    place with each dirty node's sorted list in its rows, and returned.
    CUDA tensors run the kernel; CPU tensors run emit_fixup_plain."""
    dev = val.device
    if dev.type == "cpu":
        return emit_fixup_plain(val, nodes, srcs)
    if dev.type != "cuda":
        raise ValueError(f"emit_fixup runs on cuda or cpu, not {dev}")
    return _launch(val, nodes, srcs)


emit_fixup.launches = 0
emit_fixup.captured = 0
emit_fixup.captured_elements = 0
