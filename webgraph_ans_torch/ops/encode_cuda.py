"""CUDA encode kernel (csrc/encode_blocks.cu) and its dispatching wrapper.

The kernel replaces the TPU kernel `encode_blocks_pallas`
(webgraph_ans_tpu/ops/encode_pallas.py:291): one thread per lane encodes
its token block in reverse, reading tokens and table rows straight from
device memory. It is built with nvcc for sm_90a into
`webgraph_ans_torch/build/` on first use and loaded with ctypes.

`encode_blocks` dispatches on the tensors' device only: CPU tensors go to
the plain PyTorch version (encode_torch.encode_blocks_plain), CUDA tensors
to the kernel; anything else raises. `encode_blocks.launches` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from . import cuda_build
from .encode_torch import UNROLL, _emit_pairs, encode_blocks_plain

SOURCE = os.path.join(cuda_build.CSRC_DIR, "encode_blocks.cu")
LIB_PATH = os.path.join(cuda_build.BUILD_DIR, "libencode_blocks.so")
MAX_FOLDS = 30            # the kernel's bound (values are u31)

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
            lib.wgt_encode_blocks.argtypes = [
                ctypes.POINTER(ctypes.c_longlong), vp, ctypes.c_longlong,
                vp, vp, vp, ci, ci, vp, vp, vp, vp, vp, vp]
            lib.wgt_encode_blocks.restype = ci
            lib.wgt_encode_error_string.argtypes = [ci]
            lib.wgt_encode_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _launch(params, tab, tokens, tstart, tend, cap: int):
    max_folds = int(params[9])
    if not 0 <= max_folds <= MAX_FOLDS:
        raise ValueError(f"the CUDA encode kernel supports max_folds <= "
                         f"{MAX_FOLDS}, got {max_folds}")
    if cap % UNROLL:
        raise ValueError(f"cap {cap} is not a multiple of {UNROLL}")
    dev = tokens.device
    L = tstart.shape[0]
    check = cuda_build.check
    check(tab, "tab", torch.int32, (tab.shape[0], 4), dev)
    check(tokens, "tokens", torch.int32, (tokens.shape[0], 2), dev)
    check(tstart, "tstart", torch.int32, (L,), dev)
    check(tend, "tend", torch.int32, (L,), dev)
    flat = [int(v) for c in range(9) for v in params[c]] + [max_folds]
    c_params = (ctypes.c_longlong * len(flat))(*flat)

    lib = _load()
    EP = _emit_pairs(max_folds)
    i32 = torch.int32
    emit = torch.empty((cap * EP + cap, L), dtype=i32, device=dev)
    states = torch.empty((cap, L), dtype=i32, device=dev)
    final_states = torch.empty(L, dtype=i32, device=dev)
    wtotals = torch.empty(L, dtype=i32, device=dev)
    ok = torch.empty(L, dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.wgt_encode_blocks(
        c_params, tab.data_ptr(), tab.shape[0], tokens.data_ptr(),
        tstart.data_ptr(), tend.data_ptr(), L, cap, emit.data_ptr(),
        states.data_ptr(), final_states.data_ptr(), wtotals.data_ptr(),
        ok.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("encode_blocks kernel launch failed: "
                           + lib.wgt_encode_error_string(err).decode())
    encode_blocks.launches += 1
    return emit, states, final_states, wtotals, ok


def encode_blocks(params, tab, tokens, tstart, tend, cap: int):
    """Lane-parallel reverse rANS encode; the contract of
    encode_torch.encode_blocks_plain. CUDA tensors run the CUDA kernel (tab
    int32 [entries, 4], tokens int32 [T, 2], tstart/tend int32 [L], all
    contiguous on one device); CPU tensors run the plain version. Token
    components outside 0..8 raise on either device."""
    dev = tokens.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"encode_blocks runs on cuda or cpu, not {dev}")
    if tokens.dim() == 2 and tokens.shape[0] and tokens.shape[1] == 2:
        # both versions index the 9 components' parameters by this id
        lo, hi = (int(v) for v in torch.aminmax(tokens[:, 1]))
        if lo < 0 or hi > 8:
            raise ValueError(f"token components must be 0..8, got "
                             f"{lo}..{hi}")
    if dev.type == "cpu":
        return encode_blocks_plain(params, tab, tokens, tstart, tend, cap)
    return _launch(params, tab, tokens, tstart, tend, cap)


encode_blocks.launches = 0
