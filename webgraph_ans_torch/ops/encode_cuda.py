"""CUDA encode kernel (csrc/encode_blocks.cu) and its dispatching wrapper.

The kernel replaces the TPU kernel `encode_blocks_pallas`
(webgraph_ans_tpu/ops/encode_pallas.py:291). One call launches two
kernels on the current stream: a parallel pass that turns every token into
a record of the state-independent work (table row, fold count, component
fields), then one thread per lane that encodes its block in reverse from
those records. It is built with nvcc for sm_90a into
`webgraph_ans_torch/build/` on first use and loaded with ctypes.

`encode_blocks` dispatches on the tensors' device only: CPU tensors go to
the plain PyTorch version (encode_torch.encode_blocks_plain), CUDA tensors
to the kernel; anything else raises. `encode_blocks.launches` counts calls
that launched the kernel (one per call, though each call is two kernel
launches).
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
            cl = ctypes.c_longlong
            lib.wgt_encode_records.argtypes = [
                ctypes.POINTER(cl), vp, cl, vp, cl, vp, vp, vp, ci, ci, vp]
            lib.wgt_encode_records.restype = ci
            lib.wgt_encode_lanes.argtypes = [vp, vp, vp, vp, ci, ci, ci,
                                             vp, vp, vp, vp, vp, vp]
            lib.wgt_encode_lanes.restype = ci
            lib.wgt_encode_geometry.argtypes = [ctypes.POINTER(ci)] * 4
            lib.wgt_encode_geometry.restype = None
            lib.wgt_encode_error_string.argtypes = [ci]
            lib.wgt_encode_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def launch_geometry(L: int, T: int, cap: int, max_folds: int) -> dict:
    """The two launches' shapes for L lanes, T tokens, cap and max_folds:
    lanes (threads) a block and blocks of the lanes kernel, its record
    ring slots a lane and static shared memory a block (no dynamic shared
    memory), and the records pass's threads a block and blocks (one
    thread per token or per 16 bytes of pair rows, whichever is more)."""
    vals = [ctypes.c_int() for _ in range(4)]
    _load().wgt_encode_geometry(*(ctypes.byref(v) for v in vals))
    lanes, depth, rthreads, smem = (v.value for v in vals)
    work = max(T, cap * _emit_pairs(max_folds) * L // 4)
    return {"lanes_per_block": lanes, "blocks": -(-L // lanes),
            "ring_depth": depth, "static_smem_bytes": smem,
            "dynamic_smem_bytes": 0, "record_threads": rthreads,
            "record_blocks": -(-work // rthreads)}


def _check_err(lib, err: int, what: str):
    if err != 0:
        raise RuntimeError(f"encode_blocks {what} launch failed: "
                           + lib.wgt_encode_error_string(err).decode())


def records(params, tab, tokens, emit, cap: int):
    """The first of a call's two launches: the token records, int32
    [5 * T] (rec4 [T, 4] then recp [T]), and emit's pair rows zeroed.
    Not counted in launches."""
    lib = _load()
    T = tokens.shape[0]
    flat = [int(v) for c in range(9) for v in params[c]] + [int(params[9])]
    c_params = (ctypes.c_longlong * len(flat))(*flat)
    rec = torch.empty(5 * T, dtype=torch.int32, device=tokens.device)
    stream = torch.cuda.current_stream(tokens.device).cuda_stream
    _check_err(lib, lib.wgt_encode_records(
        c_params, tab.data_ptr(), tab.shape[0], tokens.data_ptr(), T,
        rec.data_ptr(), rec.data_ptr() + 16 * T, emit.data_ptr(),
        emit.shape[1], cap, stream), "records")
    return rec


def lanes(rec, emit, tstart, tend, cap: int, max_folds: int):
    """The second launch, on records and an emit whose pair rows `records`
    zeroed: the outputs of encode_blocks (emit filled in place). Not
    counted in launches."""
    lib = _load()
    dev = tstart.device
    L = tstart.shape[0]
    T = rec.shape[0] // 5
    i32 = torch.int32
    states = torch.empty((cap, L), dtype=i32, device=dev)
    final_states = torch.empty(L, dtype=i32, device=dev)
    wtotals = torch.empty(L, dtype=i32, device=dev)
    ok = torch.empty(L, dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _check_err(lib, lib.wgt_encode_lanes(
        rec.data_ptr(), rec.data_ptr() + 16 * T, tstart.data_ptr(),
        tend.data_ptr(), L, cap, _emit_pairs(max_folds), emit.data_ptr(),
        states.data_ptr(), final_states.data_ptr(), wtotals.data_ptr(),
        ok.data_ptr(), stream), "lanes")
    return emit, states, final_states, wtotals, ok


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
    emit = torch.empty((cap * _emit_pairs(max_folds) + cap, L),
                       dtype=torch.int32, device=dev)
    out = lanes(records(params, tab, tokens, emit, cap), emit, tstart, tend,
                cap, max_folds)
    encode_blocks.launches += 1
    return out


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
