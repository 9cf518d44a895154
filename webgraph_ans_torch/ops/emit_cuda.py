"""CUDA merged-emit kernel (csrc/decode_emit.cu) and its dispatching
wrapper.

The kernel replaces the TPU kernel `decode_emit_pallas`
(webgraph_ans_tpu/ops/emit_pallas.py:501): one thread per lane runs the
token FSM, the bounded run queues and the merge of ops/emit_torch.py, with
the T-row output ring, the queues and the window rings in the block's
shared memory, and writes the rows that only continue a copy or interval
run in a tight loop (run folding; the seventh output counts them). It is
built with nvcc for sm_90a into `webgraph_ans_torch/build/` on first use
and loaded with ctypes.

`decode_emit` dispatches on the tensors' device only: CPU tensors go to
the plain PyTorch version (emit_torch.decode_emit_plain), CUDA tensors to
the kernel; anything else raises. `decode_emit.launches` counts the
kernel's launches that run: a launch recorded into a CUDA graph capture
is not counted, each replay of that graph is (graph_decode).
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from . import cuda_build
from .decode_torch import UNROLL, DecoderTables
from .emit_torch import MAX_WINDOW, _layout, decode_emit_plain

SOURCE = os.path.join(cuda_build.CSRC_DIR, "decode_emit.cu")
LIB_PATH = os.path.join(cuda_build.BUILD_DIR, "libdecode_emit.so")

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
            lib.wgt_decode_emit.argtypes = [
                ctypes.POINTER(ctypes.c_longlong), vp, vp, ctypes.c_longlong,
                vp, vp, ci, ci, ci, ci, ci, ci, vp, vp, vp, vp, vp, vp, vp,
                vp]
            lib.wgt_decode_emit.restype = ci
            lib.wgt_decode_emit_geometry.argtypes = [
                ci, ci, ctypes.POINTER(ci), ctypes.POINTER(ctypes.c_longlong)]
            lib.wgt_decode_emit_geometry.restype = ci
            lib.wgt_emit_error_string.argtypes = [ci]
            lib.wgt_emit_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _error(lib, err: int, what: str):
    raise cuda_build.KernelError(f"decode_emit {what} failed: "
                                 + lib.wgt_emit_error_string(err).decode())


def _geometry(window: int, T: int):
    """(error code, lanes per block, dynamic shared memory bytes) of the
    kernel's launch shape on the current card."""
    lib = _load()
    lanes, smem = ctypes.c_int(), ctypes.c_longlong()
    err = lib.wgt_decode_emit_geometry(window, T, ctypes.byref(lanes),
                                       ctypes.byref(smem))
    return err, lanes.value, smem.value


def launch_geometry(window: int, T: int) -> dict:
    """The kernel's launch shape on the current card for a window and ring
    depth: lanes (threads) per block and the dynamic shared memory each
    block asks for (the T-row ring, the queues and the window rings of
    each lane). Raises when not even one lane's ring fits a block."""
    err, lanes, smem = _geometry(window, T)
    if err != 0:
        _error(_load(), err, f"launch shape (window {window}, T {T})")
    return {"lanes_per_block": lanes, "smem_bytes": smem}


def ring_fits(window: int, T: int) -> bool:
    """Whether one lane's T-row ring, queues and window rings fit a
    block's shared memory on the current card (window in 0..16, T a power
    of two >= 8): False is a plan the kernel cannot serve. A failed build
    raises."""
    return _geometry(window, T)[0] == 0


def _launch(tables: DecoderTables, regs, ptrs, window: int,
            min_interval: int, cap: int, T: int, mark_deg: bool):
    if not 0 <= window <= MAX_WINDOW:
        raise ValueError(f"the CUDA merged-emit kernel supports window "
                         f"0..{MAX_WINDOW}, got {window}")
    if cap % UNROLL or T & (T - 1) or T < UNROLL:
        raise ValueError(f"cap {cap} must be a multiple of {UNROLL} and T "
                         f"{T} a power of two >= {UNROLL}")
    dev = regs.device
    L = regs.shape[1]
    params = tables.params
    check = cuda_build.check
    check(tables.lut, "lut", torch.int32, (params[9], 2), dev)
    check(tables.stream, "stream", torch.int16, (tables.stream.shape[0],),
          dev)
    check(regs, "regs", torch.int32, (_layout(window)[-1], L), dev)
    check(ptrs, "ptrs", torch.int64, (L,), dev)
    c_params = cuda_build.codec_params(params)

    lib = _load()
    i32 = torch.int32
    val = torch.empty((cap, L), dtype=i32, device=dev)
    xch = torch.empty((cap, L), dtype=i32, device=dev)
    nib = torch.empty((cap // UNROLL, L), dtype=i32, device=dev)
    rows = torch.empty(L, dtype=i32, device=dev)
    ok = torch.empty(L, dtype=torch.bool, device=dev)
    diag = torch.empty((6, L), dtype=i32, device=dev)
    fold = torch.empty(L, dtype=i32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.wgt_decode_emit(
        c_params, tables.lut.data_ptr(), tables.stream.data_ptr(),
        tables.stream.shape[0], regs.data_ptr(), ptrs.data_ptr(), L, window,
        min_interval, cap, T, int(mark_deg), val.data_ptr(), xch.data_ptr(),
        nib.data_ptr(), rows.data_ptr(), ok.data_ptr(), diag.data_ptr(),
        fold.data_ptr(), stream)
    if err != 0:
        _error(lib, err, f"kernel launch (window {window}, T {T})")
    if not torch.cuda.is_current_stream_capturing():
        decode_emit.launches += 1
    return val, xch, nib, rows, ok, diag, fold


def decode_emit(tables: DecoderTables, regs, ptrs, window: int,
                min_interval: int, cap: int, T: int = 512,
                mark_deg: bool = False):
    """Merged-emit decode; the contract of emit_torch.decode_emit_plain.
    CUDA tensors (regs int32 [nreg, L], ptrs int64 [L], contiguous, on
    one device) run the CUDA kernel; CPU tensors run the plain version."""
    dev = regs.device
    if dev.type == "cpu":
        return decode_emit_plain(tables, regs, ptrs, window, min_interval,
                                 cap, T, mark_deg)
    if dev.type != "cuda":
        raise ValueError(f"decode_emit runs on cuda or cpu, not {dev}")
    return _launch(tables, regs, ptrs, window, min_interval, cap, T,
                   mark_deg)


decode_emit.launches = 0
