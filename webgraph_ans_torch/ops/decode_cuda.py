"""CUDA token-decode kernel (csrc/decode_blocks.cu) and its dispatching
wrapper.

The kernel replaces the TPU kernel `decode_blocks_pallas`
(webgraph_ans_tpu/ops/decode_pallas.py:440): one thread per lane runs the
rANS step and the grammar FSM, reading the u16 stream and the decode LUT
straight from device memory. It is built with `nvcc` for sm_90a into
`webgraph_ans_torch/build/` on first use and loaded with ctypes.

`decode_blocks` dispatches on the tensors' device only: CPU tensors go to
the plain PyTorch version (decode_torch.decode_blocks_plain), CUDA tensors
to the kernel; anything else raises. `decode_blocks.launches` counts
token-mode kernel launches that run, `decode_blocks.aux_launches` aux-mode
ones: a launch recorded into a CUDA graph capture is not counted, each
replay of that graph is (random_torch).
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from . import cuda_build
from .decode_torch import UNROLL, DecoderTables, decode_blocks_plain

SOURCE = os.path.join(cuda_build.CSRC_DIR, "decode_blocks.cu")
LIB_PATH = os.path.join(cuda_build.BUILD_DIR, "libdecode_blocks.so")
MAX_WINDOW = 4095   # the kernel's ring: window + 1 ints of shared memory

_lock = threading.Lock()
_lib = None


def build(force: bool = False) -> dict:
    """Compiles the kernel into LIB_PATH unless an up-to-date build exists.
    Returns {"path", "seconds", "log", "built"} (log: nvcc's -Xptxas -v
    report, empty when nothing was built)."""
    return cuda_build.build(SOURCE, LIB_PATH, force)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(LIB_PATH)
            vp = ctypes.c_void_p
            lib.wgt_decode_blocks.argtypes = [
                ctypes.POINTER(ctypes.c_longlong), vp, vp, ctypes.c_longlong,
                vp, vp, vp, vp, vp, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, vp, vp, vp, vp]
            lib.wgt_decode_blocks.restype = ctypes.c_int
            lib.wgt_cuda_error_string.argtypes = [ctypes.c_int]
            lib.wgt_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _launch(tables: DecoderTables, states, ptrs, starts, ends, ring_seed,
            window: int, min_interval: int, cap: int, emit_aux: bool):
    if window > MAX_WINDOW:
        raise ValueError(f"the CUDA decode kernel supports window <= "
                         f"{MAX_WINDOW}, got {window}")
    if cap % UNROLL:
        raise ValueError(f"cap {cap} is not a multiple of {UNROLL}")
    dev = states.device
    L = states.shape[0]
    params = tables.params
    check = cuda_build.check
    check(tables.lut, "lut", torch.int32, (params[9], 2), dev)
    check(tables.stream, "stream", torch.int16, (tables.stream.shape[0],),
          dev)
    check(states, "states", torch.int64, (L,), dev)
    check(ptrs, "ptrs", torch.int64, (L,), dev)
    check(starts, "starts", torch.int32, (L,), dev)
    check(ends, "ends", torch.int32, (L,), dev)
    check(ring_seed, "ring_seed", torch.int32, (L, window + 1), dev)
    c_params = cuda_build.codec_params(params)

    lib = _load()
    vrows = 3 * cap if emit_aux else cap
    out = torch.zeros((vrows + cap // UNROLL, L), dtype=torch.int32,
                      device=dev)
    out[vrows:] = -1        # nibble rows start as all-0xF
    counts = torch.empty(L, dtype=torch.int32, device=dev)
    ok = torch.empty(L, dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.wgt_decode_blocks(
        c_params, tables.lut.data_ptr(), tables.stream.data_ptr(),
        tables.stream.shape[0], states.data_ptr(), ptrs.data_ptr(),
        starts.data_ptr(), ends.data_ptr(), ring_seed.data_ptr(), L, window,
        min_interval, cap, int(emit_aux), out.data_ptr(), counts.data_ptr(),
        ok.data_ptr(), stream)
    if err != 0:
        raise cuda_build.KernelError(
            "decode_blocks kernel launch failed: "
            + lib.wgt_cuda_error_string(err).decode())
    if not torch.cuda.is_current_stream_capturing():
        if emit_aux:
            decode_blocks.aux_launches += 1
        else:
            decode_blocks.launches += 1
    return out, counts, ok


def decode_blocks(tables: DecoderTables, states, ptrs, starts, ends,
                  ring_seed, window: int, min_interval: int, cap: int,
                  emit_aux: bool = False):
    """Grammar-FSM token decode of independent node ranges; the contract of
    decode_torch.decode_blocks_plain. CUDA tensors run the CUDA kernel
    (states/ptrs int64, starts/ends int32, ring_seed int32 [L, window+1],
    all contiguous on one device); CPU tensors run the plain version."""
    dev = states.device
    if dev.type == "cpu":
        return decode_blocks_plain(tables, states, ptrs, starts, ends,
                                   ring_seed, window, min_interval, cap,
                                   emit_aux)
    if dev.type != "cuda":
        raise ValueError(f"decode_blocks runs on cuda or cpu, not {dev}")
    return _launch(tables, states, ptrs, starts, ends, ring_seed, window,
                   min_interval, cap, emit_aux)


decode_blocks.launches = 0       # token-mode kernel launches
decode_blocks.aux_launches = 0   # aux-mode kernel launches
