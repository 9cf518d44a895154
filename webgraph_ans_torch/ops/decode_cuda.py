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
kernel launches.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

import torch

from .decode_torch import UNROLL, DecoderTables, decode_blocks_plain

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "decode_blocks.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
LIB_PATH = os.path.join(BUILD_DIR, "libdecode_blocks.so")
MAX_WINDOW = 16           # the kernel's ring holds window + 1 <= 17 entries

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA decode kernel is built "
                           "on first use and needs the CUDA toolkit")
    return path


def build(force: bool = False) -> dict:
    """Compiles the kernel into LIB_PATH unless an up-to-date build exists.
    Returns {"path", "seconds", "log"} (log: nvcc's -Xptxas -v report,
    empty when nothing was built)."""
    if (not force and os.path.exists(LIB_PATH)
            and os.path.getmtime(LIB_PATH) >= os.path.getmtime(SOURCE)):
        return {"path": LIB_PATH, "seconds": 0.0, "log": ""}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", tmp, SOURCE]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, LIB_PATH)
    return {"path": LIB_PATH, "seconds": time.perf_counter() - t0,
            "log": res.stdout + res.stderr}


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
                ctypes.c_int, vp, vp, vp, vp]
            lib.wgt_decode_blocks.restype = ctypes.c_int
            lib.wgt_cuda_error_string.argtypes = [ctypes.c_int]
            lib.wgt_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(tables: DecoderTables, states, ptrs, starts, ends, ring_seed,
            window: int, min_interval: int, cap: int):
    if window > MAX_WINDOW:
        raise ValueError(f"the CUDA decode kernel supports window <= "
                         f"{MAX_WINDOW}, got {window}")
    if cap % UNROLL:
        raise ValueError(f"cap {cap} is not a multiple of {UNROLL}")
    dev = states.device
    L = states.shape[0]
    params = tables.params
    _check(tables.lut, "lut", torch.int32, (params[9], 2), dev)
    _check(tables.stream, "stream", torch.int16, (tables.stream.shape[0],),
           dev)
    _check(states, "states", torch.int64, (L,), dev)
    _check(ptrs, "ptrs", torch.int64, (L,), dev)
    _check(starts, "starts", torch.int32, (L,), dev)
    _check(ends, "ends", torch.int32, (L,), dev)
    _check(ring_seed, "ring_seed", torch.int32, (L, window + 1), dev)
    flat = [int(v) for c in range(9) for v in params[c]]
    flat += [int(params[9]), int(params[10])]
    c_params = (ctypes.c_longlong * len(flat))(*flat)

    lib = _load()
    out = torch.zeros((cap + cap // UNROLL, L), dtype=torch.int32, device=dev)
    out[cap:] = -1          # nibble rows start as all-0xF
    counts = torch.empty(L, dtype=torch.int32, device=dev)
    ok = torch.empty(L, dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.wgt_decode_blocks(
        c_params, tables.lut.data_ptr(), tables.stream.data_ptr(),
        tables.stream.shape[0], states.data_ptr(), ptrs.data_ptr(),
        starts.data_ptr(), ends.data_ptr(), ring_seed.data_ptr(), L, window,
        min_interval, cap, out.data_ptr(), counts.data_ptr(), ok.data_ptr(),
        stream)
    if err != 0:
        raise RuntimeError("decode_blocks kernel launch failed: "
                           + lib.wgt_cuda_error_string(err).decode())
    decode_blocks.launches += 1
    return out, counts, ok


def decode_blocks(tables: DecoderTables, states, ptrs, starts, ends,
                  ring_seed, window: int, min_interval: int, cap: int):
    """Grammar-FSM token decode of independent node ranges; the contract of
    decode_torch.decode_blocks_plain. CUDA tensors run the CUDA kernel
    (states/ptrs int64, starts/ends int32, ring_seed int32 [L, window+1],
    all contiguous on one device); CPU tensors run the plain version."""
    dev = states.device
    if dev.type == "cpu":
        return decode_blocks_plain(tables, states, ptrs, starts, ends,
                                   ring_seed, window, min_interval, cap)
    if dev.type != "cuda":
        raise ValueError(f"decode_blocks runs on cuda or cpu, not {dev}")
    return _launch(tables, states, ptrs, starts, ends, ring_seed, window,
                   min_interval, cap)


decode_blocks.launches = 0
