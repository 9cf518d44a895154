"""ctypes loader for the native runtime (libwgans.so).

The shared library is built on demand with `make` (g++). It hosts the host-side
runtime of the framework: the BVGraph bitstream reader, the BvComp compressor,
the serial rANS codec used for encoding and as the CPU decode baseline, and the
Elias-Fano succinct index — the pieces the reference gets from Rust crates
(webgraph / sux / dsi-bitstream; reference: SURVEY.md section 2.2).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libwgans.so")

_lock = threading.Lock()
_lib = None

u8p = ctypes.POINTER(ctypes.c_uint8)
u16p = ctypes.POINTER(ctypes.c_uint16)
u32p = ctypes.POINTER(ctypes.c_uint32)
u64p = ctypes.POINTER(ctypes.c_uint64)
i32p = ctypes.POINTER(ctypes.c_int32)
i64p = ctypes.POINTER(ctypes.c_int64)
f64p = ctypes.POINTER(ctypes.c_double)


def _build() -> None:
    src = os.path.join(_NATIVE_DIR, "src")
    newest_src = max(
        os.path.getmtime(os.path.join(src, f)) for f in os.listdir(src) if f.endswith((".cpp", ".hpp"))
    )
    if os.path.exists(_LIB_PATH) and os.path.getmtime(_LIB_PATH) >= newest_src:
        return
    # build under a per-process name and rename: processes that start
    # together (test workers) never load a half-written library
    tmp = f"libwgans.so.{os.getpid()}.tmp"
    subprocess.run(["make", "-s", f"TARGET={tmp}"], cwd=_NATIVE_DIR, check=True,
                   capture_output=True, text=True)
    os.replace(os.path.join(_NATIVE_DIR, tmp), _LIB_PATH)


def _declare(lib: ctypes.CDLL) -> None:
    c = ctypes
    void_p, u8, u16, u32, u64, i32, i64 = (
        c.c_void_p, c.c_uint8, c.c_uint16, c.c_uint32, c.c_uint64, c.c_int32, c.c_int64,
    )
    sigs = {
        "wgt_last_error": ([], c.c_char_p),
        "wgt_set_safe_break": ([u32], None),
        "wgt_adj_num_arcs": ([void_p], u64),
        "wgt_adj_num_offsets": ([void_p], u64),
        "wgt_adj_get_offsets": ([void_p, u64p], None),
        "wgt_adj_get_succs": ([void_p, u32p], None),
        "wgt_adj_free": ([void_p], None),
        "wgt_bvgraph_scan": ([u8p, u64, u64, u32, u32, u32, i32, i32, i32, i32], void_p),
        "wgt_bvcomp_histogram": (
            [u64, u64p, u32p, u32, u32, u32, i32, u64p, u64p, u32p, u32p], void_p),
        "wgt_hist_size": ([void_p, i32], u64),
        "wgt_hist_get": ([void_p, i32, u64p, u64p], None),
        "wgt_hist_free": ([void_p], None),
        "wgt_bvcomp_encode": (
            [u64, u64p, u32p, u32, u32, u32,
             u64p, u64p, u32p, u32p,
             u16p, u64p, u32p, u32p, u32p], void_p),
        "wgt_bvcomp_encode_spill": (
            [u64, u64p, u32p, u32, u32, u32,
             u64p, u64p, u32p, u32p,
             u16p, u64p, u32p, u32p, u32p, c.c_char_p, u64], void_p),
        "wgt_bvcomp_tokens": (
            [u64, u64p, u32p, u32, u32, u32, u64p, u64p, u32p, u32p], void_p),
        "wgt_bvcomp_histogram_stream": (
            [u8p, u64, u64, u32, u32, u32, i32, i32, i32, i32,
             u32, u32, u32, i32, u64p, u64p, u32p, u32p], void_p),
        "wgt_bvcomp_encode_stream": (
            [u8p, u64, u64, u32, u32, u32, i32, i32, i32, i32,
             u32, u32, u32, u64p, u64p, u32p, u32p,
             u16p, u64p, u32p, u32p, u32p, c.c_char_p, u64], void_p),
        "wgt_seq_open": (
            [u16p, u64, u32, u64, u32, u32, u32p, u32p, u64p, u64,
             u16p, u64p, u32p, u32p, u32p], void_p),
        "wgt_seq_next": ([void_p, u64, u64], void_p),
        "wgt_seq_close": ([void_p], None),
        "wgt_tok_count": ([void_p], u64),
        "wgt_tok_get": ([void_p, u64p, u8p], None),
        "wgt_tok_free": ([void_p], None),
        "wgt_enc_stream_len": ([void_p], u64),
        "wgt_enc_num_phases": ([void_p], u64),
        "wgt_enc_num_symbols": ([void_p], u64),
        "wgt_enc_final_state": ([void_p], u32),
        "wgt_enc_get_stream": ([void_p, u16p], None),
        "wgt_enc_get_states": ([void_p, u32p], None),
        "wgt_enc_get_pointers": ([void_p, u64p], None),
        "wgt_enc_free": ([void_p], None),
        "wgt_ans_decode_seq": (
            [u16p, u64, u32, u64, u64, u32, u32, u16p, u64p, u32p, u32p, u32p], void_p),
        "wgt_ans_decode_seq_blocks": (
            [u16p, u32p, u32p, u64p, u64, u64, u32, u32,
             u16p, u64p, u32p, u32p, u32p], void_p),
        "wgt_ans_decode_random": (
            [u16p, u64, u32p, u64p, u64, u32, u32,
             u16p, u64p, u32p, u32p, u32p, u64p, u64, u32,
             u32p, u32p, u64p, u64], void_p),
        "wgt_ans_bench_random": (
            [u16p, u32p, u64p, u64, u32, u32,
             u16p, u64p, u32p, u32p, u32p, u64, u64, u32,
             u32p, u32p, u64p, u64], i64),
        "wgt_ans_decode_random_ef": (
            [u16p, u64, u32p, void_p, u64, u64, u32, u32,
             u16p, u64p, u32p, u32p, u32p, u64p, u64, u32,
             u32p, u32p, u64p, u64], void_p),
        "wgt_ans_bench_random_ef": (
            [u16p, u32p, void_p, u64, u64, u32, u32,
             u16p, u64p, u32p, u32p, u32p, u64, u64, u32,
             u32p, u32p, u64p, u64], i64),
        "wgt_ans_encode_raw": ([u64p, u8p, u64, u16p, u64p, u32p, u32p, u32p], void_p),
        "wgt_ans_decode_raw": (
            [u16p, u64, u32, u8p, u64, u16p, u64p, u32p, u32p, u32p, u64p], i32),
        "wgt_scale_freqs": ([u64p, u64p, u64, u64, i64, u64p], i32),
        "wgt_emit_split": (
            [f64p, f64p, u8p, u8p, u64, u64, i32, c.c_double, i64p], i32),
        "wgt_emit_split_last": (
            [f64p, f64p, u8p, u8p, i32p, f64p, u64, u64, c.c_double,
             c.c_double, i64p], i32),
        "wgt_ef_build_size": ([u64p, u64, u64], i64),
        "wgt_ef_build": ([u64p, u64, u64, u8p], i32),
        "wgt_ef_load": ([u8p, u64], void_p),
        "wgt_ef_get": ([void_p, u64], u64),
        "wgt_ef_get_many": ([void_p, u64p, u64, u64p], None),
        "wgt_ef_free": ([void_p], None),
        "wgt_write_codes": ([u64p, i32p, u64, u32, u8p, u64], i64),
        "wgt_read_codes": ([u8p, u64, i32p, u64, u32, u64p], i32),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            _build()
            lib = ctypes.CDLL(_LIB_PATH)
            _declare(lib)
            _lib = lib
    return _lib


def last_error() -> str:
    return get_lib().wgt_last_error().decode()


def check_ptr(p):
    if not p:
        raise RuntimeError(f"native call failed: {last_error()}")
    return p


def as_ptr(arr: np.ndarray, ctype):
    """Pointer into a C-contiguous numpy array of the right dtype."""
    assert arr.flags["C_CONTIGUOUS"], "array must be contiguous"
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def fetch_adjacency(lib, handle, num_offsets: int | None = None):
    """Copy an AdjResult handle into (offsets, succs) numpy arrays and free it."""
    try:
        n_off = int(lib.wgt_adj_num_offsets(handle)) if num_offsets is None else num_offsets
        n_arcs = int(lib.wgt_adj_num_arcs(handle))
        offsets = np.empty(n_off, dtype=np.uint64)
        succs = np.empty(n_arcs, dtype=np.uint32)
        lib.wgt_adj_get_offsets(handle, as_ptr(offsets, ctypes.c_uint64))
        if n_arcs:
            lib.wgt_adj_get_succs(handle, as_ptr(succs, ctypes.c_uint32))
        return offsets, succs
    finally:
        lib.wgt_adj_free(handle)
