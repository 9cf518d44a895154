"""Native-backed symbol-level codec wrappers (encode/decode arbitrary
(value, component) sequences). Mirrors the surface the reference exposes via
ANSEncoder/ANSDecoder directly (reference: tests/compressor_tests.rs usage)."""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np

from ..utils import native
from .model import ANSModel, build_model


@dataclasses.dataclass
class RawEncoding:
    stream: np.ndarray      # u16
    states: np.ndarray      # u32, one per OUTDEGREE symbol encoded
    pointers: np.ndarray    # u64
    final_state: int


def encode_raw(model: ANSModel, values, components) -> RawEncoding:
    """Encodes values[i] into component components[i], in order."""
    lib = native.get_lib()
    vals = np.ascontiguousarray(values, dtype=np.uint64)
    comps = np.ascontiguousarray(components, dtype=np.uint8)
    freqs, lens, log_m, radix, fidelity = model.packed()
    h = native.check_ptr(
        lib.wgt_ans_encode_raw(
            native.as_ptr(vals, ctypes.c_uint64),
            native.as_ptr(comps, ctypes.c_uint8),
            len(vals),
            native.as_ptr(freqs, ctypes.c_uint16),
            native.as_ptr(lens, ctypes.c_uint64),
            native.as_ptr(log_m, ctypes.c_uint32),
            native.as_ptr(radix, ctypes.c_uint32),
            native.as_ptr(fidelity, ctypes.c_uint32),
        )
    )
    try:
        stream_len = int(lib.wgt_enc_stream_len(h))
        nph = int(lib.wgt_enc_num_phases(h))
        stream = np.empty(stream_len, dtype=np.uint16)
        states = np.empty(nph, dtype=np.uint32)
        pointers = np.empty(nph, dtype=np.uint64)
        if stream_len:
            lib.wgt_enc_get_stream(h, native.as_ptr(stream, ctypes.c_uint16))
        if nph:
            lib.wgt_enc_get_states(h, native.as_ptr(states, ctypes.c_uint32))
            lib.wgt_enc_get_pointers(h, native.as_ptr(pointers, ctypes.c_uint64))
        return RawEncoding(stream, states, pointers, int(lib.wgt_enc_final_state(h)))
    finally:
        lib.wgt_enc_free(h)


def decode_raw(model: ANSModel, stream, state: int, components) -> np.ndarray:
    """Decodes len(components) symbols starting from `state` at the stream
    end. Decoding order is LIFO w.r.t. encoding order."""
    lib = native.get_lib()
    stream = np.ascontiguousarray(stream, dtype=np.uint16)
    comps = np.ascontiguousarray(components, dtype=np.uint8)
    out = np.empty(len(comps), dtype=np.uint64)
    freqs, lens, log_m, radix, fidelity = model.packed()
    rc = lib.wgt_ans_decode_raw(
        native.as_ptr(stream, ctypes.c_uint16),
        len(stream),
        state,
        native.as_ptr(comps, ctypes.c_uint8),
        len(comps),
        native.as_ptr(freqs, ctypes.c_uint16),
        native.as_ptr(lens, ctypes.c_uint64),
        native.as_ptr(log_m, ctypes.c_uint32),
        native.as_ptr(radix, ctypes.c_uint32),
        native.as_ptr(fidelity, ctypes.c_uint32),
        native.as_ptr(out, ctypes.c_uint64),
    )
    if rc != 0:
        raise RuntimeError(f"decode failed: {native.last_error()}")
    return out


def model_from_sequences(seqs: dict[int, np.ndarray]) -> ANSModel:
    """Builds an ANSModel from per-component raw symbol sequences (test helper)."""
    hists = []
    for comp in range(9):
        if comp in seqs and len(seqs[comp]):
            syms, counts = np.unique(np.asarray(seqs[comp], dtype=np.uint64), return_counts=True)
            hists.append((syms.astype(np.uint64), counts.astype(np.uint64)))
        else:
            hists.append((np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=np.uint64)))
    return build_model(hists)
