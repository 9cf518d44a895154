"""The Prelude: everything the decoder needs, plus (de)serialization of the
three on-disk artifacts.

Mirrors the reference's artifact roles (reference: src/ans/mod.rs:31-54,
src/bvgraph/random_access.rs:198-221):

- `basename.ans`      models + u16 stream + final state + graph metadata
- `basename.pointers` Elias-Fano of per-node stream pointers (reverse node order)
- `basename.states`   per-node u32 decoder states (reverse node order)

The layout is this framework's own little-endian format (not epserde). Model
tables store only the scaled frequencies (2 bytes/entry); cumulative
frequencies and renormalization bounds are rederived at load time, so the
`.ans` header is smaller than the reference's 8-byte EncoderModelEntry rows.
"""

from __future__ import annotations

import ctypes
import dataclasses
import struct

import numpy as np

from ..utils import native
from .model import ANSModel, ComponentModel, NUM_COMPONENTS

ANS_MAGIC = b"WGTANS01"
STATES_MAGIC = b"WGTST001"


@dataclasses.dataclass
class Prelude:
    model: ANSModel
    stream: np.ndarray  # uint16
    state: int          # final encoder state
    num_nodes: int
    num_arcs: int
    compression_window: int
    min_interval_length: int
    # Block-parallel encode entry table (None for serial single-state
    # encodes): (start_nodes u32[B], entry_states u32[B], entry_ptrs u64[B]).
    # Each block's stream region decodes independently starting from its
    # entry (state, pointer); boundaries are token-balanced node starts
    # (references may cross them — decoders seed context from phases or
    # carry the window across blocks).
    blocks: tuple | None = None
    # Phase sampling: .states/.pointers carry an entry only for nodes
    # 0, k, 2k, ... (k = phase_step). Random access enters at the
    # preceding sampled node and decodes forward — the same storage/speed
    # dial as BVGraph's offset steps, shrinking the phase artifacts ~k x
    # (the reference authors' open problem, README.md:176-179).
    phase_step: int = 1

    # ---- .ans ----
    def to_bytes(self) -> bytes:
        version = 3 if self.phase_step > 1 else (
            2 if self.blocks is not None else 1)
        parts = [ANS_MAGIC]
        parts.append(
            struct.pack(
                "<IQQIIIQ",
                version,
                self.num_nodes,
                self.num_arcs,
                self.compression_window,
                self.min_interval_length,
                self.state,
                len(self.stream),
            )
        )
        if version == 3:
            parts.append(struct.pack("<I", self.phase_step))
        for c in self.model.components:
            parts.append(struct.pack("<IIII", c.log_m, c.radix, c.fidelity, len(c.freqs)))
        for c in self.model.components:
            parts.append(np.ascontiguousarray(c.freqs, dtype="<u2").tobytes())
        if version >= 2:
            starts, bstates, bptrs = (self.blocks if self.blocks is not None
                                      else ([], [], []))
            parts.append(struct.pack("<I", len(starts)))
            parts.append(np.ascontiguousarray(starts, dtype="<u4").tobytes())
            parts.append(np.ascontiguousarray(bstates, dtype="<u4").tobytes())
            parts.append(np.ascontiguousarray(bptrs, dtype="<u8").tobytes())
        parts.append(np.ascontiguousarray(self.stream, dtype="<u2").tobytes())
        return b"".join(parts)

    @staticmethod
    def from_bytes(data) -> "Prelude":
        """Accepts bytes or any uint8 buffer (np.memmap for zero-copy
        loads: the u16 stream stays a view on the mapping, so graphs
        larger than RAM page in on demand like the reference's epserde
        mmap loads, random_access.rs:57-67)."""
        if bytes(data[:8]) != ANS_MAGIC:
            raise ValueError("not a webgraph-ans-tpu .ans file")
        off = 8
        version, nodes, arcs, window, min_int, state, stream_len = struct.unpack_from(
            "<IQQIIIQ", data, off
        )
        if version not in (1, 2, 3):
            raise ValueError(f"unsupported .ans version {version}")
        off += struct.calcsize("<IQQIIIQ")
        phase_step = 1
        if version == 3:
            (phase_step,) = struct.unpack_from("<I", data, off)
            off += 4
        params = []
        for _ in range(NUM_COMPONENTS):
            params.append(struct.unpack_from("<IIII", data, off))
            off += 16
        components = []
        for log_m, radix, fidelity, table_len in params:
            freqs = np.frombuffer(data, dtype="<u2", count=table_len, offset=off).copy()
            off += 2 * table_len
            components.append(ComponentModel(freqs, log_m, radix, fidelity))
        blocks = None
        if version >= 2:
            (nb,) = struct.unpack_from("<I", data, off)
            off += 4
            starts = np.frombuffer(data, dtype="<u4", count=nb, offset=off).copy()
            off += 4 * nb
            bstates = np.frombuffer(data, dtype="<u4", count=nb, offset=off).copy()
            off += 4 * nb
            bptrs = np.frombuffer(data, dtype="<u8", count=nb, offset=off).copy()
            off += 8 * nb
            blocks = (starts, bstates, bptrs) if nb else None
        stream = np.frombuffer(data, dtype="<u2", count=stream_len, offset=off)
        return Prelude(
            ANSModel(components), stream, state, nodes, arcs, window, min_int,
            blocks=blocks, phase_step=phase_step,
        )

    def serialized_size(self) -> int:
        """Byte size of the `.ans` artifact this prelude serializes to."""
        return len(self.to_bytes())

    def save(self, basename: str) -> None:
        with open(basename + ".ans", "wb") as f:
            f.write(self.to_bytes())

    @staticmethod
    def load(basename: str) -> "Prelude":
        return Prelude.from_bytes(
            np.memmap(basename + ".ans", dtype=np.uint8, mode="r"))


# ---- .states ----
def save_states(basename: str, states: np.ndarray) -> None:
    with open(basename + ".states", "wb") as f:
        f.write(STATES_MAGIC)
        f.write(struct.pack("<Q", len(states)))
        f.write(np.ascontiguousarray(states, dtype="<u4").tobytes())


def load_states(basename: str) -> np.ndarray:
    data = np.memmap(basename + ".states", dtype=np.uint8, mode="r")
    if bytes(data[:8]) != STATES_MAGIC:
        raise ValueError("not a webgraph-ans-tpu .states file")
    (n,) = struct.unpack_from("<Q", data, 8)
    return np.frombuffer(data, dtype="<u4", count=n, offset=16)


# ---- .pointers (Elias-Fano) ----
def save_pointers(basename: str, pointers: np.ndarray) -> None:
    """Serializes the monotone stream-pointer sequence (reverse node order)
    as Elias-Fano (reference: random_access.rs:224-236 via sux)."""
    lib = native.get_lib()
    vals = np.ascontiguousarray(pointers, dtype=np.uint64)
    u = int(vals[-1]) + 1 if len(vals) else 1
    size = lib.wgt_ef_build_size(native.as_ptr(vals, ctypes.c_uint64), len(vals), u)
    if size < 0:
        raise RuntimeError(f"EF build failed: {native.last_error()}")
    out = np.empty(size, dtype=np.uint8)
    rc = lib.wgt_ef_build(
        native.as_ptr(vals, ctypes.c_uint64), len(vals), u, native.as_ptr(out, ctypes.c_uint8)
    )
    if rc != 0:
        raise RuntimeError(f"EF build failed: {native.last_error()}")
    with open(basename + ".pointers", "wb") as f:
        f.write(out.tobytes())


def load_pointers(basename: str) -> np.ndarray:
    """Loads the EF-compressed pointers back into a plain uint64 array."""
    with open(basename + ".pointers", "rb") as f:
        blob = np.frombuffer(f.read(), dtype=np.uint8).copy()
    lib = native.get_lib()
    h = native.check_ptr(lib.wgt_ef_load(native.as_ptr(blob, ctypes.c_uint8), len(blob)))
    try:
        n = int(np.frombuffer(blob[8:16].tobytes(), dtype="<u8")[0])
        idx = np.arange(n, dtype=np.uint64)
        out = np.empty(n, dtype=np.uint64)
        lib.wgt_ef_get_many(
            h, native.as_ptr(idx, ctypes.c_uint64), n, native.as_ptr(out, ctypes.c_uint64)
        )
        return out
    finally:
        lib.wgt_ef_free(h)
