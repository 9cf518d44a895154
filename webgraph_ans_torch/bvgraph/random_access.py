"""ANSBvGraph: random-access reads from `.ans` + `.pointers` + `.states`
(reference: src/bvgraph/random_access.rs:52-82,
 src/bvgraph/factories/bvgraph_decoder_factory.rs:46-58)."""

from __future__ import annotations

import ctypes

import numpy as np

from ..ans.prelude import Prelude, load_pointers, load_states
from ..utils import native
from .graph import Adjacency


class ANSBvGraph:
    """Random-access reader. Phases (per-node state + stream pointer) are
    stored in reverse node order on disk, exactly like the reference; states
    are un-reversed into node order at load time.

    Pointers live in one of two forms:

    - succinct (default for `load`): the Elias-Fano `.pointers` blob stays
      resident as-is (~2 bits/node) and every phase lookup is a
      constant-time select inside the native decoder — the reference keeps
      the sux EF + SelectAdaptConst in memory the same way
      (src/bvgraph/factories/bvgraph_decoder_factory.rs:46-58);
    - materialized: a plain node-order u64 array (8 B/node), used when the
      caller already has one (e.g. fresh store() results) or asks for it.

    The device planner needs the full array; the `pointers` property
    materializes it on demand (cached) in either mode.
    """

    def __init__(self, prelude: Prelude, states: np.ndarray,
                 pointers: np.ndarray | None = None,
                 ef_blob: np.ndarray | None = None):
        if (pointers is None) == (ef_blob is None):
            raise ValueError("pass exactly one of pointers / ef_blob")
        self.prelude = prelude
        n = prelude.num_nodes
        k = prelude.phase_step
        expected = -(-n // k) if n else 0
        assert len(states) == expected, (
            f"states has {len(states)} entries, expected {expected} "
            f"(n={n}, phase_step={k})")
        # reverse: phases[j] on disk belongs to sampled node
        # (expected-1-j)*k; un-reversed entry i belongs to node i*k
        self.states = np.ascontiguousarray(states[::-1], dtype=np.uint32)
        self._num_phases = expected
        self._pointers: np.ndarray | None = None
        self._ef_blob = None
        self._ef_handle = None
        if pointers is not None:
            assert len(pointers) == expected, (
                f"pointers has {len(pointers)} entries, expected {expected}")
            self._pointers = np.ascontiguousarray(
                pointers[::-1], dtype=np.uint64)
        else:
            self._ef_blob = np.ascontiguousarray(ef_blob, dtype=np.uint8)
            lib = native.get_lib()
            self._ef_handle = native.check_ptr(lib.wgt_ef_load(
                native.as_ptr(self._ef_blob, ctypes.c_uint8),
                len(self._ef_blob)))
        self._packed = prelude.model.packed()
        self._stream = np.ascontiguousarray(prelude.stream, dtype=np.uint16)

    def __del__(self):
        h = getattr(self, "_ef_handle", None)
        if h:
            try:
                native.get_lib().wgt_ef_free(h)
            except Exception:  # noqa: BLE001 - interpreter teardown
                pass
            self._ef_handle = None

    @staticmethod
    def load(basename: str, ef_pointers: bool = True) -> "ANSBvGraph":
        """Opens the three artifacts. ef_pointers=True (default) keeps the
        `.pointers` Elias-Fano succinct in memory; False decompresses it to
        a plain u64 array up front."""
        prelude, states = Prelude.load(basename), load_states(basename)
        if ef_pointers:
            blob = np.fromfile(basename + ".pointers", dtype=np.uint8)
            return ANSBvGraph(prelude, states, ef_blob=blob)
        return ANSBvGraph(prelude, states, pointers=load_pointers(basename))

    @property
    def pointers(self) -> np.ndarray:
        """Node-order phase pointers as a plain u64 array (materialized
        from the EF structure on first use in succinct mode)."""
        if self._pointers is None:
            lib = native.get_lib()
            m = self._num_phases
            # EF index j holds the pointer of sampled node (m-1-j)*step
            idx = np.arange(m - 1, -1, -1, dtype=np.uint64)
            out = np.empty(m, dtype=np.uint64)
            if m:
                lib.wgt_ef_get_many(
                    self._ef_handle, native.as_ptr(idx, ctypes.c_uint64), m,
                    native.as_ptr(out, ctypes.c_uint64))
            self._pointers = out
        return self._pointers

    @property
    def num_nodes(self) -> int:
        return self.prelude.num_nodes

    @property
    def num_arcs(self) -> int:
        return self.prelude.num_arcs

    def successors_batch(self, nodes) -> Adjacency:
        """Decodes the successor lists of the queried nodes (resolving
        reference chains recursively through the phase table)."""
        p = self.prelude
        lib = native.get_lib()
        freqs, lens, log_m, radix, fidelity = self._packed
        node_ids = np.ascontiguousarray(nodes, dtype=np.uint64)
        if self._pointers is not None:
            h = native.check_ptr(
                lib.wgt_ans_decode_random(
                    native.as_ptr(self._stream, ctypes.c_uint16),
                    len(self._stream),
                    native.as_ptr(self.states, ctypes.c_uint32),
                    native.as_ptr(self._pointers, ctypes.c_uint64),
                    p.num_nodes,
                    p.compression_window,
                    p.min_interval_length,
                    native.as_ptr(freqs, ctypes.c_uint16),
                    native.as_ptr(lens, ctypes.c_uint64),
                    native.as_ptr(log_m, ctypes.c_uint32),
                    native.as_ptr(radix, ctypes.c_uint32),
                    native.as_ptr(fidelity, ctypes.c_uint32),
                    native.as_ptr(node_ids, ctypes.c_uint64),
                    len(node_ids),
                    p.phase_step,
                )
            )
        else:
            h = native.check_ptr(
                lib.wgt_ans_decode_random_ef(
                    native.as_ptr(self._stream, ctypes.c_uint16),
                    len(self._stream),
                    native.as_ptr(self.states, ctypes.c_uint32),
                    self._ef_handle,
                    self._num_phases,
                    p.num_nodes,
                    p.compression_window,
                    p.min_interval_length,
                    native.as_ptr(freqs, ctypes.c_uint16),
                    native.as_ptr(lens, ctypes.c_uint64),
                    native.as_ptr(log_m, ctypes.c_uint32),
                    native.as_ptr(radix, ctypes.c_uint32),
                    native.as_ptr(fidelity, ctypes.c_uint32),
                    native.as_ptr(node_ids, ctypes.c_uint64),
                    len(node_ids),
                    p.phase_step,
                )
            )
        offsets, succs = native.fetch_adjacency(lib, h)
        return Adjacency(offsets, succs)

    def successors(self, node: int) -> np.ndarray:
        return self.successors_batch([node]).successors(0)

    def bench_random(self, num_queries: int, seed: int = 0) -> int:
        """Native random-access benchmark: enumerates the successors of
        `num_queries` random nodes entirely in the host runtime; returns the
        number of arcs touched (reference: examples/bench_random_access.rs)."""
        p = self.prelude
        lib = native.get_lib()
        freqs, lens, log_m, radix, fidelity = self._packed
        if self._pointers is not None:
            arcs = lib.wgt_ans_bench_random(
                native.as_ptr(self._stream, ctypes.c_uint16),
                native.as_ptr(self.states, ctypes.c_uint32),
                native.as_ptr(self._pointers, ctypes.c_uint64),
                p.num_nodes,
                p.compression_window,
                p.min_interval_length,
                native.as_ptr(freqs, ctypes.c_uint16),
                native.as_ptr(lens, ctypes.c_uint64),
                native.as_ptr(log_m, ctypes.c_uint32),
                native.as_ptr(radix, ctypes.c_uint32),
                native.as_ptr(fidelity, ctypes.c_uint32),
                num_queries,
                seed,
                p.phase_step,
            )
        else:
            arcs = lib.wgt_ans_bench_random_ef(
                native.as_ptr(self._stream, ctypes.c_uint16),
                native.as_ptr(self.states, ctypes.c_uint32),
                self._ef_handle,
                self._num_phases,
                p.num_nodes,
                p.compression_window,
                p.min_interval_length,
                native.as_ptr(freqs, ctypes.c_uint16),
                native.as_ptr(lens, ctypes.c_uint64),
                native.as_ptr(log_m, ctypes.c_uint32),
                native.as_ptr(radix, ctypes.c_uint32),
                native.as_ptr(fidelity, ctypes.c_uint32),
                num_queries,
                seed,
                p.phase_step,
            )
        if arcs < 0:
            raise RuntimeError(f"bench failed: {native.last_error()}")
        return int(arcs)
