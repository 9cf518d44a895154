"""ANSBvGraphSeq: sequential-only access from `basename.ans`
(reference: src/bvgraph/sequential.rs:29-51)."""

from __future__ import annotations

import ctypes

import numpy as np

from ..ans.prelude import Prelude
from ..utils import native
from .graph import Adjacency


class ANSBvGraphSeq:
    """Sequential reader: decodes the whole graph from the final encoder
    state, walking the stream backwards (the encoder ran in reverse, so
    decode yields nodes 0..n-1 in order)."""

    def __init__(self, prelude: Prelude):
        self.prelude = prelude

    @staticmethod
    def load(basename: str) -> "ANSBvGraphSeq":
        return ANSBvGraphSeq(Prelude.load(basename))

    @property
    def num_nodes(self) -> int:
        return self.prelude.num_nodes

    @property
    def num_arcs(self) -> int:
        return self.prelude.num_arcs

    def decode_all(self) -> Adjacency:
        """Full sequential scan on the host runtime (CPU baseline; the
        device paths live in webgraph_ans_torch.ops). Block-parallel-encoded
        files decode in ONE native call that re-enters the stream at each
        block's (state, pointer) while carrying the successor window
        across blocks (block starts are token-balanced, not
        reference-safe; see ops/encode_torch.py)."""
        p = self.prelude
        lib = native.get_lib()
        freqs, lens, log_m, radix, fidelity = p.model.packed()
        stream = np.ascontiguousarray(p.stream, dtype=np.uint16)

        if p.blocks is not None and len(p.blocks[0]) > 1:
            starts, bstates, bptrs = p.blocks
            starts = np.ascontiguousarray(starts, dtype=np.uint32)
            bstates = np.ascontiguousarray(bstates, dtype=np.uint32)
            bptrs = np.ascontiguousarray(bptrs, dtype=np.uint64)
            h = native.check_ptr(
                lib.wgt_ans_decode_seq_blocks(
                    native.as_ptr(stream, ctypes.c_uint16),
                    native.as_ptr(starts, ctypes.c_uint32),
                    native.as_ptr(bstates, ctypes.c_uint32),
                    native.as_ptr(bptrs, ctypes.c_uint64),
                    len(starts),
                    p.num_nodes,
                    p.compression_window,
                    p.min_interval_length,
                    native.as_ptr(freqs, ctypes.c_uint16),
                    native.as_ptr(lens, ctypes.c_uint64),
                    native.as_ptr(log_m, ctypes.c_uint32),
                    native.as_ptr(radix, ctypes.c_uint32),
                    native.as_ptr(fidelity, ctypes.c_uint32),
                )
            )
            off, succs = native.fetch_adjacency(lib, h)
            return Adjacency(off, succs)

        off, succs = self._decode_range(
            lib, stream, freqs, lens, log_m, radix, fidelity,
            len(stream), p.state, 0, p.num_nodes)
        return Adjacency(off, succs)

    def iter_chunks(self, max_nodes: int = 1 << 16,
                    max_arcs: int = 1 << 22):
        """Streams the graph in node order as (first_node, Adjacency)
        chunks with O(window + chunk) RAM — the lazy-iterator analog of
        the reference's BvGraphSeq (src/bvgraph/sequential.rs:29-51),
        where decode_all materializes the full CSR. Block-encoded files
        re-enter the stream at each block boundary transparently."""
        p = self.prelude
        lib = native.get_lib()
        freqs, lens, log_m, radix, fidelity = p.model.packed()
        stream = np.ascontiguousarray(p.stream, dtype=np.uint16)
        if p.blocks is not None and len(p.blocks[0]) > 1:
            starts = np.ascontiguousarray(p.blocks[0], dtype=np.uint32)
            bstates = np.ascontiguousarray(p.blocks[1], dtype=np.uint32)
            bptrs = np.ascontiguousarray(p.blocks[2], dtype=np.uint64)
        else:
            starts = bstates = bptrs = None
        h = native.check_ptr(lib.wgt_seq_open(
            native.as_ptr(stream, ctypes.c_uint16), len(stream),
            p.state, p.num_nodes, p.compression_window,
            p.min_interval_length,
            native.as_ptr(starts, ctypes.c_uint32) if starts is not None else None,
            native.as_ptr(bstates, ctypes.c_uint32) if starts is not None else None,
            native.as_ptr(bptrs, ctypes.c_uint64) if starts is not None else None,
            0 if starts is None else len(starts),
            native.as_ptr(freqs, ctypes.c_uint16),
            native.as_ptr(lens, ctypes.c_uint64),
            native.as_ptr(log_m, ctypes.c_uint32),
            native.as_ptr(radix, ctypes.c_uint32),
            native.as_ptr(fidelity, ctypes.c_uint32)))
        try:
            first = 0
            while True:
                ch = native.check_ptr(lib.wgt_seq_next(h, max_nodes,
                                                       max_arcs))
                off, succs = native.fetch_adjacency(lib, ch)
                if len(off) <= 1:
                    break
                yield first, Adjacency(off, succs)
                first += len(off) - 1
        finally:
            lib.wgt_seq_close(h)

    def iter_lists(self, max_nodes: int = 1 << 16,
                   max_arcs: int = 1 << 22):
        """Yields each node's successor list in node order, O(window +
        chunk) RAM (the per-node iterator surface of the reference)."""
        for _first, adj in self.iter_chunks(max_nodes, max_arcs):
            for i in range(adj.num_nodes):
                yield adj.successors(i)

    def _decode_range(self, lib, stream, freqs, lens, log_m, radix, fidelity,
                      entry_ptr, entry_state, first_node, n):
        p = self.prelude
        h = native.check_ptr(
            lib.wgt_ans_decode_seq(
                native.as_ptr(stream, ctypes.c_uint16),
                entry_ptr,
                entry_state,
                first_node,
                n,
                p.compression_window,
                p.min_interval_length,
                native.as_ptr(freqs, ctypes.c_uint16),
                native.as_ptr(lens, ctypes.c_uint64),
                native.as_ptr(log_m, ctypes.c_uint32),
                native.as_ptr(radix, ctypes.c_uint32),
                native.as_ptr(fidelity, ctypes.c_uint32),
            )
        )
        return native.fetch_adjacency(lib, h)

    def __iter__(self):
        adj = self.decode_all()
        for i in range(adj.num_nodes):
            yield i, adj.successors(i)
