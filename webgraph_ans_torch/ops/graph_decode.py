"""Host orchestration of the lane-parallel token decoder: partition a
graph's nodes into contiguous blocks (one per lane), enter the stream at
each block's phase, seed the outdegree rings, and run the decode kernel.

The device-parallel replacement for the serial sequential scan
(reference: src/bvgraph/sequential.rs + src/ans/decoder.rs): same stream,
same phases, decoded by thousands of lanes at once. Lane pointers are
absolute 64-bit word indices, so a lane may span any part of the stream.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bvgraph.random_access import ANSBvGraph
from .decode_cuda import decode_blocks
from .decode_torch import (build_decoder_tables_np, fetch_block_tokens,
                           resolve_device, round_cap, seed_rings,
                           tables_from_numpy)


class TorchGraphDecoder:
    """Holds the device tables, stream and phases of a loaded graph.
    `device` defaults to CUDA and raises when CUDA is missing; pass
    device="cpu" for the plain PyTorch version on the host."""

    def __init__(self, graph: ANSBvGraph, device=None):
        self.device = resolve_device(device)
        p = graph.prelude
        if p.num_nodes >= 1 << 31:
            raise ValueError("the device decode path supports graphs with "
                             "< 2^31 nodes")
        self.graph = graph
        self.window = p.compression_window
        self.min_interval = p.min_interval_length
        self.num_nodes = p.num_nodes
        self.num_arcs = p.num_arcs
        self.phase_step = p.phase_step
        lut_np, params = build_decoder_tables_np(p.model)
        self.tables = tables_from_numpy(lut_np, p.stream, params, self.device)
        self.params = self.tables.params
        # graph.states/pointers are in node order (entry i = node
        # i * phase_step on sampled artifacts)
        self.states_np = np.asarray(graph.states)
        self.pointers = np.asarray(graph.pointers, dtype=np.int64)
        self._entry_table = None
        self._plans: dict[int, dict] = {}

    def _entries(self):
        """Valid lane entry points on sampled artifacts: the sampled-phase
        nodes union the encode-block starts (which carry their own entry
        state/pointer in the prelude block table). Returns (nodes i64
        ascending, states u32, ptrs i64)."""
        if self._entry_table is not None:
            return self._entry_table
        k = self.phase_step
        nodes = np.arange(0, self.num_nodes, k, dtype=np.int64)
        states = self.states_np
        ptrs = self.pointers
        blocks = self.graph.prelude.blocks
        if blocks is not None:
            bn = np.asarray(blocks[0], np.int64)
            extra = bn % k != 0
            if extra.any():
                nodes = np.concatenate([nodes, bn[extra]])
                states = np.concatenate(
                    [states, np.asarray(blocks[1], np.uint32)[extra]])
                ptrs = np.concatenate(
                    [ptrs, np.asarray(blocks[2], np.int64)[extra]])
                order = np.argsort(nodes, kind="stable")
                nodes, states, ptrs = nodes[order], states[order], ptrs[order]
        self._entry_table = (nodes, states, ptrs)
        return self._entry_table

    def _entry_lookup(self, node_arr: np.ndarray):
        """(state, ptr) for each node in node_arr; every node must be a
        valid entry point (sampled or a block start). Nodes >= num_nodes
        (padding lanes) map to (0, 0)."""
        nodes, states, ptrs = self._entries()
        node_arr = np.asarray(node_arr, np.int64)
        live = node_arr < self.num_nodes
        idx = np.searchsorted(nodes, np.where(live, node_arr, 0))
        if not np.array_equal(nodes[idx][live], node_arr[live]):
            raise ValueError("lane start is not a valid entry point "
                             "(not sampled and not an encode-block start)")
        return (np.where(live, states[idx], 0).astype(np.uint32),
                np.where(live, ptrs[idx], 0).astype(np.int64))

    def _block_bounds(self, num_lanes: int, lo: int = 0, hi: int | None = None):
        """Block boundaries over nodes [lo, hi) balanced by per-node STREAM
        spans (pointers are descending in node order), so lanes carry
        similar token loads instead of similar node counts.

        On block-parallel-encoded (prelude v2) files, every encode-block
        start inside the range is unioned into the boundary set — a decode
        lane must never cross an encode-block boundary (the rANS state
        resets there)."""
        n = self.num_nodes
        hi = n if hi is None else hi
        span = hi - lo
        if self.phase_step > 1:
            return self._sampled_bounds(num_lanes, lo, hi)
        blocks = self.graph.prelude.blocks
        if blocks is not None:
            bstarts = np.asarray(blocks[0], np.int64)
            bstarts = np.unique(np.concatenate(
                [[lo], bstarts[(bstarts > lo) & (bstarts < hi)]]))
            if 2 * len(bstarts) >= num_lanes:
                # encode blocks are token-balanced by the encoder and a lane
                # must start exactly at a block boundary, so lanes = blocks
                starts = bstarts
                ends = np.empty_like(starts)
                ends[:-1] = starts[1:]
                ends[-1] = hi
                return starts.astype(np.int32), ends.astype(np.int32)
        ptrs = self.pointers
        idx = np.arange(num_lanes, dtype=np.int64)
        if span <= num_lanes or ptrs[lo] == ptrs[hi - 1]:
            starts = lo + (idx * span) // num_lanes
            ends = lo + ((idx + 1) * span) // num_lanes
            starts, ends = self._union_encode_blocks(starts, ends, lo, hi)
        else:
            # ascending cumulative lockstep-step estimate: stream words
            # model the token count, plus a per-node term (each node costs
            # fixed steps that consume almost no stream). Integer key in
            # eighth-words: 8*words + wpn8*node_index.
            est_tokens = 2 * self.num_arcs + 3 * self.num_nodes
            wpn8 = max(1, round(24 * len(self.graph.prelude.stream)
                                / max(est_tokens, 1)))
            consumed = ((ptrs[lo] - ptrs[lo:hi]) * 8
                        + wpn8 * np.arange(span, dtype=np.int64))
            targets = (idx * consumed[-1]) // num_lanes
            starts = lo + np.searchsorted(consumed, targets, side="left")
            starts[0] = lo
            starts = np.minimum(starts, hi - 1)
            starts = np.maximum.accumulate(starts)
            starts, ends = self._union_encode_blocks(starts, None, lo, hi)
        return starts.astype(np.int32), ends.astype(np.int32)

    def _sampled_bounds(self, num_lanes: int, lo: int, hi: int):
        """Lane boundaries on phase-sampled artifacts: candidates are the
        valid entry points (sampled nodes + block starts), balanced by
        stream consumption; every encode-block start in range is
        mandatory. `lo` must itself be an entry point."""
        nodes_t, _, ptrs_t = self._entries()
        sel = (nodes_t >= lo) & (nodes_t < hi)
        cand = nodes_t[sel]
        cptr = ptrs_t[sel]
        if not len(cand) or cand[0] != lo:
            raise ValueError(
                f"range start {lo} is not a valid entry point on a "
                f"phase-sampled artifact (step={self.phase_step})")
        idx = np.arange(num_lanes, dtype=np.int64)
        consumed = cptr[0] - cptr
        total = consumed[-1] if len(consumed) else 0
        targets = (idx * total) // max(num_lanes, 1)
        pick = np.searchsorted(consumed, targets, side="left")
        pick = np.minimum(pick, len(cand) - 1)
        pick[0] = 0
        pick = np.maximum.accumulate(pick)
        starts = cand[pick]
        blocks = self.graph.prelude.blocks
        if blocks is not None:
            bstarts = np.asarray(blocks[0], np.int64)
            starts = np.concatenate(
                [starts, bstarts[(bstarts > lo) & (bstarts < hi)]])
        starts = np.unique(starts)
        ends = np.empty_like(starts)
        ends[:-1] = starts[1:]
        ends[-1] = hi
        return starts.astype(np.int32), ends.astype(np.int32)

    def _union_encode_blocks(self, starts, ends, lo: int, hi: int):
        """Unions prelude encode-block start nodes (clipped to (lo, hi))
        into the lane boundary set; recomputes contiguous ends."""
        blocks = self.graph.prelude.blocks
        if blocks is not None:
            bstarts = np.asarray(blocks[0], np.int64)
            bstarts = bstarts[(bstarts > lo) & (bstarts < hi)]
            if len(bstarts):
                starts = np.unique(np.concatenate([starts, bstarts]))
                ends = None
        if ends is None:
            starts = np.unique(starts)
            ends = np.empty_like(starts)
            ends[:-1] = starts[1:]
            ends[-1] = hi
        return starts, ends

    def plan(self, num_lanes: int) -> dict:
        """Cached per-lane-count decode plan: lane bounds, entry phases and
        the seeded outdegree rings, on the device. The plan also remembers
        a tight token cap once a decode has observed the true counts."""
        pl = self._plans.get(num_lanes)
        if pl is not None:
            return pl
        starts, ends = self._block_bounds(num_lanes)
        n, W, dev = self.num_nodes, self.window, self.device
        starts_d = torch.from_numpy(starts).to(dev)
        if W > 0 and self.phase_step > 1:
            # sampled artifacts have no per-node phases to seed from: get
            # the pre-nodes' outdegrees from the native skip-decoder
            ring = torch.from_numpy(self._rings_via_native(starts, W)).to(dev)
        elif W > 0:
            # phases of the `window` nodes before each block (clamped to 0;
            # entries before node 0 are masked inside seed_rings)
            pre = starts[:, None].astype(np.int64) - W + np.arange(W)[None, :]
            pre_cl = np.clip(pre, 0, n - 1)
            ring = seed_rings(
                self.tables,
                torch.from_numpy(self.states_np[pre_cl].astype(np.int64)).to(dev),
                torch.from_numpy(self.pointers[pre_cl]).to(dev), starts_d, W)
        else:
            ring = torch.zeros((len(starts), 1), dtype=torch.int32, device=dev)

        if self.phase_step == 1:
            last = np.minimum(starts, n - 1)
            entry_states = self.states_np[last]
            entry_ptrs = self.pointers[last]
        else:
            entry_states, entry_ptrs = self._entry_lookup(starts)
        # padding lanes (start == end) never touch the stream
        entry_ptrs = np.where(starts < ends, entry_ptrs, 0)
        # ~2.05 tokens per arc + 3 per node is a generous upper estimate
        # for BvGraph token streams; overflow doubles and retries.
        est = (2 * self.num_arcs + 3 * self.num_nodes) // max(len(starts), 1)
        pl = dict(
            starts=starts_d, ends=torch.from_numpy(ends).to(dev), ring=ring,
            states=torch.from_numpy(entry_states.astype(np.int64)).to(dev),
            ptrs=torch.from_numpy(entry_ptrs.astype(np.int64)).to(dev),
            starts_np=starts, ends_np=ends,
            cap=round_cap(self.params, max(64, int(est * 1.3))))
        self._plans[num_lanes] = pl
        return pl

    def _rings_via_native(self, starts: np.ndarray, W: int) -> np.ndarray:
        """Ring seeds [L, W+1] from the native random-access decoder
        (outdegree = decoded list length), for artifacts without per-node
        phases."""
        n = self.num_nodes
        starts = np.asarray(starts, np.int64)
        pre = starts[:, None] - W + np.arange(W)[None, :]
        valid = (pre >= 0) & (starts[:, None] < n)
        ids = np.unique(pre[valid])
        R = W + 1
        ring = np.zeros((len(starts), R), np.int32)
        if len(ids):
            adj = self.graph.successors_batch(ids.astype(np.uint64))
            degs = np.diff(adj.offsets.astype(np.int64))
            deg_arr = np.zeros_like(pre)
            deg_arr[valid] = degs[np.searchsorted(ids, pre[valid])]
            rows = np.broadcast_to(np.arange(len(starts))[:, None],
                                   pre.shape)
            ring[rows[valid], (pre % R)[valid]] = deg_arr[valid]
        return ring

    def decode_raw(self, num_lanes: int = 256, cap: int | None = None):
        """Lane-parallel token decode of the whole graph; returns the raw
        device output (out, counts, cap) of decode_blocks (layout:
        ops/decode_torch.py). Reads the ok flags back and doubles the cap
        until every lane fits."""
        pl = self.plan(num_lanes)
        auto = cap is None
        cap = pl["cap"] if auto else round_cap(self.params, cap)
        while True:
            out, counts, ok = decode_blocks(
                self.tables, pl["states"], pl["ptrs"], pl["starts"],
                pl["ends"], pl["ring"], self.window, self.min_interval, cap)
            if bool(ok.all()):
                break
            cap *= 2
        if auto:
            pl["cap"] = cap   # remember a successful (possibly grown) cap
        return out, counts, cap

    def tighten_cap(self, num_lanes: int = 256) -> int:
        """One decode to observe the true per-lane token counts, then shrink
        the plan's cap to the smallest quantum covering them."""
        pl = self.plan(num_lanes)
        _, counts, _ = self.decode_raw(num_lanes)
        tight = round_cap(self.params, int(counts.max()))
        pl["cap"] = min(pl["cap"], tight)
        return pl["cap"]

    def decode_tokens(self, num_lanes: int = 256, cap: int | None = None):
        """Decodes every (component, value) token of the graph, lane-parallel
        over `num_lanes` contiguous node blocks. Returns (values u32,
        comps u8) concatenated in forward node order (host arrays)."""
        out, counts, cap = self.decode_raw(num_lanes, cap)
        return fetch_block_tokens(out, counts, cap)
