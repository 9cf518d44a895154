"""Host orchestration of the lane-parallel decoders: partition a graph's
nodes into contiguous blocks (one per lane), enter the stream at each
block's phase, seed the outdegree rings, and run the token-decode kernel
(decode_tokens) or the merged-emit kernel and its post-pass
(decode_to_adjacency_device).

The device-parallel replacement for the serial sequential scan
(reference: src/bvgraph/sequential.rs + src/ans/decoder.rs): same stream,
same phases, decoded by thousands of lanes at once. Lane pointers are
absolute 64-bit word indices, so a lane may span any part of the stream.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bvgraph.random_access import ANSBvGraph
from . import emit_post
from .decode_cuda import decode_blocks
from .decode_torch import (UNROLL, build_decoder_tables_np,
                           fetch_block_tokens, resolve_device, round_cap,
                           seed_rings, tables_from_numpy)
from .emit_cuda import decode_emit
from .emit_torch import MAX_WINDOW, emit_init_regs
from .reconstruct_device import parse_stats


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

    def decode_raw(self, num_lanes: int = 256, cap: int | None = None,
                   emit_aux: bool = False):
        """Lane-parallel token decode of the whole graph; returns the raw
        device output (out, counts, cap) of decode_blocks (layout:
        ops/decode_torch.py). Reads the ok flags back and doubles the cap
        until every lane fits. emit_aux=True decodes in aux mode; its cap
        covers tokens plus one summary step per node and is kept in the
        plan apart from the token cap."""
        pl = self.plan(num_lanes)
        auto = cap is None
        capkey = "cap_aux" if emit_aux else "cap"
        if auto and capkey not in pl:
            nodes_max = int(np.max(pl["ends_np"] - pl["starts_np"]))
            pl["cap_aux"] = round_cap(self.params, pl["cap"] + nodes_max)
        cap = pl[capkey] if auto else round_cap(self.params, cap)
        while True:
            out, counts, ok = decode_blocks(
                self.tables, pl["states"], pl["ptrs"], pl["starts"],
                pl["ends"], pl["ring"], self.window, self.min_interval, cap,
                emit_aux=emit_aux)
            if bool(ok.all()):
                break
            cap *= 2
        if auto:
            pl[capkey] = cap   # remember a successful (possibly grown) cap
        return out, counts, cap

    def tighten_cap(self, num_lanes: int = 256,
                    emit_aux: bool = False) -> int:
        """One decode to observe the true per-lane token counts, then shrink
        the plan's cap (token or aux) to the smallest quantum covering
        them."""
        pl = self.plan(num_lanes)
        _, counts, _ = self.decode_raw(num_lanes, emit_aux=emit_aux)
        if emit_aux:
            steps = counts.cpu().numpy() + (pl["ends_np"] - pl["starts_np"])
            tight = round_cap(self.params, int(steps.max()))
            pl["cap_aux"] = min(pl["cap_aux"], tight)
            return pl["cap_aux"]
        tight = round_cap(self.params, int(counts.max()))
        pl["cap"] = min(pl["cap"], tight)
        return pl["cap"]

    def decode_tokens(self, num_lanes: int = 256, cap: int | None = None):
        """Decodes every (component, value) token of the graph, lane-parallel
        over `num_lanes` contiguous node blocks. Returns (values u32,
        comps u8) concatenated in forward node order (host arrays)."""
        out, counts, cap = self.decode_raw(num_lanes, cap)
        return fetch_block_tokens(out, counts, cap)

    # ------------------------------------------------------------------
    # Merged-emit pipeline: decode and reconstruction in one kernel
    # (ops/emit_cuda.py), finished by the post-pass (ops/emit_post.py).
    # ------------------------------------------------------------------

    # output-ring rows of the merged-emit kernel before degrees are known:
    # a copy source older than this many rows makes the node dirty (the
    # post-pass resolves it)
    EMIT_RING_T = 512

    def _emit_bounds(self, num_lanes: int, key=None):
        """Lane bounds for the merged-emit kernel. First call: the
        stream-balanced block bounds. Once per-node degrees are known
        (cached from a decode), a minmax split over the kernel's step
        estimate (elements + 2*nodes, or the observed node_work)."""
        pl = self._plans.setdefault(key or ("emit", num_lanes), {})
        if "bounds" in pl:
            return pl["bounds"]
        n = self.num_nodes
        degs = pl.get("degs_np")
        if degs is None:
            starts, ends = self._block_bounds(num_lanes)
            if (self.window > 12 and self.phase_step == 1
                    and self.graph.prelude.blocks is None):
                # deep unbounded reference chains: even the first decode
                # splits at reference-safe nodes (a 4*window halo cannot
                # cover them); without safe nodes this is one lane
                if "safe_np" not in pl:
                    pl["safe_np"] = self._safe_boundaries()
                safe_nodes = np.nonzero(pl["safe_np"])[0]
                idx = np.searchsorted(safe_nodes, starts, side="right") - 1
                snapped = safe_nodes[np.maximum(idx, 0)]
                snapped[0] = 0
                bounds = np.unique(snapped)
                if len(bounds) < len(starts):
                    bounds = np.concatenate(
                        [bounds, np.full(len(starts) - len(bounds), n,
                                         bounds.dtype)])
                starts = bounds
                ends = np.empty_like(starts)
                ends[:-1] = starts[1:]
                ends[-1] = n
            return starts, ends
        safe = pl.get("safe_np")
        offs = np.concatenate([[0], np.cumsum(degs, dtype=np.int64)])
        nw = pl.get("node_work")
        if nw is not None:
            work = np.concatenate([[0.0], np.cumsum(nw)])
        else:
            work = offs + 2.0 * np.arange(n + 1)
        # halo re-decode cost per boundary (a halo is used only without
        # safe boundaries; see _emit_plan)
        Hsp = 4 * self.window if (self.phase_step == 1
                                  and self.graph.prelude.blocks is None
                                  and self.window > 0
                                  and safe is None) else 0
        halo_el = offs - offs[np.maximum(np.arange(n + 1) - Hsp, 0)]
        # Python floats and bools: the greedy split below is a scalar loop
        cost = np.diff(work).tolist()
        halo_l = halo_el.astype(np.float64).tolist()
        safe_l = [True] * n if safe is None else np.asarray(safe).tolist()
        force_unsafe = self.window <= 12

        def split(target):
            blist = [0]
            acc = halo_l[0]
            for x in range(n):
                w = cost[x]
                # prefer safe boundaries; inside long unsafe stretches
                # force an unsafe one at 1.5x target (deep-chain windows,
                # > 12, never force)
                close = acc + w > target and safe_l[x]
                close |= (acc + w > 1.5 * target) and force_unsafe
                if close and x > blist[-1]:
                    if len(blist) == num_lanes:
                        return None
                    blist.append(x)
                    acc = halo_l[x]
                acc += w
            while len(blist) < num_lanes + 1:
                blist.append(n)
            return np.array(blist, np.int64)

        lo = float(work[-1]) / num_lanes
        hi = lo * 8 + float(np.max(degs, initial=0) + halo_el.max()) + 4096
        for _ in range(40):
            mid = (lo + hi) / 2
            if split(mid) is None:
                lo = mid
            else:
                hi = mid
        bounds = split(hi)
        blocks = self.graph.prelude.blocks
        if blocks is not None or self.phase_step > 1:
            # a lane must start at an entry point: an encode-block start
            # (the rANS state resets there) or a sampled phase
            if blocks is not None:
                ent = np.unique(np.concatenate(
                    [[0], np.asarray(blocks[0], np.int64), [n]]))
            else:
                ent = self._entries()[0]
            bounds = ent[np.minimum(np.searchsorted(ent, bounds),
                                    len(ent) - 1)]
            bounds[0], bounds[-1] = 0, n
            bounds = np.maximum.accumulate(bounds)
            if blocks is not None:
                # no lane may cross an encode-block start (the rANS state
                # resets there): split lanes at the starts they contain.
                # The bounds are then the block table's starts plus 0 and
                # n whatever the bisection chose; it only places the empty
                # lanes, which keeps the plan equal to the JAX planner's
                bst = np.asarray(blocks[0], np.int64)
                bounds = np.sort(np.concatenate(
                    [bounds, bst[~np.isin(bst, bounds)]]))
        starts = bounds[:-1].copy()
        ends = bounds[1:].copy()
        pl["bounds"] = (starts, ends)
        return starts, ends

    def _emit_plan(self, num_lanes: int) -> dict:
        """Plan for decode_emit: lane bounds, halo starts, the register
        file and entry pointers on the device, the ring depth T and the
        step cap."""
        key = ("emit", num_lanes)
        pl = self._plans.setdefault(key, {})
        if "regs" in pl:
            return pl
        rstarts, ends = self._emit_bounds(num_lanes, key=key)
        rstarts = np.asarray(rstarts, np.int64)
        ends = np.asarray(ends, np.int64)
        W, n, dev = self.window, self.num_nodes, self.device
        # halo: decode 4*window nodes ahead of each lane so reference
        # chains of its first real nodes resolve in the lane (halo rows
        # feed the ring but are never marked); impossible across encode
        # blocks and on sampled artifacts (a lane starts at an entry)
        if (self.phase_step == 1 and self.graph.prelude.blocks is None
                and W > 0 and pl.get("safe_np") is None):
            H = 4 * W
        else:
            H = 0
        starts = np.where(rstarts >= ends, rstarts,
                          np.maximum(rstarts - H, 0))
        if W > 0 and self.phase_step > 1:
            ring = torch.from_numpy(self._rings_via_native(starts, W)).to(dev)
        elif W > 0:
            pre = starts[:, None] - W + np.arange(W)[None, :]
            pre_cl = np.clip(pre, 0, n - 1)
            ring = seed_rings(
                self.tables,
                torch.from_numpy(self.states_np[pre_cl].astype(np.int64)).to(dev),
                torch.from_numpy(self.pointers[pre_cl]).to(dev),
                torch.from_numpy(starts).to(dev), W)
        else:
            ring = torch.zeros((len(starts), 1), dtype=torch.int32,
                               device=dev)
        if self.phase_step == 1:
            last = np.minimum(starts, n - 1)
            entry_states, entry_ptrs = self.states_np[last], self.pointers[last]
        else:
            entry_states, entry_ptrs = self._entry_lookup(starts)
        entry_ptrs = np.where(starts < ends, entry_ptrs, 0).astype(np.int64)
        L = len(starts)
        # ring depth: copies reach back at most the window's degree sum
        # in output rows, so once degrees are known take the smallest
        # power of two that leaves only a trace of dirty nodes
        degs = pl.get("degs_np")
        T = self.EMIT_RING_T
        if degs is not None:
            W2 = max(W, 1)
            cs = np.concatenate([[0], np.cumsum(degs, dtype=np.int64)])
            ws = cs[W2:] - cs[:-W2] if len(cs) > W2 else cs[-1:]
            for cand_t, budget in ((256, max(64, n // 1000)),
                                   (512, max(64, n // 100)),
                                   (1024, max(64, n // 50)),
                                   (2048, max(64, n // 50)),
                                   (4096, n)):
                T = cand_t
                if int((ws > cand_t).sum()) <= budget:
                    break
        if degs is not None:
            offs = np.concatenate([[0], np.cumsum(degs, dtype=np.int64)])
            le = offs[ends] - offs[starts]       # includes halo elements
            est = int((le + 2 * (ends - starts)).max() * 1.12) + 64
        else:
            est = int((self.num_arcs * 1.35 + 3 * n) / max(L, 1) * 2.2) + 64
        regs = emit_init_regs(entry_states.astype(np.int64), starts, ends,
                              ring, W, real_starts=rstarts)
        pl.update(regs=regs, ptrs=torch.from_numpy(entry_ptrs).to(dev), T=T,
                  starts_np=rstarts, ends_np=ends, hstarts_np=starts,
                  cap=-(-est // UNROLL) * UNROLL)
        return pl

    def _safe_boundaries(self) -> np.ndarray:
        """safe[x] is True iff no reference chain crosses a lane boundary
        placed at x (suffix minimum of the ancestor minima >= x). The
        parent table comes from one aux-mode token decode at 2048 lanes
        (plan time only)."""
        n = self.num_nodes
        out, _, cap = self.decode_raw(2048, emit_aux=True)
        st = parse_stats(out, n, cap)
        parent = st["parent"].cpu().numpy().astype(np.int64)
        ref_mask = st["depth"].cpu().numpy() > 0
        am = np.arange(n, dtype=np.int64)
        # ancestor minimum resolves forward (parents precede children)
        for _ in range(64):
            upd = ref_mask & (am[parent] < am)
            if not upd.any():
                break
            am = np.where(upd, am[parent], am)
        sm = np.minimum.accumulate(am[::-1])[::-1]
        safe = np.ones(n, bool)
        safe[1:] = sm[1:] >= np.arange(1, n)
        return safe

    def decode_emit_raw(self, num_lanes: int = 2048, cap: int | None = None,
                        check: bool = True):
        """Merged-emit kernel decode: returns (val, xch, nib, cap), the
        device channels of ops/emit_post.py. check=True reads the lanes'
        done flags back, doubles the cap until every lane finishes, and
        then keeps the observed rows and the tight cap in the plan;
        check=False issues no host synchronisation."""
        pl = self._emit_plan(num_lanes)
        auto = cap is None
        cap = pl["cap"] if auto else -(-cap // UNROLL) * UNROLL
        while True:
            val, xch, nib, rows, ok, _ = decode_emit(
                self.tables, pl["regs"], pl["ptrs"], self.window,
                self.min_interval, cap, T=pl["T"])
            if not check:
                break
            if bool(ok.all()):
                rows_np = rows.cpu().numpy()
                pl["rows_np"] = rows_np
                if auto:
                    # the true step need: later calls run a tight cap
                    pl["cap"] = -(-max(int(rows_np.max()), UNROLL)
                                  // UNROLL) * UNROLL
                break
            cap *= 2
            if auto:
                pl["cap"] = cap
        return val, xch, nib, cap

    def decode_to_adjacency_device(self, num_lanes: int = 2048):
        """End-to-end merged-emit decode: the kernel and the post-pass.
        Returns (succs2d [cap, L] int32, starts_flat [n] int32, degs [n]
        int32) on the device: node x's successors are
        succs2d.flatten()[starts_flat[x] + k*L] for k < degs[x]
        (emit_post.to_dense_csr converts).

        The first call decodes on stream-balanced bounds and caches the
        degrees; the next rebalances onto reference-safe, element-balanced
        bounds and refines them once on the observed rows; the plan is
        then verified, and later calls run the kernel (mark_deg mode) and
        the cached-layout post-pass with no host synchronisation."""
        if self.window > MAX_WINDOW:
            raise NotImplementedError(
                f"window {self.window} > {MAX_WINDOW}: the merged-emit "
                "kernel serves windows up to 16; larger windows need the "
                "sort-path reconstruction (ROADMAP module item 4, not "
                "ported)")
        pl0 = self._plans.setdefault(("emit", num_lanes), {})
        mc0 = pl0.get("post_meta") or {}
        if pl0.get("verified") and "fx_offs" in mc0:
            val, xch, _, _, _, _ = decode_emit(
                self.tables, pl0["regs"], pl0["ptrs"], self.window,
                self.min_interval, pl0["cap"], T=pl0["T"], mark_deg=True)
            return emit_post.post_steady(
                val, xch, *(mc0[k] for k in emit_post.STEADY_KEYS))
        val, xch, nib, _ = self.decode_emit_raw(
            num_lanes, check=not pl0.get("verified"))
        pl = self._plans[("emit", num_lanes)]
        if "lane_of" not in pl:
            lens = pl["ends_np"] - pl["starts_np"]
            pl["lane_of"] = np.repeat(np.arange(len(lens), dtype=np.int32),
                                      lens)
        succs2d, starts_flat, degs, _ = emit_post.postprocess(
            val, xch, nib, pl["lane_of"], pl["starts_np"], self.num_nodes,
            meta_cache=pl.setdefault("post_meta", {}))
        if "degs_np" not in pl and "bounds" not in pl:
            # cache degrees and rebalance the lane split once, onto
            # element-balanced bounds at reference-safe nodes (no chain
            # crosses a boundary: no cross-lane dirty nodes, no halo)
            pl["degs_np"] = degs.cpu().numpy()
            pl["safe_np"] = self._safe_boundaries()
            for k in ("regs", "cap", "post_meta", "lane_of"):
                pl.pop(k, None)
        elif "node_work" not in pl and "rows_np" in pl:
            # one refinement: the split modelled steps as elements +
            # 2*nodes; spread each lane's observed rows over its nodes
            # and re-split on that
            starts_np, ends_np = pl["starts_np"], pl["ends_np"]
            degs_np = pl["degs_np"].astype(np.float64)
            offs = np.concatenate([[0], np.cumsum(degs_np)])
            nw = degs_np.copy()
            rows = pl["rows_np"].astype(np.float64)
            for li in range(len(starts_np)):
                a, b = int(starts_np[li]), int(ends_np[li])
                if b > a:
                    extra = max(rows[li] - (offs[b] - offs[a]), 0.0)
                    nw[a:b] += extra / (b - a)
            pl["node_work"] = nw
            for k in ("regs", "cap", "post_meta", "lane_of", "bounds",
                      "rows_np"):
                pl.pop(k, None)
            return self.decode_to_adjacency_device(num_lanes)
        elif not pl.get("verified"):
            pl["verified"] = True
        return succs2d, starts_flat, degs
