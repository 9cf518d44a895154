"""Host orchestration of the lane-parallel decoders: partition a graph's
nodes into contiguous blocks (one per lane), enter the stream at each
block's phase, seed the outdegree rings, and run the token-decode kernel
(decode_tokens; in aux mode with the device sort-path reconstruction,
decode_to_csr_device) or the merged-emit kernel and its post-pass
(decode_to_adjacency_device, which falls back to the sort path on what
the merged-emit kernel cannot serve).

The device-parallel replacement for the serial sequential scan
(reference: src/bvgraph/sequential.rs + src/ans/decoder.rs): same stream,
same phases, decoded by thousands of lanes at once. Lane pointers are
absolute 64-bit word indices, so a lane may span any part of the stream.
"""

from __future__ import annotations

import ctypes
import functools
import logging

import numpy as np
import torch

from ..bvgraph.random_access import ANSBvGraph
from ..utils import native, trace
from . import emit_cuda, emit_post, fixup_cuda
from .cuda_build import KernelError
from .decode_cuda import decode_blocks
from .decode_torch import (UNROLL, build_decoder_tables_np,
                           fetch_block_tokens, resolve_device, round_cap,
                           seed_rings, tables_from_numpy)
from .emit_cuda import decode_emit
from .emit_torch import MAX_WINDOW, emit_init_regs
from .reconstruct_device import (LayoutTooLarge, check_flat, parse_stats,
                                 reconstruct_device)

log = logging.getLogger(__name__)


class EmitPlanUnsupported(RuntimeError):
    """The merged-emit kernel cannot serve this plan on this device."""


def _device_fault(e: BaseException) -> bool:
    """A kernel's build or launch failure, or an error of the device
    itself: never a reason to fall back to another path."""
    faults = (KernelError, torch.OutOfMemoryError,
              getattr(torch, "AcceleratorError", KernelError))
    return isinstance(e, faults)


def _grow_cap(run, ok: torch.Tensor, cap: int, bound: int,
              what: str) -> int:
    """The cap at which every lane of a doubling loop finishes, given the
    ok flags [L] of a launch of all lanes at `cap`. Relaunches only the
    lanes that did not finish, run(idx, cap) -> their ok flags, at twice
    the cap each time, so that the memory of a growing launch follows the
    unfinished lanes. Raises RuntimeError naming the first such lane once
    the cap has reached `bound`, which no valid lane can exceed. A
    `cap.grow` stage; each nonzero and mask counts a host
    synchronisation."""
    with trace.stage("cap.grow", what=what, cap=cap) as grow:
        trace.count("host_syncs")
        idx = torch.nonzero(~ok).flatten()
        while idx.numel():
            if cap >= bound:
                raise RuntimeError(
                    f"{what}: lane {int(idx[0])} has not finished at cap "
                    f"{cap}, past the {bound} steps that any lane of this "
                    "graph can need; the artifact is corrupt")
            cap *= 2
            trace.count("host_syncs")
            idx = idx[~run(idx, cap)]
        grow.set(to=cap)
    return cap


def _pad_lanes(starts, ends, hi: int, pad_to: int):
    """Lane bounds as int32, padded with empty lanes (start == end == hi)
    up to a multiple of pad_to."""
    pad = -len(starts) % pad_to
    if pad:
        starts = np.concatenate([starts, np.full(pad, hi, starts.dtype)])
        ends = np.concatenate([ends, np.full(pad, hi, ends.dtype)])
    return starts.astype(np.int32), ends.astype(np.int32)


def _native_split(fn: str, cost, halo, safe, num_lanes: int, *args,
                  cuts=()):
    """Runs the native split fn over cost [n] and halo [n + 1] (float64)
    and safe [n] (bool, or None: every node safe), then the pointers of
    `cuts` ((array [n] or None, the numpy dtype and the ctypes type fn
    takes) each), with its own args after the lane count: the
    num_lanes + 1 lane bounds (int64), or None where it refuses."""
    cost = np.ascontiguousarray(cost, np.float64)
    halo = np.ascontiguousarray(halo, np.float64)
    n = len(cost)
    if len(halo) != n + 1 or num_lanes < 1:
        raise ValueError(f"{fn}: {n} costs need {n + 1} halo sums "
                         f"(got {len(halo)}) and at least one lane")
    safe_p = None
    if safe is not None:
        safe = np.ascontiguousarray(safe, np.uint8)
        if len(safe) != n:
            raise ValueError(f"{fn}: {n} costs need {n} safe flags "
                             f"(got {len(safe)})")
        safe_p = native.as_ptr(safe, ctypes.c_uint8)
    cut_p = []
    cuts = [(None if arr is None else np.ascontiguousarray(arr, dtype), ctype)
            for arr, dtype, ctype in cuts]
    for arr, ctype in cuts:
        if arr is not None and len(arr) != n:
            raise ValueError(f"{fn}: {n} costs need {n} entries a node "
                             f"(got {len(arr)})")
        cut_p.append(None if arr is None else native.as_ptr(arr, ctype))
    bounds = np.empty(num_lanes + 1, np.int64)
    fits = getattr(native.get_lib(), fn)(
        native.as_ptr(cost, ctypes.c_double),
        native.as_ptr(halo, ctypes.c_double), safe_p, *cut_p, n, num_lanes,
        *args, native.as_ptr(bounds, ctypes.c_int64))
    return bounds if fits else None


def emit_split(cost: np.ndarray, halo: np.ndarray, safe, num_lanes: int,
               force_unsafe: bool, target: float, forced=None):
    """The merged-emit planner's greedy split of n nodes into at most
    num_lanes lanes at `target`, in the native runtime (wgt_emit_split):
    walking the nodes in order, a lane closes before node x when its cost
    sum would pass target at a safe node, or 1.5 * target anywhere when
    force_unsafe, or when forced[x] (x > 0), and the next lane's sum
    starts at halo[x]. cost [n] and halo [n + 1] are float64, safe [n]
    bool or None (every node safe), forced [n] bool or None (none: the
    encode-block starts of a block-parallel artifact). Returns the
    num_lanes + 1 lane bounds (int64, the unused lanes empty at n), or
    None when the nodes need more lanes at this target."""
    return _native_split("wgt_emit_split", cost, halo, safe, num_lanes,
                         int(bool(force_unsafe)), float(target),
                         cuts=((forced, np.uint8, ctypes.c_uint8),))


# a lane cut inside a safe gap closes at the fewest crossings among the
# bounds that fill it to this share of the target (emit_split_last)
CUT_FILL = 0.85


def emit_split_last(cost: np.ndarray, halo: np.ndarray, safe,
                    num_lanes: int, target: float, cross=None, gap=None,
                    forced=None):
    """The split of plans that cut at safe nodes, in the native runtime
    (wgt_emit_split_last): a lane that starts at a has sum halo[a] +
    (P[b] - P[a]), P = [0, cumsum(cost)] in float64, and ends at the
    largest safe b > a at which that sum stays within target, or at n.
    No lane passes target, so bisected on target (min_max_split) the
    longest lane is the least of any split at safe nodes. Inputs as
    emit_split's.

    With cross (int32 [n], chain_crossings) and gap (float64 [n],
    safe_gaps over the same cost and safe), a safe gap longer than the
    target is cut inside: where the node that passes the target lies in
    such a gap and the last safe node fills the lane below CUT_FILL of
    the target (or there is none), the lane ends at the unsafe bound
    before that node that the fewest reference chains cross, among those
    that fill it to CUT_FILL of the target (the last on ties; the fullest
    where none does). Where every safe gap fits the target the bounds are
    those without them, so a plan whose gaps all fit a mean lane (the
    bisection's least target) keeps them at every target it tries.

    With forced (bool [n], as emit_split's), a lane also closes at the
    first forced node it reaches within the target.

    Returns the num_lanes + 1 lane bounds (int64, the unused lanes empty
    at n), or None when a lane has no such b or the nodes need more lanes
    at this target."""
    if (cross is None) != (gap is None) or (cross is not None
                                            and safe is None):
        raise ValueError("emit_split_last: cross and gap go together, "
                         "with a safe mask")
    return _native_split("wgt_emit_split_last", cost, halo, safe,
                         num_lanes, float(target), float(CUT_FILL),
                         cuts=((forced, np.uint8, ctypes.c_uint8),
                               (cross, np.int32, ctypes.c_int32),
                               (gap, np.float64, ctypes.c_double)))


def safe_gaps(cost: np.ndarray, safe: np.ndarray) -> np.ndarray:
    """gap [n] float64: the cost of the safe gap that holds each node, the
    nodes from the last safe node at or before it (node 0 counts as safe)
    to the next one (or n), which a split at safe nodes alone must keep in
    one lane."""
    P = np.concatenate([[0.0], np.cumsum(np.asarray(cost, np.float64))])
    n = len(P) - 1
    s = np.flatnonzero(np.asarray(safe, bool)[1:]) + 1
    s = np.concatenate([[0], s, [n]])
    g = np.searchsorted(s, np.arange(n), side="right") - 1
    return P[s[g + 1]] - P[s[g]]


def min_max_split(split, lo: float, hi: float, steps: int = 40):
    """(target, bounds): the least target at which split(target) gives
    bounds, found by bisection between lo and hi to (hi - lo) / 2**steps,
    and split(target). Where split gives none at hi (a gap between safe
    nodes longer than hi), hi doubles first, lo taking its value."""
    while split(hi) is None:
        if not hi < np.inf:
            raise ValueError("min_max_split: no target gives bounds")
        lo, hi = hi, max(2 * hi, 1.0)
    for _ in range(steps):
        mid = (lo + hi) / 2
        if split(mid) is None:
            lo = mid
        else:
            hi = mid
    return hi, split(hi)


def lane_costs(cost: np.ndarray, halo: np.ndarray, bounds) -> np.ndarray:
    """Each lane's sum in the splits' cost model, halo[a] + (P[b] - P[a])
    for a lane [a, b), and 0 for an empty lane."""
    P = np.concatenate([[0.0], np.cumsum(np.asarray(cost, np.float64))])
    a, b = np.asarray(bounds[:-1]), np.asarray(bounds[1:])
    return np.where(b > a, np.asarray(halo, np.float64)[a] + (P[b] - P[a]),
                    0.0)


def node_rows(mrow: np.ndarray, starts: np.ndarray, ends: np.ndarray,
              rows: np.ndarray) -> np.ndarray:
    """Each node's rows in a merged-emit decode of lanes [starts, ends),
    from mrow [n], the row of each node's marker: the rows from its
    marker to the next node's in its lane, or to the rows its lane used
    (rows [L]) after the lane's last node; a lane's first node also takes
    the rows before its marker (the lane's lead-in, and its halo's rows
    where it has one). Each lane's nodes sum to its rows."""
    mrow = np.asarray(mrow, np.float64)
    starts, ends = np.asarray(starts), np.asarray(ends)
    used = ends > starts
    nxt = np.empty_like(mrow)
    nxt[:-1] = mrow[1:]
    nxt[ends[used] - 1] = np.asarray(rows, np.float64)[used]
    nw = nxt - mrow
    nw[starts[used]] += mrow[starts[used]]
    return nw


def spread_rows(degs: np.ndarray, starts: np.ndarray, ends: np.ndarray,
                rows: np.ndarray) -> np.ndarray:
    """Each node's rows with each lane's rows spread evenly: its elements
    (degs [n]), plus the rows its lane of [starts, ends) used (rows [L])
    past the lane's elements, shared alike by the lane's nodes."""
    degs = np.asarray(degs, np.float64)
    offs = np.concatenate([[0.0], np.cumsum(degs)])
    starts, ends = np.asarray(starts), np.asarray(ends)
    used = ends > starts
    a, b = starts[used], ends[used]
    extra = np.maximum(np.asarray(rows, np.float64)[used]
                       - (offs[b] - offs[a]), 0.0) / (b - a)
    # the nodes of the used lanes, lane by lane
    length = b - a
    idx = (np.arange(length.sum()) + np.repeat(a - (np.cumsum(length)
                                                    - length), length))
    nw = degs.copy()
    nw[idx] += np.repeat(extra, length)
    return nw


def safe_nodes(parent: np.ndarray, has_ref: np.ndarray) -> np.ndarray:
    """safe[x] is True iff no reference chain crosses a lane boundary
    placed at x. A chain that crosses x has an edge from a node y >= x to
    its parent below x (parents precede children), so safe[x] is: no
    node y >= x with a reference has parent[y] < x, a suffix minimum of
    where(has_ref, parent, y), exact at any chain depth."""
    n = len(parent)
    link = np.where(has_ref, parent, np.arange(n, dtype=np.int64))
    sm = np.minimum.accumulate(link[::-1])[::-1]
    safe = np.ones(n, bool)
    safe[1:] = sm[1:] >= np.arange(1, n)
    return safe


def chain_crossings(parent: np.ndarray, has_ref: np.ndarray) -> np.ndarray:
    """cross [n] int32: the reference links that a lane boundary placed at
    x cuts, the nodes y >= x with a reference whose parent is below x
    (parents precede children); safe_nodes is cross == 0."""
    n = len(parent)
    y = np.flatnonzero(has_ref)
    d = (np.bincount(np.asarray(parent, np.int64)[y] + 1, minlength=n + 1)
         - np.bincount(y + 1, minlength=n + 1))
    return np.cumsum(d[:n]).astype(np.int32)


def unsafe_cuts(bounds, safe) -> int:
    """The distinct lane bounds strictly inside (0, n) that are not at a
    safe node (0 without a safe mask)."""
    if safe is None:
        return 0
    b = np.unique(np.asarray(bounds, np.int64))
    b = b[(b > 0) & (b < len(safe))]
    return int((~np.asarray(safe, bool)[b]).sum())


def _all_done(ok: torch.Tensor, cap: int, what: str):
    """The check of the full launch at the grown cap."""
    if not bool(trace.fetch(ok.all())):
        raise RuntimeError(f"{what}: lanes that finished alone at cap {cap} "
                           "did not finish in the full launch")


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

    def _block_bounds(self, num_lanes: int, lo: int = 0, hi: int | None = None,
                      pad_to: int = 1):
        """Block boundaries over nodes [lo, hi) balanced by per-node STREAM
        spans (pointers are descending in node order), so lanes carry
        similar token loads instead of similar node counts.

        On block-parallel-encoded (prelude v2) files, every encode-block
        start inside the range is unioned into the boundary set — a decode
        lane must never cross an encode-block boundary (the rANS state
        resets there). The result is padded with empty lanes (start ==
        end == hi) up to a multiple of `pad_to`, so that callers that split
        the lanes over devices get equal groups."""
        n = self.num_nodes
        hi = n if hi is None else hi
        span = hi - lo
        if self.phase_step > 1:
            return self._sampled_bounds(num_lanes, lo, hi, pad_to)
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
                return _pad_lanes(starts, ends, hi, pad_to)
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
        return _pad_lanes(starts, ends, hi, pad_to)

    def _sampled_bounds(self, num_lanes: int, lo: int, hi: int,
                        pad_to: int = 1):
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
        return _pad_lanes(starts, ends, hi, pad_to)

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

    def plan(self, num_lanes: int, lo: int = 0, hi: int | None = None,
             pad_to: int = 1, seed=None) -> dict:
        """Cached decode plan of nodes [lo, hi) (the whole graph by
        default) over num_lanes lanes, padded with empty lanes to a
        multiple of pad_to: lane bounds, entry phases and the seeded
        outdegree rings, on the device. The plan also remembers a tight
        token cap once a decode has observed the true counts. seed(states,
        ptrs, starts, window) seeds the rings in place of seed_rings on
        the decoder's device (the sharded decoder splits it over its
        devices)."""
        n = self.num_nodes
        hi = n if hi is None else hi
        key = (num_lanes if (lo, hi, pad_to) == (0, n, 1)
               else (num_lanes, lo, hi, pad_to))
        pl = self._plans.get(key)
        if pl is not None:
            return pl
        starts, ends = self._block_bounds(num_lanes, lo, hi, pad_to)
        W, dev = self.window, self.device
        starts_d = trace.upload(starts, dev)
        if W > 0 and self.phase_step > 1:
            # sampled artifacts have no per-node phases to seed from: get
            # the pre-nodes' outdegrees from the native skip-decoder
            ring = trace.upload(self._rings_via_native(starts, W), dev)
        elif W > 0:
            # phases of the `window` nodes before each block (clamped to 0;
            # entries before node 0 are masked inside seed_rings)
            pre = starts[:, None].astype(np.int64) - W + np.arange(W)[None, :]
            pre_cl = np.clip(pre, 0, n - 1)
            ring = (seed or functools.partial(seed_rings, self.tables))(
                trace.upload(self.states_np[pre_cl].astype(np.int64), dev),
                trace.upload(self.pointers[pre_cl], dev), starts_d, W)
        else:
            ring = torch.zeros((len(starts), 1), dtype=torch.int32, device=dev)

        if self.phase_step == 1:
            last = np.minimum(starts, n - 1)
            entry_states = self.states_np[last]
            entry_ptrs = self.pointers[last]
        else:
            # a padding lane's start need not be an entry point
            entry_states, entry_ptrs = self._entry_lookup(
                np.where(starts < ends, starts, n))
        # padding lanes (start == end) never touch the stream
        entry_ptrs = np.where(starts < ends, entry_ptrs, 0)
        # ~2.05 tokens per arc + 3 per node is a generous upper estimate
        # for BvGraph token streams, here scaled to the range's share of
        # the nodes; overflow doubles and retries.
        est = ((2 * self.num_arcs + 3 * n) * (hi - lo)
               // max(n * len(starts), 1))
        pl = dict(
            starts=starts_d, ends=trace.upload(ends, dev), ring=ring,
            states=trace.upload(entry_states.astype(np.int64), dev),
            ptrs=trace.upload(entry_ptrs.astype(np.int64), dev),
            starts_np=starts, ends_np=ends,
            cap=round_cap(self.params, max(64, int(est * 1.3))))
        self._plans[key] = pl
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

    def step_bound(self, mode: str = "token") -> int:
        """The most steps a valid lane of this graph can take, in `mode`
        "token", "aux" or "emit"; the cap-doubling loops raise past it.
        No lane decodes more tokens than the whole graph holds: a node
        has at most 5 + d_ref + 3d tokens (outdegree, reference, block
        count, at most d_ref + 1 blocks, interval count, two tokens an
        interval and one a residual, at most d of each), and a node is
        referenced by at most `window` later ones, so the graph holds at
        most 5n + (window + 3)m tokens. Aux mode adds one summary step a
        node. A merged-emit step decodes a token or emits a row (an
        element or a node's marker); its bound is twice that count."""
        n, m = self.num_nodes, self.num_arcs
        tokens = 5 * n + (self.window + 3) * m
        if mode == "aux":
            return tokens + n
        if mode == "emit":
            return 2 * (tokens + m + n)
        return tokens

    def _launch_blocks(self, lanes, cap: int, idx=None,
                       emit_aux: bool = False):
        """decode_blocks on the decoder's device over a plan's lanes
        (states, ptrs, starts, ends, ring), or over the lanes idx of
        them: the default `launch` of decode_raw."""
        if idx is not None:
            lanes = [a[idx] for a in lanes]
        return decode_blocks(self.tables, *lanes, self.window,
                             self.min_interval, cap, emit_aux=emit_aux)

    def decode_raw(self, num_lanes: int = 256, cap: int | None = None,
                   emit_aux: bool = False, lo: int = 0,
                   hi: int | None = None, pad_to: int = 1, seed=None,
                   launch=None):
        """Lane-parallel token decode of nodes [lo, hi) (the whole graph
        by default); returns the raw device output (out, counts, cap) of
        decode_blocks (layout: ops/decode_torch.py). Reads the ok flags
        back; when a lane did not fit, doubles the cap for the unfinished
        lanes alone (raising once it passes step_bound), then decodes
        every lane at that cap. emit_aux=True decodes in aux mode; its cap
        covers tokens plus one summary step per node and is kept in the
        plan apart from the token cap; its layout must stay under the
        int32 flat-index limit (reconstruct_device.check_flat raises
        ValueError naming it). pad_to and seed go to plan();
        launch(lanes, cap, idx=None, emit_aux=False) -> (out, counts, ok)
        runs the kernel in place of _launch_blocks (the sharded decoder
        splits the lanes over its devices)."""
        pl = self.plan(num_lanes, lo, hi, pad_to, seed)
        launch = launch or self._launch_blocks
        auto = cap is None
        capkey = "cap_aux" if emit_aux else "cap"
        if auto and capkey not in pl:
            nodes_max = int(np.max(pl["ends_np"] - pl["starts_np"]))
            pl["cap_aux"] = round_cap(self.params, pl["cap"] + nodes_max)
        cap = pl[capkey] if auto else round_cap(self.params, cap)
        lanes = [pl[k] for k in ("states", "ptrs", "starts", "ends", "ring")]

        def check(c):
            # the sort path reads the aux layout with int32 flat indices
            if emit_aux:
                check_flat("aux-mode decode [3cap + cap//8, L]",
                           (3 * c + c // UNROLL) * len(pl["starts_np"]),
                           pl.setdefault("flat_sizes", {}))

        check(cap)
        out, counts, ok = launch(lanes, cap, emit_aux=emit_aux)
        if not bool(trace.fetch(ok.all())):
            cap = _grow_cap(
                lambda idx, c: launch(lanes, c, idx, emit_aux=emit_aux)[2],
                ok, cap, self.step_bound("aux" if emit_aux else "token"),
                "decode_blocks")
            check(cap)
            out, counts, ok = launch(lanes, cap, emit_aux=emit_aux)
            _all_done(ok, cap, "decode_blocks")
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
            steps = trace.fetch(counts) + (pl["ends_np"] - pl["starts_np"])
            tight = round_cap(self.params, int(steps.max()))
            pl["cap_aux"] = min(pl["cap_aux"], tight)
            return pl["cap_aux"]
        tight = round_cap(self.params, int(trace.fetch(counts.max())))
        pl["cap"] = min(pl["cap"], tight)
        return pl["cap"]

    def decode_tokens(self, num_lanes: int = 256, cap: int | None = None,
                      lo: int = 0, hi: int | None = None):
        """Decodes every (component, value) token of nodes [lo, hi) (the
        whole graph by default), lane-parallel over `num_lanes` contiguous
        node blocks. Returns (values u32, comps u8) concatenated in forward
        node order (host arrays)."""
        out, counts, cap = self.decode_raw(num_lanes, cap, lo=lo, hi=hi)
        return fetch_block_tokens(out, counts, cap)

    def decode_to_csr_device(self, num_lanes: int = 2048,
                             cap: int | None = None):
        """Full decode on the device by the sort path: the aux-mode token
        decode and the device reconstruction, with no host copy of the
        tokens. Returns (offsets [n+1] int32, succs [Epad] int32, E) on
        the decoder's device; the successor lists are succs[:E]. The
        first call tightens the aux cap with one observation decode; the
        plan caches the reconstruction's meta vector, so later calls
        fetch it only to verify it."""
        pl = self.plan(num_lanes)
        if cap is None and not pl.get("tight_aux"):
            self.tighten_cap(num_lanes, emit_aux=True)
            pl["tight_aux"] = True
        out, _, cap = self.decode_raw(num_lanes, cap, emit_aux=True)
        return reconstruct_device(out, self.num_nodes, self.num_arcs, cap,
                                  pl.setdefault("recon_meta", {}))

    # ------------------------------------------------------------------
    # Merged-emit pipeline: decode and reconstruction in one kernel
    # (ops/emit_cuda.py), finished by the post-pass (ops/emit_post.py).
    # ------------------------------------------------------------------

    # output-ring rows of the merged-emit kernel before degrees are known:
    # a copy source older than this many rows makes the node dirty (the
    # post-pass resolves it)
    EMIT_RING_T = 512
    # up to this window a lane may also be cut at an unsafe node (the
    # greedy split's forced cut; a 4*window halo re-decodes its chains);
    # past it every cut is at a reference-safe node, or, on a plan whose
    # longest safe gap passes CUT_GAP_LANES mean lanes (an artifact without
    # safe breaks), also inside a safe gap longer than the target, where
    # the fixup finishes the crossing chains. Safe breaks keep the gaps
    # below it: cnr-2000's every 128 nodes at 1024 lanes, 0.72 of a mean
    # lane; without them its longest gap holds 99 mean lanes.
    FORCED_CUT_WINDOW = 12
    CUT_GAP_LANES = 4

    def _split_rule(self) -> str:
        """The merged-emit split's rule once degrees are known: "greedy"
        (emit_split with its forced cut) up to FORCED_CUT_WINDOW, else
        "last_safe" (emit_split_last, with the reference chains' crossings
        on plans that cut inside safe gaps, _cut_gaps, so that a gap
        longer than the target is cut inside). The refinement follows it: a
        last_safe split holds every lane within its target, so it prices
        each node by its own rows (node_rows); a greedy split spreads each
        lane's rows evenly over its nodes (spread_rows), whose plan the
        card decodes faster on cnr-2000 at the same longest lane."""
        return "last_safe" if self.window > self.FORCED_CUT_WINDOW \
            else "greedy"

    def _encode_block_starts(self):
        """The encode-block starts of a block-parallel artifact (int64,
        ascending, node 0 first), where the rANS state resets and a lane
        must start; None on a serial artifact."""
        blocks = self.graph.prelude.blocks
        if blocks is None:
            return None
        bs = np.asarray(blocks[0], np.int64)
        return np.unique(np.concatenate([[0], bs[bs < self.num_nodes]]))

    def _block_floor(self, nodes) -> np.ndarray:
        """The encode-block start at or before each node (int64; 0 on a
        serial artifact): a lane's halo reaches no further back."""
        nodes = np.asarray(nodes, np.int64)
        bs = self._encode_block_starts()
        if bs is None:
            return np.zeros_like(nodes)
        return bs[np.searchsorted(bs, nodes, side="right") - 1]

    def _emit_bounds(self, num_lanes: int, key=None):
        """Lane bounds for the merged-emit kernel. First call: the
        stream-balanced block bounds. Once per-node degrees are known
        (cached from a decode): a minmax split, the bisection of the
        split's target over the kernel's step estimate (elements +
        2*nodes, or the observed node_work) under `_split_rule`. On a
        block-parallel artifact every encode-block start is a forced bound
        (no lane crosses one: the rANS state resets there), so the one
        bisected target gives each block lanes by its steps, at least one;
        the lanes stay within num_lanes where the blocks are fewer. On a
        phase-sampled artifact each bound then moves up to the next entry
        point (a sampled node or a block start)."""
        pl = self._plans.setdefault(key or ("emit", num_lanes), {})
        if "bounds" in pl:
            return pl["bounds"]
        n = self.num_nodes
        degs = pl.get("degs_np")
        if degs is None:
            starts, ends = self._block_bounds(num_lanes)
            if (self.window > self.FORCED_CUT_WINDOW and self.phase_step == 1
                    and self.graph.prelude.blocks is None):
                # deep unbounded reference chains: even the first decode
                # splits at reference-safe nodes (a 4*window halo cannot
                # cover them), each start moved back to its safe node;
                # on a plan that cuts inside safe gaps (_cut_gaps), starts
                # inside a gap longer than a mean lane stay where they are
                # (the fixup finishes the chains they cut)
                long_gap = (self._cut_gaps(pl, num_lanes)
                            if "safe_np" not in pl else None)
                safe_nodes = np.nonzero(pl["safe_np"])[0]
                idx = np.searchsorted(safe_nodes, starts, side="right") - 1
                snapped = safe_nodes[np.maximum(idx, 0)]
                snapped[0] = 0
                if long_gap is not None:
                    inside = long_gap[np.minimum(starts, n - 1)]
                    snapped = np.where(inside, starts, snapped)
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
        offs = np.concatenate([[0], np.cumsum(degs, dtype=np.int64)])
        nw = pl.get("node_work")
        if nw is not None:
            work = np.concatenate([[0.0], np.cumsum(nw)])
        else:
            work = offs + 2.0 * np.arange(n + 1)
        # halo re-decode cost per boundary, clipped at its encode block
        H = self._halo(pl)
        x = np.arange(n + 1)
        halo_el = offs - offs[np.maximum(x - H, self._block_floor(x))]
        cost = np.diff(work)
        halo = halo_el.astype(np.float64)
        safe = pl.get("safe_np")
        bstarts = self._encode_block_starts()
        lanes, forced, gap_safe = num_lanes, {}, safe
        if bstarts is not None:
            at = np.zeros(n, bool)
            at[bstarts] = True
            lanes, forced = max(num_lanes, len(bstarts)), dict(forced=at)
            if safe is not None:
                gap_safe = safe | at
        rule = self._split_rule()
        if rule == "last_safe":
            cross = pl.get("cross_np") if safe is not None else None
            # a safe gap longer than the target is cut inside where the
            # reference chains are known
            cuts = ({} if cross is None else
                    dict(cross=cross, gap=safe_gaps(cost, gap_safe)))
            split = functools.partial(emit_split_last, cost, halo, safe,
                                      lanes, **cuts, **forced)
        else:
            split = functools.partial(emit_split, cost, halo, safe,
                                      lanes, True, **forced)
        lo = float(work[-1]) / lanes
        hi = lo * 8 + float(np.max(degs, initial=0) + halo_el.max()) + 4096
        with trace.stage("emit.split", lanes=num_lanes,
                         model="rows" if nw is not None else "elements",
                         rule=rule) as st:
            target, bounds = min_max_split(split, lo, hi)
            lc = lane_costs(cost, halo, bounds)
            if self.phase_step > 1:
                # a lane must start at an entry point: a sampled phase
                ent = self._entries()[0]
                bounds = ent[np.minimum(np.searchsorted(ent, bounds),
                                        len(ent) - 1)]
                bounds[0], bounds[-1] = 0, n
                bounds = np.maximum.accumulate(bounds)
            st.set(target=target, max_cost=float(lc.max()),
                   mean_cost=float(lc.mean()),
                   unsafe_cuts=unsafe_cuts(bounds, safe),
                   block_starts=(0 if bstarts is None else
                                 int(np.isin(bstarts, bounds).sum())))
        starts = bounds[:-1].copy()
        ends = bounds[1:].copy()
        pl["bounds"] = (starts, ends)
        return starts, ends

    def _cut_gaps(self, pl: dict, num_lanes: int):
        """The safe nodes of a plan past FORCED_CUT_WINDOW ("safe_np"),
        and whether its lanes are cut inside safe gaps: where its longest
        safe gap passes CUT_GAP_LANES mean lanes (elements + 2 a node), the
        reference chains' crossings ("cross_np", by which the split cuts
        the gaps longer than its target), and returned, the nodes inside
        gaps longer than a mean lane (the first call cuts inside those);
        else "cross_np" and the return are None, and every bound is a
        safe node."""
        cross, degs = self._reference_chains()
        safe = cross == 0
        cost = degs + 2.0
        gap = safe_gaps(cost, safe)
        mean = cost.sum() / num_lanes
        cut = bool(gap.max(initial=0) > self.CUT_GAP_LANES * mean)
        pl.update(safe_np=safe, cross_np=cross if cut else None)
        return gap > mean if cut else None

    def _halo(self, pl: dict) -> int:
        """The nodes a lane of plan pl decodes ahead of its start, so that
        the reference chains of its first real nodes resolve in the lane
        (halo rows feed the ring but are never marked): 4*window; none on
        lanes split at reference-safe nodes and on sampled artifacts (a
        lane starts at an entry). On a block-parallel artifact each lane's
        halo stops at its encode block's start (_block_floor), where the
        rANS state resets: a lane that starts there has none; and its
        first call has none (its lanes, the stream-balanced bounds with
        the block starts added, outgrow their estimated cap even without
        one: cnr-2000's longest at 512 blocks takes 1.9x, a halo makes it
        2.1x and doubles the cap loop's memory)."""
        if (self.phase_step > 1 or self.window == 0
                or pl.get("safe_np") is not None
                or (self.graph.prelude.blocks is not None
                    and "degs_np" not in pl)):
            return 0
        return 4 * self.window

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
        starts = np.where(rstarts >= ends, rstarts,
                          np.maximum(rstarts - self._halo(pl),
                                     self._block_floor(rstarts)))
        if W > 0 and self.phase_step > 1:
            ring = trace.upload(self._rings_via_native(starts, W), dev)
        elif W > 0:
            pre = starts[:, None] - W + np.arange(W)[None, :]
            pre_cl = np.clip(pre, 0, n - 1)
            ring = seed_rings(
                self.tables,
                trace.upload(self.states_np[pre_cl].astype(np.int64), dev),
                trace.upload(self.pointers[pre_cl], dev),
                trace.upload(starts, dev), W)
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
        pl.update(regs=regs, ptrs=trace.upload(entry_ptrs, dev), T=T,
                  starts_np=rstarts, ends_np=ends, hstarts_np=starts,
                  cap=-(-est // UNROLL) * UNROLL)
        return pl

    def _reference_parents(self):
        """(parent [n] int64, has_ref [n] bool, the lanes' token counts,
        degs [n] int64): each node's reference target and outdegree, from
        one aux-mode token decode at 2048 lanes (plan time only)."""
        out, counts, cap = self.decode_raw(2048, emit_aux=True)
        st = parse_stats(out, self.num_nodes, cap)
        return (trace.fetch(st["parent"]).astype(np.int64),
                trace.fetch(st["depth"]) > 0, counts,
                trace.fetch(st["d"]).astype(np.int64))

    def _safe_boundaries(self) -> np.ndarray:
        """safe[x] is True iff no reference chain crosses a lane boundary
        placed at x (safe_nodes over _reference_parents)."""
        parent, has_ref = self._reference_parents()[:2]
        return safe_nodes(parent, has_ref)

    def _reference_chains(self):
        """(cross [n] int32, degs [n] int64): the reference links that a
        lane boundary at x cuts (chain_crossings; x is safe where it is 0)
        and each node's outdegree, from _reference_parents."""
        parent, has_ref, _, degs = self._reference_parents()
        return chain_crossings(parent, has_ref), degs

    def _emit_servable(self, T: int) -> bool:
        """Whether the merged-emit kernel can run a plan with a T-row ring
        on the decoder's device: on CUDA one lane's ring, queues and
        window rings must fit a block's shared memory."""
        if self.device.type != "cuda":
            return True
        return emit_cuda.ring_fits(self.window, T)

    def _launch_emit(self, regs, ptrs, cap: int, T: int, idx=None,
                     mark_deg: bool = False):
        """decode_emit on the decoder's device over a plan's register
        file and entry pointers, or over the lanes idx of them: the
        default `launch` of the merged-emit path."""
        if idx is not None:
            regs, ptrs = regs[:, idx], ptrs[idx]
        return decode_emit(self.tables, regs, ptrs, self.window,
                           self.min_interval, cap, T=T, mark_deg=mark_deg)

    @staticmethod
    def _check_emit_layout(pl: dict, cap: int):
        """The post-pass addresses the [cap, L] channels with int32 flat
        indices (starts_flat) and packs a marker's row as row << 6."""
        sizes = pl.setdefault("flat_sizes", {})
        check_flat("merged-emit [cap, L]", cap * pl["ptrs"].shape[0], sizes)
        check_flat("merged-emit marker rows [cap << 6]", cap << 6, sizes)

    def decode_emit_raw(self, num_lanes: int = 2048, cap: int | None = None,
                        check: bool = True, launch=None):
        """Merged-emit kernel decode: returns (val, xch, nib, cap), the
        device channels of ops/emit_post.py. check=True reads the lanes'
        done flags back; when a lane did not finish, doubles the cap for
        the unfinished lanes alone (raising once it passes step_bound) and
        decodes every lane at that cap; it then keeps the observed rows
        and the tight cap in the plan; check=False issues no host
        synchronisation. Raises EmitPlanUnsupported for a plan the kernel
        cannot serve, and ValueError (check_flat) for channels past the
        post-pass's int32 flat indices. launch(regs, ptrs, cap, T, idx=None, mark_deg=False)
        returns decode_emit's outputs in place of _launch_emit (the
        sharded merged emit splits the lanes over its devices)."""
        launch = launch or self._launch_emit
        pl = self._emit_plan(num_lanes)
        if not self._emit_servable(pl["T"]):
            raise EmitPlanUnsupported(
                f"a lane's ring of T={pl['T']} rows (window {self.window}) "
                "does not fit a block's shared memory")
        auto = cap is None
        cap = pl["cap"] if auto else -(-cap // UNROLL) * UNROLL
        regs, ptrs, T = pl["regs"], pl["ptrs"], pl["T"]
        self._check_emit_layout(pl, cap)
        val, xch, nib, rows, ok, _, fold = launch(regs, ptrs, cap, T)
        if not check:
            return val, xch, nib, cap
        if not bool(trace.fetch(ok.all())):
            cap = _grow_cap(
                lambda idx, c: launch(regs, ptrs, c, T, idx)[4],
                ok, cap, self.step_bound("emit"), "decode_emit")
            self._check_emit_layout(pl, cap)
            val, xch, nib, rows, ok, _, fold = launch(regs, ptrs, cap, T)
            _all_done(ok, cap, "decode_emit")
        rows_np, pl["fold_np"] = trace.fetch(torch.stack([rows, fold]))
        pl["rows_np"] = rows_np
        if auto:
            # the true step need: later calls run a tight cap
            pl["cap"] = -(-max(int(rows_np.max()), UNROLL) // UNROLL) * UNROLL
        return val, xch, nib, cap

    def _steady(self, pl: dict, launch=None):
        """The verified steady state: decode_emit in mark_deg mode and the
        cached-layout post-pass, with no host synchronisation."""
        mc = pl["post_meta"]
        val, xch = (launch or self._launch_emit)(
            pl["regs"], pl["ptrs"], pl["cap"], pl["T"], mark_deg=True)[:2]
        return emit_post.post_steady(
            val, xch, *(mc[k] for k in emit_post.STEADY_KEYS))

    def _steady_graph(self, pl: dict):
        """The steady state on CUDA as one CUDA graph, the counterpart of
        the JAX package's one fused steady program (_emit_e2e_fused): the
        first steady call runs eagerly, then records the kernel and the
        post-pass (a few small launches and the fixup kernel) into a
        graph, with one host synchronisation as the capture starts (a
        `plan.capture` stage); every later call replays it (a
        `decode.steady` span). A replay overwrites the graph's outputs,
        so each call returns copies of succs2d and degs (one device copy
        of [cap, L] + [n] int32); starts_flat is the cached layout itself,
        as in the eager call."""
        captured = pl.get("graph")
        if captured is None:
            with trace.stage("plan.capture", lanes=pl["ptrs"].shape[0]):
                out = self._steady(pl)
                graph = torch.cuda.CUDAGraph()
                fx = fixup_cuda.emit_fixup
                fixups = (fx.captured, fx.captured_elements)
                with torch.cuda.graph(graph):
                    static = self._steady(pl)
                fixups = (fx.captured - fixups[0],
                          fx.captured_elements - fixups[1])
                pl["graph"] = (graph, static, fixups)
            trace.count("decode_graph_captures")
            return out
        graph, (succs2d, starts_flat, degs), fixups = captured
        with trace.span("decode.steady"):
            graph.replay()
            decode_emit.launches += 1      # the replay runs the kernel once
            fixup_cuda.count_launch(*fixups)   # and the fixups it recorded
            return succs2d.clone(), starts_flat, degs.clone()

    def decode_to_adjacency_device(self, num_lanes: int = 2048,
                                   launch=None):
        """End-to-end merged-emit decode: the kernel and the post-pass.
        Returns (succs2d [cap, L] int32, starts_flat [n] int32, degs [n]
        int32) on the device: node x's successors are
        succs2d.flatten()[starts_flat[x] + k*L] for k < degs[x]
        (emit_post.to_dense_csr converts).

        The first call decodes on stream-balanced bounds and caches the
        degrees; the next rebalances onto reference-safe, element-balanced
        bounds (on a block-parallel artifact split inside the encode
        blocks, each block start a bound) and refines them once on the
        observed rows; the plan is then verified, and later calls run the
        kernel (mark_deg mode) and the cached-layout post-pass with no
        host synchronisation; on CUDA as one CUDA graph (_steady_graph).

        Past window 12 lanes are cut at reference-safe nodes, and inside
        a safe gap only where it is longer than a lane's target (a
        high-compression artifact without safe breaks, whose chains run
        thousands of nodes deep): the chains such a cut crosses leave
        their nodes dirty, and the post-pass's fixup resolves them at any
        depth. What the merged-emit kernel cannot serve goes to the sort
        path (_adjacency_via_sort_path) on the same device, with a
        warning that names the cause, and stays there: a window past 16,
        a plan the kernel cannot run (EmitPlanUnsupported), or a
        post-pass RuntimeError (a node layout the fixup cannot take).
        When the reference-safe boundaries cannot be computed, the
        rebalanced plan keeps the halo re-decode instead. A kernel's build or launch
        failure, a device error and a layout past the int32 flat indices
        (LayoutTooLarge, a ValueError naming the layout, also from the
        safe boundaries' aux-mode decode) are no such cause: they
        propagate.

        launch (decode_emit_raw's hook) runs the kernel in place of
        _launch_emit; the plan, its cap loop and its post-pass are the
        same. With a launch given there is no fallback (what would fall
        back raises: EmitPlanUnsupported, or the post-pass's
        RuntimeError) and the steady state runs eagerly, not as a CUDA
        graph; plan-time steps (ring seeds, the safe boundaries) run on
        the decoder's device.

        A call is a `decode` span, its steady state a `decode.steady`
        span. The planning calls record one stage each step, always:
        `plan.first` (the first call's decode on stream-balanced bounds,
        its cap loop and post-pass), `plan.safe` (the degrees' read-back
        and the safe boundaries' aux-mode decode), `plan.bounds` (the
        element-balanced split, its decode and post-pass), `plan.refine`
        (the observed rows spread over the nodes), `plan.verify` (the
        split on those rows, the decode that verifies the plan and its
        post-pass), `plan.capture` (the first steady call and the CUDA
        graph's capture) and `plan.fallback` (the sort path's first call,
        with the cause); each split is an `emit.split` stage, each cap
        regrowth a `cap.grow` stage. `plan.safe` keeps the count of safe
        nodes (`safe_nodes`); `plan.verify` keeps the steady layout it
        verified: the fixup's rounds (the dirty-chain depth,
        `fixup_rounds`), the dirty nodes the fixup resolves each call
        (`dirty_nodes`) and their elements (`dirty_elements`, the node
        layout's sources), the layout's rows that take the fixup kernel's
        two-run step (`two_run_rows`), the empty lanes (`empty_lanes`),
        all lanes (`lanes`), the encode blocks of a block-parallel
        artifact (`encode_blocks`, 0 on a serial one), the lane bounds not
        at a safe node (`unsafe_cuts`), and the longest lane's and the
        mean lane's rows in the verifying decode (`rows_max`, `rows_mean`,
        the mean over all lanes), the rows that decode wrote by run folding
        (`fold_rows`, summed over the lanes) and the longest and the mean
        lane's rows less its folded ones, its full steps (`steps_max`,
        `steps_mean`). Each
        `emit.split` keeps its rule (`rule`, `_split_rule`), the bisected
        `target`, the split's longest and mean lane cost (`max_cost`,
        `mean_cost`), its bounds not at a safe node (`unsafe_cuts`) and
        the encode-block starts it forced as bounds (`block_starts`, 0 on
        a serial artifact)."""
        with trace.span("decode", lanes=num_lanes):
            return self._adjacency_device(num_lanes, launch)

    def emit_steady(self, num_lanes: int) -> bool:
        """Whether the merged-emit plan at num_lanes is in its steady state:
        verified, and not sent to the sort path. Its calls then run the
        kernel in mark_deg mode and the cached-layout post-pass."""
        pl = self._plans.get(("emit", num_lanes), {})
        return bool(pl.get("verified")) and not pl.get("emit_broken")

    def _adjacency_device(self, num_lanes: int, launch):
        pl = self._plans.setdefault(("emit", num_lanes), {})
        if launch is not None and (pl.get("emit_broken")
                                   or self.window > MAX_WINDOW):
            raise EmitPlanUnsupported(pl.get("emit_broken") or
                                      f"window {self.window} > {MAX_WINDOW}")
        if not pl.get("emit_broken") and self.window > MAX_WINDOW:
            return self._fall_back(pl, num_lanes,
                                   f"window {self.window} > {MAX_WINDOW}")
        if pl.get("emit_broken"):
            return self._adjacency_via_sort_path(num_lanes)
        if self.emit_steady(num_lanes):
            if launch is None and pl["regs"].device.type == "cuda":
                return self._steady_graph(pl)
            with trace.span("decode.steady"):
                return self._steady(pl, launch)
        if "degs_np" not in pl:
            step = trace.stage("plan.first", lanes=num_lanes)
        elif "node_work" not in pl:
            step = trace.stage("plan.bounds", lanes=num_lanes)
        else:
            step = trace.stage("plan.verify", lanes=num_lanes)
        with step:
            out = self._emit_call(pl, num_lanes, launch)
        if isinstance(out, str):
            return self._fall_back(pl, num_lanes, out)
        succs2d, starts_flat, degs = out
        if "degs_np" not in pl and "bounds" not in pl:
            # cache degrees and rebalance the lane split once, onto
            # element-balanced bounds at reference-safe nodes (no chain
            # crosses a boundary: no cross-lane dirty nodes, no halo)
            with trace.stage("plan.safe") as stage:
                pl["degs_np"] = trace.fetch(degs)
                try:
                    if pl.get("safe_np") is None:   # else the first call's
                        pl["safe_np"] = self._safe_boundaries()
                    stage.set(safe_nodes=int(pl["safe_np"].sum()))
                except LayoutTooLarge:
                    raise
                except (RuntimeError, ValueError) as e:
                    if _device_fault(e):
                        raise
                    log.warning("safe-boundary computation failed (%r); "
                                "falling back to the halo re-decode", e)
                    pl["safe_np"] = None    # correct without it
            for k in ("regs", "cap", "post_meta", "lane_of"):
                pl.pop(k, None)
        elif "node_work" not in pl and "rows_np" in pl:
            # one refinement: the split modelled steps as elements +
            # 2*nodes; re-split on the rows the decode observed
            with trace.stage("plan.refine"):
                lanes = pl["starts_np"], pl["ends_np"], pl["rows_np"]
                if self._split_rule() == "last_safe":
                    pl["node_work"] = node_rows(
                        trace.fetch(pl["post_meta"]["mrow_d"]), *lanes)
                else:
                    pl["node_work"] = spread_rows(pl["degs_np"], *lanes)
            for k in ("regs", "cap", "post_meta", "lane_of", "bounds",
                      "rows_np"):
                pl.pop(k, None)
            return self._adjacency_device(num_lanes, launch)
        else:
            pl["verified"] = True
            # the steady layout this plan keeps, on its plan.verify stage
            mc, rows = pl["post_meta"], pl["rows_np"]
            steps = rows - pl["fold_np"]
            bstarts = self._encode_block_starts()
            step.set(fixup_rounds=int(mc["rounds"]),
                     dirty_nodes=len(mc["order_np"]),
                     dirty_elements=int(mc["fx_srcs"].shape[0]),
                     two_run_rows=int(mc["two_run_rows"]),
                     empty_lanes=int((pl["starts_np"] >= pl["ends_np"]).sum()),
                     lanes=len(pl["starts_np"]), rows_max=int(rows.max()),
                     encode_blocks=0 if bstarts is None else len(bstarts),
                     rows_mean=float(rows.mean()),
                     fold_rows=int(pl["fold_np"].sum()),
                     steps_max=int(steps.max()),
                     steps_mean=float(steps.mean()),
                     unsafe_cuts=unsafe_cuts(pl["starts_np"],
                                             pl.get("safe_np")))
        return succs2d, starts_flat, degs

    def _emit_call(self, pl: dict, num_lanes: int, launch):
        """A planning call's kernel (with its cap loop) and full post-pass:
        (succs2d, starts_flat, degs), or the cause (a str) for which the
        sort path serves the plan."""
        try:
            val, xch, nib, _ = self.decode_emit_raw(num_lanes, launch=launch)
        except EmitPlanUnsupported as e:
            if launch is not None:
                raise
            return f"merged-emit kernel unavailable ({e})"
        if "lane_of" not in pl:
            lens = pl["ends_np"] - pl["starts_np"]
            pl["lane_of"] = np.repeat(np.arange(len(lens), dtype=np.int32),
                                      lens)
        try:
            return emit_post.postprocess(
                val, xch, nib, pl["lane_of"], pl["starts_np"],
                self.num_nodes, meta_cache=pl.setdefault("post_meta", {}))[:3]
        except RuntimeError as e:
            if _device_fault(e) or launch is not None:
                raise
            return (f"merged-emit post-pass unsupported for this artifact "
                    f"({e})")

    def _fall_back(self, pl: dict, num_lanes: int, cause: str):
        """Sends the plan to the sort path for good, with a warning that
        names the cause, and serves this call there (a `plan.fallback`
        stage)."""
        log.warning("%s; using the sort-path reconstruction", cause)
        pl["emit_broken"] = cause
        with trace.stage("plan.fallback", cause=cause):
            return self._adjacency_via_sort_path(num_lanes)

    def _adjacency_via_sort_path(self, num_lanes: int):
        """The sort-path reconstruction (decode_to_csr_device) in the
        padded-adjacency contract of decode_to_adjacency_device, in the
        one-lane layout (G = 1: a flat index is the CSR index)."""
        offsets, succs, _ = self.decode_to_csr_device(num_lanes=num_lanes)
        return (succs.reshape(-1, 1), offsets[:-1].contiguous(),
                offsets[1:] - offsets[:-1])
