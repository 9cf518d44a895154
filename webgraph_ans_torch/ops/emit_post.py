"""Post-pass of the merged-emit decode: kernel channels -> device adjacency.

The merged-emit kernel (ops/emit_cuda.py, plain version ops/emit_torch.py)
reconstructs successor lists in the kernel and writes one final sorted
successor per step; this module turns its channels into a column-major
padded adjacency and finishes the nodes the kernel left dirty. It is the
port of webgraph_ans_tpu/ops/emit_post.py, in torch ops on the device.

Channel contract (S = steps, G = lanes, int32 bit patterns; lane l's rows
run down column l):

- val [S, G]: the successor; j (position in the parent's list) on
  placeholder rows; ref on refinfo rows.
- xch [S, G]: the node id on marker rows (codes 1/3/5/7/8/9), or its
  outdegree when the kernel ran with mark_deg.
- nib [S//8, G]: 4-bit row codes, row s at word s//8, nibble s%8:
  0 element, 1 first element of a clean node, 2 hole, 3/7/8/9 refinfo
  (first row of a dirty node; the code names the cause), 4 placeholder,
  5 empty node, 0xF done.

Dirty nodes emit grouped (placeholders for copies, then intervals, then
residuals). Every call finishes them the same way: the fixup
(ops/fixup_cuda.py emit_fixup: one hand-written kernel on CUDA, its plain
version on the CPU) resolves each dirty node's placeholders from its
parent's final list, in (dirty-chain depth, node) order, and writes the
node's sorted list to its rows, over a node layout that a plan's first
call builds (build_fixup_cache). The reference it is held to is the JAX
package's post_steady (its rounds: a gather, a sort and a scatter a chain
level) on the CPU, and emit_fixup_plain on the card.

Result: succs2d [S, G] int32, starts_flat [n] int32, degs [n] int32, where
node x's successors are succs2d.flatten()[starts_flat[x] + k*G] for
k < degs[x]. `to_dense_csr` converts to (offsets, succs).

The steady state (post_steady) reads only layout cached from a verified
first decode and issues no host synchronisation.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import trace
from .fixup_cuda import FOLLOWS, emit_fixup
from .reconstruct_device import _cumsum, _cumsum_tok, unpack_nibbles

I32 = torch.int32

# row codes
C_EL, C_FIRST, C_HOLE, C_REFINFO, C_PLACE, C_EMPTY = range(6)
C_DONE = 0xF


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] with indices clamped into x, as an XLA gather clamps."""
    return x[torch.clamp(idx.long(), 0, x.numel() - 1)]


def _set_drop(x: torch.Tensor, idx: torch.Tensor, v: torch.Tensor):
    """x with x[idx] = v where idx < len(x); indices at or past the end
    land in one spare slot that is cut off."""
    n = x.numel()
    ext = torch.cat([x, x.new_zeros(1)])
    ext[torch.clamp(idx.long(), 0, n)] = v.to(x.dtype)
    return ext[:n]


def extract_node_tables(val, xch, nib, lane_of, n: int) -> dict:
    """Pass 1: per-node tables from the channels (lane_of [n] int32: the
    lane holding each node). Returns n-arrays start_el (row of the first
    element), deg, kind (0 clean / 1 dirty / 2 empty), ref, cause, span
    (rows until the next marker of the lane), rank_at, mrow, the [S, G]
    codes and the ok flag (a 0-d bool tensor)."""
    S, G = val.shape
    dev = val.device
    codes = unpack_nibbles(nib, S)
    is_elem = (codes == C_EL) | (codes == C_FIRST) | (codes == C_PLACE)
    is_refinfo = ((codes == C_REFINFO) | (codes == 7) | (codes == 8)
                  | (codes == 9))
    is_marker = (codes == C_FIRST) | is_refinfo | (codes == C_EMPTY)

    rows = torch.arange(S, dtype=I32, device=dev)[:, None].expand(S, G)
    ie = is_elem.to(I32)
    rank = _cumsum_tok(ie) - ie               # exclusive, token order

    kind = torch.where(codes == C_FIRST, 0,
                       torch.where(is_refinfo, 1, 2)).to(I32)
    cause = torch.where(is_refinfo, codes, 0).to(I32)
    idx = torch.where(is_marker, xch, n)
    packed = (rows << 6) | (cause << 2) | kind
    idx = torch.where((idx >= 0) & (idx <= n), idx, n + 1)
    mrow_p = _set_drop(torch.zeros(n + 1, dtype=I32, device=dev),
                       idx.reshape(-1), packed.reshape(-1))
    mrow, mkind = mrow_p[:n] >> 6, mrow_p[:n] & 3
    mcause = (mrow_p[:n] >> 2) & 0xF

    lane_of = lane_of.to(I32)
    flat = mrow * G + lane_of
    rank_at = _take(rank.reshape(-1), flat)
    ref_raw = _take(val.reshape(-1), flat)
    ref = torch.where(mkind == 1, ref_raw, 0).to(I32)

    lane_tot = rank[-1, :] + ie[-1, :]
    one_false = torch.zeros(1, dtype=torch.bool, device=dev)
    next_same_lane = torch.cat([lane_of[1:] == lane_of[:-1], one_false])
    nxt_rank = torch.cat([rank_at[1:], rank_at.new_zeros(1)])
    deg = (torch.where(next_same_lane, nxt_rank, _take(lane_tot, lane_of))
           - rank_at)
    deg = torch.where(mkind == 2, 0, deg).to(I32)

    start_el = mrow + (mkind == 1).to(I32)
    nxt_mrow = torch.cat([mrow[1:], mrow.new_zeros(1)])
    span = (torch.where(next_same_lane, nxt_mrow, S) - start_el).to(I32)
    ok = (deg >= 0).all() & (span >= deg).all()
    return dict(start_el=start_el, deg=deg, kind=mkind, ref=ref,
                cause=mcause, span=span, rank_at=rank_at, codes=codes,
                mrow=mrow, ok=ok)


def _expand_spans(len_n, mask_n, Dcap: int):
    """Ragged expansion: for masked nodes, (node, k) pairs for k < len_n
    packed densely into [Dcap] in node order. Returns (node, k, valid,
    dbase [n])."""
    dev = len_n.device
    n = len_n.shape[0]
    ln = torch.where(mask_n, len_n, 0).to(I32)
    dbase = _cumsum(ln) - ln                     # exclusive
    total = dbase[-1] + ln[-1]
    g = torch.arange(Dcap, dtype=I32, device=dev)
    starts = torch.where(mask_n & (ln > 0), dbase, Dcap)
    starts = torch.clamp(starts, 0, Dcap + 1)
    ids = torch.arange(n, dtype=I32, device=dev)
    arr = torch.zeros(Dcap + 2, dtype=I32, device=dev).scatter_reduce(
        0, starts.long(), ids, "amax")
    node = torch.cummax(arr[:Dcap], 0).values
    k = g - _take(dbase, node)
    valid = (g < total) & (k >= 0) & (k < _take(ln, node))
    return node, k, valid, dbase


def _node_layout(mc: dict, deg, startsF, G: int, order, ordl, rowf, vals,
                 codes):
    """The fixup kernel's path layout (ops/fixup_cuda.py): (nodes [nd, 5],
    srcs [E]) int64 numpy, from the dirty nodes' rows in fixup order
    (ordl: each row's ordinal in order; rowf, vals, codes: its flat index
    into val, value and code). The dirty nodes that read a dirty parent's
    list form a forest; it is cut into paths, each following a node's
    child of the deepest subtree, and the rows list the paths one after
    another in the order of their first nodes' (chain depth, node), each
    node's elements in its rows' order. Raises RuntimeError where the
    layout breaks what the fixup relies on: a node's elements are its
    degree, a placeholder indexes its parent's list, a dirty parent comes
    earlier."""
    nd = len(order)
    dego = deg[order]
    is_el = (codes == C_EL) | (codes == C_FIRST) | (codes == C_PLACE)
    is_pl = codes == C_PLACE
    par = mc["parent"][order][ordl]
    pd = is_pl & (mc["ddep"][par] > 0)        # reads a dirty parent's list
    # placeholder j values are layout (a position in the parent's list)
    j = np.where(is_pl, vals.astype(np.int64), 0)
    if not np.array_equal(np.bincount(ordl[is_el], minlength=nd), dego):
        raise RuntimeError("a dirty node's elements differ from its degree")
    if (is_pl & ((j < 0) | (j >= deg[par]))).any():
        raise RuntimeError("a placeholder points past its parent's list")
    # ~j for a dirty parent's j-th successor, else a flat row of val: a
    # clean parent's j-th successor or the node's own row
    src = np.where(pd, ~j, np.where(is_pl, startsF[par] + j * G, rowf))
    ordinal = np.full(len(mc["parent"]), -1, np.int64)
    ordinal[order] = np.arange(nd)
    reads = np.zeros(nd, bool)
    reads[ordl[pd]] = True
    pord = np.where(reads, ordinal[mc["parent"][order]], -1)
    if (reads & ((pord < 0) | (pord >= np.arange(nd)))).any():
        raise RuntimeError("a dirty node reads a parent not before it")
    # each node's tallest subtree, a chain depth at a time from the
    # deepest (a node reads a parent one chain level up), then the child
    # a path follows
    height = np.ones(nd, np.int64)
    lvl = mc["ddep"][order]
    edges = np.flatnonzero(np.diff(lvl)) + 1
    for a, b in zip(np.append(edges, nd)[::-1], np.append(0, edges)[::-1]):
        r = np.arange(b, a)[pord[b:a] >= 0]
        np.maximum.at(height, pord[r], height[r] + 1)
    kids = np.nonzero(pord >= 0)[0]
    kids = kids[np.lexsort((kids, -height[kids], pord[kids]))]
    first = np.ones(len(kids), bool)
    first[1:] = pord[kids][1:] != pord[kids][:-1]
    follows = np.zeros(nd, bool)
    follows[kids[first]] = True
    # a path's id is its first node's ordinal (ordinals rise along it)
    ids = np.arange(nd)
    path = ids + chain_sums(np.where(follows, pord, -1),
                            np.where(follows, pord - ids, 0))
    rows = np.lexsort((np.arange(nd), path))
    row_of = np.empty(nd, np.int64)
    row_of[rows] = np.arange(nd)
    link = np.where(follows, FOLLOWS,
                    np.where(pord >= 0, row_of[pord], -1))
    publish = np.zeros(nd, np.int64)
    publish[pord[(pord >= 0) & ~follows]] = 1
    rdeg = dego[rows]
    ebase = np.cumsum(rdeg) - rdeg
    nodes = np.stack([ebase, rdeg, startsF[order][rows], link[rows],
                      publish[rows]], 1)
    # each row's elements, moved from their ordinal's place to the row's
    pos = np.repeat((np.cumsum(dego) - dego)[rows] - ebase, rdeg)
    return nodes, src[is_el][pos + np.arange(len(pos))]


# a two-run row's elements at most: the card's warp path (two a lane)
TWO_RUN_MAX = 64


def two_run_layout(nodes, srcs):
    """A path layout (_node_layout's columns, or the first five of a node
    table) in the fixup kernel's two-run form: (nodes [nd, 6], srcs [E],
    two_run_rows). Within each row the sources that copy the dirty
    parent's list (~j) come first, in ascending j, then the others in
    their order; the order of a row's sources does not change its sorted
    list. Column 5 is the row's number of copies where it takes the
    kernel's two-run step, else -1 (the kernel's block ranks it over the
    runs it finds): a row of at most TWO_RUN_MAX elements that reads a
    parent, or copies nothing. two_run_rows counts those rows."""
    nodes = np.asarray(nodes, np.int64)[:, :5]
    srcs = np.asarray(srcs, np.int64)
    nd = len(nodes)
    deg, link = nodes[:, 1], nodes[:, 3]
    row = np.repeat(np.arange(nd), deg)
    k = np.arange(len(row)) - np.repeat(np.cumsum(deg) - deg, deg)
    at = np.repeat(nodes[:, 0], deg) + k
    s = srcs[at]
    copy = s < 0
    s = s[np.lexsort((np.where(copy, ~s, (1 << 40) + k), row))]
    out = srcs.copy()
    out[at] = s
    copies = np.bincount(row, copy, minlength=nd).astype(np.int64)
    two = (deg <= TWO_RUN_MAX) & ((link != -1) | (copies == 0))
    nodes = np.concatenate([nodes, np.where(two, copies, -1)[:, None]], 1)
    return nodes, out, int(two.sum())


def fixup_provider(val, nib):
    """build_fixup_cache's val_np_provider over one decode's val and nib
    channels: (values, codes) numpy at flat rows."""
    G = val.shape[1]
    dev = val.device
    flatv = val.reshape(-1)
    nibf = nib.reshape(-1)

    def provider(rowf):
        rowf_d = trace.upload(rowf.astype(np.int64), dev)
        vals = trace.fetch(flatv[rowf_d])
        row, lane = rowf_d // G, rowf_d % G
        words = nibf[(row >> 3) * G + lane].long() & 0xFFFFFFFF
        codes = trace.fetch((words >> ((row & 7) * 4)) & 0xF)
        return vals, codes

    return provider


def build_fixup_cache(mc: dict, tabs: dict, lane_of_np, val_np_provider):
    """The fixup's node layout of a plan's first decode, on the node
    tables' device: "fx_nodes" [nd, 6] and "fx_srcs" [E] int32 (empty
    without dirty nodes), the path layout (_node_layout) in the kernel's
    two-run form (two_run_layout), and the count of rows that take the
    two-run step ("two_run_rows"). Reads the dirty nodes in fixup order,
    their parents and chain depths from mc (_dirty_chains), and the node
    tables `tabs` of the decode; values are never cached.

    val_np_provider(rowf int64) -> (values, codes) numpy: the decode's val
    channel and row codes at flat rows (fixup_provider)."""
    dev = tabs["deg"].device
    order = mc["order_np"].astype(np.int64)
    nodes, srcs, two_run = np.zeros((0, 6), np.int32), np.zeros(0), 0
    if len(order):
        G = tabs["codes"].shape[1]
        deg = trace.fetch(tabs["deg"]).astype(np.int64)
        startsF = (trace.fetch(tabs["start_el"]).astype(np.int64) * G
                   + np.asarray(lane_of_np, np.int64))
        # every row of each dirty node's span, in fixup order
        ln = trace.fetch(tabs["span"]).astype(np.int64)[order]
        ordl = np.repeat(np.arange(len(order)), ln)
        k = np.arange(len(ordl)) - np.repeat(np.cumsum(ln) - ln, ln)
        rowf = startsF[order][ordl] + k * G
        vals, codes = val_np_provider(rowf)
        nodes, srcs, two_run = two_run_layout(*_node_layout(
            mc, deg, startsF, G, order, ordl, rowf, vals, codes))
    mc["two_run_rows"] = two_run
    mc["fx_nodes"] = trace.upload(np.ascontiguousarray(nodes, np.int32), dev)
    mc["fx_srcs"] = trace.upload(np.ascontiguousarray(srcs, np.int32), dev)


# post_steady's cached-layout arguments, in order, as postprocess keys
# them in its meta cache: post_steady(val, xch, *(mc[k] for k in
# STEADY_KEYS))
STEADY_KEYS = ("lane_of_d", "mrow_d", "kind_d", "starts_flat_d", "fx_nodes",
               "fx_srcs")


def post_steady(val, xch, lane_of, mrow, kind, starts_flat, fx_nodes,
                fx_srcs):
    """Steady-state post-pass: the marker layout (rows, kinds, starts,
    dirty-node layout) is cached from the verified first decode, the
    kernel ran with mark_deg (each node's decoded outdegree on its marker
    row of xch), so degrees are one n-scale gather and values come from
    this decode's val channel, which the fixup (ops/fixup_cuda.py
    emit_fixup: the kernel on CUDA, its plain version on the CPU) patches
    in place over the node layout. No host synchronisation."""
    G = val.shape[1]
    deg = _take(xch.reshape(-1), mrow * G + lane_of)
    deg = torch.where(kind == 2, 0, deg).to(I32)
    if fx_nodes.shape[0]:
        val = emit_fixup(val, fx_nodes, fx_srcs)
    return val, starts_flat, deg


def chain_sums(up: np.ndarray, count: np.ndarray) -> np.ndarray:
    """Each node's count summed along its chain: s[x] = count[x] +
    s[up[x]] where up[x] >= 0, else count[x]. Every chain must end (up
    points to an earlier node, as a parent precedes its children); pointer
    doubling, about log2 of the deepest chain passes over the nodes."""
    n = len(up)
    # node n: the chains' end, counting 0
    nxt = np.append(np.where(up >= 0, up, n), n)
    s = np.append(np.asarray(count, np.int64), 0)
    while (nxt[:n] < n).any():
        s = s + s[nxt]
        nxt = nxt[nxt]
    return s[:n]


def _dirty_chains(mc: dict, tabs: dict, n: int):
    """Each node's parent and dirty-chain depth ("parent", "ddep"; clean
    0, dirty 1 + the depth of its maybe dirty parent, a dirty node without
    a reference 1), the deepest chain ("rounds") and the dirty nodes in
    (chain depth, node) order ("order_np"), the order the fixup resolves
    them in. Any depth: parents precede children (chain_sums)."""
    kind = trace.fetch(tabs["kind"])
    ref = trace.fetch(tabs["ref"])
    parent = np.maximum(np.arange(n) - ref, 0)
    dirty = kind == 1
    ddep = chain_sums(np.where(dirty & (ref > 0), parent, -1),
                      dirty).astype(np.int32)
    didx = np.flatnonzero(dirty)
    mc.update(parent=parent.astype(np.int32), ddep=ddep,
              rounds=int(ddep.max(initial=0)),
              order_np=didx[np.lexsort((didx, ddep[didx]))].astype(np.int32))


def postprocess(val, xch, nib, lane_of_np, lane_starts_np, n: int,
                meta_cache: dict | None = None):
    """Full post-pass: channels -> (succs2d int32, starts_flat, degs,
    tabs). The fixup (emit_fixup over the node layout, as in post_steady)
    patches val in place: succs2d is val. meta_cache (mutated) keeps what
    the plan's first call finds: the dirty chains, the node layout and the
    steady state's marker layout (STEADY_KEYS); later calls reuse them.
    Raises RuntimeError where the node layout breaks what the fixup
    relies on (_node_layout); the dirty chains may run to any depth."""
    mc = meta_cache if meta_cache is not None else {}
    first = "fx_nodes" not in mc
    if first:
        mc["lane_of_d"] = trace.upload(
            np.ascontiguousarray(lane_of_np, np.int32), val.device)
    lane_of = mc["lane_of_d"]
    tabs = extract_node_tables(val, xch, nib, lane_of, n)
    if first:
        _dirty_chains(mc, tabs, n)
        # the marker layout: rows, kinds and starts of a deterministic
        # kernel on a fixed artifact (values and degrees are decoded again
        # on every call)
        mc.update(mrow_d=tabs["mrow"], kind_d=tabs["kind"],
                  starts_flat_d=tabs["start_el"] * val.shape[1] + lane_of)
        build_fixup_cache(mc, tabs, lane_of_np, fixup_provider(val, nib))
    if mc["fx_nodes"].shape[0]:
        val = emit_fixup(val, mc["fx_nodes"], mc["fx_srcs"])
    return val, mc["starts_flat_d"], tabs["deg"], tabs


def to_host_lists(succs2d, starts_flat, degs, n: int):
    """Host verification helper: the list of each node's successors."""
    F = succs2d.cpu().numpy().reshape(-1)
    st = starts_flat.cpu().numpy().astype(np.int64)
    d = degs.cpu().numpy().astype(np.int64)
    G = succs2d.shape[1]
    return [F[st[x] + np.arange(d[x]) * G] for x in range(n)]


def to_dense_csr(succs2d, starts_flat, degs, E: int):
    """Contiguous CSR (offsets [n+1] int32, succs [E] int32) from the
    padded column-major adjacency: one element-scale gather. E is the
    output length (at least the arc count; the tail is 0)."""
    n = degs.shape[0]
    G = succs2d.shape[1]
    dev = degs.device
    offsets = torch.cat([torch.zeros(1, dtype=I32, device=dev),
                         _cumsum(degs)])
    node, k, valid, _ = _expand_spans(
        degs, torch.ones(n, dtype=torch.bool, device=dev), E)
    src = torch.clamp(_take(starts_flat, node) + k * G, 0,
                      succs2d.shape[0] * G - 1)
    succs = torch.where(valid, _take(succs2d.reshape(-1), src), 0).to(I32)
    return offsets, succs
