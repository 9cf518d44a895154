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
residuals); the fixup gathers all dirty spans into one compact buffer in
(dirty-chain depth, node) order, resolves placeholders from the already
final parents round by round, sorts each node's slice and writes it back.

Result: succs2d [S, G] int32, starts_flat [n] int32, degs [n] int32, where
node x's successors are succs2d.flatten()[starts_flat[x] + k*G] for
k < degs[x]. `to_dense_csr` converts to (offsets, succs).

The steady state (post_steady) reads only layout cached from a verified
first decode and issues no host synchronisation. Its fixup runs over a
node layout (ops/fixup_cuda.py): one hand-written kernel on CUDA, its
plain version on the CPU; the JAX package's rounds (_fixup_steady) are
kept as their reference.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import trace
from .fixup_cuda import FOLLOWS, emit_fixup
from .reconstruct_device import (_cumsum, _cumsum_tok, _quant, _sort2,
                                 unpack_nibbles)

I32 = torch.int32
UNROLL = 8
BIG = 0x7FFFFFFF

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


def fixup_dirty_compact(val, nib, start_el, deg, span, lane_of, order,
                        cpos_n, pdirty, parent, roffs: tuple, Dall: int):
    """Compact-block fixup (first-call path): gathers every dirty span
    into a compact buffer in (chain depth, node) order, resolves and sorts
    each round's slice (parents of later rounds read the already-sorted
    compact slices of earlier ones), and writes back with one scatter.

    order [nd]: dirty node ids sorted by (chain depth, node), -1 padded;
    cpos_n [n]: each dirty node's compact base; roffs: (round start,
    padded length, true length) per round."""
    S, G = val.shape
    dev = val.device
    n = start_el.shape[0]
    F = val.reshape(-1)
    nibf = nib.reshape(-1)
    lane_of = lane_of.to(I32)
    startsF = start_el * G + lane_of
    pstartF = _take(startsF, parent)
    nd = order.shape[0]

    # slot -> dirty ordinal via scatter-max of ordinals at compact bases
    ln = torch.where(order >= 0, _take(span, torch.clamp(order, min=0)),
                     0).to(I32)
    obase = _cumsum(ln) - ln
    slots = torch.arange(Dall, dtype=I32, device=dev)
    st = torch.clamp(torch.where(ln > 0, obase, Dall), 0, Dall + 1)
    arr = torch.zeros(Dall + 2, dtype=I32, device=dev).scatter_reduce(
        0, st.long(), torch.arange(nd, dtype=I32, device=dev), "amax")
    ordl = torch.cummax(arr[:Dall], 0).values
    node = _take(order, ordl)
    k = slots - _take(obase, ordl)
    valid = (node >= 0) & (k >= 0) & (k < _take(ln, ordl))
    node = torch.clamp(node, min=0)

    row = _take(start_el, node) + k
    lane = _take(lane_of, node)
    rowf = torch.where(valid, row * G + lane, 0)
    wordf = torch.where(valid, (row >> 3) * G + lane, 0)
    Cv = torch.where(valid, _take(F, rowf), 0).to(I32)
    Cc = torch.where(valid, (_take(nibf, wordf) >> ((row & 7) * 4)) & 0xF,
                     C_HOLE).to(I32)
    cbase = _take(obase, ordl)

    for (lo, lpad, tlen) in roffs:
        sl_v = Cv[lo:lo + lpad]
        sl_c = Cc[lo:lo + lpad]
        sl_node = node[lo:lo + lpad]
        sl_valid = valid[lo:lo + lpad]
        is_el = (sl_c == C_EL) | (sl_c == C_FIRST) | (sl_c == C_PLACE)
        is_pl = sl_valid & (sl_c == C_PLACE)
        par = _take(parent, sl_node)
        pd = _take(pdirty, par)
        srcF = torch.clamp(_take(pstartF, sl_node) + sl_v * G, 0, S * G - 1)
        srcC = torch.clamp(_take(cpos_n, par) + sl_v, 0, Dall - 1)
        vF = _take(F, torch.where(is_pl & ~pd, srcF, 0))
        vC = _take(Cv, torch.where(is_pl & pd, srcC, 0))
        v = torch.where(is_pl, torch.where(pd, vC, vF), sl_v)
        in_round = torch.arange(lpad, device=dev) < tlen
        key = torch.where(sl_valid & is_el & in_round, v, BIG)
        # slots past the true length belong to later rounds: push them
        # past every real group
        sortn = torch.where(in_round, sl_node, BIG)
        sord, sv = _sort2(sortn, key)
        gb = _take(cpos_n, torch.clamp(sord, 0, n - 1)) - lo
        rank = torch.arange(lpad, dtype=I32, device=dev) - gb
        put = ((sv != BIG) & (sord >= 0) & (rank >= 0)
               & (rank < _take(deg, torch.clamp(sord, min=0))))
        dst = torch.where(put, gb + rank + lo, Dall)
        Cv = _set_drop(Cv, dst, sv)
    # final write-back: compact value at (node, rank) -> its F row
    rank_f = slots - cbase
    okf = valid & (rank_f < _take(deg, node))
    destF = torch.where(okf, _take(startsF, node) + rank_f * G, S * G)
    return _set_drop(F, destF, Cv).reshape(S, G)


def _post_fused(val, xch, nib, lane_of, order, cpos_n, pdirty, parent,
                n: int, roffs: tuple, Dall: int):
    """extract + fixup (first-call and verification path)."""
    tabs = extract_node_tables(val, xch, nib, lane_of, n)
    G = val.shape[1]
    if roffs:
        succs2d = fixup_dirty_compact(
            val, nib, tabs["start_el"], tabs["deg"], tabs["span"],
            lane_of, order, cpos_n, pdirty, parent, roffs, Dall)
    else:
        succs2d = val
    starts_flat = tabs["start_el"] * G + lane_of.to(I32)
    return succs2d, starts_flat, tabs["deg"], tabs


def _node_layout(mc: dict, order, ln, valid, is_el, is_pl, pd, par, j,
                 rowf, srcF, startsF):
    """The fixup kernel's node layout (ops/fixup_cuda.py): (nodes [nd, 5],
    srcs [E]) int32 numpy. The dirty nodes that read a dirty parent's list
    form a forest; it is cut into paths, each following a node's child of
    the deepest subtree, and the rows list the paths one after another in
    the order of their first nodes' (chain depth, node), each node's
    elements in its rows' order. Raises RuntimeError where the layout
    breaks what both fixups rely on: a node's elements are its degree, a
    dirty parent's placeholder indexes the parent's list, the parent
    comes earlier."""
    nd, tot = len(order), int(ln.sum())
    deg = mc["deg_np"][order]
    elm = (valid & is_el)[:tot]
    ordl = np.repeat(np.arange(nd), ln)
    if not np.array_equal(np.bincount(ordl[elm], minlength=nd), deg):
        raise RuntimeError("a dirty node's elements differ from its degree")
    pd = pd[:tot]
    jt = j[:tot]
    if (is_pl[:tot] & ((jt < 0) | (jt >= mc["deg_np"][par[:tot]]))).any():
        raise RuntimeError("a placeholder points past its parent's list")
    src = np.where(pd, ~jt, np.where(is_pl[:tot], srcF[:tot], rowf[:tot]))
    ordinal = np.full(len(mc["parent"]), -1, np.int64)
    ordinal[order] = np.arange(nd)
    reads = np.zeros(nd, bool)
    reads[ordl[pd]] = True
    pord = np.where(reads, ordinal[mc["parent"][order]], -1)
    if (reads & ((pord < 0) | (pord >= np.arange(nd)))).any():
        raise RuntimeError("a dirty node reads a parent not before it")
    # each node's tallest subtree, then the child a path follows
    height = np.ones(nd, np.int64)
    for i in range(nd - 1, -1, -1):
        if pord[i] >= 0:
            height[pord[i]] = max(height[pord[i]], height[i] + 1)
    kids = np.nonzero(pord >= 0)[0]
    kids = kids[np.lexsort((kids, -height[kids], pord[kids]))]
    first = np.ones(len(kids), bool)
    first[1:] = pord[kids][1:] != pord[kids][:-1]
    follows = np.zeros(nd, bool)
    follows[kids[first]] = True
    path = np.arange(nd)
    for i in np.nonzero(follows)[0]:        # ordinals rise along a path
        path[i] = path[pord[i]]
    rows = np.lexsort((np.arange(nd), path))
    row_of = np.empty(nd, np.int64)
    row_of[rows] = np.arange(nd)
    link = np.where(follows, FOLLOWS,
                    np.where(pord >= 0, row_of[pord], -1))
    publish = np.zeros(nd, np.int64)
    publish[pord[(pord >= 0) & ~follows]] = 1
    rdeg = deg[rows]
    ebase = np.cumsum(rdeg) - rdeg
    nodes = np.stack([ebase, rdeg, startsF[order][rows], link[rows],
                      publish[rows]], 1)
    # each row's elements, moved from their ordinal's place to the row's
    pos = np.repeat((np.cumsum(deg) - deg)[rows] - ebase, rdeg)
    return nodes, src[elm][pos + np.arange(len(pos))]


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


def build_fixup_cache(mc: dict, val_np_provider, device,
                      rounds: bool = False):
    """Precomputes the steady fixup's layout from the verified first decode
    (host numpy): the fixup kernel's node layout under "fx_nodes" and
    "fx_srcs" (device tensors) and the static round offsets under
    "fx_offs". Values are never cached. With `rounds`, also the per-slot
    index and layout arrays of the round-by-round fixup (ROUNDS_KEYS:
    row positions, code classes, placeholder sources, sort group shapes,
    destinations), the reference that _fixup_steady runs.

    val_np_provider(rowf [Dall] int64) -> (values, codes) numpy: the first
    decode's val channel and row codes at flat rows (fixup_provider)."""
    n = len(mc["parent"])
    order = mc["order_np"]
    span = mc["span_np"]
    start_el = mc["start_el_np"]
    deg = mc["deg_np"]
    lane_of = mc["lane_of_np"]
    parent = mc["parent"]
    pdirty = mc["pdirty_np"]
    cpos = mc["cpos_np"]
    Dall = mc["Dall"]
    G = mc["G"]

    # slot -> (node, k) in (chain depth, node) order
    ln = span[order].astype(np.int64)
    obase = np.concatenate([[0], np.cumsum(ln)])[:-1]
    tot = int(ln.sum())
    node = np.full(Dall, -1, np.int64)
    k = np.zeros(Dall, np.int64)
    cb_r = np.repeat(obase, ln)
    node[:tot] = np.repeat(order, ln)
    k[:tot] = np.arange(tot) - cb_r
    valid = node >= 0
    nodec = np.maximum(node, 0)
    row = start_el[nodec] + k
    rowf = np.where(valid, row * G + lane_of[nodec], 0)
    vals0, codes = val_np_provider(rowf)
    codes = np.where(valid, codes, C_HOLE)
    is_el = (codes == C_EL) | (codes == C_FIRST) | (codes == C_PLACE)
    is_pl = valid & (codes == C_PLACE)
    par = parent[nodec]
    pd = pdirty[par] & is_pl
    startsF = start_el.astype(np.int64) * G + lane_of
    # placeholder j values are layout (a position in the parent's list)
    j = np.where(is_pl, vals0.astype(np.int64), 0)
    srcF = np.where(is_pl & ~pd,
                    np.clip(startsF[par] + j * G, 0, mc["SG"] - 1), 0)
    nodes, srcs = _node_layout(mc, order, ln, valid, is_el, is_pl, pd, par,
                               j, rowf, srcF, startsF)

    def dev_i32(a):
        return trace.upload(np.ascontiguousarray(a, np.int32), device)

    def dev_bool(a):
        return trace.upload(np.ascontiguousarray(a, bool), device)

    mc["fx_offs"] = tuple(mc["roffs"])
    mc["fx_nodes"] = dev_i32(nodes)
    mc["fx_srcs"] = dev_i32(srcs)
    if not rounds:
        return

    srcC = np.where(pd, np.clip(cpos[par] + j, 0, Dall - 1), 0)
    cbase = np.zeros(Dall, np.int64)
    cbase[:tot] = cb_r
    # per-round sort layout: sorted group ids, ranks, destinations
    sortn_rounds, dst_rounds = [], []
    for (lo, lpad, tlen) in mc["roffs"]:
        sl = slice(lo, lo + lpad)
        in_round = np.arange(lpad) < tlen
        elmask = valid[sl] & is_el[sl] & in_round
        sortn = np.where(in_round, nodec[sl], BIG).astype(np.int64)
        # the sort key is BIG wherever elmask is false, so the sorted
        # group order (and each group's element count) is layout
        key0 = np.where(elmask, 0, BIG)
        o = np.lexsort((key0, sortn))
        sord = sortn[o]
        skey0 = key0[o]
        gb = np.where(sord != BIG, cpos[np.clip(sord, 0, n - 1)] - lo, 0)
        rank = np.arange(lpad) - gb
        put = ((skey0 != BIG) & (sord != BIG) & (rank >= 0)
               & (rank < deg[np.clip(sord, 0, n - 1)]))
        dst = np.where(put, gb + rank + lo, Dall)
        sortn_rounds.append(sortn)
        dst_rounds.append(dst)
    rank_f = np.arange(Dall) - cbase
    okf = valid & (rank_f < deg[nodec])
    destF = np.where(okf, startsF[nodec] + rank_f * G, mc["SG"])

    mc["fx_rowf"] = dev_i32(np.where(valid, rowf, 0))
    mc["fx_valid"] = dev_bool(valid)
    mc["fx_ispl"] = dev_bool(is_pl)
    mc["fx_pd"] = dev_bool(pd)
    mc["fx_elmask"] = dev_bool(is_el & valid)
    mc["fx_srcF"] = dev_i32(srcF)
    mc["fx_srcC"] = dev_i32(srcC)
    mc["fx_sortn"] = dev_i32(np.concatenate(sortn_rounds))
    mc["fx_dst"] = dev_i32(np.concatenate(dst_rounds))
    mc["fx_destF"] = dev_i32(destF)


# the per-slot arrays of the round-by-round fixup, in _fixup_steady's order
ROUNDS_KEYS = ("fx_rowf", "fx_valid", "fx_ispl", "fx_pd", "fx_elmask",
               "fx_srcF", "fx_srcC", "fx_sortn", "fx_dst", "fx_destF")


def _fixup_steady(val, mc: dict):
    """The round-by-round fixup of the JAX package's post_steady, with
    every index and mask cached (build_fixup_cache with rounds): two
    Dall-scale gathers, then per round one gather, one sort and one
    scatter, then one final scatter. A new tensor; the reference the
    fixup kernel and its plain version are held to."""
    if not mc["fx_offs"]:
        return val.clone()
    rowf, valid, ispl, pd, elmask, srcF, srcC, sortn, dst, destF = (
        mc[k] for k in ROUNDS_KEYS)
    S, G = val.shape
    F = val.reshape(-1)
    Cv0 = torch.where(valid, _take(F, rowf), 0).to(I32)
    vF = _take(F, srcF)                     # placeholders of clean parents
    Cv = torch.where(ispl & ~pd, vF, Cv0)
    off = 0
    for (lo, lpad, _) in mc["fx_offs"]:
        sl = slice(lo, lo + lpad)
        so = slice(off, off + lpad)
        off += lpad
        sl_v = Cv[sl]
        vC = _take(Cv, srcC[sl])            # placeholders of dirty parents
        v = torch.where(ispl[sl] & pd[sl], vC, sl_v)
        key = torch.where(elmask[sl], v, BIG)
        _, sv = _sort2(sortn[so], key)
        Cv = _set_drop(Cv, dst[so], sv)
    return _set_drop(F, destF, Cv).reshape(S, G)


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


def postprocess(val, xch, nib, lane_of_np, lane_starts_np, n: int,
                meta_cache: dict | None = None):
    """Full post-pass: channels -> (succs2d int32, starts_flat, degs,
    tabs). meta_cache (mutated) keeps the dirty-chain layout and, for the
    steady state, the marker layout and the fixup index cache."""
    dev = val.device
    mc = meta_cache if meta_cache is not None else {}
    if "order_d" in mc:
        return _post_fused(val, xch, nib, mc["lane_of_d"], mc["order_d"],
                           mc["cpos_d"], mc["pdirty_d"], mc["parent_d"], n,
                           mc["roffs"], mc["Dall"])
    lane_of = trace.upload(np.ascontiguousarray(lane_of_np, np.int32), dev)
    tabs = extract_node_tables(val, xch, nib, lane_of, n)
    if "ddep" not in mc:
        kind = trace.fetch(tabs["kind"])
        ref = trace.fetch(tabs["ref"])
        span = trace.fetch(tabs["span"])
        parent = np.maximum(np.arange(n) - ref, 0)
        dirty = kind == 1
        hasref = ref > 0
        # dirty-chain depth: clean 0; dirty 1 + the depth of its (maybe
        # dirty) parent; a dirty node without a reference has depth 1
        ddep = np.where(dirty, 1, 0).astype(np.int32)
        for _ in range(4096):
            upd = dirty & hasref & (ddep <= ddep[parent])
            if not upd.any():
                break
            ddep = np.where(upd, ddep[parent] + 1, ddep)
        else:
            raise RuntimeError("dirty chains deeper than 4096")
        if int(ddep.max()) > 192:
            # each chain level is one fixup round
            raise RuntimeError(
                f"dirty chains {int(ddep.max())} rounds deep "
                "(fixup supports <= 192)")
        mc["ddep"] = ddep
        mc["parent"] = parent.astype(np.int32)
        mc["rounds"] = int(ddep.max())
        # compact-fixup layout: dirty nodes in (chain depth, node) order
        didx = np.nonzero(dirty)[0]
        dd_sort = np.argsort(ddep[didx] * (n + 1.0) + didx, kind="stable")
        order = didx[dd_sort].astype(np.int32)
        spans_o = span[order].astype(np.int64)
        obase = np.concatenate([[0], np.cumsum(spans_o)])
        cpos = np.full(n, 0, np.int32)
        cpos[order] = obase[:-1].astype(np.int32)
        roffs = []
        lo = 0
        hi_need = 1
        for r in range(1, mc["rounds"] + 1):
            tlen = int(spans_o[ddep[order] == r].sum())
            lpad = _quant(tlen + 1)
            roffs.append((lo, lpad, tlen))
            hi_need = max(hi_need, lo + lpad)
            lo += tlen
        # Dall covers every padded slice
        mc["Dall"] = _quant(max(lo, hi_need) + 1)
        mc["roffs"] = tuple(roffs)
        mc["order_np"] = order
        mc["cpos_np"] = cpos
        mc["pdirty_np"] = dirty
    mc["lane_of_d"] = lane_of
    mc["parent_d"] = trace.upload(mc["parent"], dev)
    order_p = np.full(max(len(mc["order_np"]), 1), -1, np.int32)
    order_p[:len(mc["order_np"])] = mc["order_np"]
    mc["order_d"] = trace.upload(order_p, dev)
    mc["cpos_d"] = trace.upload(mc["cpos_np"], dev)
    mc["pdirty_d"] = trace.upload(mc["pdirty_np"], dev)
    # marker layout for the steady state: rows, kinds and starts of a
    # deterministic kernel on a fixed artifact (values and degrees are
    # decoded again on every call)
    S, G = val.shape
    mc["mrow_d"] = tabs["mrow"]
    mc["kind_d"] = tabs["kind"]
    mc["starts_flat_d"] = tabs["start_el"] * G + lane_of
    if mc["roffs"] and "fx_offs" not in mc:
        mc["span_np"] = trace.fetch(tabs["span"]).astype(np.int64)
        mc["start_el_np"] = trace.fetch(tabs["start_el"]).astype(np.int64)
        mc["deg_np"] = trace.fetch(tabs["deg"]).astype(np.int64)
        mc["lane_of_np"] = np.asarray(lane_of_np).astype(np.int64)
        mc["G"], mc["SG"] = G, S * G
        build_fixup_cache(mc, fixup_provider(val, nib), dev)
    elif "fx_offs" not in mc:
        mc["fx_offs"] = ()
        mc["fx_nodes"] = torch.zeros((0, 5), dtype=I32, device=dev)
        mc["fx_srcs"] = torch.zeros(0, dtype=I32, device=dev)
    return _post_fused(val, xch, nib, lane_of, mc["order_d"], mc["cpos_d"],
                       mc["pdirty_d"], mc["parent_d"], n, mc["roffs"],
                       mc["Dall"])


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
