"""Successor-list reconstruction from decoded (component, value) tokens.

The reference reconstructs successor lists serially, one node at a time,
resolving copy-list references recursively (executable spec:
native/src/bvgraph.hpp read_successors). Here this becomes a data-parallel
pipeline over ALL nodes at once:

1. parse (host, numpy): flat token stream -> per-node fields (outdegree,
   reference, copy blocks, intervals, residual gaps) with mask/segment ops;
2. prefill (host): interval expansions and residual gap prefix-sums are
   reference-free, computed for every node in one shot;
3. rounds (device, PyTorch): nodes at reference-chain depth k copy from
   their already-resolved-and-sorted referenced list via one gather and
   scatter, then one sort of the int64 key (segment << 32 | successor)
   re-sorts every successor list. Chain depth is bounded by max_ref_count
   (default 3), so a handful of rounds replaces the per-node recursion.
   Deeper chains (high-compression artifacts) resolve on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import trace

from .decode_torch import resolve_device


# ---- host helpers (vectorized numpy) ----

def _np_nat2int(v):
    """Inverse of int2nat: even v -> v/2, odd v -> -(v/2)-1."""
    v = np.asarray(v, dtype=np.int64)
    return np.where(v & 1 == 1, -((v >> 1) + 1), v >> 1)


def _np_seg_cumsum(vals, firsts):
    """Inclusive cumulative sum over flat `vals`, restarting wherever
    `firsts` is True. Works for signed values."""
    vals = np.asarray(vals, dtype=np.int64)
    c = np.cumsum(vals)
    seg_idx = np.cumsum(firsts) - 1
    bases = (c - vals)[firsts]
    return c - bases[seg_idx]


def _np_intra_count(seg_ids):
    """Position of each element within its (contiguous) run of equal ids."""
    k = len(seg_ids)
    if k == 0:
        return np.zeros(0, np.int64)
    firsts = np.ones(k, bool)
    firsts[1:] = seg_ids[1:] != seg_ids[:-1]
    return _np_seg_cumsum(np.ones(k, np.int64), firsts) - 1


def _np_ragged(lengths, total):
    """(segment index, intra position) for positions 0..total-1 laid out as
    consecutive segments of the given lengths (zero lengths allowed)."""
    cum = np.cumsum(lengths)
    pos = np.arange(total)
    seg = np.searchsorted(cum, pos, side="right")
    starts = cum - lengths
    return seg, pos - starts[seg]


def reconstruct(values: np.ndarray, comps: np.ndarray, num_nodes: int,
                min_interval: int, node_ids: np.ndarray | None = None,
                device=None):
    """Reconstructs the CSR adjacency (offsets u64, succs u32) from the
    forward-order token stream.

    With node_ids=None the stream covers nodes 0..num_nodes-1 in order.
    Otherwise it covers exactly the nodes listed in node_ids (ascending
    unique graph node ids, num_nodes of them) — used by random access,
    where the decoded set is the query set plus its reference closure; the
    set must be closed under references (x in set and x references x-r
    implies x-r in set).

    The gather/sort rounds run on `device` (CUDA by default; raises when
    CUDA is missing and no device was given)."""
    device = resolve_device(device)
    values = np.asarray(values, dtype=np.int64)
    comps = np.asarray(comps, dtype=np.int8)

    # ---- per-node field extraction ----
    is_out = comps == 0
    node_of = np.cumsum(is_out) - 1
    d = values[is_out].astype(np.int64)
    n = num_nodes
    if len(d) != n:
        raise ValueError(f"expected {n} outdegree tokens, got {len(d)}")
    if node_ids is None:
        gid = np.arange(n, dtype=np.int64)       # local index -> graph node id
        local_of_gid = None
    else:
        gid = np.asarray(node_ids, dtype=np.int64)
        if len(gid) != n or not np.all(np.diff(gid) > 0):
            raise ValueError("node_ids must be num_nodes ascending unique ids")
        local_of_gid = True  # sentinel: use searchsorted mapping below

    ref = np.zeros(n, np.int64)
    m = comps == 1
    ref[node_of[m]] = values[m]
    has_ref = ref > 0

    bc = np.zeros(n, np.int64)
    m = comps == 2
    bc[node_of[m]] = values[m]

    m = comps == 3
    blk_node = node_of[m]
    blk_raw = values[m]
    blk_first = np.ones(len(blk_node), bool)
    blk_first[1:] = blk_node[1:] != blk_node[:-1]
    # block i>0 is stored minus one (native/src/bvgraph.hpp:65)
    blocks = blk_raw + (~blk_first)

    m5 = comps == 5
    m6 = comps == 6
    iv_node = node_of[m5]
    iv_start_tok = values[m5].astype(np.int64)
    iv_len = values[m6] + min_interval

    m7 = comps == 7
    m8 = comps == 8
    fr = np.zeros(n, np.int64)
    fr[node_of[m7]] = values[m7]
    res_gap_node = node_of[m8]
    res_gap = values[m8]
    nres = np.zeros(n, np.int64)
    nres[node_of[m7]] = 1
    np.add.at(nres, res_gap_node, 1)

    # ---- copied-element plan (even-indexed runs copy; even block count
    # also copies the tail of the reference list: bvgraph.hpp:69-82) ----
    if local_of_gid is None:
        parent_local = np.maximum(np.arange(n) - ref, 0)
    else:
        parent_local = np.searchsorted(gid, gid - ref)
        parent_local = np.minimum(parent_local, n - 1)
        if not np.all(gid[parent_local[has_ref]] == (gid - ref)[has_ref]):
            raise ValueError("decoded node set is not closed under references")
    d_ref = np.where(has_ref, d[parent_local], 0)
    blk_idx = _np_intra_count(blk_node)
    run_start = _np_seg_cumsum(blocks, blk_first) - blocks
    is_copy_run = blk_idx % 2 == 0
    blocks_sum = np.zeros(n, np.int64)
    np.add.at(blocks_sum, blk_node, blocks)
    tail_len = np.where(has_ref & (bc % 2 == 0), d_ref - blocks_sum, 0)
    ncop = np.zeros(n, np.int64)
    np.add.at(ncop, blk_node[is_copy_run], blocks[is_copy_run])
    ncop += tail_len

    niv_tot = np.zeros(n, np.int64)
    np.add.at(niv_tot, iv_node, iv_len)
    if not np.all(ncop + niv_tot + nres == d):
        raise ValueError("token stream inconsistent")

    tail_nodes = np.nonzero(tail_len)[0]
    cop_runs_node = np.concatenate([blk_node[is_copy_run], tail_nodes])
    cop_runs_start = np.concatenate([run_start[is_copy_run], blocks_sum[tail_nodes]])
    cop_runs_len = np.concatenate([blocks[is_copy_run], tail_len[tail_nodes]])
    keep = cop_runs_len > 0
    cop_runs_node, cop_runs_start, cop_runs_len = (
        cop_runs_node[keep], cop_runs_start[keep], cop_runs_len[keep])
    order = np.lexsort((cop_runs_start, cop_runs_node))
    cop_runs_node = cop_runs_node[order]
    cop_runs_start = cop_runs_start[order]
    cop_runs_len = cop_runs_len[order]

    # ---- reference-chain depths: the steps from each node to the root
    # of its chain, by pointer jumping (ceil(log2 depth) + 1 rounds) ----
    depth = has_ref.astype(np.int64)
    up = np.where(has_ref, parent_local, np.arange(n))
    for _ in range(max(n, 1).bit_length() + 1):
        open_ = has_ref[up]
        if not open_.any():
            break
        depth = depth + np.where(open_, depth[up], 0)
        up = up[up]
    else:
        raise ValueError("reference chains do not resolve")
    max_depth = int(depth.max(initial=0))

    # ---- CSR layout ----
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(d, out=offsets[1:])
    E = int(offsets[-1])
    seg_of_slot = np.repeat(np.arange(n), d)

    succs = np.zeros(E, np.int64)

    # interval expansion: left_0 = x + nat2int(s_0); left_i = prev + s_i + 1
    if len(iv_node):
        iv_first = np.ones(len(iv_node), bool)
        iv_first[1:] = iv_node[1:] != iv_node[:-1]
        prev_len = np.zeros(len(iv_len), np.int64)
        prev_len[1:] = np.where(iv_first[1:], 0, iv_len[:-1])
        b = np.where(iv_first, gid[iv_node] + _np_nat2int(iv_start_tok),
                     iv_start_tok + 1) + prev_len
        lefts = _np_seg_cumsum(b, iv_first)
        E_iv = int(iv_len.sum())
        iv_seg, iv_intra = _np_ragged(iv_len, E_iv)
        iv_val_node = iv_node[iv_seg]
        iv_rank = _np_intra_count(iv_val_node)
        succs[offsets[iv_val_node] + ncop[iv_val_node] + iv_rank] = (
            lefts[iv_seg] + iv_intra)

    # residual expansion: r_0 = x + nat2int(fr); r_i = prev + gap + 1
    res_nodes = np.nonzero(nres > 0)[0]
    if len(res_nodes):
        flat_node = np.concatenate([res_nodes, res_gap_node])
        contrib = np.concatenate(
            [gid[res_nodes] + _np_nat2int(fr[res_nodes]), res_gap + 1])
        pos = np.concatenate([np.zeros(len(res_nodes), np.int64),
                              _np_intra_count(res_gap_node) + 1])
        order = np.lexsort((pos, flat_node))
        flat_node = flat_node[order]
        contrib = contrib[order]
        firsts = np.ones(len(flat_node), bool)
        firsts[1:] = flat_node[1:] != flat_node[:-1]
        res_vals = _np_seg_cumsum(contrib, firsts)
        rank = _np_intra_count(flat_node)
        succs[offsets[flat_node] + ncop[flat_node] + niv_tot[flat_node] +
              rank] = res_vals

    # copied plan expansion -> (destination slot, source slot, depth)
    E_cop = int(cop_runs_len.sum())
    if E_cop:
        cop_seg, cop_intra = _np_ragged(cop_runs_len, E_cop)
        cop_node = cop_runs_node[cop_seg]
        cop_refpos = cop_runs_start[cop_seg] + cop_intra
        cop_rank = _np_intra_count(cop_node)
        cop_slot = offsets[cop_node] + cop_rank
        cop_src = offsets[parent_local[cop_node]] + cop_refpos
        cop_depth = depth[cop_node]

    if max_depth <= 8:
        # ---- device rounds: gather copied values, re-sort all segments.
        # Node ids and successors are < 2^31, so (seg << 32 | succ) orders
        # by segment, then by value. ----
        seg_t = trace.upload(seg_of_slot.astype(np.int64), device)
        seg_key = seg_t << 32

        def sort_segments(s):
            return torch.sort(seg_key | s).values & 0xFFFFFFFF

        succs_t = sort_segments(trace.upload(succs, device))
        if E_cop:
            cop_slot_t = trace.upload(cop_slot, device)
            cop_src_t = trace.upload(cop_src, device)
            cop_depth_t = trace.upload(cop_depth, device)
            for k in range(1, max_depth + 1):
                take = cop_depth_t == k
                trace.count("host_syncs", 2)     # two boolean masks
                succs_t[cop_slot_t[take]] = succs_t[cop_src_t[take]]
                succs_t = sort_segments(succs_t)
        return offsets.astype(np.uint64), trace.fetch(succs_t).astype(
            np.uint32)

    # ---- deep-chain fallback (high-compression mode: max_ref_count is
    # effectively unbounded, so chains can be thousands deep): per round,
    # sort only that round's node segments on the host. Total work stays
    # O(E log E) because each segment is sorted exactly once. ----
    # The slots and copies of each depth are grouped once (a stable sort
    # by depth keeps each group ascending), so a round touches only its
    # own.
    def by_depth(dep):
        order = np.argsort(dep, kind="stable")
        bounds = np.searchsorted(dep[order], np.arange(max_depth + 2))
        return [order[bounds[k]:bounds[k + 1]] for k in range(max_depth + 1)]

    slots = by_depth(depth[seg_of_slot])
    cops = by_depth(cop_depth) if E_cop else None
    for k in range(max_depth + 1):
        if k and E_cop and len(cops[k]):
            sel = cops[k]
            succs[cop_slot[sel]] = succs[cop_src[sel]]
        slots_k = slots[k]
        sk = succs[slots_k]
        perm = np.lexsort((sk, seg_of_slot[slots_k]))
        succs[slots_k] = sk[perm]
    return offsets.astype(np.uint64), succs.astype(np.uint32)
