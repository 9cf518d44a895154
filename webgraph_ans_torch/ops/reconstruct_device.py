"""Successor-list reconstruction on the device from aux-mode decode output.

Turns decode_blocks(emit_aux=True) output into a CSR adjacency with
PyTorch operations on the output's device: the port of the JAX package's
sort-path reconstructor (webgraph_ans_tpu/ops/reconstruct_device.py), which
is XLA operations there, so plain PyTorch here. The reference capability is
the successor reconstruction of webgraph's BvGraph (executable spec:
native/src/bvgraph.hpp read_successors).

In aux mode the decode kernel emits, per token, two extra rows with
pre-resolved reconstruction fields:

- residual tokens: aux1 = the absolute successor value, aux2 = the
  node-local grouped element index (copies + intervals + prior residuals);
- interval start/len tokens: aux1 = the absolute left extreme, aux2 = the
  node-local grouped element start of the run;
- block tokens: aux1 = the running block-length sum (start of this block
  inside the referenced list), aux2 = (copied-so-far << 1) | is_copy;
- one summary pseudo-step per node (nibble 0x9): value = ncop,
  aux1 = niv, aux2 = tail_len.

`parse_stats` turns these into per-node tables (outdegree, reference,
parent, reference-chain depth, copy and interval counts); `assemble`
scatters every run's packed value at its first element, broadcasts it over
the run with one last-valid scan, sorts each node's segment, then resolves
copies round by round in reference-chain depth order: round k gathers the
copied elements of depth-k nodes from their already sorted parents and
re-sorts. Chains past the 64-bucket depth histogram (high-compression
artifacts; cnr-2000 hc reaches depth 4506) take `_deep_rounds`, one masked
round per depth. `reconstruct_device` is the entry point; its `meta_cache`
lets a caller that decodes one artifact repeatedly skip the one host
fetch that shapes the assembly.

What existed in the reference only for XLA or the TPU is not carried over:
the two-level blocked cumulative sums and scans, the buffer padding of each
round's slice, the split of the assembly into two programs past a compiler
memory limit, and the chunking of the deep rounds into bounded programs.
The outputs are identical: offsets, succs[:E], E and the meta vector.

Component ids: 0 outdegree, 1 reference, 2 block count, 3 block,
4 interval count, 5 interval start, 6 interval len, 7 first residual,
8 residual gap, 9 node summary, 0xF invalid (see ops/decode_torch.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import trace

from .decode_torch import NIB_SUM, P_BLK, P_IS, P_OUT, P_REF, UNROLL

I32 = torch.int32
DEPTH_BUCKETS = 64      # the meta vector's reference-depth histogram
# The device layouts are addressed by int32 flat indices and summed by
# int32 running sums (a [rows, L] array's row * L + lane, emit_post's
# starts_flat, _cumsum), which wrap at this many elements: the planners
# refuse a layout that reaches it (64-bit indices are not implemented).
FLAT_LIMIT = 1 << 31


class LayoutTooLarge(ValueError):
    """A layout past the int32 flat indices (check_flat)."""


def check_flat(layout: str, size: int, sizes: dict | None = None) -> None:
    """Raises LayoutTooLarge (a ValueError) naming `layout` when its
    `size` elements reach FLAT_LIMIT; otherwise records in `sizes` (when
    given) the largest size of each layout seen."""
    if size >= FLAT_LIMIT:
        raise LayoutTooLarge(
            f"the {layout} layout holds {size} elements, past the "
            f"{FLAT_LIMIT} that its int32 flat indices reach: a graph this "
            "large needs 64-bit indices")
    if sizes is not None:
        sizes[layout] = max(sizes.get(layout, 0), int(size))


def _quant(x: int) -> int:
    """Buffer-size quantizer: smallest m<<k >= x with m in 4..7 (1, 1.25,
    1.5, 1.75 times a power of two), minimum 16."""
    x = max(int(x), 16)
    k = max(x.bit_length() - 3, 0)
    return -(-x >> k) << k


def unpack_nibbles(cpk: torch.Tensor, rows: int) -> torch.Tensor:
    """[rows//8, L] packed nibble words -> [rows, L] int32 codes."""
    shifts = torch.arange(UNROLL, dtype=torch.int64, device=cpk.device) * 4
    words = cpk.long() & 0xFFFFFFFF
    return ((words[:, None, :] >> shifts[None, :, None]) & 0xF).reshape(
        rows, -1).to(I32)


def _unpack4(out: torch.Tensor, cap: int):
    """Aux-mode decode output -> step-major (v, a1, a2, nib) [cap, L]
    int32 arrays; lane l's tokens run down column l."""
    return (out[:cap], out[cap:2 * cap], out[2 * cap:3 * cap],
            unpack_nibbles(out[3 * cap:], cap))


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """int32 inclusive cumulative sum along the last axis (wrapping as an
    int32 sum does), as one scan of the flattened array with each row's
    carry taken back out: PyTorch scans a 1-D tensor with CUB, but runs a
    few long rows through a kernel that took 12 ms of a 39 ms
    reconstruction on an H100 (tools/sort_path_profile.py)."""
    cs = torch.cumsum(x.reshape(-1), 0, dtype=I32)
    if x.dim() == 1:
        return cs
    cs = cs.reshape(-1, x.shape[-1])
    carry = torch.cat([cs.new_zeros(1), cs[:-1, -1]])
    return (cs - carry[:, None]).reshape(x.shape)


def _excl(cs: torch.Tensor) -> torch.Tensor:
    """Exclusive cumulative sum from an inclusive one (prepends 0)."""
    return torch.cat([cs.new_zeros(1), cs])


def _cumsum_tok(x: torch.Tensor) -> torch.Tensor:
    """int32 cumulative sum in token (column-major) order over step-major
    [..., rows, L] arrays."""
    lead, (rows, L) = x.shape[:-2], x.shape[-2:]
    flat = x.transpose(-1, -2).reshape(*lead, L * rows)
    return _cumsum(flat).reshape(*lead, L, rows).transpose(-1, -2)


def _tok_gather(x2d: torch.Tensor, m: torch.Tensor, cap: int):
    """x2d[m % cap, m // cap] for lane-major flat token indices m (clamped
    into the array, as an XLA gather clamps)."""
    G = x2d.shape[1]
    flat = x2d.reshape(-1)
    idx = torch.clamp((m % cap) * G + m // cap, 0, flat.numel() - 1)
    return flat[idx.long()]


def _set_drop(size: int, idx: torch.Tensor, vals: torch.Tensor):
    """int32 [size] zeros with out[idx] = vals; indices outside [0, size)
    are dropped (they land in a sink slot past the end). The live indices
    of every caller are unique, so the result does not depend on the
    order of the writes."""
    idx = idx.long()
    idx = torch.where((idx >= 0) & (idx < size), idx, size)
    out = torch.zeros(size + 1, dtype=I32, device=vals.device)
    out[idx] = vals.to(I32)
    return out[:size]


def _fill_forward(valid: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Each slot takes vals at the last valid slot at or before it along
    the last axis, 0 before a row's first one. One flat cumulative count
    of the valid slots numbers them, a scatter lays their values out in
    that order and a gather reads each slot's back: no cummax, whose
    PyTorch scan took 18 ms over a 3.7M-slot row on an H100
    (tools/sort_path_profile.py)."""
    N = valid.shape[-1]
    v = valid.reshape(-1)
    seen = torch.cumsum(v, 0, dtype=I32)        # valid slots up to here
    table = vals.new_zeros(v.numel() + 1)
    table[torch.where(v, seen - 1, v.numel()).long()] = vals.reshape(-1)
    out = table[torch.clamp(seen - 1, min=0).long()].view(-1, N)
    # a slot with none of its row's valid slots at or before it takes 0:
    # compare with the count of valid slots before the row
    seen = seen.view(-1, N)
    before = torch.cat([seen.new_zeros(1), seen[:-1, -1]])
    return torch.where(seen > before[:, None], out, 0).reshape(valid.shape)


def _ffill_valid(ch: torch.Tensor) -> torch.Tensor:
    """Forward-fill of the last value with bit 0 set along the last axis
    (channels pack run values as (val << 1) | 1; unseeded slots are 0,
    and 0 fills the slots before the first valid one)."""
    return _fill_forward((ch & 1) == 1, ch)


def _scatter_add_rows(C: int, size: int, idx_n, deltas):
    """[C, size] scatter-add of per-channel deltas [C, n] at the shared
    column indices idx_n [n]; indices outside [0, size) are dropped.
    Integer sums do not depend on the order of the adds."""
    idx = idx_n.long()
    idx = torch.where((idx >= 0) & (idx < size), idx, size)
    out = torch.zeros((C, size + 1), dtype=I32, device=deltas.device)
    out.index_add_(1, idx, deltas.to(I32))
    return out[:, :size]


def _bcast_runs_multi(size: int, starts_n, vals_list, mask_n):
    """Broadcasts vals[i] over [starts_n[i], starts_n[next masked i]) of a
    length-`size` array for masked nodes (0 before the first), for several
    value channels sharing (starts, mask): one stable n-scale argsort, one
    delta scatter and one cumulative sum."""
    key = torch.where(mask_n, starts_n, size)
    order = torch.argsort(key, stable=True)
    st = key[order]
    sv = torch.stack([v[order] for v in vals_list])
    delta = sv - torch.cat([sv.new_zeros((len(vals_list), 1)), sv[:, :-1]],
                           dim=1)
    return _cumsum(_scatter_add_rows(len(vals_list), size, st, delta))


def _depth_order(depth, ncop):
    """Nodes ordered by (reference-chain depth, node): pi = the order,
    cb = each node's copy-element base within that order (indexed by the
    original node id)."""
    n = depth.shape[0]
    pi = torch.argsort(depth, stable=True)
    cb = torch.empty(n, dtype=I32, device=depth.device)
    cb[pi] = _excl(_cumsum(ncop[pi]))[:n]
    return pi, cb


def _sort2(k1: torch.Tensor, k2: torch.Tensor):
    """Sorts pairs (k1, k2) of int32 keys lexicographically as one int64
    sort of k1 << 32 | (k2 + 2^31). Returns the sorted (k1, k2)."""
    key = (k1.long() << 32) + (k2.long() + (1 << 31))
    s = torch.sort(key).values
    return (s >> 32).to(I32), ((s & 0xFFFFFFFF) - (1 << 31)).to(I32)


def sort_segments(seg: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """s ordered by (seg, s): each segment's values sorted by value, the
    segments in order of their ids."""
    return _sort2(seg, s)[1]


def _chain_depth(parent, has_ref, depth_iters: int):
    """Reference-chain depth: 0 without a reference, the parent's depth + 1
    otherwise, by pointer jumping (ceil(log2 n) rounds of two gathers, no
    host synchronisation). A node whose chain never reaches a node without
    a reference (node 0 referencing itself on a corrupt stream) gets -1,
    as the reference's wavefront leaves it. depth_iters > 0 resolves only
    chains up to that depth (deeper ones get -1), as the reference's
    wavefront unrolled that many rounds does."""
    n = parent.shape[0]
    ids = torch.arange(n, dtype=I32, device=parent.device)
    anc = torch.where(has_ref, parent, ids).long()
    dist = has_ref.to(I32)
    for _ in range(max(1, (n - 1).bit_length())):
        dist = dist + dist[anc]
        anc = anc[anc]
    depth = torch.where(has_ref[anc], -1, dist)
    if depth_iters > 0:
        depth = torch.where(depth > depth_iters, -1, depth)
    return depth.to(I32)


def parse_stats(out: torch.Tensor, num_nodes: int, cap: int,
                depth_iters: int = 0) -> dict:
    """Pass 1: step-major token arrays and per-node tables of an aux-mode
    decode ([3cap + cap//8, L] int32 output of decode_blocks(emit_aux=True),
    lanes in node order), after one token-order cumulative sum and one
    token -> 2n scatter (node starts and node summaries). Returns int32
    tensors on out's device: v a1 a2 nib (the token arrays), sp (each
    node's outdegree-token position), d, ref, offsets [n+1], ncop, niv,
    tail, parent = x - ref (clamped into [0, n)), depth, and the meta
    vector [ok, total_iv, total_cop, max_depth, hist64...] (copy elements
    by reference-chain depth, the last bucket holding every depth >= 63),
    the one value the host fetches to shape pass 2.

    depth_iters > 0 (the cached-meta steady path passes the known maximum
    depth) resolves chains up to that depth only; deeper ones then
    surface as ok = 0 and depth 0."""
    n = num_nodes
    dev = out.device
    v, a1, a2, nib = _unpack4(out, cap)
    G = v.shape[1]
    rows = torch.arange(cap, dtype=I32, device=dev)[:, None]
    cols = torch.arange(G, dtype=I32, device=dev)[None, :]
    pos = (cols * cap + rows).expand(cap, G)      # lane-major flat index
    is_out = nib == P_OUT
    is_sum = nib == NIB_SUM

    nd = torch.clamp(_cumsum_tok(is_out.to(I32)) - 1, 0, n - 1)
    # one scatter finds each node's outdegree-token and summary positions
    idx = torch.where(is_out, nd, torch.where(is_sum, n + nd, 2 * n))
    spp = _set_drop(2 * n, idx.reshape(-1), pos.reshape(-1))
    sp, ssp = spp[:n], spp[n:]

    d = _tok_gather(v, sp, cap)
    ref = torch.where(_tok_gather(nib, sp + 1, cap) == P_REF,
                      _tok_gather(v, sp + 1, cap), 0).to(I32)
    ids = torch.arange(n, dtype=I32, device=dev)
    parent = torch.clamp(ids - ref, 0, n - 1)
    has_ref = ref > 0
    ncop = _tok_gather(v, ssp, cap)
    niv = _tok_gather(a1, ssp, cap)
    tail = _tok_gather(a2, ssp, cap)
    offsets = _excl(_cumsum(d))
    ok = (ncop + niv <= d).all() & (tail <= ncop).all()

    depth = _chain_depth(parent, has_ref, depth_iters)
    if depth_iters > 0:
        ok = ok & (depth >= 0).all()
        depth = torch.clamp(depth, min=0)
    hist = torch.zeros(DEPTH_BUCKETS, dtype=I32, device=dev).index_add_(
        0, torch.clamp(depth, 0, DEPTH_BUCKETS - 1).long(), ncop)
    meta = torch.cat([torch.stack([ok.to(I32), niv.sum().to(I32),
                                   ncop.sum().to(I32), depth.max()]), hist])
    return dict(v=v, a1=a1, a2=a2, nib=nib, sp=sp, d=d, ref=ref,
                offsets=offsets, ncop=ncop, niv=niv, tail=tail,
                parent=parent, depth=depth, meta=meta)


def fill_slice(succs_x, F, slot, src):
    """Resolves one depth round's copy elements: gathers their sources
    from the sorted array F and writes them at their slots of the grouped
    succs, in place. succs_x has one sink slot past its Epad elements, where
    the worklist's dead entries (slot Epad) land; the live slots are
    unique (one per copied element)."""
    succs_x[slot.long()] = F[src.long()]


def _assemble_body(v, a1, a2, nib, sp, offsets, ncop, niv, parent, depth,
                   Epad: int, Ccap: int):
    """Pass 2, before the sort: the combined run/element scatter, the two
    last-valid scans and the element-space node tables. Returns (succs
    [Epad + 1] grouped elements with a sink slot at Epad, seg [Epad], ffC
    [Ccap] the copy channel: each copy element's packed source base)."""
    cap, G = v.shape
    n = sp.shape[0]
    dev = v.device
    # previous token in column-major order: shift down one row, column
    # heads take the previous column's last row
    prev_nib = torch.cat([
        torch.cat([torch.full((1, 1), 0xF, dtype=I32, device=dev),
                   nib[-1:, :-1]], dim=1),
        nib[:-1, :]], dim=0)
    is_blk = nib == P_BLK
    b = v + (is_blk & (prev_nib == P_BLK)).to(I32)
    is_is = nib == P_IS
    is_res = (nib == 7) | (nib == 8)
    is_sum = nib == NIB_SUM

    _, cb = _depth_order(depth, ncop)

    # per-token broadcast of the per-node tables: one [4, cap, G] delta
    # scatter at the node-start positions and one token-order cumsum
    bvals = torch.stack([
        offsets[:n],                              # 0: off_x
        offsets[parent.long()],                   # 1: off_par
        offsets[torch.clamp(parent + 1, max=n).long()],   # 2: off_par end
        cb,                                       # 3: copy-channel base
    ])
    deltas = bvals - torch.cat([bvals.new_zeros((4, 1)), bvals[:, :-1]],
                               dim=1)
    spf = (sp % cap) * G + sp // cap            # flat step-major index
    bb = _cumsum_tok(_scatter_add_rows(4, cap * G, spf, deltas)
                     .reshape(4, cap, G))
    off_x, off_par, off_pend, cbx = bb[0], bb[1], bb[2], bb[3]

    # the combined scatter: each token contributes at most one update,
    # into three disjoint regions (residual values into succs,
    # interval-run seeds, copy-run seeds)
    own = is_blk & ((a2 & 1) == 1) & (b > 0)       # copy blocks
    tl = is_sum & (a2 > 0)                         # reference tails
    qs_own = cbx + (a2 >> 1)
    qs_tl = cbx + v - a2
    BIG = 2 * Epad + Ccap
    idx = torch.where(is_res, off_x + a2,
          torch.where(is_is, Epad + off_x + a2,
          torch.where(own, 2 * Epad + qs_own,
          torch.where(tl, 2 * Epad + qs_tl, BIG))))
    val = torch.where(is_res, a1,
          torch.where(is_is, ((a1 - (off_x + a2)) << 1) | 1,
          torch.where(own, ((off_par + a1 - qs_own) << 1) | 1,
                      ((off_pend - a2 - qs_tl) << 1) | 1)))
    buf = _set_drop(BIG + 1, idx.reshape(-1), val.reshape(-1))

    # run-value broadcast: the last-valid scans of the two run channels
    ffA = _ffill_valid(buf[Epad:2 * Epad])
    ffC = _ffill_valid(buf[2 * Epad:2 * Epad + Ccap])

    # element-space node tables over Epad: one stacked scatter at the
    # node element bases and one stacked cumsum
    evals = torch.stack([
        torch.arange(n, dtype=I32, device=dev),   # segment id
        offsets[:n] + ncop,                       # copy/interval boundary
        offsets[:n] + ncop + niv,                 # interval/residual bound
    ])
    edeltas = evals - torch.cat([evals.new_zeros((3, 1)), evals[:, :-1]],
                                dim=1)
    st = torch.clamp(offsets[:n], max=Epad)
    eb = _cumsum(_scatter_add_rows(3, Epad, st, edeltas))
    g = torch.arange(Epad, dtype=I32, device=dev)
    # padding elements (g >= E) sort after every real segment
    seg = torch.where(g >= offsets[n], n, eb[0])
    is_iv_el = (g >= eb[1]) & (g < eb[2])
    succs = torch.where(is_iv_el, (ffA >> 1) + g, buf[:Epad])
    return torch.cat([succs, succs.new_zeros(1)]), seg, ffC


def _copy_worklist(offsets, ncop, depth, ffC, total_cop, Epad: int,
                   Ccap: int, with_depth: bool = False):
    """The copy elements in (reference-chain depth, node) order: each
    one's destination slot (Epad for the dead tail past total_cop) and its
    source position in the sorted array, and with_depth its node's depth
    as well."""
    n = ncop.shape[0]
    _, cb = _depth_order(depth, ncop)
    q = torch.arange(Ccap, dtype=I32, device=ncop.device)
    chans = [offsets[:n] - cb] + ([depth] if with_depth else [])
    bc = _bcast_runs_multi(Ccap, cb, chans, ncop > 0)
    live = q < total_cop
    slot = torch.where(live, bc[0] + q, Epad)
    src = torch.where(live, torch.clamp((ffC >> 1) + q, 0, Epad - 1), 0)
    return slot, src, (bc[1] if with_depth else None)


def _rounds_body(offsets, succs_x, seg, ffC, ncop, depth, total_cop,
                 Epad: int, Ccap: int, hist_key: tuple):
    """Segment sort and the depth-resolution rounds: round k resolves the
    hist_key[k-1] copy elements of depth-k nodes, a contiguous slice of
    the worklist. Returns (F, succs_x)."""
    F = sort_segments(seg, succs_x[:Epad])
    if hist_key:
        slot, src, _ = _copy_worklist(offsets, ncop, depth, ffC, total_cop,
                                      Epad, Ccap)
        off = 0
        for cnt in hist_key:
            if cnt == 0:
                continue
            fill_slice(succs_x, F, slot[off:off + cnt], src[off:off + cnt])
            F = sort_segments(seg, succs_x[:Epad])
            off += cnt
    return F, succs_x


def assemble(st: dict, total_cop, Epad: int, Ccap: int, hist_key: tuple):
    """Pass 2 on parse_stats' tables: _assemble_body, then the segment
    sort and the rounds of hist_key (the copy-element counts at depths 1,
    2, ...; empty when nothing is copied). total_cop may be a device
    scalar. Returns (F [Epad] sorted node-order CSR, succs_x, seg, ffC)."""
    succs_x, seg, ffC = _assemble_body(
        st["v"], st["a1"], st["a2"], st["nib"], st["sp"], st["offsets"],
        st["ncop"], st["niv"], st["parent"], st["depth"], Epad, Ccap)
    F, succs_x = _rounds_body(st["offsets"], succs_x, seg, ffC, st["ncop"],
                              st["depth"], total_cop, Epad, Ccap, hist_key)
    return F, succs_x, seg, ffC


def parse_and_assemble(out, num_nodes: int, cap: int, Epad: int, Ccap: int,
                       hist_key: tuple, depth_iters: int = 0):
    """The whole reconstruction without a host synchronisation, usable
    once the meta vector is known (cached from an earlier call on the same
    artifact). Returns (offsets, F, meta): the caller verifies meta
    against its cache afterwards."""
    st = parse_stats(out, num_nodes, cap, depth_iters=depth_iters)
    F, _, _, _ = assemble(st, st["meta"][2], Epad, Ccap, hist_key)
    return st["offsets"], F, st["meta"]


def _hist_key(meta, max_depth: int) -> tuple:
    """The copy-element counts of depths 1..max_depth from the meta
    vector's histogram (empty when nothing is copied)."""
    if not (int(meta[2]) and max_depth > 0):
        return ()
    return tuple(int(c) for c in meta[5:5 + max_depth])


def reconstruct_device(out, num_nodes: int, num_arcs: int, cap: int,
                       meta_cache: dict | None = None):
    """Full-graph reconstruction on out's device from
    decode_blocks(emit_aux=True) output [3cap + cap//8, L] (lanes in node
    order). Returns (offsets [n+1] int32, succs [Epad] int32, E) on that
    device, with the successor lists in succs[:E]; raises ValueError on an
    inconsistent token stream, or on an element space past the int32
    flat indices (check_flat; its size is recorded in
    meta_cache["flat_sizes"]).

    `meta_cache` (optional, mutated): the meta vector of pass 1 is the one
    value the host needs before it can shape pass 2, so fetching it is the
    one blocking synchronisation. A caller that decodes one artifact
    repeatedly passes a dict: after the first call the cached meta shapes
    pass 2 at once, and the meta fetched at the end only verifies the
    cache (a mismatch drops it and raises ValueError)."""
    n, E = num_nodes, int(num_arcs)
    cached = meta_cache.get("meta") if meta_cache is not None else None
    sizes = (meta_cache.setdefault("flat_sizes", {})
             if meta_cache is not None else None)

    def element_space(total_cop: int):
        Epad, Ccap = _quant(E + 1), _quant(total_cop)
        check_flat("sort-path element space [2 Epad + Ccap]",
                   2 * Epad + Ccap + 1, sizes)
        return Epad, Ccap

    if cached is not None and int(cached[3]) < DEPTH_BUCKETS - 1:
        max_depth = int(cached[3])
        offsets, F, meta_d = parse_and_assemble(
            out, n, cap, *element_space(int(cached[2])),
            _hist_key(cached, max_depth), depth_iters=max(max_depth, 1))
        if not np.array_equal(trace.fetch(meta_d), cached):
            meta_cache.pop("meta", None)
            raise ValueError(
                "token stream changed under a cached reconstruction meta")
        return offsets, F, E

    st = parse_stats(out, n, cap)
    meta = trace.fetch(st["meta"])
    if not bool(meta[0]):
        raise ValueError("token stream inconsistent")
    if meta_cache is not None:
        meta_cache["meta"] = meta
    total_cop, max_depth = int(meta[2]), int(meta[3])
    Epad, Ccap = element_space(total_cop)
    if max_depth < DEPTH_BUCKETS - 1:
        F, _, _, _ = assemble(st, total_cop, Epad, Ccap,
                              _hist_key(meta, max_depth))
        return st["offsets"], F, E

    # The depth histogram saturates (hc-style unbounded chains): resolve
    # with one masked round per depth over the whole worklist.
    F, succs_x, seg, ffC = assemble(st, total_cop, Epad, Ccap, ())
    slot, src, dep_el = _copy_worklist(st["offsets"], st["ncop"],
                                       st["depth"], ffC, total_cop, Epad,
                                       Ccap, with_depth=True)
    F = _deep_rounds(succs_x, F, seg, slot, src, dep_el, max_depth)
    return st["offsets"], F, E


def _deep_rounds(succs_x, F, seg, slot, src, dep_el, max_depth: int):
    """Masked depth rounds 1..max_depth: fill the depth-k copy slots from
    the sorted parents, re-sort, repeat. Returns the final F."""
    Epad = seg.shape[0]
    for k in range(1, max_depth + 1):
        fill_slice(succs_x, F, torch.where(dep_el == k, slot, Epad), src)
        F = sort_segments(seg, succs_x[:Epad])
    return F
