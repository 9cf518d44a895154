"""Merged-emit decode in plain PyTorch: BvGraph decode and successor
reconstruction in one lane-parallel step machine.

The plain version of the CUDA kernel in ops/emit_cuda.py (same contract,
same bits); the TPU kernel both replace is `decode_emit_pallas`
(webgraph_ans_tpu/ops/emit_pallas.py:501). Each step of a lane runs the
rANS grammar FSM of ops/decode_torch.py for one token (stalling when a
queue it must push to is full) into three bounded queues -- copy runs
(QC), interval runs (QI), residual values (QR) -- and a queue of node
metas (QN). An emission side merges the queue heads by value and writes
one final sorted successor per step. Copy values are read back from a
T-row ring of the lane's own emitted rows: ring row = global step & (T-1),
the same row for every lane. Nodes the lane cannot resolve (reference
target before the lane, copy source older than the ring, a queue that
overflows before the node's meta is sent) are written grouped, with
placeholder rows, for the post-pass (ops/emit_post.py).

Output contract (per lane column; emit_post.py has the consumer):
row codes 0 element, 1 first element of a clean node, 2 hole, 3/7/8/9
first row of a dirty node (3 queue overflow, 7 cross-lane parent,
8 tainted parent, 9 ring overflow), 4 placeholder, 5 empty node, 0xF
done; `val` holds the successor (or j / ref), `xch` the node id (or, with
mark_deg, its outdegree) on marker rows.

The register file is [nreg, L] int32 (`_layout`), with the stream
pointers kept apart as absolute int64 words. Queues use the one-hot push
of the reference (a push at a full queue writes nothing but still counts)
and a shift-down pop, so every channel is bit-equal to the TPU kernel's,
including `val` on hole rows (the stale residual-queue head).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import trace

from .decode_torch import (M32, P_BC, P_BLK, P_DONE, P_FR, P_IC, P_IL,
                           P_IS, P_OUT, P_REF, P_RES, UNROLL, DecoderTables,
                           _comp_table, _to_i32, ans_decode_step)

# row codes (match ops/emit_post.py)
C_EL, C_FIRST, C_HOLE, C_REFINFO, C_PLACE, C_EMPTY = range(6)
C_DONE = 0xF

# queue capacities (entries); an over-capacity node goes dirty through the
# early-meta rule, so these bound registers, not correctness
QC, QI, QR, QN = 16, 16, 12, 4

# decode-side register rows
(D_STATE, D_PTR, D_LEFT, D_PHASE, D_D, D_BC, D_BREM, D_BIDX, D_BSUM,
 D_CPY, D_COPIED, D_REFD, D_EXTRA, D_IVREM, D_RESREM, D_XMOD, D_X,
 D_PREVRES, D_IVL, D_FIV, D_REF, D_METASENT,
 # emission-side rows
 E_ACTIVE, E_X, E_XMOD, E_D, E_REF, E_DIRTY, E_EMITTED, E_FIRST,
 E_PBASE, E_CCJ, E_CCLEFT, E_CSRC, E_CIVAL, E_CILEFT, E_DONEROW,
 E_LSTART, E_RSTART, E_MARKROW, E_MDIRTY,
 # queue counters
 N_QC, N_QI, N_QR, N_QN) = range(45)
NFIX = 45
_NAMES = ("state ptr left phase d bc brem bidx bsum cpy copied refd extra "
          "ivrem resrem xmod x prevres ivl fiv ref metasent "
          "e_active e_x e_xmod e_d e_ref e_dirty e_emitted e_first e_pbase "
          "e_ccj e_ccleft e_csrc e_cival e_cileft e_donerow e_lstart "
          "e_rstart e_markrow e_mdirty n_qc n_qi n_qr n_qn").split()
MAX_WINDOW = 16
BIG = 0x7FFFFFFF


def _layout(window: int):
    """Register rows: the fixed rows, then the decode outdegree ring (R),
    the emission base ring (R), the emission dirty ring (R), then the
    queues (2 rows per copy/interval/residual entry, 3 per meta)."""
    R = window + 1
    degring = NFIX
    basering = degring + R
    dirtyring = basering + R
    qc0 = dirtyring + R
    qi0 = qc0 + 2 * QC
    qr0 = qi0 + 2 * QI
    qn0 = qr0 + 2 * QR
    nreg = qn0 + 3 * QN
    return degring, basering, dirtyring, qc0, qi0, qr0, qn0, nreg


def _lane_array(x, dev) -> torch.Tensor:
    """A per-lane integer array (host array or tensor) as int64 on dev; a
    tensor already there is not copied through the host."""
    if isinstance(x, torch.Tensor):
        return x.to(dev, torch.int64)
    return trace.upload(np.ascontiguousarray(x, np.int64), dev)


def emit_init_regs(states, starts, ends, ring, window: int,
                   real_starts=None) -> torch.Tensor:
    """Initial register file [nreg, L] int32 for decode_emit (the rows of
    emit_pallas.emit_init_regs_core, lane-major). states: u32 entry states
    (any integer dtype); starts/ends: lane node ranges (starts may reach
    back into a halo before real_starts, the first node the lane marks);
    ring [L, window+1] the outdegree ring seed. The lane arrays may be
    host arrays or tensors; tensors on ring's device are used there, with
    no host synchronisation. The stream pointers are passed to
    decode_emit separately."""
    R = window + 1
    dev = ring.device
    L = ring.shape[0]
    nreg = _layout(window)[-1]
    starts = _lane_array(starts, dev)
    ends = _lane_array(ends, dev)
    real = starts if real_starts is None else _lane_array(real_starts, dev)
    regs = torch.zeros((nreg, L), dtype=torch.int32, device=dev)
    regs[D_STATE] = _to_i32(_lane_array(states, dev))
    regs[D_LEFT] = (ends - starts).to(torch.int32)
    regs[D_PHASE] = torch.where(starts < ends, P_OUT, P_DONE).to(torch.int32)
    regs[D_XMOD] = (starts % R).to(torch.int32)
    regs[D_X] = starts.to(torch.int32)
    regs[E_X] = starts.to(torch.int32)
    regs[E_XMOD] = (starts % R).to(torch.int32)
    regs[E_LSTART] = starts.to(torch.int32)
    regs[E_RSTART] = real.to(torch.int32)
    degring = _layout(window)[0]
    regs[degring:degring + R] = ring.to(torch.int32).t()
    return regs


def regs_from_jax(init_regs_np: np.ndarray, L: int) -> torch.Tensor:
    """The JAX package's emit register file [nch, nreg, A, 128] (as numpy)
    -> the port's [nreg, L] int32 (the first L lanes). Its D_PTR row holds
    slab-relative pointers, which decode_emit does not read."""
    r = np.asarray(init_regs_np, np.int32)
    nch, nreg, A, lanes = r.shape
    flat = r.transpose(1, 0, 2, 3).reshape(nreg, nch * A * lanes)
    return torch.from_numpy(np.ascontiguousarray(flat[:, :L]))


class _Queue:
    """A bounded register queue [Q, width, L] with the reference's one-hot
    push and shift-down pop."""

    def __init__(self, rows: torch.Tensor, width: int):
        Q = rows.shape[0] // width
        self.q = rows.reshape(Q, width, -1).clone()
        self.slots = torch.arange(Q, device=rows.device)[:, None]

    def push(self, cnt, do, *fields):
        sel = (self.slots == cnt[None, :]) & do[None, :]
        new = torch.stack(torch.broadcast_tensors(*fields))
        self.q = torch.where(sel[:, None, :], new[None], self.q)
        return cnt + do.to(torch.int32)

    def shift(self, cnt, do):
        down = torch.cat([self.q[1:], self.q[-1:]])
        self.q = torch.where(do[None, None, :], down, self.q)
        return cnt - do.to(torch.int32)

    def head(self, f: int):
        return self.q[0, f]


def _sel(rows: torch.Tensor, idx: torch.Tensor, lanes) -> torch.Tensor:
    """rows[idx[l], l]: the R-way ring read of each lane."""
    return rows[idx.long(), lanes]


def decode_emit_plain(tables: DecoderTables, regs: torch.Tensor,
                      ptrs: torch.Tensor, window: int, min_interval: int,
                      cap: int, T: int = 512, mark_deg: bool = False):
    """Merged-emit decode, plain PyTorch on regs' device. regs [nreg, L]
    int32 from emit_init_regs; ptrs [L] int64 absolute entry pointers.
    cap (steps) must be a multiple of 8 and T (ring rows) a power of two.
    mark_deg writes a popped node's outdegree, not its id, into xch.

    Returns (val [cap, L], xch [cap, L], nib [cap//8, L] int32 bit
    patterns, rows_used [L] int32, ok [L] bool, diag [6, L] int32: last
    non-halo marker row and its dirty/empty bits, decode node, emission
    node, active*1e6 + emitted, queue fill, fold_rows [L] int32).

    fold_rows counts, per lane, the rows the CUDA kernel writes by run
    folding, one step a row here: a row that emits from the same copy
    (or interval) run as the row before it, where both rows left the
    decode side idle (stalled or finished) and moved no queue (no early
    meta, no meta pop, no run activation), and the row before it did not
    finish its node."""
    if cap % UNROLL or T & (T - 1) or T < UNROLL:
        raise ValueError(f"cap {cap} must be a multiple of {UNROLL} and T "
                         f"{T} a power of two >= {UNROLL}")
    i32 = torch.int32
    dev = regs.device
    R = window + 1
    degring, basering, dirtyring, qc0, qi0, qr0, qn0, nreg = _layout(window)
    if regs.shape[0] != nreg:
        raise ValueError(f"regs has {regs.shape[0]} rows, expected {nreg}")
    L = regs.shape[1]
    ctab = _comp_table(tables.params, dev)
    lanes = torch.arange(L, device=dev)
    ring_rows = torch.arange(R, device=dev)[:, None]

    r = {k: regs[i].clone() for i, k in enumerate(_NAMES)}
    state = regs[D_STATE].long() & M32
    ptr = ptrs.long().clone()
    deg = regs[degring:degring + R].clone()
    base = regs[basering:basering + R].clone()
    dirt = regs[dirtyring:dirtyring + R].clone()
    qc = _Queue(regs[qc0:qi0], 2)
    qi = _Queue(regs[qi0:qr0], 2)
    qr = _Queue(regs[qr0:qn0], 2)
    qn = _Queue(regs[qn0:nreg], 3)
    ring = torch.empty((T, L), dtype=i32, device=dev)

    val = torch.empty((cap, L), dtype=i32, device=dev)
    xch = torch.empty((cap, L), dtype=i32, device=dev)
    nib = torch.empty((cap // UNROLL, L), dtype=i32, device=dev)
    cpk = torch.zeros(L, dtype=torch.int64, device=dev)
    zero = torch.zeros(L, dtype=i32, device=dev)
    fold = torch.zeros(L, dtype=i32, device=dev)
    # the row before could start a fold of its copy (interval) run
    fold_c = torch.zeros(L, dtype=torch.bool, device=dev)
    fold_i = torch.zeros_like(fold_c)

    def where(c, a, b):
        return torch.where(c, a, b).to(i32)

    for row_now in range(cap):
        p = r["phase"]
        active = p != P_DONE
        qc_n, qi_n, qr_n, qn_n = r["n_qc"], r["n_qi"], r["n_qr"], r["n_qn"]
        # done at step start: rows_used counts every row the lane touched
        was_done = ~active & (r["e_active"] == 0) & (qn_n == 0)
        if row_now % UNROLL == 0 and bool(was_done.all()):
            # every lane is finished: the remaining rows repeat the
            # frozen head values with code 0xF
            val[row_now:] = qr.head(0)
            xch[row_now:] = (qn.head(0) if mark_deg else r["e_x"])
            nib[row_now // UNROLL:] = -1
            break

        # ---------------- decode stall / early meta ----------------
        meta_unsent = r["metasent"] == 0
        qfull_c = ((p == P_BC) | (p == P_BLK)) & (qc_n > QC - 2)
        qfull_i = (p == P_IL) & (qi_n > QI - 1)
        qfull_r = ((p == P_FR) | (p == P_RES)) & (qr_n > QR - 1)
        meta_phase = ((p == P_OUT) | (p == P_BC) | (p == P_BLK)
                      | (p == P_IL) | (p == P_FR))
        qfull_n = meta_phase & meta_unsent & (qn_n > QN - 1)
        stall = active & (qfull_c | qfull_i | qfull_r | qfull_n)
        # early dirty meta only on true self-deadlock (emission idle)
        early = (active & meta_unsent & (qfull_c | qfull_i)
                 & (r["e_active"] == 0) & (qn_n == 0))
        tagd = r["x"] & 0xFF
        qn_n = qn.push(qn_n, early, r["d"],
                       (r["ref"] << 10) | (1 << 9) | tagd, zero)
        metasent = where(early, 1, r["metasent"])

        dec_active = active & ~stall
        # ---------------- rANS step + grammar FSM ----------------
        comp = torch.clamp(p, max=P_RES).long()
        v_u, state, ptr = ans_decode_step(tables, ctab, state, ptr, comp,
                                          dec_active)
        v = _to_i32(torch.where(dec_active, v_u, 0))

        x = r["x"]
        d, bc = r["d"], r["bc"]
        brem, bidx, bsum = r["brem"], r["bidx"], r["bsum"]
        cpy, copied, refd = r["cpy"], r["copied"], r["refd"]
        extra, ivrem, resrem = r["extra"], r["ivrem"], r["resrem"]
        xmod = r["xmod"]
        bsum_pre = bsum

        is_out = dec_active & (p == P_OUT)
        d = where(is_out, v, d)
        deg = where(is_out[None, :] & (ring_rows == xmod[None, :]),
                    v[None, :], deg)

        is_ref = dec_active & (p == P_REF)
        rsel = xmod - v
        rsel = torch.clamp(where(rsel < 0, rsel + R, rsel), 0, R - 1)
        refd = where(is_ref, _sel(deg, rsel, lanes), refd)
        refreg = where(is_out, 0, where(is_ref, v, r["ref"]))

        is_bc = dec_active & (p == P_BC)
        bc = where(is_bc, v, bc)
        brem = where(is_bc, v, brem)
        bidx = where(is_bc, 0, bidx)
        bsum = where(is_bc, 0, bsum)
        cpy = cpy | is_bc.to(i32)
        copied = where(is_bc | is_ref | is_out, 0, copied)
        copied = where(is_bc & (v == 0), refd, copied)

        is_blk = dec_active & (p == P_BLK)
        b = v + (bidx > 0).to(i32)
        bsum = where(is_blk, bsum + b, bsum)
        blk_copy = is_blk & (cpy != 0)
        copied = where(blk_copy, copied + b, copied)
        cpy = where(is_blk, 1 - cpy, cpy)
        bidx = where(is_blk, bidx + 1, bidx)
        brem = where(is_blk, brem - 1, brem)
        blocks_done = is_blk & (brem == 0)
        tail_len = where(blocks_done & ((bc & 1) == 0), refd - bsum, zero)
        copied = where(blocks_done, copied + tail_len, copied)

        # copy-run enqueues: whole list (bc == 0), copy block, block tail
        enq_whole = is_bc & (v == 0) & (refd > 0)
        enq_blk = blk_copy & (b > 0)
        ca = where(enq_whole, 0, bsum_pre)
        cl = where(enq_whole, refd, b)
        qc_n = qc.push(qc_n, enq_whole | enq_blk, ca, cl | (tagd << 20))
        enq_tail = blocks_done & (tail_len > 0)
        qc_n = qc.push(qc_n, enq_tail, bsum, tail_len | (tagd << 20))

        is_ic = dec_active & (p == P_IC)
        ivrem = where(is_ic, v, ivrem)

        is_is = dec_active & (p == P_IS)
        n2i = (v >> 1) ^ -(v & 1)
        fiv0, ivl0 = r["fiv"], r["ivl"]
        left_iv = where(fiv0 != 0, x + n2i, ivl0 + 1 + v)
        ivl = where(is_is, left_iv, ivl0)
        fiv = where(is_ic, 1, where(is_is, 0, fiv0))

        is_il = dec_active & (p == P_IL)
        ilen = v + min_interval
        extra = where(is_il, extra - ilen, extra)
        ivrem = where(is_il, ivrem - 1, ivrem)
        ivl = where(is_il, ivl + ilen, ivl)
        qi_n = qi.push(qi_n, is_il & (ilen > 0), ivl - ilen,
                       ilen | (tagd << 20))

        is_fr = dec_active & (p == P_FR)
        is_res = dec_active & (p == P_RES)
        resval = where(is_fr, x + n2i, r["prevres"] + v + 1)
        prevres = where(is_fr | is_res, resval, r["prevres"])
        resrem = where(is_fr | is_res, resrem - 1, resrem)
        qr_n = qr.push(qr_n, is_fr | is_res, resval, tagd)

        # ---------------- next phase ----------------
        DN = -1
        enter_tail = ((is_out & (v > 0) & (window == 0))
                      | (is_ref & (v == 0)) | (is_bc & (v == 0))
                      | blocks_done)
        extra = where(enter_tail, d - copied, extra)
        tail_ph = P_IC if min_interval != 0 else P_FR

        def tail_phase(ev):
            return where(ev > 0, tail_ph, DN)

        nxt = torch.full((L,), -2, dtype=i32, device=dev)
        nxt = where(is_out & (v == 0), DN, nxt)
        if window > 0:
            nxt = where(is_out & (v > 0), P_REF, nxt)
        else:
            nxt = where(is_out & (v > 0), tail_phase(d - copied), nxt)
        nxt = where(is_ref & (v > 0), P_BC, nxt)
        nxt = where(is_ref & (v == 0), tail_phase(extra), nxt)
        nxt = where(is_bc & (v > 0), P_BLK, nxt)
        nxt = where(is_bc & (v == 0), tail_phase(extra), nxt)
        nxt = where(blocks_done, tail_phase(extra), nxt)
        nxt = where(is_ic, where(v > 0, P_IS, P_FR), nxt)
        nxt = where(is_is, P_IL, nxt)
        nxt = where(is_il, where(ivrem > 0, P_IS,
                                 where(extra > 0, P_FR, DN)), nxt)
        resrem = where(nxt == P_FR, extra, resrem)
        nxt = where(is_fr | is_res, where(resrem > 0, P_RES, DN), nxt)

        node_done = nxt == DN
        # meta: first residual, or node end without residuals
        push_meta = (is_fr | node_done) & (metasent == 0)
        qn_n = qn.push(qn_n, push_meta, d, (refreg << 10) | tagd, copied)
        metasent = where(push_meta, 1, metasent)
        metasent = where(node_done, 0, metasent)

        left = where(node_done, r["left"] - 1, r["left"])
        x = where(node_done, x + 1, x)
        xmod = where(node_done, xmod + 1, xmod)
        xmod = where(xmod >= R, 0, xmod)
        nxt = where(node_done, where(left <= 0, P_DONE, P_OUT), nxt)
        phase = where(nxt == -2, p, nxt)

        r.update(left=left, phase=phase, d=d, bc=bc, brem=brem, bidx=bidx,
                 bsum=bsum, cpy=cpy, copied=copied, refd=refd, extra=extra,
                 ivrem=ivrem, resrem=resrem, xmod=xmod, x=x, prevres=prevres,
                 ivl=ivl, fiv=fiv, ref=refreg, metasent=metasent)

        # =================== emission substep ===================
        em_active = r["e_active"] != 0
        ex, exmod = r["e_x"], r["e_xmod"]
        tagx = ex & 0xFF

        # ---- pop the next node meta ----
        can_pop = ~em_active & (qn_n > 0)
        md, mp, mncop = qn.head(0), qn.head(1), qn.head(2)
        mref = mp >> 10
        mdirty0 = (mp >> 9) & 1
        parent = ex - mref
        hasref = mref > 0
        psel = exmod - (mref % R if window > 0 else 0)
        psel = torch.clamp(where(psel < 0, psel + R, psel), 0, R - 1)
        pbase = _sel(base, psel, lanes)
        ptaint = _sel(dirt, psel, lanes)
        crossl = hasref & (parent < r["e_lstart"])
        qc_match_pop = (qc_n > 0) & ((qc.head(1) >> 20) == tagx)
        firstsrc = pbase + qc.head(0)
        # ring-overflow bound: the c-th copy is read at most (non-copy
        # elements) rows after its source entered the ring
        tover = hasref & qc_match_pop & (
            (row_now + md - mncop - firstsrc) > (T - UNROLL))
        dirty = (mdirty0 != 0) | (hasref & ((ptaint != 0) | crossl)) | tover
        dcause = where(mdirty0 != 0, C_REFINFO,
                       where(hasref & crossl, 7,
                             where(hasref & (ptaint != 0), 8, 9)))
        empty = md == 0
        qn_n = qn.shift(qn_n, can_pop)

        popped_dirty = can_pop & ~empty & dirty
        popped_empty = can_pop & empty
        newbase = row_now + dirty.to(i32)
        selk = can_pop[None, :] & (ring_rows == exmod[None, :])
        base = where(selk, newbase[None, :], base)
        dirt = where(selk, dirty.to(i32)[None, :], dirt)
        em_active2 = (can_pop & ~empty) | em_active
        e_d = where(can_pop, md, r["e_d"])
        e_ref = where(can_pop, mref, r["e_ref"])
        e_dirty = where(can_pop, dirty.to(i32), r["e_dirty"])
        e_emitted = where(can_pop, 0, r["e_emitted"])
        e_first = where(can_pop, 1, r["e_first"])
        e_pbase = where(can_pop, pbase, r["e_pbase"])
        cc_left = where(can_pop, 0, r["e_ccleft"])
        ci_left = where(can_pop, 0, r["e_cileft"])
        ex2 = where(popped_empty, ex + 1, ex)
        exmod2 = where(popped_empty, exmod + 1, exmod)
        exmod2 = where(exmod2 >= R, 0, exmod2)

        # ---- run activation (not on the refinfo / empty step) ----
        emit_now = em_active2 & ~popped_dirty & ~popped_empty
        tagx2 = where(can_pop, ex & 0xFF, tagx)
        qc_match = (qc_n > 0) & ((qc.head(1) >> 20) == tagx2)
        act_c = emit_now & (cc_left == 0) & qc_match
        cc_j = where(act_c, qc.head(0), r["e_ccj"])
        cc_left = where(act_c, qc.head(1) & 0xFFFFF, cc_left)
        cc_src = where(act_c, e_pbase + qc.head(0), r["e_csrc"])
        qc_n = qc.shift(qc_n, act_c)
        qi_match = (qi_n > 0) & ((qi.head(1) >> 20) == tagx2)
        act_i = emit_now & (ci_left == 0) & qi_match
        ci_val = where(act_i, qi.head(0), r["e_cival"])
        ci_left = where(act_i, qi.head(1) & 0xFFFFF, ci_left)
        qi_n = qi.shift(qi_n, act_i)

        # ---- group-done signals (decode position checks) ----
        dx, dphase = r["x"], r["phase"]
        dec_past = dx > ex2
        dec_past_blk = dec_past | ((dx == ex2) & (dphase >= P_IC))
        dec_past_iv = dec_past | ((dx == ex2) & (dphase >= P_FR))
        qc_match2 = (qc_n > 0) & ((qc.head(1) >> 20) == tagx2)
        qi_match2 = (qi_n > 0) & ((qi.head(1) >> 20) == tagx2)
        cop_av = cc_left > 0
        cop_done = ~cop_av & ~qc_match2 & dec_past_blk
        iv_av = ci_left > 0
        iv_done = ~iv_av & ~qi_match2 & dec_past_iv
        res_av = (qr_n > 0) & (qr.head(1) == tagx2)
        res_done = ~res_av & dec_past

        # ---- heads and merge ----
        hc = ring[(cc_src & (T - 1)).long(), lanes]
        hi = ci_val
        hr = qr.head(0)
        clean = e_dirty == 0
        hc_k = where(emit_now & cop_av & clean, hc, BIG)
        hi_k = where(emit_now & iv_av, hi, BIG)
        hr_k = where(emit_now & res_av, hr, BIG)
        gate = (emit_now & (cop_av | cop_done) & (iv_av | iv_done)
                & (res_av | res_done) & clean)
        emit_c = gate & cop_av & (hc_k <= hi_k) & (hc_k <= hr_k)
        emit_i = gate & iv_av & ~emit_c & (hi_k <= hr_k)
        emit_r = gate & res_av & ~emit_c & ~emit_i
        # dirty nodes emit grouped: copies (placeholders), intervals,
        # residuals
        dgate = emit_now & ~clean
        emit_c = emit_c | (dgate & cop_av)
        emit_i = emit_i | (dgate & ~cop_av & cop_done & iv_av)
        emit_r = emit_r | (dgate & ~cop_av & cop_done & ~iv_av & iv_done
                           & res_av)
        emitted = emit_c | emit_i | emit_r

        out_v = where(emit_c, where(~clean, cc_j, hc), where(emit_i, hi, hr))
        cc_j = where(emit_c, cc_j + 1, cc_j)
        cc_src = where(emit_c, cc_src + 1, cc_src)
        cc_left = where(emit_c, cc_left - 1, cc_left)
        ci_val = where(emit_i, ci_val + 1, ci_val)
        ci_left = where(emit_i, ci_left - 1, ci_left)
        qr_n = qr.shift(qr_n, emit_r)

        e_emitted = e_emitted + emitted.to(i32)
        node_fin = em_active2 & (e_emitted >= e_d) & emitted
        ex3 = where(node_fin, ex2 + 1, ex2)
        exmod3 = where(node_fin, exmod2 + 1, exmod2)
        exmod3 = where(exmod3 >= R, 0, exmod3)
        em_active3 = em_active2 & ~node_fin

        # ---- run folding (counted; the kernel writes these rows alone) ----
        quiet = ~dec_active & ~early & ~can_pop & ~act_c & ~act_i
        fold += (quiet & ((fold_c & emit_c) | (fold_i & emit_i))).to(i32)
        fold_c = quiet & emit_c & em_active3
        fold_i = quiet & emit_i & em_active3

        # ---- output row ----
        lane_done = (r["phase"] == P_DONE) & ~em_active3 & (qn_n == 0)
        halo = ex < r["e_rstart"]     # halo nodes feed the ring, unmarked
        code = torch.full((L,), C_HOLE, dtype=i32, device=dev)
        code = where(emitted, where(
            emit_c & ~clean, C_PLACE,
            where((e_first != 0) & clean & ~halo, C_FIRST, C_EL)), code)
        code = where(popped_dirty & ~halo, dcause, code)
        code = where((popped_dirty | popped_empty) & halo, C_HOLE, code)
        code = where(popped_empty & ~halo, C_EMPTY, code)
        code = where(lane_done & ~emitted & ~can_pop, C_DONE, code)
        out_v = where(popped_dirty, e_ref, out_v)
        out_x = md if mark_deg else ex
        e_first = where(emitted, 0, e_first)

        mark_now = can_pop & ~halo
        r.update(
            e_active=em_active3.to(i32), e_x=ex3, e_xmod=exmod3, e_d=e_d,
            e_ref=e_ref, e_dirty=e_dirty, e_emitted=e_emitted,
            e_first=e_first, e_pbase=e_pbase, e_ccj=cc_j, e_ccleft=cc_left,
            e_csrc=cc_src, e_cival=ci_val, e_cileft=ci_left,
            e_donerow=where(was_done, r["e_donerow"], row_now + 1),
            e_markrow=where(mark_now, row_now, r["e_markrow"]),
            e_mdirty=where(mark_now, dirty.to(i32) | (empty.to(i32) << 1),
                           r["e_mdirty"]),
            n_qc=qc_n, n_qi=qi_n, n_qr=qr_n, n_qn=qn_n)

        val[row_now] = out_v
        xch[row_now] = out_x
        ring[row_now & (T - 1)] = out_v
        sub = row_now % UNROLL
        if sub == 0:
            cpk = torch.full((L,), M32, dtype=torch.int64, device=dev)
        cpk = (cpk & ~(0xF << (4 * sub)) & M32) | (code.long() << (4 * sub))
        if sub == UNROLL - 1:
            nib[row_now // UNROLL] = _to_i32(cpk)

    done = ((r["phase"] == P_DONE) & (r["e_active"] == 0)
            & (r["n_qn"] == 0))
    diag = torch.stack([
        r["e_markrow"], r["e_mdirty"], r["x"], r["e_x"],
        r["e_active"] * 1000000 + r["e_emitted"],
        r["n_qn"] * 1000 + r["n_qc"] * 100 + r["n_qi"] * 10 + r["n_qr"]])
    return val, xch, nib, r["e_donerow"].clone(), done, diag, fold
