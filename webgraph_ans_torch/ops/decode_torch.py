"""Lane-parallel rANS token decode in PyTorch: decoder tables, the plain
version of the decode kernel, outdegree ring seeds and the host unpack.

Every node boundary of the stream carries a phase (decoder state, stream
pointer), so every node is an independent decode entry point. A decode
*lane* takes a contiguous node range, enters the stream at the phase of
its first node, and decodes one token per step: LUT slot -> frequency,
cumulative frequency, folded symbol and fold count; u32 state update;
16-bit refills from the u16 stream walking downwards; quasi-unfold. The
BvGraph component grammar (outdegree, reference, blocks, intervals,
residuals; executable spec: native/src/bvgraph.hpp read_successors) runs
on top as a per-lane state machine with a `window+1` outdegree ring.

`decode_blocks_plain` is the plain PyTorch version of the CUDA kernel in
`ops/decode_cuda.py` (same contract, same bits). It vectorises over lanes
and loops over steps in Python. Torch on the CPU has no u32 `+ << >> <`,
so u32 quantities are carried in int64 and masked with `& 0xFFFFFFFF`.

Output layout (step-major, shared by the kernel): `out` [cap + cap//8, L]
int32 holding u32 bit patterns. Row s < cap holds the token value of
lockstep step s (0 on finished lanes); rows cap + s//8 hold component ids
packed 4 bits per token, 8 tokens per word (token s at nibble s % 8, 0xF
on finished lanes).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# rANS constants (reference: src/ans/mod.rs:18-24).
B = 16
LOWER_BOUND = 1 << 16
M32 = 0xFFFFFFFF

# Component ids double as FSM phase ids (reference: src/bvgraph/mod.rs:13-23).
P_OUT, P_REF, P_BC, P_BLK, P_IC, P_IS, P_IL, P_FR, P_RES = range(9)
P_DONE = 9
_P_NODE_DONE = -1    # next-phase sentinel: node finished
_P_KEEP = -2         # next-phase sentinel: keep the current phase

# Component nibbles are packed 8 per u32 output word.
UNROLL = 8

# The token-cap quantum of the reference decoder: its stream window spans
# 32-word rows and a token consumes at most 1 + 2*max_folds words. Kept so
# both packages size their output buffers identically.
WORDS_PER_ROW = 32


class DecoderTables(NamedTuple):
    """Device copies of the decode LUT and the stream, plus the codec
    parameters. lut row = [freq | cumul<<16, folded symbol | folds<<16]
    (u32 bit patterns in int32); the 31-bit symbol prefix is recomputed
    per token as (sym - fold_off*folds) << (folds*radix)."""

    lut: torch.Tensor      # int32 [slots, 2]
    stream: torch.Tensor   # int16 [stream_len] (u16 bit patterns)
    params: tuple          # see build_decoder_tables_np


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is missing and no device was given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch version on the host")
        return torch.device("cuda")
    return torch.device(device)


def build_decoder_tables_np(model):
    """Host-side decode LUT (u32 [slots, 2]) and the codec parameters:
    9 x (offset, log_m, mask, radix, fold_off), then [9] the slot count
    and [10] the model's maximum fold count."""
    fc_parts, sf_parts = [], []
    params = []
    base = 0
    max_folds = 0
    for c in model.components:
        frame = 1 << c.log_m if len(c.freqs) else 0
        params.append((base, int(c.log_m),
                       (1 << c.log_m) - 1 if len(c.freqs) else 0,
                       int(c.radix), int(c.folding_offset)))
        if frame == 0:
            continue
        freqs = c.freqs.astype(np.uint32)
        cumul = np.zeros(len(freqs), dtype=np.uint64)
        np.cumsum(freqs[:-1], out=cumul[1:])
        nz = np.nonzero(freqs)[0]
        syms = np.repeat(nz, freqs[nz])  # one entry per used slot
        used = len(syms)
        if used > frame:
            raise ValueError("component frequencies exceed the frame")
        thr = c.folding_threshold
        off = c.folding_offset
        folds = np.where(syms < thr, 0, (syms - thr) // off + 1).astype(np.uint64)
        prefix = (syms.astype(np.uint64) - off * folds) << (folds * c.radix)
        if used:
            if int(prefix.max()) >> 31:
                raise ValueError(
                    "symbol prefix exceeds 31 bits; graph too large for the "
                    "device path")
            if int(syms.max()) >= 1 << 16:
                raise ValueError("folded symbol exceeds 16 bits")
            max_folds = max(max_folds, int(folds.max()))
        pad = frame - used
        fc_parts.append(np.concatenate(
            [freqs[syms] | (cumul[syms].astype(np.uint32) << 16),
             np.zeros(pad, np.uint32)]))
        sf_parts.append(np.concatenate(
            [syms.astype(np.uint32) | (folds.astype(np.uint32) << 16),
             np.zeros(pad, np.uint32)]))
        base += frame
    slots = max(base, 1)
    z = [np.zeros(1, np.uint32)]
    fc = np.concatenate(fc_parts or z)
    sf = np.concatenate(sf_parts or z)
    fc.resize(slots)
    sf.resize(slots)
    lut = np.stack([fc, sf], axis=1)
    params.append(slots)
    params.append(max_folds)
    return lut, params


def tables_from_numpy(lut_np, stream_u16, params, device) -> DecoderTables:
    """Host decode tables (u32 LUT [slots, 2], u16 stream) -> device
    tensors. Accepts the JAX package's host tables as well."""
    lut = np.ascontiguousarray(lut_np, dtype=np.uint32).view(np.int32)
    stream = np.ascontiguousarray(stream_u16, dtype=np.uint16).view(np.int16)
    if len(stream) == 0:
        stream = np.zeros(1, np.int16)
    return DecoderTables(lut=torch.from_numpy(lut.copy()).to(device),
                         stream=torch.from_numpy(stream.copy()).to(device),
                         params=tuple(params))


def _cap_quantum(max_folds: int) -> int:
    rows_back = 1 + -(-(1 + 2 * max_folds) // WORDS_PER_ROW)
    k = max(1, (WORDS_PER_ROW * (rows_back - 1)) // (1 + 2 * max_folds))
    return k * UNROLL // int(np.gcd(k, UNROLL))


def round_cap(params, cap: int) -> int:
    """Rounds a token capacity up to the decode cap quantum (a multiple of
    UNROLL)."""
    q = _cap_quantum(params[10])
    return -(-max(cap, 1) // q) * q


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """u32 bit pattern held in int64 -> int32 tensor of the same bits."""
    x = x & M32
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _comp_table(params, device) -> torch.Tensor:
    """Per-component codec parameters [9, 5] int64: offset, log_m, mask,
    radix, fold_off."""
    return torch.tensor([list(params[c]) for c in range(9)],
                        dtype=torch.int64, device=device)


def ans_decode_step(tables: DecoderTables, ctab, state, ptr, comp, active):
    """One rANS decode step per lane (reference: src/ans/decoder.rs:58-87):
    LUT read, u32 state update, 16-bit refills, quasi-unfold up to the
    model's maximum fold count. state/ptr/comp int64 [L]; `active` masks
    lanes. Returns (value, state, ptr), unchanged on inactive lanes."""
    slots, max_folds = tables.params[9], tables.params[10]
    cp = ctab[comp]
    offset, log_m, mask, radix, fold_off = cp.unbind(1)
    radix_mask = (1 << radix) - 1
    slot = state & mask
    row = tables.lut[torch.clamp(offset + slot, max=slots - 1)].long() & M32
    fc, sf = row[:, 0], row[:, 1]
    freq, cumul = fc & 0xFFFF, fc >> 16
    sym, folds = sf & 0xFFFF, sf >> 16
    prefix = (((sym - fold_off * folds) & M32)
              << torch.clamp(folds * radix, max=31)) & M32

    last_word = tables.stream.shape[0] - 1

    def refill(s, p, a):
        # reads the word at ptr-1, clamped to the stream as the kernel does
        need = a & (s < LOWER_BOUND)
        new_p = p - need.long()
        word = (tables.stream[torch.clamp(new_p, 0, last_word)].long()
                & 0xFFFF)
        return (torch.where(need, ((s << B) | word) & M32, s),
                torch.where(need, new_p, p))

    new_state = (((state >> log_m) * freq) + slot - cumul) & M32
    new_state, new_ptr = refill(new_state, ptr, active)
    fold = torch.zeros_like(state)
    folds_left = torch.where(active, folds, 0)
    for _ in range(max_folds):
        a = folds_left > 0
        new_state, new_ptr = refill(new_state, new_ptr, a)
        fold = torch.where(a, ((fold << radix) | (new_state & radix_mask))
                           & M32, fold)
        new_state = torch.where(a, new_state >> radix, new_state)
        new_state, new_ptr = refill(new_state, new_ptr, a)
        folds_left = folds_left - a.long()
    value = prefix | fold
    return (value, torch.where(active, new_state, state),
            torch.where(active, new_ptr, ptr))


def decode_blocks_plain(tables: DecoderTables, states, ptrs, starts, ends,
                        ring_seed, window: int, min_interval: int, cap: int):
    """Grammar-FSM token decode of independent node ranges, plain PyTorch
    on the tensors' device. Lane l decodes every token of nodes
    starts[l]..ends[l]-1, entering the stream at (states[l], ptrs[l]),
    the phase of node starts[l]; ptrs are absolute u16 word indices.
    ring_seed [L, window+1] holds the outdegrees of the `window` nodes
    before each start at slots node % (window+1) (see seed_rings).

    cap must be a multiple of UNROLL. Returns (out [cap + cap//8, L]
    int32, counts int32 [L], ok bool [L]); see the module docstring for
    the layout. Lanes with more than `cap` tokens report ok=False."""
    if cap % UNROLL:
        raise ValueError(f"cap {cap} is not a multiple of {UNROLL}")
    dev = states.device
    L = states.shape[0]
    R = window + 1
    ctab = _comp_table(tables.params, dev)
    lanes = torch.arange(L, device=dev)
    ring_cols = torch.arange(R, device=dev)[None, :]

    state = states.long() & M32
    ptr = ptrs.long()
    x = starts.long()
    ends = ends.long()
    phase = torch.where(x < ends, P_OUT, P_DONE)
    ring = ring_seed.long().clone()
    zero = torch.zeros(L, dtype=torch.int64, device=dev)
    d, bc, brem, bidx, bsum = zero, zero, zero, zero, zero
    copied, refd, extra, ivrem, resrem, outn = zero, zero, zero, zero, zero, zero
    cpy = torch.zeros(L, dtype=torch.bool, device=dev)

    out = torch.zeros((cap + cap // UNROLL, L), dtype=torch.int32, device=dev)
    out[cap:] = -1          # untouched nibble words read as 0xF nibbles
    cpk = torch.full((L,), M32, dtype=torch.int64, device=dev)

    def tail_phase(e):
        return torch.where(e > 0, P_IC if min_interval else P_FR,
                           _P_NODE_DONE)

    for step in range(cap):
        active = phase != P_DONE
        if not bool(active.any()):
            break
        p = phase
        comp = torch.clamp(p, max=P_RES)
        vu, state, ptr = ans_decode_step(tables, ctab, state, ptr, comp,
                                         active)
        vu = torch.where(active, vu, 0)
        nib = torch.where(active, comp, 0xF)
        v = torch.where(vu >= 1 << 31, vu - (1 << 32), vu)  # i32 view

        is_out = active & (p == P_OUT)
        d = torch.where(is_out, v, d)
        ring = torch.where(is_out[:, None] & (ring_cols == (x % R)[:, None]),
                           v[:, None], ring)

        is_ref = active & (p == P_REF)
        ref_sel = ring[lanes, (x - v) % R]
        refd = torch.where(is_ref, ref_sel, refd)

        is_bc = active & (p == P_BC)
        bc = torch.where(is_bc, v, bc)
        brem = torch.where(is_bc, v, brem)
        bidx = torch.where(is_bc, 0, bidx)
        bsum = torch.where(is_bc, 0, bsum)
        cpy = cpy | is_bc
        copied = torch.where(is_bc | is_ref | is_out, 0, copied)
        # bc == 0: the whole reference list is tail-copied
        # (native/src/bvgraph.hpp:79-81).
        copied = torch.where(is_bc & (v == 0), refd, copied)

        is_blk = active & (p == P_BLK)
        b = v + (bidx > 0).long()
        bsum = torch.where(is_blk, bsum + b, bsum)
        copied = torch.where(is_blk & cpy, copied + b, copied)
        cpy = torch.where(is_blk, ~cpy, cpy)
        bidx = torch.where(is_blk, bidx + 1, bidx)
        brem = torch.where(is_blk, brem - 1, brem)
        blocks_done = is_blk & (brem == 0)
        copied = torch.where(blocks_done & (bc % 2 == 0),
                             copied + refd - bsum, copied)

        is_ic = active & (p == P_IC)
        ivrem = torch.where(is_ic, v, ivrem)
        is_il = active & (p == P_IL)
        extra = torch.where(is_il, extra - (v + min_interval), extra)
        ivrem = torch.where(is_il, ivrem - 1, ivrem)
        is_fr = active & (p == P_FR)
        is_res = active & (p == P_RES)
        resrem = torch.where(is_fr | is_res, resrem - 1, resrem)

        enter_tail = ((is_out & (v > 0) & (window == 0))
                      | (is_ref & (v == 0)) | (is_bc & (v == 0))
                      | blocks_done)
        extra = torch.where(enter_tail, d - copied, extra)

        nxt = torch.full_like(p, _P_KEEP)
        nxt = torch.where(is_out & (v == 0), _P_NODE_DONE, nxt)
        if window > 0:
            nxt = torch.where(is_out & (v > 0), P_REF, nxt)
        else:
            nxt = torch.where(is_out & (v > 0), tail_phase(d - copied), nxt)
        nxt = torch.where(is_ref & (v > 0), P_BC, nxt)
        nxt = torch.where(is_ref & (v == 0), tail_phase(extra), nxt)
        nxt = torch.where(is_bc & (v > 0), P_BLK, nxt)
        nxt = torch.where(is_bc & (v == 0), tail_phase(extra), nxt)
        nxt = torch.where(blocks_done, tail_phase(extra), nxt)
        # ic > 0 -> interval pairs; ic == 0 -> the residual tail
        nxt = torch.where(is_ic, torch.where(v > 0, P_IS, P_FR), nxt)
        nxt = torch.where(active & (p == P_IS), P_IL, nxt)
        nxt = torch.where(
            is_il, torch.where(ivrem > 0, P_IS,
                               torch.where(extra > 0, P_FR, _P_NODE_DONE)),
            nxt)
        resrem = torch.where(nxt == P_FR, extra, resrem)
        nxt = torch.where(is_fr | is_res,
                          torch.where(resrem > 0, P_RES, _P_NODE_DONE), nxt)

        node_done = nxt == _P_NODE_DONE
        x = torch.where(node_done, x + 1, x)
        nxt = torch.where(node_done, torch.where(x >= ends, P_DONE, P_OUT),
                          nxt)
        phase = torch.where(nxt == _P_KEEP, p, nxt)
        outn = outn + active.long()

        sub = step % UNROLL
        if sub == 0:
            cpk = torch.full_like(cpk, M32)
        cpk = (cpk & ~(0xF << (4 * sub)) & M32) | (nib << (4 * sub))
        out[step] = _to_i32(vu)
        out[cap + step // UNROLL] = _to_i32(cpk)
    ok = phase == P_DONE
    return out, outn.to(torch.int32), ok


def seed_rings(tables: DecoderTables, states, ptrs, starts, window: int):
    """Outdegree ring seeds for decode_blocks: for each lane, decodes the
    Outdegree token of each of the `window` nodes before its start, each
    entered at its own phase (reference:
    src/bvgraph/factories/bvgraph_decoder_factory.rs:46-58).

    states/ptrs: [L, window] phases (absolute pointers) of nodes
    starts[l]-window .. starts[l]-1, clamped to node 0; entries before
    node 0 are ignored. Returns int32 [L, window+1] with outdegrees at
    slots node % (window+1)."""
    L = states.shape[0]
    R = window + 1
    dev = states.device
    ring = torch.zeros((L, R), dtype=torch.int64, device=dev)
    if window == 0:
        return ring.to(torch.int32)
    ctab = _comp_table(tables.params, dev)
    ring_cols = torch.arange(R, device=dev)[None, :]
    comp = torch.zeros(L, dtype=torch.int64, device=dev)   # OUTDEGREE
    for j in range(window):
        node = starts.long() - window + j
        valid = node >= 0
        v, _, _ = ans_decode_step(tables, ctab, states[:, j].long() & M32,
                                  ptrs[:, j].long(), comp, valid)
        ring = torch.where(valid[:, None] & (ring_cols == (node % R)[:, None]),
                           v[:, None], ring)
    return _to_i32(ring)


def unpack_block_tokens(vals: np.ndarray, cpk: np.ndarray,
                        counts: np.ndarray):
    """Host unpack of decode output (value rows [rows, L] and packed-nibble
    rows [ceil(rows/8), L], u32) into forward-node-order (values u32,
    comps u8) flat arrays. Rows whose nibble is 0xF are dropped; each
    lane contributes exactly counts[l] tokens in order."""
    rows = vals.shape[0]
    steps = np.arange(rows)
    nib = (cpk[steps // UNROLL, :] >> ((steps % UNROLL) * 4)[:, None]) & 0xF
    valid = nib <= 8                     # [rows, L]
    # column-major flatten keeps each lane's rows contiguous and in order
    vmask = valid.T.ravel()
    flat_v = vals.T.ravel()[vmask]
    flat_c = nib.T.ravel()[vmask].astype(np.uint8)
    if not np.array_equal(valid.sum(axis=0), counts):
        raise RuntimeError("token accounting mismatch")
    return flat_v, flat_c


def fetch_block_tokens(out: torch.Tensor, counts: torch.Tensor, cap: int):
    """Copies decode output to the host, trimming untouched rows on the
    device first, and unpacks it (see unpack_block_tokens)."""
    counts_np = counts.cpu().numpy()
    rows = min(cap, -(-max(int(counts_np.max(initial=0)), 1) // 64) * 64)
    vals = out[:rows].cpu().numpy().view(np.uint32)
    cpk = out[cap: cap + -(-rows // UNROLL)].cpu().numpy().view(np.uint32)
    return unpack_block_tokens(vals, cpk, counts_np)
