"""Lane-parallel rANS encoding in PyTorch: encoder tables, the block plan,
the plain version of the encode kernel and the host stream assembly.

The serial encoder runs ONE rANS state over the reversed token stream
(reference: src/ans/encoder.rs:39-86, driven by
src/bvgraph/writers/bvgraph_encoder.rs:159-174). Here the token stream
splits at node boundaries into independent blocks, one per lane; each lane
encodes its range in reverse (fold pushes with renormalisation, then the
division-free state update), and the per-block streams concatenate in block
order, last block first, as the serial emission has it. Every node keeps a
phase (state, stream pointer), so every decoder reads the result; only the
state's continuity across block starts is given up (each block starts from
the rANS lower bound, about two words per block). The prelude's block table
records each block's first node, entry state and entry pointer.

Division is a reciprocal multiply-shift: per folded symbol,
q = umulhi(state, M) >> sh, then one correction step in each direction.

`encode_blocks_plain` is the plain PyTorch version of the CUDA kernel in
`ops/encode_cuda.py` (same contract, same bits). It vectorises over lanes
and loops over steps in Python. Torch on the CPU has no u32 `+ << >> <`, so
u32 quantities are carried in int64 and masked with `& 0xFFFFFFFF`.

Output layout (step-major, shared by the kernel), u32 bit patterns in
int32: `emit` [cap*EP + cap, L], where rows s*EP .. s*EP+EP-1 hold step
s's emitted words packed two per u32, low word first (0 in unused slots
and on finished lanes), and row cap*EP + s holds the meta word
`nemit | is_outdeg << 8 | wcnt_after << 9` (nemit 0xFF on finished
lanes); `states` [cap, L] the state after each step. Every row up to cap
is written. EP = (max_folds + 2) // 2.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from .decode_torch import B, LOWER_BOUND, M32, _to_i32, resolve_device

MASK16 = 0xFFFF
UNROLL = 8   # cap granularity, kept so raw outputs have the JAX shapes
# the per-step meta word packs the cumulative word count into 23 bits
MAX_LANE_WORDS = 1 << 23


class EncodePlan(NamedTuple):
    """Device inputs of the encode kernel and the host block bounds."""

    params: tuple          # 9 x (offset, log_m, radix, fidelity), max_folds
    tab: torch.Tensor      # int32 [entries, 4] (u32 bit patterns)
    tokens: torch.Tensor   # int32 [T, 2]: (value, component)
    tstart: torch.Tensor   # int32 [L]
    tend: torch.Tensor     # int32 [L]
    cap: int
    tstart_np: np.ndarray
    tend_np: np.ndarray
    block_nodes: np.ndarray
    tab_np: np.ndarray     # uint32 [entries, 4]


def _magic(freq: int):
    """Reciprocal magic for floor(x / freq) on x < 2^32 via
    umulhi(x, M) >> sh, exact to within +1 (the correction step fixes the
    off-by-one)."""
    if freq == 0:
        return 0, 0
    if freq == 1:
        # umulhi(x, 2^32-1) = x - 1 for x >= 1; the correction adds it back
        return 0xFFFFFFFF, 0
    if freq & (freq - 1) == 0:
        # power of two: umulhi(x, 2^31) = x >> 1, then shift the rest
        return 0x80000000, freq.bit_length() - 2
    l = freq.bit_length() - 1   # floor(log2(freq))
    M = ((1 << (32 + l)) + freq - 1) // freq  # ceil(2^(32+l)/freq) < 2^32
    assert M < 1 << 32
    return M, l


def build_encoder_tables_np(model):
    """Host encode table (u32 [entries, 4], rows = [freq | cumul<<16,
    renorm bound - 1, M, sh], components concatenated) and the codec
    parameters: 9 x (offset, log_m, radix, fidelity), then max_folds."""
    rows = []
    params = []
    base = 0
    max_folds = 0
    for c in model.components:
        params.append((base, int(c.log_m), int(c.radix), int(c.fidelity)))
        n = len(c.freqs)
        if n == 0:
            continue
        freqs = c.freqs.astype(np.int64)
        cumul = np.zeros(n, np.int64)
        np.cumsum(freqs[:-1], out=cumul[1:])
        k = 16 - c.log_m
        row = np.zeros((n, 4), np.uint32)
        row[:, 0] = (freqs & 0xFFFF) | ((cumul & 0xFFFF) << 16)
        # the renorm bound (1 << (k+B)) * freq is stored MINUS ONE so it
        # fits u32 for frame-1 components too (bound 2^32: never renorm);
        # the step tests state > bound - 1. freq == 0 rows are never used.
        bound = (1 << (k + B)) * freqs
        row[:, 1] = np.maximum(bound - 1, 0) & 0xFFFFFFFF
        for s in range(n):
            row[s, 2], row[s, 3] = _magic(int(freqs[s]))
        rows.append(row)
        thr = c.folding_threshold
        off = c.folding_offset
        if n > thr:
            max_folds = max(max_folds, int((n - 1 - thr) // off + 1))
        base += n
    tab = np.concatenate(rows) if rows else np.zeros((1, 4), np.uint32)
    params.append(max_folds)
    return tab, tuple(params)


def build_encoder_tables(model, device):
    """(tab int32 [entries, 4] on `device`, params, tab_np uint32)."""
    tab_np, params = build_encoder_tables_np(model)
    tab = torch.from_numpy(tab_np.view(np.int32).copy()).to(device)
    return tab, params, tab_np


def _emit_pairs(max_folds: int) -> int:
    """Packed u32 rows per step: one optional renorm word per fold push
    plus one before the state update, two words per row."""
    return (max_folds + 2) // 2


def encode_plan(model, values: np.ndarray, comps: np.ndarray,
                num_blocks: int = 512, device=None) -> EncodePlan:
    """Kernel inputs: tables and params, the token array, and block bounds
    at node starts balanced in token space (at most num_blocks blocks).
    cap = the longest block's token count rounded up to a multiple of 8."""
    device = resolve_device(device)
    values = np.ascontiguousarray(values, dtype=np.uint64)
    comps = np.ascontiguousarray(comps, dtype=np.uint8)
    T = len(values)
    if np.any(values >> 31):
        raise ValueError("token values must fit in uint31 for the device "
                         "encoder")
    if np.any(comps > 8):
        raise ValueError("token components must be 0..8")
    tab, params, tab_np = build_encoder_tables(model, device)

    node_starts = np.nonzero(comps == 0)[0]
    n_nodes = len(node_starts)
    Bn = min(num_blocks, max(n_nodes, 1))
    targets_tok = (np.arange(Bn, dtype=np.int64) * T) // max(Bn, 1)
    if n_nodes:
        picks = np.minimum(np.searchsorted(node_starts, targets_tok),
                           n_nodes - 1)
    else:
        picks = np.zeros(1, np.int64)
    block_nodes = np.unique(picks).astype(np.int64)
    tstart = (node_starts[block_nodes].astype(np.int32) if n_nodes
              else np.zeros(1, np.int32))
    tend = np.empty_like(tstart)
    tend[:-1] = tstart[1:]
    tend[-1] = T

    tokens = np.stack([values.astype(np.int32), comps.astype(np.int32)],
                      axis=1)
    cap = max(int((tend - tstart).max()), 1)
    cap = -(-cap // UNROLL) * UNROLL
    return EncodePlan(
        params, tab, torch.from_numpy(tokens).to(device),
        torch.from_numpy(tstart.copy()).to(device),
        torch.from_numpy(tend.copy()).to(device), cap, tstart, tend,
        block_nodes, tab_np)


def _umulhi(a, b):
    """High 32 bits of the u32 product of int64-held a and b, exact: the
    64-bit product would overflow int64, so split b in 16-bit halves."""
    return (a * (b >> 16) + ((a * (b & MASK16)) >> 16)) >> 16


def encode_blocks_plain(params, tab, tokens, tstart, tend, cap: int):
    """Lane-parallel reverse rANS encode, plain PyTorch on the tensors'
    device. Lane l encodes tokens[tstart[l] .. tend[l]-1] last to first,
    from state LOWER_BOUND. tab int32 [entries, 4]; tokens int32 [T, 2];
    tstart/tend int32 [L]. Returns (emit [cap*EP + cap, L] int32, states
    [cap, L] int32, final_states [L] int32, wtotals [L] int32, ok [L]
    bool); see the module docstring for the layout. ok is False on lanes
    with more than cap tokens."""
    max_folds = params[9]
    EP = _emit_pairs(max_folds)
    dev = tokens.device
    L = tstart.shape[0]
    T = tokens.shape[0]
    i64 = torch.int64
    ctab = torch.tensor([list(params[c]) for c in range(9)], dtype=i64,
                        device=dev)
    tab64 = tab.long() & M32
    entries = tab64.shape[0]
    tok64 = tokens.long() & M32
    state = torch.full((L,), LOWER_BOUND, dtype=i64, device=dev)
    cur = tend.long()
    ends = tstart.long()
    wcnt = torch.zeros(L, dtype=i64, device=dev)
    emit = torch.empty((cap * EP + cap, L), dtype=i64, device=dev)
    states = torch.empty((cap, L), dtype=i64, device=dev)
    lanes = torch.arange(L, device=dev)
    dump = 2 * EP   # scatter column of words that are not emitted

    for s in range(cap):
        active = cur > ends
        if T:
            row = tok64[torch.clamp(cur - 1, 0, T - 1)]
            sym_in = torch.where(active, row[:, 0], 0)
            comp = torch.where(active, row[:, 1], 0)
        else:
            sym_in = torch.zeros(L, dtype=i64, device=dev)
            comp = sym_in
        offset, log_m, radix, fidelity = ctab[comp].unbind(1)
        fold_off = ((1 << radix) - 1) * (1 << (fidelity - 1))
        radix_mask = (1 << radix) - 1

        # fold count by comparisons: folds >= k <=> sym >= 2^(fid+k*radix-1);
        # an exponent >= 32 is never reached
        folds = torch.zeros(L, dtype=i64, device=dev)
        for k in range(1, max_folds + 1):
            e = fidelity + k * radix - 1
            kthr = 1 << torch.clamp(e, max=31)
            folds = folds + ((sym_in >= kthr) & (e < 32)).long()

        words = torch.zeros((L, 2 * EP + 1), dtype=i64, device=dev)
        nemit = torch.zeros(L, dtype=i64, device=dev)
        sym = sym_in
        folds_left = folds
        for _ in range(max_folds):
            a = folds_left > 0
            # renorm before a push: emit 16 LSBs if the top radix bits are used
            need = a & ((state >> (32 - radix)) != 0)
            words[lanes, torch.where(need, nemit, dump)] = state & MASK16
            nemit = nemit + need.long()
            state = torch.where(need, state >> B, state)
            state = torch.where(
                a, ((state << radix) + (sym & radix_mask)) & M32, state)
            sym = torch.where(a, sym >> radix, sym)
            folds_left = folds_left - a.long()
        sym = torch.where(folds > 0, sym + fold_off * folds, sym_in)

        erow = tab64[torch.clamp(offset + sym, max=entries - 1)]
        freq, cumul = erow[:, 0] & MASK16, erow[:, 0] >> 16
        upper, M, sh = erow[:, 1], erow[:, 2], torch.clamp(erow[:, 3],
                                                           max=31)
        need = active & (state > upper)   # upper = renorm bound MINUS ONE
        words[lanes, torch.where(need, nemit, dump)] = state & MASK16
        nemit = nemit + need.long()
        state = torch.where(need, state >> B, state)

        # division-free update; r is tested as a signed 32-bit value
        q = _umulhi(state, M) >> sh
        r = (state - q * freq) & M32
        fix_lo = r >= 1 << 31
        q = torch.where(fix_lo, q - 1, q) & M32
        r = torch.where(fix_lo, r + freq, r) & M32
        fix_hi = r >= freq
        q = torch.where(fix_hi, q + 1, q) & M32
        r = torch.where(fix_hi, r - freq, r)
        new_state = ((q << log_m) + cumul + r) & M32
        state = torch.where(active, new_state, state)

        pairs = words[:, 0:dump:2] | (words[:, 1:dump:2] << 16)
        emit[s * EP:(s + 1) * EP] = torch.where(active[:, None], pairs, 0).T
        wcnt = (wcnt + torch.where(active, nemit, 0)) & M32
        is_out = (active & (comp == 0)).long()
        emit[cap * EP + s] = (torch.where(active, nemit, 0xFF)
                              | (is_out << 8) | ((wcnt << 9) & M32))
        states[s] = state
        cur = torch.where(active, cur - 1, cur)

    return (_to_i32(emit), _to_i32(states), _to_i32(state), _to_i32(wcnt),
            cur <= ends)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def lane_encode_tokens(model, values: np.ndarray, comps: np.ndarray,
                       num_blocks: int = 512, device=None,
                       seconds: dict | None = None):
    """Encodes the forward-order token stream with `num_blocks`
    independent lanes split at token-balanced node starts, on `device`
    (CUDA by default; device="cpu" runs the plain version). Returns
    (stream u16, states u32 reverse node order, pointers u64 reverse node
    order, final_state, blocks): the artifact contract of the serial
    native encode, plus the prelude block table (start_nodes,
    entry_states, entry_ptrs). `seconds`, when given, receives the stage
    times: encode_plan, encode_kernel, encode_assembly."""
    from .encode_cuda import encode_blocks

    t0 = time.perf_counter()
    plan = encode_plan(model, values, comps, num_blocks, device)
    t1 = time.perf_counter()
    emit, states, final_states, wtotals, ok = encode_blocks(
        plan.params, plan.tab, plan.tokens, plan.tstart, plan.tend,
        plan.cap)
    if emit.is_cuda:
        torch.cuda.synchronize(emit.device)
    t2 = time.perf_counter()
    if not bool(ok.all()):
        raise RuntimeError("a lane did not finish within the encode cap")
    wtot = _u32(wtotals)
    if len(wtot) and int(wtot.max()) >= MAX_LANE_WORDS:
        raise ValueError(
            "a lane emitted >= 2^23 stream words; use more encode blocks "
            "(num_blocks) so per-lane output stays under 16 MiB")
    cap, tstart, tend = plan.cap, plan.tstart_np, plan.tend_np
    EP = _emit_pairs(plan.params[9])
    emit = _u32(emit)
    states = _u32(states)
    final_states = _u32(final_states)

    meta = emit[cap * EP:]                       # [cap, Bn]
    Bn = len(tstart)
    steps_per_lane = (tend - tstart).astype(np.int64)
    live = np.arange(cap)[:, None] < steps_per_lane[None, :]
    nemit = np.where(live, meta & 0xFF, 0).astype(np.int64)
    is_out = live & (((meta >> 8) & 1).astype(bool))
    wcnt_after = (meta >> 9).astype(np.int64)

    # global order: the serial emission processes the LAST block first
    lane_totals = nemit.sum(axis=0)
    offsets = np.zeros(Bn, np.int64)  # global word offset of each lane
    offsets[:-1] = np.cumsum(lane_totals[::-1])[::-1][1:]
    total_words = int(lane_totals.sum())
    # word j of step s in lane l goes to
    #   offsets[l] + (exclusive cumsum of nemit over steps)[s, l] + j
    pos = np.cumsum(nemit, axis=0) - nemit + offsets[None, :]
    stream = np.zeros(total_words, np.uint16)
    for p in range(EP):
        pairs = emit[:cap * EP][p::EP]           # rows s*EP+p -> [cap, Bn]
        m0 = nemit > 2 * p
        stream[(pos + 2 * p)[m0]] = (pairs & 0xFFFF).astype(np.uint16)[m0]
        m1 = nemit > 2 * p + 1
        stream[(pos + 2 * p + 1)[m1]] = (pairs >> 16).astype(np.uint16)[m1]

    # phases in reverse global node order: lanes last to first, steps
    # ascending within each lane
    sel = is_out[:, ::-1].T                      # [Bn (desc), cap]
    states_out = states[:, ::-1].T[sel]
    pointers_out = (wcnt_after + offsets[None, :])[:, ::-1].T[sel] \
        .astype(np.uint64)
    final_state = int(final_states[0]) if Bn else LOWER_BOUND
    blocks = (plan.block_nodes.astype(np.uint32),
              final_states.astype(np.uint32),
              (offsets + lane_totals).astype(np.uint64))
    if seconds is not None:
        seconds["encode_plan"] = t1 - t0
        seconds["encode_kernel"] = t2 - t1
        seconds["encode_assembly"] = time.perf_counter() - t2
    return (stream, states_out.astype(np.uint32), pointers_out, final_state,
            blocks)
