"""Device model construction: the (fidelity, radix) x frame-size grid
search over folded symbol distributions, with every candidate a lane.

The reference runs the search serially per component (reference:
src/ans/model4encoder_builder.rs:80-271, the CPU-heavy part of
compression). Here every (combo, frame) candidate of every component is a
lane: symbol folding is a numpy scatter-add on the host, and the exact
frequency-rescaling recurrence (reference: src/utils/data_utils.rs:15-39)
runs as ONE float64 loop over the sorted symbols on the device, with all
lanes advancing in lockstep and the approximate folded-distribution cost
(reference: builder.rs:297-327) accumulating in the same loop. Only the
reference's acceptance logic (builder.rs:165-206) stays on the host,
replicated exactly, so the model chosen equals the host search's
(ans/model.build_model) and the compressed bytes are the same.

float64 is required for bit-identical rescaling. There is no CUDA kernel
here: the loop is plain PyTorch, one launch per elementwise operation.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ans.model import (ANSModel, ComponentModel, Histogram,
                         NUM_COMPONENTS, PARAMS_COMBINATIONS, THETA,
                         _component_entropy, fold_symbols)
from .decode_torch import resolve_device


def _fold_all_combos(syms: np.ndarray, counts: np.ndarray):
    """Folded histograms for every (fidelity, radix) combo: returns
    (folded [C, MAXB] int64, biggest [C] int64)."""
    C = len(PARAMS_COMBINATIONS)
    folded_idx = np.empty((C, len(syms)), dtype=np.int64)
    for ci, (f, r) in enumerate(PARAMS_COMBINATIONS):
        thr = 1 << (f + r - 1)
        below = syms < thr
        fi = np.empty(len(syms), dtype=np.int64)
        fi[below] = syms[below].astype(np.int64)
        if (~below).any():
            fi[~below] = fold_symbols(syms[~below], r, f)
        folded_idx[ci] = fi
    biggest = folded_idx.max(axis=1)
    maxb = int(biggest.max()) + 1
    folded = np.zeros((C, maxb), dtype=np.int64)
    for ci in range(C):
        np.add.at(folded[ci], folded_idx[ci], counts.astype(np.int64))
    return folded, biggest


def _candidates(syms, counts, max_frame_log2: int) -> dict:
    """One component's candidate lanes: (combo, frame) pairs with
    m >= next_pow2(nnz), with each lane's sorted frequencies and fold-cost
    bits (ascending frequency, ties by symbol index, zero frequencies
    last)."""
    C = len(PARAMS_COMBINATIONS)
    folded, biggest = _fold_all_combos(syms, counts)   # [C, D]
    D = folded.shape[1]
    nnz = (folded > 0).sum(axis=1).astype(np.int64)
    sort_key = np.where(folded > 0, folded, np.iinfo(np.int64).max)
    order = np.argsort(sort_key, axis=1, kind="stable")

    fold_bits = np.zeros((C, D), dtype=np.float64)
    sym_idx = np.arange(D)
    for ci, (f, r) in enumerate(PARAMS_COMBINATIONS):
        thr = 1 << (f + r - 1)
        off = ((1 << r) - 1) * (1 << (f - 1))
        folds = np.where(sym_idx < thr, 0, (sym_idx - thr) // off + 1)
        fold_bits[ci] = folds * r

    m0_exp = np.where(nnz > 1,
                      np.ceil(np.log2(np.maximum(nnz, 1))).astype(np.int64),
                      0)
    combo_l, exp_l = np.meshgrid(np.arange(C), np.arange(max_frame_log2 + 1),
                                 indexing="ij")
    combo_l, exp_l = combo_l.ravel(), exp_l.ravel()
    keep = exp_l >= m0_exp[combo_l]
    combo_l, exp_l = combo_l[keep], exp_l[keep]
    W = int(nnz.max())
    cols = order[:, :W]
    return {
        "folded": folded, "biggest": biggest, "order": order,
        "nnz": nnz, "m0_exp": m0_exp, "combo": combo_l, "exp": exp_l,
        "f_sorted": np.take_along_axis(folded, cols, axis=1)[combo_l],
        "fb_sorted": np.take_along_axis(fold_bits, cols, axis=1)[combo_l],
    }


def _scan_lanes(f_sorted, fb_sorted, nnz, m, total):
    """Lockstep scale_freqs + cost over lanes, plain PyTorch in float64 on
    the tensors' device: f_sorted int64 [L, W] (each lane's frequencies in
    sort order, zero past nnz), fb_sorted float64 [L, W] (fold-cost bits),
    nnz / m / total int64 [L]. Returns (ok bool [L], cost float64 [L],
    approx int64 [L, W])."""
    L, W = f_sorted.shape
    f64 = torch.float64
    ratio = m.to(f64) / total.to(f64)
    n_f = nnz.to(f64)
    new_m = m.clone()
    m_rem = total.clone()
    ok = torch.ones(L, dtype=torch.bool, device=m.device)
    cost = torch.zeros(L, dtype=f64, device=m.device)
    approx_all = torch.empty((W, L), dtype=torch.int64, device=m.device)
    m_f = m.to(f64)
    for i in range(W):
        f = f_sorted[:, i]
        f_f = f.to(f64)
        valid = i < nnz
        second_ratio = new_m.to(f64) / m_rem.to(f64)
        scale = (n_f - i) * ratio / n_f + i * second_ratio / n_f
        approx_f = torch.floor(0.5 + scale * f_f)
        approx = torch.where(approx_f < 1.0, 1, approx_f.to(torch.int64))
        approx = torch.where(valid, approx, 0)
        new_m = new_m - approx
        m_rem = torch.where(valid, m_rem - f, m_rem)
        ok = ok & (new_m >= 0)
        p = approx.to(f64) / m_f
        contrib = torch.where(
            valid,
            (-torch.log2(torch.where(approx > 0, p, 1.0)) + fb_sorted[:, i])
            * f_f, 0.0)
        cost = cost + contrib
        approx_all[i] = approx
    return ok, cost, approx_all.T


def build_model_torch(histograms: list[Histogram], max_frame_log2: int = 16,
                      device=None) -> ANSModel:
    """The model of ans.model.build_model, with the per-candidate scaling
    and cost sweep of all nine components in one lane loop on `device`
    (CUDA unless given; device="cpu" runs it on the host)."""
    device = resolve_device(device)
    original_costs = []
    totals = []
    for _syms, counts in histograms:
        total = int(counts.sum()) if len(counts) else 0
        totals.append(total)
        original_costs.append(_component_entropy(counts, total)
                              if total else 0.0)
    original_graph_cost = float(sum(original_costs))
    max_frame = 1 << max_frame_log2

    cands = {}
    for comp in range(NUM_COMPONENTS):
        syms, counts = histograms[comp]
        if len(syms):
            cands[comp] = _candidates(syms.astype(np.uint64),
                                      counts.astype(np.uint64),
                                      max_frame_log2)
    ok = cost = approx = None
    if cands:
        lane0 = 0   # each component's first lane in the batch
        for c in cands.values():
            c["lane0"] = lane0
            lane0 += len(c["combo"])
        W = max(c["f_sorted"].shape[1] for c in cands.values())

        def cat(key, dtype):
            parts = []
            for c in cands.values():
                a = c[key]
                parts.append(np.pad(a, ((0, 0), (0, W - a.shape[1]))))
            return torch.from_numpy(np.concatenate(parts).astype(dtype))

        lane_nnz = np.concatenate([c["nnz"][c["combo"]]
                                   for c in cands.values()])
        lane_m = np.concatenate([1 << c["exp"].astype(np.int64)
                                 for c in cands.values()])
        lane_total = np.concatenate([np.full(len(c["combo"]), totals[comp],
                                             np.int64)
                                     for comp, c in cands.items()])
        ok, cost, approx = _scan_lanes(
            cat("f_sorted", np.int64).to(device),
            cat("fb_sorted", np.float64).to(device),
            torch.from_numpy(lane_nnz).to(device),
            torch.from_numpy(lane_m).to(device),
            torch.from_numpy(lane_total).to(device))
        ok = ok.cpu().numpy()
        cost = cost.cpu().numpy()

    components: list[ComponentModel] = []
    for comp in range(NUM_COMPONENTS):
        if comp not in cands:
            components.append(ComponentModel(np.zeros(0, dtype=np.uint16),
                                             0, 2, 2))
            continue
        c = cands[comp]
        combo_l, exp_l, m0_exp = c["combo"], c["exp"], c["m0_exp"]
        lane_of = {(int(ci), int(e)): c["lane0"] + i
                   for i, (ci, e) in enumerate(zip(combo_l, exp_l))}

        # ---- exact reference acceptance logic (builder.rs:140-206) ----
        best = None
        best_frame = None
        lowest_cost = math.inf
        for ci in range(len(PARAMS_COMBINATIONS)):
            for e in range(int(m0_exp[ci]), max_frame_log2 + 1):
                if (ci, e) not in lane_of:
                    break  # this combo needs a frame beyond the cap
                li = lane_of[(ci, e)]
                if not ok[li]:
                    continue
                m = 1 << e
                new_cost = cost[li]
                difference = new_cost - original_costs[comp]
                if original_graph_cost != 0.0:
                    ratio = ((original_graph_cost + difference)
                             / original_graph_cost)
                else:
                    ratio = 1.0 if difference <= 0.0 else math.inf
                if ratio <= THETA:
                    if best_frame is None or m < best_frame:
                        lowest_cost = new_cost
                        best = li
                        best_frame = m
                elif m == max_frame:
                    if new_cost >= lowest_cost:
                        break
                    lowest_cost = new_cost
                    best = li
                    best_frame = m
                    break

        assert best is not None, (
            f"component {comp}: no foldable distribution fits a 2^16 frame")
        local = best - c["lane0"]
        ci = int(combo_l[local])
        fidelity, radix = PARAMS_COMBINATIONS[ci]
        big = int(c["biggest"][ci])
        nnz = int(c["nnz"][ci])
        # approx follows the sort order; scatter back to symbol index
        dist = np.zeros(c["folded"].shape[1], dtype=np.int64)
        dist[c["order"][ci][:nnz]] = approx[best, :nnz].cpu().numpy()
        components.append(ComponentModel(
            dist[: big + 1].astype(np.uint16), int(exp_l[local]), radix,
            fidelity))

    return ANSModel(components)
