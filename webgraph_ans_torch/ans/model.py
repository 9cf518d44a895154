"""ANS model construction: per-component (fidelity, radix) x frame-size grid
search over folded symbol distributions.

Semantics match the reference model builder exactly so that compressed sizes
are on par (reference: src/ans/model4encoder_builder.rs:80-271):

- candidate (fidelity, radix) pairs with 4 <= f+r <= 11, in the same order
- per-candidate folding of the raw histogram (Moffat quasi-folding)
- frequency rescaling to a power-of-two frame m <= 2^16, low-frequency
  symbols first (native wgt_scale_freqs, reference src/utils/data_utils.rs)
- accept the smallest frame whose folded-distribution cost inflates the
  total graph cost by at most THETA; fall back to the best max-frame
  distribution otherwise

The only intentional divergence: ties between equal-frequency symbols are
broken by symbol index (numpy stable argsort) where the reference's
sort_unstable is arbitrary; both orders are valid inputs to scale_freqs.

This module is the exact host model search; ops/model_torch.py runs the
same search with every candidate a lane on the device.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np

from ..utils import native

# Maximum raw symbol (reference: src/lib.rs:18).
MAX_RAW_SYMBOL = (1 << 48) - 1
# Maximum ANS frame size (reference: src/ans/mod.rs:28).
MAXIMUM_FRAME_SIZE = 1 << 16
# Accepted cost-inflation bound (reference: builder.rs:23).
THETA = 1.0001
NUM_COMPONENTS = 9

# (fidelity, radix) combinations, 4 <= f+r <= 11, reference order
# (reference: builder.rs:28-37).
PARAMS_COMBINATIONS: tuple[tuple[int, int], ...] = tuple(
    (f, s - f) for s in range(4, 12) for f in range(1, s)
)


def ilog2_u64(v: np.ndarray) -> np.ndarray:
    """Exact floor(log2(v)) for uint64 v in [1, 2^53)."""
    _, e = np.frexp(v.astype(np.float64))
    return (e - 1).astype(np.int64)


def fold_symbols(syms: np.ndarray, radix: int, fidelity: int) -> np.ndarray:
    """Vectorized fold_without_streaming_out (reference: ans_utils.rs:4-12).
    Caller must guarantee syms >= folding threshold."""
    syms = syms.astype(np.uint64)
    cuts = ((ilog2_u64(syms) + 1 - fidelity) // radix).astype(np.uint64)
    shifted = syms >> (cuts * np.uint64(radix))
    offset = np.uint64(((1 << radix) - 1) * (1 << (fidelity - 1)))
    return (shifted + offset * cuts).astype(np.int64)


def fold_one(sym: int, radix: int, fidelity: int) -> int:
    cuts = (sym.bit_length() - fidelity) // radix
    return (sym >> (cuts * radix)) + ((1 << radix) - 1) * (1 << (fidelity - 1)) * cuts


@dataclasses.dataclass
class ComponentModel:
    """Per-component encoder model (reference: component_model4encoder.rs:37-70)."""

    freqs: np.ndarray  # uint16 scaled frequencies, indexed by folded symbol
    log_m: int         # log2 of frame size
    radix: int = 2
    fidelity: int = 2

    @property
    def folding_threshold(self) -> int:
        return 1 << (self.fidelity + self.radix - 1)

    @property
    def folding_offset(self) -> int:
        return ((1 << self.radix) - 1) * (1 << (self.fidelity - 1))

    @property
    def frame_size(self) -> int:
        return 1 << self.log_m

    def cumul(self) -> np.ndarray:
        c = np.zeros(len(self.freqs), dtype=np.uint32)
        np.cumsum(self.freqs[:-1], out=c[1:])
        return c.astype(np.uint16)


@dataclasses.dataclass
class ANSModel:
    components: list[ComponentModel]

    def packed(self):
        """Flattened arrays for the native API (freqs concat + per-comp params)."""
        freqs = np.concatenate([c.freqs for c in self.components]) if any(
            len(c.freqs) for c in self.components
        ) else np.zeros(0, dtype=np.uint16)
        lens = np.array([len(c.freqs) for c in self.components], dtype=np.uint64)
        log_m = np.array([c.log_m for c in self.components], dtype=np.uint32)
        radix = np.array([c.radix for c in self.components], dtype=np.uint32)
        fidelity = np.array([c.fidelity for c in self.components], dtype=np.uint32)
        return freqs.astype(np.uint16), lens, log_m, radix, fidelity


Histogram = tuple[np.ndarray, np.ndarray]  # (symbols u64, counts u64)


def _scale_freqs(freqs: np.ndarray, sorted_idx: np.ndarray, total: int, new_m: int):
    """Exact reference rescaling via the native kernel. Returns the scaled
    array or None if new_m is too small."""
    lib = native.get_lib()
    out = freqs.copy()
    rc = lib.wgt_scale_freqs(
        native.as_ptr(freqs, ctypes.c_uint64),
        native.as_ptr(sorted_idx, ctypes.c_uint64),
        len(sorted_idx),
        total,
        new_m,
        native.as_ptr(out, ctypes.c_uint64),
    )
    return out if rc == 0 else None


def _approx_cost(folded: np.ndarray, approx: np.ndarray, m: int, fidelity: int, radix: int) -> float:
    """Cost of encoding the folded distribution with the approximated one:
    self-information under approx probabilities plus folds*radix bits per
    folded occurrence (reference: builder.rs:297-327)."""
    threshold = 1 << (fidelity + radix - 1)
    offset = ((1 << radix) - 1) * (1 << (fidelity - 1))
    nz = np.nonzero(approx)[0]
    freq = folded[nz].astype(np.float64)
    folds = np.where(nz < threshold, 0, (nz - threshold) // offset + 1).astype(np.float64)
    prob = approx[nz].astype(np.float64) / float(m)
    return float(np.sum((-np.log2(prob) + folds * radix) * freq))


def _component_entropy(counts: np.ndarray, total: int) -> float:
    p = counts.astype(np.float64) / float(total)
    return float(np.sum(-np.log2(p) * counts.astype(np.float64)))


def build_model(histograms: list[Histogram],
                max_frame_log2: int = 16) -> ANSModel:
    """Builds the 9-component ANSModel from raw-symbol histograms
    (reference: builder.rs:80-271).

    max_frame_log2 < 16 trades a little compression for decode-table size:
    the decode LUT stays small enough to cache on the device. 16 reproduces the reference exactly."""
    original_costs = []
    totals = []
    for syms, counts in histograms:
        total = int(counts.sum()) if len(counts) else 0
        totals.append(total)
        original_costs.append(_component_entropy(counts, total) if total else 0.0)
    original_graph_cost = float(sum(original_costs))

    components: list[ComponentModel] = []
    for comp in range(NUM_COMPONENTS):
        syms, counts = histograms[comp]
        if len(syms) == 0:
            components.append(ComponentModel(np.zeros(0, dtype=np.uint16), 0, 2, 2))
            continue
        syms = syms.astype(np.uint64)
        counts = counts.astype(np.uint64)
        total = totals[comp]

        max_frame = 1 << max_frame_log2
        best = None  # (frame_size, fidelity, radix, distribution, cost)
        best_frame = None
        lowest_cost = math.inf

        for fidelity, radix in PARAMS_COMBINATIONS:
            max_bucket = fold_one(MAX_RAW_SYMBOL, radix, fidelity)
            threshold = 1 << (fidelity + radix - 1)
            below = syms < threshold
            folded_idx = np.empty(len(syms), dtype=np.int64)
            folded_idx[below] = syms[below].astype(np.int64)
            if (~below).any():
                folded_idx[~below] = fold_symbols(syms[~below], radix, fidelity)
            folded = np.zeros(max_bucket, dtype=np.uint64)
            np.add.at(folded, folded_idx, counts)
            biggest_symbol = int(folded_idx.max())

            nz = np.nonzero(folded)[0]
            n = len(nz)
            m = 1 << (n - 1).bit_length() if n > 1 else n
            # ascending frequency; ties by symbol index (stable)
            order = np.argsort(folded[nz], kind="stable")
            sorted_idx = nz[order].astype(np.uint64)

            if m > max_frame:
                continue
            while m <= max_frame:
                approx = _scale_freqs(folded, sorted_idx, total, m)
                if approx is None:
                    m *= 2
                    continue
                new_cost = _approx_cost(folded, approx, m, fidelity, radix)
                difference = new_cost - original_costs[comp]
                if original_graph_cost != 0.0:
                    ratio = (original_graph_cost + difference) / original_graph_cost
                else:
                    # Deliberate divergence: a zero-entropy graph puts the
                    # reference on a 0/0=NaN path whose max-frame fallback
                    # wraps freq 2^16 to 0 (u16 cast, builder.rs:224-231) and
                    # ends in an unchecked division by zero (encoder.rs:67-73,
                    # UB). Accept any zero-extra-cost distribution at the
                    # smallest frame instead.
                    ratio = 1.0 if difference <= 0.0 else math.inf
                if ratio <= THETA:
                    if best_frame is None or m < best_frame:
                        lowest_cost = new_cost
                        best = (m, fidelity, radix, approx[: biggest_symbol + 1].copy())
                        best_frame = m
                elif m == max_frame:
                    # never found an acceptable distribution at this combo;
                    # keep the best max-frame one across combos
                    if new_cost >= lowest_cost:
                        break
                    lowest_cost = new_cost
                    best = (m, fidelity, radix, approx[: biggest_symbol + 1].copy())
                    best_frame = m
                    break
                m *= 2

        assert best is not None, (
            f"component {comp}: no foldable distribution fits a 2^16 frame"
        )
        m, fidelity, radix, dist = best
        log_m = m.bit_length() - 1
        components.append(
            ComponentModel(dist.astype(np.uint16), log_m, radix, fidelity)
        )

    return ANSModel(components)


def model_report(model: ANSModel, histograms: list[Histogram]) -> list[dict]:
    """Structured per-component report (replaces the reference's parsed log
    output, builder.rs:237-266 + percomponent_analysis.py)."""
    report = []
    names = [
        "Outdegree", "ReferenceOffset", "BlockCount", "Blocks", "IntervalCount",
        "IntervalStart", "IntervalLen", "FirstResidual", "Residual",
    ]
    for comp, c in enumerate(model.components):
        syms, counts = histograms[comp]
        total = int(counts.sum()) if len(counts) else 0
        cost_bits = 0.0
        if total:
            threshold = c.folding_threshold
            below = syms < threshold
            folded_idx = np.empty(len(syms), dtype=np.int64)
            folded_idx[below] = syms[below].astype(np.int64)
            if (~below).any():
                folded_idx[~below] = fold_symbols(syms[~below], c.radix, c.fidelity)
            folded = np.zeros(max(len(c.freqs), int(folded_idx.max()) + 1), dtype=np.uint64)
            np.add.at(folded, folded_idx, counts)
            approx = np.zeros_like(folded)
            approx[: len(c.freqs)] = c.freqs
            cost_bits = _approx_cost(folded, approx, c.frame_size, c.fidelity, c.radix)
        report.append(
            {
                "component": names[comp],
                "frame_log2": c.log_m,
                "radix": c.radix,
                "fidelity": c.fidelity,
                "symbols": total,
                "est_cost_bytes": cost_bits / 8.0,
            }
        )
    return report
