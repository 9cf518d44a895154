"""Cost estimators steering BvComp's reference selection.

- Log2 estimator: cost(v) = floor(log2(v + 2)); used to bootstrap pass 1
  (reference: src/bvgraph/estimators/log2_estimator.rs:15-49). Implemented
  directly in the native BvComp (est_type=0).
- Entropy estimator: per-component fixed-point cost tables derived from a
  built ANS model: ceil(-log2(p) * 2^16) + folds*radix*2^16
  (reference: src/bvgraph/estimators/entropy_estimator.rs:33-113). The tables
  are computed here (vectorized) and consumed by the native BvComp.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..ans.model import ANSModel, MAX_RAW_SYMBOL, NUM_COMPONENTS, fold_one

LOG2 = 0
ENTROPY = 1


@dataclasses.dataclass
class EntropyTables:
    """Flattened per-component cost tables for the native API."""

    costs: np.ndarray      # u64, concatenated
    lens: np.ndarray       # u64[9]
    fidelity: np.ndarray   # u32[9]
    radix: np.ndarray      # u32[9]


def entropy_tables(model: ANSModel) -> EntropyTables:
    tables = []
    fidelity = np.zeros(NUM_COMPONENTS, dtype=np.uint32)
    radix = np.zeros(NUM_COMPONENTS, dtype=np.uint32)
    for comp, c in enumerate(model.components):
        fidelity[comp] = c.fidelity
        radix[comp] = c.radix
        max_folded = fold_one(MAX_RAW_SYMBOL, c.radix, c.fidelity)
        syms = np.arange(max_folded + 1, dtype=np.int64)
        freqs = np.ones(max_folded + 1, dtype=np.float64)
        if len(c.freqs):
            table = c.freqs.astype(np.float64)
            table[table == 0] = 1.0  # zero-frequency symbols cost as freq 1
            k = min(len(table), max_folded + 1)
            freqs[:k] = table[:k]
        threshold = c.folding_threshold
        offset = c.folding_offset
        folds = np.where(syms < threshold, 0, (syms - threshold) // max(offset, 1) + 1)
        prob = freqs / float(1 << c.log_m)
        shifted = np.round(-np.log2(prob) * 65536.0).astype(np.uint64)
        cost = shifted + (folds.astype(np.uint64) * c.radix) * 65536
        tables.append(cost)
    costs = np.concatenate(tables)
    lens = np.array([len(t) for t in tables], dtype=np.uint64)
    return EntropyTables(costs.astype(np.uint64), lens, fidelity, radix)


def empty_tables() -> EntropyTables:
    """Placeholder tables for the log2 estimator (est_type=0 ignores them)."""
    return EntropyTables(
        np.zeros(9, dtype=np.uint64),
        np.ones(NUM_COMPONENTS, dtype=np.uint64),
        np.full(NUM_COMPONENTS, 2, dtype=np.uint32),
        np.full(NUM_COMPONENTS, 2, dtype=np.uint32),
    )
