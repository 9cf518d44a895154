"""Pure-Python reference rANS encoder + minimal no-reference BvGraph token
emitter.

Mirrors the native encoder exactly (native/src/ans.hpp ANSEncoder;
reference: src/ans/encoder.rs:39-86) so that:
- the multi-device dry run (webgraph_ans_torch/dryrun.py) can synthesize
  a VALID compressed stream without the C++ runtime, and
- tests can cross-check the native encoder against an independent
  implementation.
"""

from __future__ import annotations

import numpy as np

from .model import ANSModel, ComponentModel, fold_one

B = 16
LOWER_BOUND = 1 << 16
MASK16 = 0xFFFF


class PyANSEncoder:
    def __init__(self, model: ANSModel):
        self.model = model
        self.state = LOWER_BOUND
        self.stream: list[int] = []
        self._cumul = []
        self._upper = []
        for c in model.components:
            cum, up = [], []
            acc = 0
            # k = 16 - log_m exactly (reference
            # component_model4encoder.rs:28-35: upperbound is u64;
            # a frame-1 component has bound 2^32 and never shrinks)
            k = 16 - c.log_m
            for f in c.freqs.tolist():
                cum.append(acc & MASK16)
                acc += int(f)
                up.append((1 << (k + B)) * int(f))
            self._cumul.append(cum)
            self._upper.append(up)

    def _shrink(self):
        self.stream.append(self.state & MASK16)
        self.state >>= B

    def encode(self, symbol: int, comp: int):
        c = self.model.components[comp]
        if symbol >= c.folding_threshold:
            folds = (symbol.bit_length() - c.fidelity) // c.radix
            radix_mask = (1 << c.radix) - 1
            for _ in range(folds):
                if (32 - self.state.bit_length()) < c.radix:
                    self._shrink()
                self.state = ((self.state << c.radix) & 0xFFFFFFFF) + (symbol & radix_mask)
                symbol >>= c.radix
            symbol += c.folding_offset * folds
        freq = int(c.freqs[symbol])
        if self.state >= self._upper[comp][symbol]:
            self._shrink()
        block = self.state // freq
        self.state = ((block << c.log_m) + self._cumul[comp][symbol]
                      + (self.state - block * freq)) & 0xFFFFFFFF


def tokens_no_reference(lists, window: int = 7, min_interval: int = 2):
    """Emits the (component, value) token stream of a graph encoded with
    reference 0 everywhere (intervals + residuals only) — the grammar subset
    sufficient for synthetic dry runs. Token order mirrors BvComp's emit
    (native/src/bvgraph.hpp:377-407)."""
    toks: list[tuple[int, int]] = []
    for x, succ in enumerate(lists):
        d = len(succ)
        toks.append((0, d))
        if d == 0:
            continue
        if window > 0:
            toks.append((1, 0))
        intervals, residuals = [], []
        i = 0
        succ = list(succ)
        while i < d:
            j = i + 1
            while j < d and succ[j] == succ[j - 1] + 1:
                j += 1
            if min_interval != 0 and j - i >= min_interval:
                intervals.append((succ[i], j - i))
            else:
                residuals.extend(succ[i:j])
            i = j
        if min_interval != 0 and d > 0:
            toks.append((4, len(intervals)))
            prev = 0
            for i, (left, length) in enumerate(intervals):
                if i == 0:
                    delta = left - x
                    toks.append((5, 2 * delta if delta >= 0 else 2 * -delta - 1))
                else:
                    toks.append((5, left - prev - 1))
                toks.append((6, length - min_interval))
                prev = left + length
        if residuals:
            delta = residuals[0] - x
            toks.append((7, 2 * delta if delta >= 0 else 2 * -delta - 1))
            for a, b_ in zip(residuals, residuals[1:]):
                toks.append((8, b_ - a - 1))
    return toks


def simple_model_for(tokens, radix: int = 2, fidelity: int = 2) -> ANSModel:
    """Builds a valid (not size-optimal) ANSModel for a token stream:
    every used folded symbol gets frequency >= 1 in a power-of-two frame."""
    comps = []
    thr = 1 << (fidelity + radix - 1)
    for comp in range(9):
        vals = [v for c, v in tokens if c == comp]
        if not vals:
            comps.append(ComponentModel(np.zeros(0, dtype=np.uint16), 0, radix, fidelity))
            continue
        folded = [v if v < thr else fold_one(v, radix, fidelity) for v in vals]
        hi = max(folded)
        freqs = np.zeros(hi + 1, dtype=np.int64)
        for fsym in folded:
            freqs[fsym] += 1
        used = int((freqs > 0).sum())
        m = 1
        while m < used + 1:
            m *= 2
        # frequency 1 for every used symbol, leftover mass to the most
        # frequent one (valid, not size-optimal; keeps freqs well inside u16)
        scaled = (freqs > 0).astype(np.int64)
        scaled[int(np.argmax(freqs))] += m - used
        assert scaled.sum() == m and (scaled[freqs > 0] > 0).all()
        comps.append(ComponentModel(scaled.astype(np.uint16),
                                    m.bit_length() - 1, radix, fidelity))
    return ANSModel(comps)


def encode_graph_py(lists, window: int = 7, min_interval: int = 2):
    """Full pure-Python encode of a no-reference graph: returns
    (model, stream u16, states u32 node order, pointers i64 node order,
    final_state). Matches the on-disk phase semantics (reverse-order encode
    with a phase per outdegree; native/src/ans.hpp BufferSink::encode)."""
    toks = tokens_no_reference(lists, window, min_interval)
    model = simple_model_for(toks)
    enc = PyANSEncoder(model)
    states, pointers = [], []
    for comp, val in reversed(toks):
        enc.encode(val, comp)
        if comp == 0:
            states.append(enc.state)
            pointers.append(len(enc.stream))
    states = np.array(states[::-1], dtype=np.uint32)
    pointers = np.array(pointers[::-1], dtype=np.int64)
    stream = np.array(enc.stream, dtype=np.uint16)
    return model, stream, states, pointers, enc.state
