"""Pure-Python rANS codec: the executable specification of the stream format.

Bit-for-bit identical behavior to the native codec (and to the reference's
semantics: encoder src/ans/encoder.rs:39-86, decoder src/ans/decoder.rs:58-100,
decoder LUT src/ans/models/model4decoder.rs:18-68). Used by tests to
cross-validate the native runtime and the device kernels' plain versions.
Slow by design; use the native codec or the device kernels for real work.
"""

from __future__ import annotations

import numpy as np

from .model import ANSModel, ComponentModel

B = 16
INTERVAL_LOWER_BOUND = 1 << 16
NORMALIZATION_MASK = 0xFFFF
BIT_RESERVED_FOR_SYMBOL = 48


class PyANSEncoder:
    def __init__(self, model: ANSModel):
        self.model = model
        self.state = INTERVAL_LOWER_BOUND
        self.stream: list[int] = []
        self._tables = []
        for c in model.components:
            cumul = c.cumul()
            k = 16 - c.log_m   # u64 bound; frame-1 never shrinks
            upper = [(1 << (k + B)) * int(f) for f in c.freqs]
            self._tables.append((c, cumul, upper))

    def encode(self, symbol: int, component: int) -> None:
        c, cumul, upper = self._tables[component]
        if symbol >= c.folding_threshold:
            folds = (symbol.bit_length() - c.fidelity) // c.radix
            mask = (1 << c.radix) - 1
            for _ in range(folds):
                bits = symbol & mask
                if self._leading_zeros(self.state) < c.radix:
                    self._shrink()
                self.state = ((self.state << c.radix) + bits) & 0xFFFFFFFF
                symbol >>= c.radix
            symbol += c.folding_offset * folds
        freq = int(c.freqs[symbol])
        if self.state >= upper[symbol]:
            self._shrink()
        block = self.state // freq
        self.state = ((block << c.log_m) + int(cumul[symbol]) + (self.state - block * freq)) & 0xFFFFFFFF

    def phase(self) -> tuple[int, int]:
        return self.state, len(self.stream)

    @staticmethod
    def _leading_zeros(v: int) -> int:
        return 32 - v.bit_length()

    def _shrink(self) -> None:
        self.stream.append(self.state & NORMALIZATION_MASK)
        self.state >>= B


class PyANSDecoder:
    def __init__(self, model: ANSModel, stream, state: int, pointer: int | None = None):
        self.stream = list(stream)
        self.state = state
        self.ptr = len(self.stream) if pointer is None else pointer
        self._luts = []
        for c in model.components:
            frame = 1 << c.log_m
            cumul = c.cumul()
            freq_lut = np.zeros(frame, dtype=np.uint32)
            cumul_lut = np.zeros(frame, dtype=np.uint32)
            quasi_lut = np.zeros(frame, dtype=np.uint64)
            slot = 0
            for sym, f in enumerate(c.freqs):
                f = int(f)
                if f == 0:
                    continue
                qf = self._quasi_fold(sym, c)
                freq_lut[slot : slot + f] = f
                cumul_lut[slot : slot + f] = cumul[sym]
                quasi_lut[slot : slot + f] = qf
                slot += f
            self._luts.append((c, freq_lut, cumul_lut, quasi_lut))

    @staticmethod
    def _quasi_fold(sym: int, c: ComponentModel) -> int:
        if sym < c.folding_threshold:
            return sym
        folds = (sym - c.folding_threshold) // c.folding_offset + 1
        v = (sym - c.folding_offset * folds) << (folds * c.radix)
        return v | (folds << BIT_RESERVED_FOR_SYMBOL)

    def decode(self, component: int) -> int:
        c, freq_lut, cumul_lut, quasi_lut = self._luts[component]
        mask = (1 << c.log_m) - 1
        slot = self.state & mask
        freq, cumul, qf = int(freq_lut[slot]), int(cumul_lut[slot]), int(quasi_lut[slot])
        self.state = (self.state >> c.log_m) * freq + slot - cumul
        if self.state < INTERVAL_LOWER_BOUND:
            self._extend()
        quasi_unfolded = qf & ((1 << BIT_RESERVED_FOR_SYMBOL) - 1)
        folds = qf >> BIT_RESERVED_FOR_SYMBOL
        fold = 0
        rmask = (1 << c.radix) - 1
        for _ in range(folds):
            if self.state < INTERVAL_LOWER_BOUND:
                self._extend()
            fold = (fold << c.radix) | (self.state & rmask)
            self.state >>= c.radix
            if self.state < INTERVAL_LOWER_BOUND:
                self._extend()
        return quasi_unfolded | fold

    def _extend(self) -> None:
        self.ptr -= 1
        self.state = ((self.state << B) | int(self.stream[self.ptr])) & 0xFFFFFFFF
