// Common type aliases and small helpers for the webgraph-ans-tpu native runtime.
//
// Type base mirrors the reference's global aliases (reference: src/lib.rs:10-24):
//   Symbol   = u16 (folded symbols)
//   RawSymbol= u64 (pre-folding values, <= 2^48-1)
//   State    = u32 (rANS state)
//   Freq     = u16 (scaled frequencies)
#pragma once

#include <cstdint>
#include <cstddef>
#include <cstring>
#include <vector>
#include <string>
#include <stdexcept>

namespace wgans {

using Symbol = uint16_t;
using RawSymbol = uint64_t;
using State = uint32_t;
using Freq = uint16_t;

// reference: src/lib.rs:18
constexpr RawSymbol MAX_RAW_SYMBOL = (1ULL << 48) - 1;
// rANS renormalization chunk log2 (reference: src/ans/mod.rs:18)
constexpr unsigned B = 16;
// reference: src/ans/mod.rs:21
constexpr State INTERVAL_LOWER_BOUND = 1u << 16;
// reference: src/ans/mod.rs:24
constexpr uint32_t NORMALIZATION_MASK = 0xFFFFu;
// reference: src/ans/mod.rs:28
constexpr size_t MAXIMUM_FRAME_SIZE = 1 << 16;

inline unsigned ilog2_u64(uint64_t v) {
  // floor(log2(v)); v must be > 0.
  return 63u - static_cast<unsigned>(__builtin_clzll(v));
}

// Number of leading zeros of a 32-bit state (clz(0) == 32).
inline unsigned clz32(uint32_t v) {
  return v == 0 ? 32u : static_cast<unsigned>(__builtin_clz(v));
}

// Moffat quasi-folding without streaming bits out: cut `cuts*radix` low bits,
// add a per-cut offset so folded buckets do not collide.
// reference: src/utils/ans_utils.rs:4-12
inline Symbol fold_without_streaming_out(RawSymbol sym, unsigned radix, unsigned fidelity) {
  unsigned cuts = (ilog2_u64(sym) + 1 - fidelity) / radix;
  uint64_t bits_to_cut = static_cast<uint64_t>(cuts) * radix;
  sym >>= bits_to_cut;
  uint64_t offset = ((1ULL << radix) - 1) * (1ULL << (fidelity - 1)) * cuts;
  uint64_t folded = sym + offset;
  if (folded > 0xFFFF) throw std::runtime_error("folded symbol exceeds u16");
  return static_cast<Symbol>(folded);
}

// Bijection N -> Z used by the BV format for values that may be negative
// (first interval start, first residual).
inline int64_t nat2int(uint64_t n) {
  return static_cast<int64_t>(n >> 1) ^ -static_cast<int64_t>(n & 1);
}

inline uint64_t int2nat(int64_t i) {
  return (static_cast<uint64_t>(i) << 1) ^ static_cast<uint64_t>(i >> 63);
}

}  // namespace wgans
