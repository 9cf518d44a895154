// Elias-Fano encoding of monotone sequences with constant-time-ish `get`,
// re-owning the capability the reference takes from the `sux` crate
// (EliasFano + SelectAdaptConst; reference: src/bvgraph/factories/mod.rs:6-8,
// src/bvgraph/random_access.rs:224-236). Used for the `.pointers` file.
//
// Serialized layout (little-endian):
//   magic  u64 'WGTEF001'
//   n      u64  number of values
//   u      u64  strict upper bound (all values < u)
//   l      u64  low-bits width
//   low    ceil(n*l/64) u64 words (l-bit values packed LSB-first)
//   high   ceil((n + (u>>l) + 1)/64) u64 words (unary-coded high parts)
// Select samples are rebuilt at load time.
#pragma once

#include "common.hpp"

namespace wgans {

constexpr uint64_t EF_MAGIC = 0x3130304645544757ULL;  // "WGTEF001"
constexpr uint64_t EF_SELECT_STEP = 256;               // sample every 256 ones

struct EliasFano {
  uint64_t n = 0, u = 0, l = 0;
  std::vector<uint64_t> low;
  std::vector<uint64_t> high;
  std::vector<uint64_t> select_samples;  // bit position of every 256th one

  static uint64_t low_bits_for(uint64_t n, uint64_t u) {
    if (n == 0 || u <= n) return 0;
    return ilog2_u64(u / n);
  }

  static EliasFano build(const uint64_t* vals, uint64_t n, uint64_t u) {
    EliasFano ef;
    ef.n = n;
    ef.u = u;
    ef.l = low_bits_for(n, u);
    ef.low.assign((n * ef.l + 63) / 64, 0);
    uint64_t high_bits = n + (ef.l < 64 ? (u >> ef.l) : 0) + 1;
    ef.high.assign((high_bits + 63) / 64, 0);
    for (uint64_t i = 0; i < n; ++i) {
      uint64_t v = vals[i];
      if (ef.l > 0) {
        uint64_t lowv = v & ((1ULL << ef.l) - 1);
        uint64_t bit = i * ef.l;
        ef.low[bit / 64] |= lowv << (bit % 64);
        if (bit % 64 + ef.l > 64) ef.low[bit / 64 + 1] |= lowv >> (64 - bit % 64);
      }
      uint64_t hpos = (v >> ef.l) + i;
      ef.high[hpos / 64] |= 1ULL << (hpos % 64);
    }
    ef.build_samples();
    return ef;
  }

  void build_samples() {
    select_samples.clear();
    uint64_t ones = 0;
    for (size_t w = 0; w < high.size(); ++w) {
      uint64_t word = high[w];
      while (word) {
        if (ones % EF_SELECT_STEP == 0) {
          unsigned tz = static_cast<unsigned>(__builtin_ctzll(word));
          select_samples.push_back(w * 64 + tz);
        }
        word &= word - 1;
        ++ones;
      }
    }
  }

  // Value of the i-th element (0-based).
  uint64_t get(uint64_t i) const {
    // select the i-th one in `high`
    uint64_t sample_idx = i / EF_SELECT_STEP;
    uint64_t pos = select_samples[sample_idx];
    uint64_t ones = sample_idx * EF_SELECT_STEP;
    size_t w = pos / 64;
    uint64_t word = high[w] & ~((1ULL << (pos % 64)) - 1);
    for (;;) {
      uint64_t cnt = static_cast<uint64_t>(__builtin_popcountll(word));
      if (ones + cnt > i) break;
      ones += cnt;
      word = high[++w];
    }
    // the (i - ones)-th set bit of word
    for (uint64_t k = ones; k < i; ++k) word &= word - 1;
    uint64_t bitpos = w * 64 + static_cast<uint64_t>(__builtin_ctzll(word));
    uint64_t highv = bitpos - i;
    if (l == 0) return highv;
    uint64_t bit = i * l;
    uint64_t lowv = low[bit / 64] >> (bit % 64);
    if (bit % 64 + l > 64) lowv |= low[bit / 64 + 1] << (64 - bit % 64);
    lowv &= (1ULL << l) - 1;
    return (highv << l) | lowv;
  }

  size_t serialized_size() const {
    return 8 * (4 + low.size() + high.size());
  }

  void serialize(uint8_t* out) const {
    uint64_t* w = reinterpret_cast<uint64_t*>(out);
    w[0] = EF_MAGIC;
    w[1] = n;
    w[2] = u;
    w[3] = l;
    std::memcpy(w + 4, low.data(), low.size() * 8);
    std::memcpy(w + 4 + low.size(), high.data(), high.size() * 8);
  }

  static EliasFano load(const uint8_t* data, size_t nbytes) {
    const uint64_t* w = reinterpret_cast<const uint64_t*>(data);
    if (nbytes < 32 || w[0] != EF_MAGIC)
      throw std::runtime_error("bad EliasFano blob");
    EliasFano ef;
    ef.n = w[1];
    ef.u = w[2];
    ef.l = w[3];
    size_t low_words = (ef.n * ef.l + 63) / 64;
    uint64_t high_bits = ef.n + (ef.l < 64 ? (ef.u >> ef.l) : 0) + 1;
    size_t high_words = (high_bits + 63) / 64;
    if (nbytes < 8 * (4 + low_words + high_words))
      throw std::runtime_error("truncated EliasFano blob");
    ef.low.assign(w + 4, w + 4 + low_words);
    ef.high.assign(w + 4 + low_words, w + 4 + low_words + high_words);
    ef.build_samples();
    return ef;
  }
};

}  // namespace wgans
