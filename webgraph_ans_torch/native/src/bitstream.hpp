// Big-endian (MSB-first) bit reader with the instantaneous codes used by the
// BVGraph format: unary, gamma, delta, zeta_k (Boldi-Vigna).
//
// This replaces the reference's external `dsi-bitstream` dependency for the
// *input* path (reading `.graph` files produced by WebGraph); see
// reference: SURVEY.md section 2.2 (bit readers / gamma codes).
#pragma once

#include "common.hpp"

namespace wgans {

class BitReader {
 public:
  BitReader(const uint8_t* data, size_t size_bytes)
      : data_(data), size_bits_(size_bytes * 8), pos_(0) {}

  size_t position() const { return pos_; }
  void set_position(size_t bit_pos) { pos_ = bit_pos; }

  inline uint32_t read_bit() {
    uint32_t bit = (data_[pos_ >> 3] >> (7 - (pos_ & 7))) & 1u;
    ++pos_;
    return bit;
  }

  // Read up to 57 bits, MSB first.
  inline uint64_t read_bits(unsigned n) {
    if (n == 0) return 0;
    // Fast path: load 8 bytes spanning the position.
    size_t byte = pos_ >> 3;
    unsigned bit_off = pos_ & 7;
    uint64_t word = 0;
    // Avoid reading past the buffer end: assemble available bytes.
    size_t avail = (size_bits_ + 7) / 8 - byte;
    size_t take = avail < 8 ? avail : 8;
    for (size_t i = 0; i < take; ++i) word = (word << 8) | data_[byte + i];
    word <<= (8 - take) * 8;
    pos_ += n;
    if (n + bit_off <= 64) {
      return (word << bit_off) >> (64 - n);
    }
    // n + bit_off > 64 (n > 57): slow path bit by bit.
    pos_ -= n;
    uint64_t v = 0;
    for (unsigned i = 0; i < n; ++i) v = (v << 1) | read_bit();
    return v;
  }

  inline uint64_t read_unary() {
    // Count zeros before the first 1.
    uint64_t zeros = 0;
    for (;;) {
      size_t byte = pos_ >> 3;
      unsigned bit_off = pos_ & 7;
      uint8_t cur = static_cast<uint8_t>(data_[byte] << bit_off);
      if (cur != 0) {
        unsigned lead = static_cast<unsigned>(__builtin_clz(cur)) - 24;
        pos_ += lead + 1;
        return zeros + lead;
      }
      zeros += 8 - bit_off;
      pos_ += 8 - bit_off;
      if (pos_ >= size_bits_) throw std::runtime_error("unary read past end of stream");
    }
  }

  inline uint64_t read_gamma() {
    uint64_t h = read_unary();
    return ((1ULL << h) | read_bits(static_cast<unsigned>(h))) - 1;
  }

  inline uint64_t read_delta() {
    uint64_t h = read_gamma();
    return ((1ULL << h) | read_bits(static_cast<unsigned>(h))) - 1;
  }

  inline uint64_t read_nibble() {
    // Variable-length nibble code (Java webgraph InputBitStream.readNibble):
    // each nibble = [stop bit][3 data bits], most significant group first;
    // stop bit 1 marks the last nibble.
    uint64_t x = 0;
    uint64_t stop;
    do {
      stop = read_bit();
      x = (x << 3) | read_bits(3);
    } while (!stop);
    return x;
  }

  inline uint64_t read_zeta(unsigned k) {
    uint64_t h = read_unary();
    uint64_t left = 1ULL << (h * k);
    uint64_t m = read_bits(static_cast<unsigned>(h * k + k - 1));
    if (m < left) return m + left - 1;
    return (m << 1) + read_bit() - 1;
  }

 private:
  const uint8_t* data_;
  size_t size_bits_;
  size_t pos_;
};

// Instantaneous code identifiers (matching the Python-side enum in
// webgraph_ans_tpu/bvgraph/properties.py).
enum Code : int {
  CODE_UNARY = 0,
  CODE_GAMMA = 1,
  CODE_DELTA = 2,
  CODE_ZETA = 3,
  CODE_NIBBLE = 4,
};

inline uint64_t read_code(BitReader& br, int code, unsigned zeta_k) {
  switch (code) {
    case CODE_UNARY: return br.read_unary();
    case CODE_GAMMA: return br.read_gamma();
    case CODE_DELTA: return br.read_delta();
    case CODE_ZETA: return br.read_zeta(zeta_k);
    case CODE_NIBBLE: return br.read_nibble();
    default: throw std::runtime_error("unknown code id");
  }
}

// MSB-first bit writer (used by tests and by future standard-BVGraph output).
class BitWriter {
 public:
  void write_bit(uint32_t bit) {
    if ((nbits_ & 7) == 0) bytes_.push_back(0);
    if (bit) bytes_.back() |= static_cast<uint8_t>(1u << (7 - (nbits_ & 7)));
    ++nbits_;
  }
  void write_bits(uint64_t v, unsigned n) {
    for (unsigned i = 0; i < n; ++i) write_bit((v >> (n - 1 - i)) & 1);
  }
  void write_unary(uint64_t x) {
    for (uint64_t i = 0; i < x; ++i) write_bit(0);
    write_bit(1);
  }
  void write_gamma(uint64_t x) {
    uint64_t v = x + 1;
    unsigned h = ilog2_u64(v);
    write_unary(h);
    write_bits(v & ((1ULL << h) - 1), h);
  }
  void write_delta(uint64_t x) {
    uint64_t v = x + 1;
    unsigned h = ilog2_u64(v);
    write_gamma(h);
    write_bits(v & ((1ULL << h) - 1), h);
  }
  void write_nibble(uint64_t x) {
    // Java webgraph OutputBitStream.writeNibble: 3-bit groups, most
    // significant first, each preceded by a stop bit (1 on the last).
    int h = x ? static_cast<int>(ilog2_u64(x)) / 3 : 0;
    for (int i = h; i >= 0; --i) {
      write_bit(i == 0);
      write_bits((x >> (3 * i)) & 7, 3);
    }
  }
  void write_zeta(uint64_t x, unsigned k) {
    uint64_t v = x + 1;
    unsigned h = ilog2_u64(v) / k;
    write_unary(h);
    uint64_t left = 1ULL << (h * k);
    if (v - left < left) {
      write_bits(v - left, h * k + k - 1);
    } else {
      write_bits(v, h * k + k);
    }
  }
  const std::vector<uint8_t>& bytes() const { return bytes_; }
  size_t nbits() const { return nbits_; }

 private:
  std::vector<uint8_t> bytes_;
  size_t nbits_ = 0;
};

}  // namespace wgans
