// Out-of-core pass-3 token spill: O(chunk)-RAM reverse replay.
//
// The reference keeps pass 3's ~O(arcs) symbol buffer off the heap by
// spilling bit-reversed gamma codes to disk and mmap-replaying them
// backwards (reference: src/utils/rev.rs:116-221, used at
// src/bvgraph/writers/bvgraph_encoder.rs:159-174). This runtime gets the
// same O(1)-RAM property with a different, simpler design: tokens are
// LEB128-varint-packed into fixed-token-count chunks written forward to a
// temp file, with an in-RAM (offset, count) chunk index; the reverse
// replay walks chunks backwards, decoding each chunk forward into a small
// buffer and iterating it in reverse. RAM is O(chunk_tokens), disk is
// ~1-3 bytes/token.
#pragma once

#include <cstdio>
#include <string>

#include "ans.hpp"

namespace wgans {

struct SpillSink : SymbolSink {
  explicit SpillSink(const std::string& path, uint64_t chunk_tokens)
      : path_(path), chunk_tokens_(chunk_tokens ? chunk_tokens : 1) {
    f_ = std::fopen(path.c_str(), "wb+");
    if (!f_) throw std::runtime_error("spill: cannot open " + path);
    buf_.reserve(chunk_tokens_ * 2);
  }
  ~SpillSink() override {
    if (f_) std::fclose(f_);
    std::remove(path_.c_str());
  }

  void push(int component, uint64_t value) override {
    // token = (value << 4) | component; values are <= MAX_RAW_SYMBOL (2^48)
    uint64_t t = (value << 4) | static_cast<uint64_t>(component);
    while (t >= 0x80) {
      buf_.push_back(static_cast<uint8_t>(t) | 0x80);
      t >>= 7;
    }
    buf_.push_back(static_cast<uint8_t>(t));
    ++total_tokens_;
    if (++chunk_fill_ == chunk_tokens_) flush_chunk();
  }

  uint64_t total_tokens() const { return total_tokens_; }

  // Replays every token backwards through the encoder, capturing a phase
  // at each Outdegree (node boundary), exactly like BufferSink::encode.
  void encode(const EncoderModel& model, std::vector<uint16_t>& stream,
              std::vector<State>& states, std::vector<uint64_t>& pointers,
              State& final_state) {
    flush_chunk();
    ANSEncoder enc(model);
    states.clear();
    pointers.clear();
    std::vector<uint8_t> bytes;
    std::vector<uint64_t> toks;
    toks.reserve(chunk_tokens_);
    for (size_t c = chunks_.size(); c-- > 0;) {
      bytes.resize(chunks_[c].bytes);
      if (std::fseek(f_, static_cast<long>(chunks_[c].offset), SEEK_SET) ||
          std::fread(bytes.data(), 1, bytes.size(), f_) != bytes.size())
        throw std::runtime_error("spill: chunk read failed");
      toks.clear();
      for (size_t p = 0; p < bytes.size();) {
        uint64_t t = 0;
        unsigned shift = 0;
        while (bytes[p] & 0x80) {
          t |= static_cast<uint64_t>(bytes[p++] & 0x7F) << shift;
          shift += 7;
        }
        t |= static_cast<uint64_t>(bytes[p++]) << shift;
        toks.push_back(t);
      }
      for (size_t i = toks.size(); i-- > 0;) {
        int comp = static_cast<int>(toks[i] & 0xF);
        enc.encode(toks[i] >> 4, comp);
        if (comp == OUTDEGREE) {
          states.push_back(enc.state());
          pointers.push_back(enc.stream_len());
        }
      }
    }
    final_state = enc.state();
    stream = std::move(enc.stream());
  }

 private:
  struct Chunk {
    uint64_t offset;
    uint64_t bytes;
  };

  void flush_chunk() {
    if (buf_.empty()) {
      chunk_fill_ = 0;
      return;
    }
    if (std::fseek(f_, 0, SEEK_END))
      throw std::runtime_error("spill: seek failed");
    uint64_t off = static_cast<uint64_t>(std::ftell(f_));
    if (std::fwrite(buf_.data(), 1, buf_.size(), f_) != buf_.size())
      throw std::runtime_error("spill: chunk write failed");
    chunks_.push_back({off, buf_.size()});
    buf_.clear();
    chunk_fill_ = 0;
  }

  std::string path_;
  uint64_t chunk_tokens_;
  std::FILE* f_ = nullptr;
  std::vector<uint8_t> buf_;
  std::vector<Chunk> chunks_;
  uint64_t chunk_fill_ = 0;
  uint64_t total_tokens_ = 0;
};

}  // namespace wgans
