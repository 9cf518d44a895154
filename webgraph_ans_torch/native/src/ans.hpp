// Single-state streaming rANS encoder/decoder with Moffat quasi-folding,
// semantically identical to the reference codec so that models built by the
// Python/JAX model pipeline produce byte-identical streams.
//
// Encoder semantics: reference src/ans/encoder.rs:39-86.
// Decoder semantics: reference src/ans/decoder.rs:58-100.
// Decoder LUT construction: reference src/ans/models/model4decoder.rs:18-68.
#pragma once

#include "bvgraph.hpp"

namespace wgans {

// Per-component encoder model (reference: src/ans/models/component_model4encoder.rs).
struct CompEncoderModel {
  std::vector<Freq> freqs;     // scaled frequency of each folded symbol
  std::vector<Freq> cumul;     // exclusive prefix sums of freqs (u16, may wrap)
  std::vector<uint64_t> upper; // renorm upper bound: (1 << (k + B)) * freq
  unsigned log_m = 0;          // log2 of the frame size
  unsigned radix = 2;
  unsigned fidelity = 2;
  uint64_t folding_threshold = 10;
  uint64_t folding_offset = 10;

  // Derives cumul/upper/threshold/offset from freqs + params, matching
  // reference builder.rs:216-234 and component_model4encoder.rs:28-35.
  // upper is u64 like the reference's EncoderModelEntry::upperbound:
  // for log_m = 0 (single-symbol frame) the bound is 2^32 — the symbol
  // costs zero bits and must NEVER renormalize (a u32 bound here once
  // wrapped and drove the state below the decoder's lower bound,
  // desyncing any model with a frame-1 component).
  void finalize() {
    cumul.resize(freqs.size());
    upper.resize(freqs.size());
    unsigned k = 16 - log_m;
    uint16_t acc = 0;
    for (size_t i = 0; i < freqs.size(); ++i) {
      cumul[i] = acc;
      acc = static_cast<uint16_t>(acc + freqs[i]);  // wraps like checked_add...unwrap_or(0)
      upper[i] = (1ULL << (k + B)) * static_cast<uint64_t>(freqs[i]);
    }
    folding_threshold = 1ULL << (fidelity + radix - 1);
    folding_offset = ((1ULL << radix) - 1) * (1ULL << (fidelity - 1));
  }
};

struct EncoderModel {
  CompEncoderModel comp[NUM_COMPONENTS];
};

// Streaming rANS encoder; one u32 state, 16-bit renormalization emissions.
class ANSEncoder {
 public:
  explicit ANSEncoder(const EncoderModel& model)
      : model_(model), state_(INTERVAL_LOWER_BOUND) {}

  void encode(uint64_t symbol, int component) {
    const CompEncoderModel& m = model_.comp[component];
    if (symbol >= m.folding_threshold) {
      unsigned folds = (ilog2_u64(symbol) + 1 - m.fidelity) / m.radix;
      uint32_t radix_mask = (1u << m.radix) - 1;
      for (unsigned f = 0; f < folds; ++f) {
        uint32_t bits_to_push = static_cast<uint32_t>(symbol) & radix_mask;
        if (clz32(state_) < m.radix) shrink_state();
        state_ = (state_ << m.radix) + bits_to_push;
        symbol >>= m.radix;
      }
      symbol += m.folding_offset * folds;
    }
    Freq freq = m.freqs[symbol];
    if (state_ >= m.upper[symbol]) shrink_state();
    uint32_t block = state_ / freq;
    state_ = (block << m.log_m) + m.cumul[symbol] + (state_ - block * freq);
  }

  State state() const { return state_; }
  size_t stream_len() const { return stream_.size(); }
  std::vector<uint16_t>& stream() { return stream_; }

 private:
  inline void shrink_state() {
    stream_.push_back(static_cast<uint16_t>(state_ & NORMALIZATION_MASK));
    state_ >>= B;
  }

  const EncoderModel& model_;
  State state_;
  std::vector<uint16_t> stream_;
};

// Per-component decoder LUT: for each of the 2^log_m slots, the slot's
// symbol frequency, cumulative frequency and quasi-folded value (folds count
// in bits 48.., pre-shifted symbol prefix in bits 0..47).
struct CompDecoderModel {
  std::vector<Freq> freq;
  std::vector<Freq> cumul;
  std::vector<uint64_t> quasi_folded;
  unsigned log_m = 0;
  unsigned radix = 2;
  uint32_t frame_mask = 0;
};

constexpr uint64_t BIT_RESERVED_FOR_SYMBOL = 48;

inline uint64_t quasi_fold(uint64_t sym, uint64_t folding_offset,
                           uint64_t folding_threshold, unsigned radix) {
  if (sym < folding_threshold) return sym;
  uint64_t folds = (sym - folding_threshold) / folding_offset + 1;
  uint64_t folds_bits = folds << BIT_RESERVED_FOR_SYMBOL;
  sym -= folding_offset * folds;
  sym <<= folds * radix;
  return sym | folds_bits;
}

struct DecoderModel {
  CompDecoderModel comp[NUM_COMPONENTS];

  static DecoderModel from_encoder(const EncoderModel& enc) {
    DecoderModel dm;
    for (int c = 0; c < NUM_COMPONENTS; ++c) {
      const CompEncoderModel& m = enc.comp[c];
      CompDecoderModel& d = dm.comp[c];
      d.log_m = m.log_m;
      d.radix = m.radix;
      size_t frame = 1ULL << m.log_m;
      d.frame_mask = static_cast<uint32_t>(frame - 1);
      d.freq.assign(frame, 0);
      d.cumul.assign(frame, 0);
      d.quasi_folded.assign(frame, 0);
      uint32_t last_slot = 0;
      for (size_t sym = 0; sym < m.freqs.size(); ++sym) {
        Freq f = m.freqs[sym];
        if (f == 0) continue;
        uint64_t qf = quasi_fold(sym, m.folding_offset, m.folding_threshold, m.radix);
        for (uint32_t slot = last_slot; slot < last_slot + f; ++slot) {
          d.freq[slot] = f;
          d.cumul[slot] = m.cumul[sym];
          d.quasi_folded[slot] = qf;
        }
        last_slot += f;
      }
    }
    return dm;
  }
};

// Streaming rANS decoder; reads the u16 stream backwards from stream_pointer.
class ANSDecoder {
 public:
  ANSDecoder(const DecoderModel& model, const uint16_t* stream,
             size_t stream_pointer, State state)
      : model_(model), stream_(stream), ptr_(stream_pointer), state_(state) {}

  uint64_t decode(int component) {
    const CompDecoderModel& m = model_.comp[component];
    uint32_t slot = state_ & m.frame_mask;
    Freq freq = m.freq[slot];
    Freq cumul = m.cumul[slot];
    uint64_t qf = m.quasi_folded[slot];

    state_ = (state_ >> m.log_m) * freq + slot - cumul;
    if (state_ < INTERVAL_LOWER_BOUND) extend_state();

    uint64_t quasi_unfolded = qf & ((1ULL << BIT_RESERVED_FOR_SYMBOL) - 1);
    uint32_t folds = static_cast<uint32_t>(qf >> BIT_RESERVED_FOR_SYMBOL);
    uint64_t fold = 0;
    uint32_t radix_mask = (1u << m.radix) - 1;
    for (uint32_t f = 0; f < folds; ++f) {
      if (state_ < INTERVAL_LOWER_BOUND) extend_state();
      fold = (fold << m.radix) | (state_ & radix_mask);
      state_ >>= m.radix;
      if (state_ < INTERVAL_LOWER_BOUND) extend_state();
    }
    return quasi_unfolded | fold;
  }

  // Decode interface for read_successors.
  uint64_t read_outdegree() { return decode(OUTDEGREE); }
  uint64_t read_reference_offset() { return decode(REFERENCE_OFFSET); }
  uint64_t read_block_count() { return decode(BLOCK_COUNT); }
  uint64_t read_block() { return decode(BLOCKS); }
  uint64_t read_interval_count() { return decode(INTERVAL_COUNT); }
  uint64_t read_interval_start() { return decode(INTERVAL_START); }
  uint64_t read_interval_len() { return decode(INTERVAL_LEN); }
  uint64_t read_first_residual() { return decode(FIRST_RESIDUAL); }
  uint64_t read_residual() { return decode(RESIDUAL); }

  State state() const { return state_; }
  size_t pointer() const { return ptr_; }

 private:
  inline void extend_state() {
    --ptr_;
    state_ = (state_ << B) | static_cast<State>(stream_[ptr_]);
  }

  const DecoderModel& model_;
  const uint16_t* stream_;
  size_t ptr_;
  State state_;
};

// ---------------------------------------------------------------------------
// BvComp sinks.
// ---------------------------------------------------------------------------

// Pass 1/2 sink: per-component histograms of raw symbols
// (reference: src/ans/model4encoder_builder.rs:67-78 via
//  src/bvgraph/writers/bvgraph_model_builder.rs:51-103).
struct HistogramSink : SymbolSink {
  // Open-addressing would be faster; std::unordered_map is fine at this scale.
  std::vector<std::unordered_map<uint64_t, uint64_t>> hist;
  HistogramSink() : hist(NUM_COMPONENTS) {}
  void push(int component, uint64_t value) override { ++hist[component][value]; }
};

// Pass 3 sink: buffers (value, component) pairs in forward order; encode()
// then replays them backwards through the rANS encoder, capturing a phase
// (state, stream_pointer) at every Outdegree = node boundary
// (reference: src/bvgraph/writers/bvgraph_encoder.rs:159-174).
struct BufferSink : SymbolSink {
  std::vector<uint64_t> values;
  std::vector<uint8_t> components;

  void push(int component, uint64_t value) override {
    values.push_back(value);
    components.push_back(static_cast<uint8_t>(component));
  }

  // Returns (stream, states, pointers, final_state); states/pointers are in
  // reverse node order (phases[j] belongs to node n-1-j), exactly like the
  // reference's flush loop.
  void encode(const EncoderModel& model, std::vector<uint16_t>& stream,
              std::vector<State>& states, std::vector<uint64_t>& pointers,
              State& final_state) const {
    ANSEncoder enc(model);
    states.clear();
    pointers.clear();
    for (size_t i = values.size(); i-- > 0;) {
      enc.encode(values[i], components[i]);
      if (components[i] == OUTDEGREE) {
        states.push_back(enc.state());
        pointers.push_back(enc.stream_len());
      }
    }
    final_state = enc.state();
    stream = std::move(enc.stream());
  }
};

}  // namespace wgans
