// BvGraph successor-list reconstruction and the BV compressor (BvComp).
//
// These re-own the capabilities the reference pulls from the external
// `webgraph` crate (reference: SURVEY.md section 2.2): the 9-stream codec
// plug-in boundary, the successor reconstruction machinery (reference
// resolution + copy blocks + intervals + residual gaps), and the BV
// compression heuristics (window search, reference selection by estimator
// cost, copy-block splitting, interval extraction, residual gap coding).
//
// Both sides are generic over a Decoder / Encoder concept with one method per
// BVGraph component, mirroring the `Decode`/`Encode` trait boundary the
// reference plugs into (reference: src/ans/decoder.rs:103-139,
// src/bvgraph/writers/bvgraph_encoder.rs:96-174).
#pragma once

#include "bitstream.hpp"

#include <algorithm>

namespace wgans {

// The 9 BVGraph component streams (reference: src/bvgraph/mod.rs:13-28).
enum Component : int {
  OUTDEGREE = 0,
  REFERENCE_OFFSET = 1,
  BLOCK_COUNT = 2,
  BLOCKS = 3,
  INTERVAL_COUNT = 4,
  INTERVAL_START = 5,
  INTERVAL_LEN = 6,
  FIRST_RESIDUAL = 7,
  RESIDUAL = 8,
};
constexpr int NUM_COMPONENTS = 9;

// ---------------------------------------------------------------------------
// Successor reconstruction (decode side).
// ---------------------------------------------------------------------------

// Reconstructs the successor list of node `x` by pulling component symbols
// from `dec` and copying from `get_ref_list(x - ref)` when a reference is
// used. `dec` must expose read_<component>() methods returning uint64_t.
template <class Decoder, class RefListFn>
void read_successors(Decoder& dec, uint64_t x, unsigned window,
                     unsigned min_interval_length, RefListFn&& get_ref_list,
                     std::vector<uint64_t>& out) {
  out.clear();
  uint64_t d = dec.read_outdegree();
  if (d == 0) return;
  out.reserve(d);

  uint64_t ref = 0;
  if (window > 0) ref = dec.read_reference_offset();

  // Copied values from the referenced list, selected by alternating
  // copy/skip blocks (even-indexed blocks copy; if the block count is even,
  // the tail of the reference list is also copied). Local vectors (not
  // shared scratch): get_ref_list may recurse back into read_successors.
  std::vector<uint64_t> copied;
  if (ref > 0) {
    uint64_t block_count = dec.read_block_count();
    std::vector<uint64_t> blocks;
    uint64_t total = 0;
    for (uint64_t i = 0; i < block_count; ++i) {
      uint64_t b = dec.read_block() + (i == 0 ? 0 : 1);
      blocks.push_back(b);
      total += b;
    }
    const std::vector<uint64_t>& ref_list = get_ref_list(x - ref);
    size_t pos = 0;
    bool copy = true;
    for (uint64_t b : blocks) {
      if (copy) {
        for (uint64_t j = 0; j < b; ++j) copied.push_back(ref_list[pos + j]);
      }
      pos += b;
      copy = !copy;
    }
    if (block_count % 2 == 0) {
      for (size_t j = pos; j < ref_list.size(); ++j) copied.push_back(ref_list[j]);
    }
  }

  int64_t extra = static_cast<int64_t>(d) - static_cast<int64_t>(copied.size());

  std::vector<uint64_t> intervals;
  if (min_interval_length != 0 && extra > 0) {
    uint64_t interval_count = dec.read_interval_count();
    uint64_t prev = 0;
    for (uint64_t i = 0; i < interval_count; ++i) {
      uint64_t left;
      if (i == 0) {
        left = static_cast<uint64_t>(static_cast<int64_t>(x) +
                                     nat2int(dec.read_interval_start()));
      } else {
        left = prev + dec.read_interval_start() + 1;
      }
      uint64_t len = dec.read_interval_len() + min_interval_length;
      for (uint64_t j = 0; j < len; ++j) intervals.push_back(left + j);
      prev = left + len;
      extra -= static_cast<int64_t>(len);
    }
  }

  std::vector<uint64_t> residuals;
  if (extra > 0) {
    uint64_t r = static_cast<uint64_t>(static_cast<int64_t>(x) +
                                       nat2int(dec.read_first_residual()));
    residuals.push_back(r);
    for (int64_t i = 1; i < extra; ++i) {
      r = r + dec.read_residual() + 1;
      residuals.push_back(r);
    }
  }

  // Three-way merge of the sorted, disjoint lists.
  size_t ic = 0, ii = 0, ir = 0;
  while (ic < copied.size() || ii < intervals.size() || ir < residuals.size()) {
    uint64_t best = UINT64_MAX;
    int which = -1;
    if (ic < copied.size() && copied[ic] < best) { best = copied[ic]; which = 0; }
    if (ii < intervals.size() && intervals[ii] < best) { best = intervals[ii]; which = 1; }
    if (ir < residuals.size() && residuals[ir] < best) { best = residuals[ir]; which = 2; }
    out.push_back(best);
    if (which == 0) ++ic; else if (which == 1) ++ii; else ++ir;
  }
}

// Decoder over a `.graph` bitstream with configurable instantaneous codes.
struct BvBitDecoder {
  BitReader br;
  int outdeg_code, ref_code, block_code, residual_code;
  unsigned zeta_k;

  uint64_t read_outdegree() { return read_code(br, outdeg_code, zeta_k); }
  uint64_t read_reference_offset() { return read_code(br, ref_code, zeta_k); }
  uint64_t read_block_count() { return read_code(br, block_code, zeta_k); }
  uint64_t read_block() { return read_code(br, block_code, zeta_k); }
  uint64_t read_interval_count() { return br.read_gamma(); }
  uint64_t read_interval_start() { return br.read_gamma(); }
  uint64_t read_interval_len() { return br.read_gamma(); }
  uint64_t read_first_residual() { return read_code(br, residual_code, zeta_k); }
  uint64_t read_residual() { return read_code(br, residual_code, zeta_k); }
};

// Full sequential scan of a BVGraph bitstream. Fills `offsets` (n+1 entries)
// and `succs` (concatenated successor lists).
inline void bvgraph_scan(const uint8_t* data, size_t size_bytes, uint64_t n,
                         unsigned window, unsigned min_interval_length,
                         unsigned zeta_k, int outdeg_code, int ref_code,
                         int block_code, int residual_code,
                         std::vector<uint64_t>& offsets,
                         std::vector<uint32_t>& succs) {
  BvBitDecoder dec{BitReader(data, size_bytes), outdeg_code, ref_code,
                   block_code, residual_code, zeta_k};
  offsets.assign(1, 0);
  offsets.reserve(n + 1);
  succs.clear();

  // Sliding window of the last `window` successor lists.
  size_t ring = window + 1;
  std::vector<std::vector<uint64_t>> win(ring);
  std::vector<uint64_t> curr;
  for (uint64_t x = 0; x < n; ++x) {
    read_successors(
        dec, x, window, min_interval_length,
        [&](uint64_t node) -> const std::vector<uint64_t>& {
          return win[node % ring];
        },
        curr);
    for (uint64_t s : curr) succs.push_back(static_cast<uint32_t>(s));
    offsets.push_back(succs.size());
    win[x % ring] = curr;
  }
}

// ---------------------------------------------------------------------------
// BvComp (encode side).
// ---------------------------------------------------------------------------

// Cost estimator interface: returns the (fixed-point) cost of writing `value`
// into `component`. Two concrete estimators exist, mirroring the reference:
//  - Log2Estimator: cost(v) = floor(log2(v + 2))
//    (reference: src/bvgraph/estimators/log2_estimator.rs:15-49)
//  - EntropyEstimator: table lookup of folded symbols
//    (reference: src/bvgraph/estimators/entropy_estimator.rs:81-113)
struct Estimator {
  // type 0: log2. type 1: entropy tables.
  int type = 0;
  // Entropy tables: per component, cost of each folded symbol.
  std::vector<std::vector<uint64_t>> tables;
  std::vector<unsigned> fidelity, radix;
  std::vector<uint64_t> threshold;

  inline uint64_t cost(uint64_t value, int component) const {
    if (type == 0) return ilog2_u64(value + 2);
    uint64_t folded = value < threshold[component]
                          ? value
                          : fold_without_streaming_out(value, radix[component],
                                                       fidelity[component]);
    return tables[component][folded];
  }
};

// Sink receiving the final (component, value) symbol stream chosen by BvComp.
struct SymbolSink {
  virtual ~SymbolSink() = default;
  virtual void push(int component, uint64_t value) = 0;
  virtual void end_node(uint64_t node) {}
};

// Internal representation of one node's diffed encoding.
struct DiffPlan {
  uint64_t ref = 0;
  std::vector<uint64_t> blocks;           // on-the-wire semantics: raw run lengths
  std::vector<std::pair<uint64_t, uint64_t>> intervals;  // (left, len)
  std::vector<uint64_t> residuals;        // absolute successor values
};

// The BV compressor. Feeds successor lists in node order; for each node,
// evaluates every admissible reference candidate with the estimator and
// emits the cheapest encoding to the sink.
class BvComp {
 public:
  BvComp(unsigned window, unsigned max_ref_count, unsigned min_interval_length,
         const Estimator& est, SymbolSink& sink)
      : window_(window),
        max_ref_count_(max_ref_count),
        min_interval_(min_interval_length),
        est_(est),
        sink_(sink),
        ring_(window + 1),
        lists_(ring_),
        ref_counts_(ring_, 0) {}

  // Reference-safe break interval: when > 0, no reference may reach
  // past a multiple of k — node x's candidates are floored at
  // floor(x/k)*k — so no copy chain crosses those nodes and every
  // multiple of k is a safe lane boundary for the parallel decoder.
  // This is a format extension of THIS framework (the reference has no
  // equivalent): it bounds reference-chain length for the lane-parallel
  // TPU decoder at a negligible size cost (references are constrained
  // only for the `window` nodes after each break), which is what makes
  // high-compression mode (-w 16, unbounded max_ref) decodable in
  // parallel. All three passes of a store() run must use the same
  // value (set via wgt_set_safe_break).
  static unsigned& safe_break() {
    static unsigned k = 0;
    return k;
  }

  void push(uint64_t x, const uint64_t* succ, size_t d) {
    curr_.assign(succ, succ + d);
    uint64_t best_ref = 0;
    unsigned brk = safe_break();
    uint64_t floor_node = 0;
    if (brk) {
      // break every k nodes AND whenever 16k elements accumulated
      // since the last break: dense regions break early, so every
      // inter-break segment is bounded in BOTH nodes and elements —
      // the parallel decoder's lane balance depends on the latter.
      // Deterministic across passes (depends only on outdegrees).
      if (x % brk == 0 || elems_since_break_ >= 16ull * brk) {
        last_break_ = x;
        elems_since_break_ = 0;
      }
      elems_since_break_ += d;
      floor_node = last_break_;
    }
    if (d > 0 && window_ > 0) {
      uint64_t best_cost = plan_cost(x, 0);
      uint64_t max_back =
          std::min<uint64_t>(std::min<uint64_t>(window_, x), x - floor_node);
      for (uint64_t r = 1; r <= max_back; ++r) {
        if (ref_counts_[(x - r) % ring_] >= max_ref_count_) continue;
        uint64_t c = plan_cost(x, r);
        if (c < best_cost) {
          best_cost = c;
          best_ref = r;
        }
      }
    }
    ref_counts_[x % ring_] =
        best_ref > 0 ? ref_counts_[(x - best_ref) % ring_] + 1 : 0;

    // Emit the chosen encoding.
    sink_.push(OUTDEGREE, d);
    if (d > 0) {
      DiffPlan plan;
      make_plan(x, best_ref, plan);
      emit(x, plan);
    }
    sink_.end_node(x);
    lists_[x % ring_] = curr_;
  }

 private:
  // Builds the diff encoding of curr_ against reference `ref` (0 = none).
  void make_plan(uint64_t x, uint64_t ref, DiffPlan& plan) const {
    plan.ref = ref;
    plan.blocks.clear();
    plan.intervals.clear();
    plan.residuals.clear();

    std::vector<uint64_t> extras;

    if (ref > 0) {
      const std::vector<uint64_t>& ref_list = lists_[(x - ref) % ring_];
      // Two-pointer sweep computing alternating copy/skip run lengths over
      // the reference list (runs start with a copy run, possibly empty).
      size_t i = 0, j = 0;
      bool copying = true;
      uint64_t run = 0;
      while (i < ref_list.size()) {
        bool is_copied;
        if (j < curr_.size()) {
          if (ref_list[i] < curr_[j]) {
            is_copied = false;
          } else if (ref_list[i] > curr_[j]) {
            extras.push_back(curr_[j]);
            ++j;
            continue;
          } else {
            is_copied = true;
          }
        } else {
          is_copied = false;
        }
        if (is_copied != copying) {
          plan.blocks.push_back(run);
          run = 0;
          copying = is_copied;
        }
        ++run;
        ++i;
        if (is_copied) ++j;
      }
      if (run > 0) plan.blocks.push_back(run);
      // The final run is implicit: if it was a copy run, dropping it leaves
      // an even block count (tail copied); if a skip run, an odd count.
      if (!plan.blocks.empty()) plan.blocks.pop_back();
      while (j < curr_.size()) extras.push_back(curr_[j++]);
    } else {
      extras = curr_;
    }

    // Interval extraction: maximal runs of consecutive integers of length
    // >= min_interval_ become intervals; the rest are residuals.
    if (min_interval_ != 0) {
      size_t i = 0;
      while (i < extras.size()) {
        size_t jr = i + 1;
        while (jr < extras.size() && extras[jr] == extras[jr - 1] + 1) ++jr;
        size_t len = jr - i;
        if (len >= min_interval_) {
          plan.intervals.emplace_back(extras[i], len);
        } else {
          for (size_t t = i; t < jr; ++t) plan.residuals.push_back(extras[t]);
        }
        i = jr;
      }
    } else {
      plan.residuals.assign(extras.begin(), extras.end());
    }
  }

  // Estimator cost of encoding curr_ with reference `ref` (excluding the
  // outdegree, which is identical across candidates).
  uint64_t plan_cost(uint64_t x, uint64_t ref) const {
    DiffPlan plan;
    make_plan(x, ref, plan);
    uint64_t c = est_.cost(ref, REFERENCE_OFFSET);
    if (ref > 0) {
      c += est_.cost(plan.blocks.size(), BLOCK_COUNT);
      for (size_t i = 0; i < plan.blocks.size(); ++i)
        c += est_.cost(plan.blocks[i] - (i == 0 ? 0 : 1), BLOCKS);
    }
    int64_t extra_count =
        static_cast<int64_t>(plan.residuals.size());
    for (auto& iv : plan.intervals) extra_count += iv.second;
    if (min_interval_ != 0 && extra_count > 0) {
      c += est_.cost(plan.intervals.size(), INTERVAL_COUNT);
      uint64_t prev = 0;
      for (size_t i = 0; i < plan.intervals.size(); ++i) {
        uint64_t left = plan.intervals[i].first, len = plan.intervals[i].second;
        if (i == 0) {
          c += est_.cost(int2nat(static_cast<int64_t>(left) -
                                 static_cast<int64_t>(x)),
                         INTERVAL_START);
        } else {
          c += est_.cost(left - prev - 1, INTERVAL_START);
        }
        c += est_.cost(len - min_interval_, INTERVAL_LEN);
        prev = left + len;
      }
    }
    if (!plan.residuals.empty()) {
      c += est_.cost(int2nat(static_cast<int64_t>(plan.residuals[0]) -
                             static_cast<int64_t>(x)),
                     FIRST_RESIDUAL);
      for (size_t i = 1; i < plan.residuals.size(); ++i)
        c += est_.cost(plan.residuals[i] - plan.residuals[i - 1] - 1, RESIDUAL);
    }
    return c;
  }

  // Emits the chosen plan to the sink in the exact order the decode side
  // consumes components.
  void emit(uint64_t x, const DiffPlan& plan) {
    if (window_ > 0) sink_.push(REFERENCE_OFFSET, plan.ref);
    if (plan.ref > 0) {
      sink_.push(BLOCK_COUNT, plan.blocks.size());
      for (size_t i = 0; i < plan.blocks.size(); ++i)
        sink_.push(BLOCKS, plan.blocks[i] - (i == 0 ? 0 : 1));
    }
    int64_t extra_count = static_cast<int64_t>(plan.residuals.size());
    for (auto& iv : plan.intervals) extra_count += iv.second;
    if (min_interval_ != 0 && extra_count > 0) {
      sink_.push(INTERVAL_COUNT, plan.intervals.size());
      uint64_t prev = 0;
      for (size_t i = 0; i < plan.intervals.size(); ++i) {
        uint64_t left = plan.intervals[i].first, len = plan.intervals[i].second;
        if (i == 0) {
          sink_.push(INTERVAL_START, int2nat(static_cast<int64_t>(left) -
                                             static_cast<int64_t>(x)));
        } else {
          sink_.push(INTERVAL_START, left - prev - 1);
        }
        sink_.push(INTERVAL_LEN, len - min_interval_);
        prev = left + len;
      }
    }
    if (!plan.residuals.empty()) {
      sink_.push(FIRST_RESIDUAL, int2nat(static_cast<int64_t>(plan.residuals[0]) -
                                         static_cast<int64_t>(x)));
      for (size_t i = 1; i < plan.residuals.size(); ++i)
        sink_.push(RESIDUAL, plan.residuals[i] - plan.residuals[i - 1] - 1);
    }
  }

  unsigned window_, max_ref_count_, min_interval_;
  const Estimator& est_;
  SymbolSink& sink_;
  size_t ring_;
  std::vector<std::vector<uint64_t>> lists_;
  std::vector<unsigned> ref_counts_;
  std::vector<uint64_t> curr_;
  uint64_t last_break_ = 0;
  uint64_t elems_since_break_ = 0;
};

}  // namespace wgans
