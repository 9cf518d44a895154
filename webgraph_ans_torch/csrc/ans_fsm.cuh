// The rANS token step and the BvGraph grammar FSM shared by the decode
// kernels (decode_blocks.cu, decode_emit.cu), so both decode the same
// bits. One CUDA thread per lane; u32 semantics as in the plain PyTorch
// versions (ops/decode_torch.py, ops/emit_torch.py). The codec
// parameters are read from shared memory, and each token's LUT row is
// requested one step ahead (lut_row).
//
// rANS step reference: src/ans/decoder.rs:58-100. Grammar executable
// spec: native/src/bvgraph.hpp read_successors.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace wgt {

// Component ids double as FSM phase ids; P_SUM is the aux-mode summary
// pseudo-step of decode_blocks.
enum Phase { P_OUT, P_REF, P_BC, P_BLK, P_IC, P_IS, P_IL, P_FR, P_RES,
             P_DONE, P_SUM };
constexpr int kNodeDone = -1;   // next-phase sentinel: node finished
constexpr int kKeep = -2;       // next-phase sentinel: keep the phase
constexpr int kMaxWindow = 16;

struct CodecParams {
  uint32_t offset[9], log_m[9], mask[9], radix[9], fold_off[9];
  uint32_t slots, max_folds;
};

// params: 47 ints -- 9 x (offset, log_m, mask, radix, fold_off), slots,
// max_folds (decode_torch.build_decoder_tables_np).
inline CodecParams codec_params(const long long* params) {
  CodecParams prm;
  for (int c = 0; c < 9; ++c) {
    prm.offset[c] = static_cast<uint32_t>(params[5 * c + 0]);
    prm.log_m[c] = static_cast<uint32_t>(params[5 * c + 1]);
    prm.mask[c] = static_cast<uint32_t>(params[5 * c + 2]);
    prm.radix[c] = static_cast<uint32_t>(params[5 * c + 3]);
    prm.fold_off[c] = static_cast<uint32_t>(params[5 * c + 4]);
  }
  prm.slots = static_cast<uint32_t>(params[45]);
  prm.max_folds = static_cast<uint32_t>(params[46]);
  return prm;
}

// The codec parameters of one block, copied into shared memory once:
// every token reads them at the lane's component c, which differs across
// a warp, so a read from the by-value kernel parameter would serialise
// (or spill the struct to local memory). Nine entries of one field lie in
// nine banks, so a warp's reads of one field never conflict.
__device__ __forceinline__ void stage_params(const CodecParams& prm,
                                             CodecParams& sp) {
  if (threadIdx.x == 0) sp = prm;
  __syncthreads();
}

// 16-bit renormalisation: reads the word at ptr-1, clamped to the stream.
__device__ __forceinline__ void refill(uint32_t& st, long long& ptr,
                                       const uint16_t* __restrict__ stream,
                                       long long last_word) {
  if (st < (1u << 16)) {
    --ptr;
    long long i = ptr;   // clipped with ifs, as decode_emit.cu's ring_slot
    if (i < 0) i = 0;
    if (i > last_word) i = last_word;
    st = (st << 16) | __ldg(stream + i);
  }
}

// The LUT row of the next token of component c (0..8) at this state. The
// kernels request it as soon as the state and the phase of the next token
// are known, so the rest of a step runs while the load is in flight.
__device__ __forceinline__ uint2 lut_row(const CodecParams& prm,
                                         const uint2* __restrict__ lut, int c,
                                         uint32_t state) {
  uint32_t idx = prm.offset[c] + (state & prm.mask[c]);
  if (idx >= prm.slots) idx = prm.slots - 1;
  return __ldg(lut + idx);
}

// One rANS decode step of component c from its LUT row e (lut_row at this
// state): u32 state update, refills, quasi-unfold. prm lies in shared
// memory (stage_params). Updates state and ptr; returns the value.
__device__ __forceinline__ uint32_t ans_step(
    const CodecParams& prm, uint2 e, const uint16_t* __restrict__ stream,
    long long last_word, int c, uint32_t& state, long long& ptr) {
  const uint32_t slot = state & prm.mask[c];
  const uint32_t freq = e.x & 0xFFFFu, cumul = e.x >> 16;
  const uint32_t sym = e.y & 0xFFFFu;
  const uint32_t folds = min(e.y >> 16, prm.max_folds);
  const uint32_t radix = prm.radix[c];
  // a u32 shift by >= 32 is undefined; the shifted base is 0 there
  const uint32_t sh = min(folds * radix, 31u);
  const uint32_t prefix = (sym - prm.fold_off[c] * folds) << sh;
  uint32_t st = (state >> prm.log_m[c]) * freq + slot - cumul;  // mod 2^32
  refill(st, ptr, stream, last_word);
  uint32_t fold = 0;
  const uint32_t rmask = (1u << radix) - 1u;
  for (uint32_t f = 0; f < folds; ++f) {
    refill(st, ptr, stream, last_word);
    fold = (fold << radix) | (st & rmask);
    st >>= radix;
    refill(st, ptr, stream, last_word);
  }
  state = st;
  return prefix | fold;
}

// Grammar registers of one lane.
struct Grammar {
  int d = 0, bc = 0, brem = 0, bidx = 0, bsum = 0, cpy = 0, copied = 0;
  int refd = 0, extra = 0, ivrem = 0, resrem = 0;
};

// What one grammar token did, for the callers' side effects.
struct GrammarStep {
  int nxt;            // next phase, kNodeDone or kKeep
  int b;              // block length (P_BLK)
  int tail_len;       // copied tail of the reference list (blocks done)
  bool blk_copy;      // a P_BLK token of a copy block
  bool blocks_done;   // the last P_BLK token of the node
};

__device__ __forceinline__ int tail_phase(int extra, int min_interval) {
  return extra > 0 ? (min_interval ? P_IC : P_FR) : kNodeDone;
}

// One grammar token of component c with value v. `ring` holds the window's
// outdegrees: ring.store(v) writes the current node's slot, ring.ref(v)
// reads the referenced node's outdegree.
template <class Ring>
__device__ __forceinline__ GrammarStep grammar_step(
    Grammar& g, int c, int v, Ring& ring, int window, int min_interval) {
  GrammarStep r{kKeep, 0, 0, false, false};
  switch (c) {
    case P_OUT:
      g.d = v;
      ring.store(v);
      g.copied = 0;
      if (v == 0) {
        r.nxt = kNodeDone;
      } else if (window > 0) {
        r.nxt = P_REF;
      } else {
        g.extra = g.d;
        r.nxt = tail_phase(g.extra, min_interval);
      }
      break;
    case P_REF:
      g.refd = ring.ref(v);
      g.copied = 0;
      if (v > 0) {
        r.nxt = P_BC;
      } else {
        g.extra = g.d;
        r.nxt = tail_phase(g.extra, min_interval);
      }
      break;
    case P_BC:
      g.bc = v;
      g.brem = v;
      g.bidx = 0;
      g.bsum = 0;
      g.cpy = 1;
      // bc == 0: the whole reference list is tail-copied
      g.copied = v == 0 ? g.refd : 0;
      if (v > 0) {
        r.nxt = P_BLK;
      } else {
        g.extra = g.d - g.copied;
        r.nxt = tail_phase(g.extra, min_interval);
      }
      break;
    case P_BLK:
      r.b = v + (g.bidx > 0 ? 1 : 0);
      g.bsum += r.b;
      r.blk_copy = g.cpy != 0;
      if (r.blk_copy) g.copied += r.b;
      g.cpy = 1 - g.cpy;
      ++g.bidx;
      --g.brem;
      if (g.brem == 0) {
        r.blocks_done = true;
        r.tail_len = (g.bc & 1) == 0 ? g.refd - g.bsum : 0;
        g.copied += r.tail_len;
        g.extra = g.d - g.copied;
        r.nxt = tail_phase(g.extra, min_interval);
      }
      break;
    case P_IC:
      g.ivrem = v;
      r.nxt = v > 0 ? P_IS : P_FR;
      break;
    case P_IS:
      r.nxt = P_IL;
      break;
    case P_IL:
      g.extra -= v + min_interval;
      --g.ivrem;
      r.nxt = g.ivrem > 0 ? P_IS : (g.extra > 0 ? P_FR : kNodeDone);
      break;
    default:   // P_FR, P_RES
      --g.resrem;
      break;
  }
  if (r.nxt == P_FR) g.resrem = g.extra;
  if (c >= P_FR) r.nxt = g.resrem > 0 ? P_RES : kNodeDone;
  return r;
}

}  // namespace wgt
