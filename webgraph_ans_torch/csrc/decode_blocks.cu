// Grammar-FSM rANS token decode of independent node ranges (lanes), one
// CUDA thread per lane. Same contract and bits as the plain PyTorch version
// decode_torch.decode_blocks_plain; bound to Python with ctypes by
// ops/decode_cuda.py (plain C interface, no PyTorch headers).
//
// Replaces the TPU kernel decode_blocks_pallas
// (webgraph_ans_tpu/ops/decode_pallas.py:440). The Pallas kernel's stream
// slab, where-tree gathers and [A,128] register tiling exist for the TPU's
// VMEM and gather forms; here a lane reads its u16 words straight from
// device memory at a 64-bit pointer that walks downwards, and the LUT
// ([slots, 2] u32, 263 KB on cnr-2000, over a block's shared memory) is read
// through the read-only cache.
//
// What bounds it on an H100: bytes. The least traffic is the stream read
// once (2 B/word), the LUT once and the output written once (4 B per
// token row per lane plus the nibble rows); the integer work is a few tens
// of operations per token. What limits this simple version instead is
// latency: each token's LUT slot depends on the previous token's state
// (a chain of dependent global loads per lane), and the lanes of a warp sit
// in different grammar phases, so the warp diverges at the FSM switch.
// Warp-per-lane-group layouts, a shared-memory LUT for small models and
// more lanes per SM are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxRing = 17;          // window + 1 <= 17 (window <= 16)
constexpr int kThreads = 128;

enum Phase { P_OUT, P_REF, P_BC, P_BLK, P_IC, P_IS, P_IL, P_FR, P_RES, P_DONE };
constexpr int kNodeDone = -1;
constexpr int kKeep = -2;

struct CodecParams {
  uint32_t offset[9], log_m[9], mask[9], radix[9], fold_off[9];
  uint32_t slots, max_folds;
};

// 16-bit renormalisation: reads the word at ptr-1, clamped to the stream.
__device__ __forceinline__ void refill(uint32_t& st, long long& ptr,
                                       const uint16_t* __restrict__ stream,
                                       long long last_word) {
  if (st < (1u << 16)) {
    --ptr;
    const long long i = ptr < 0 ? 0 : (ptr > last_word ? last_word : ptr);
    st = (st << 16) | __ldg(stream + i);
  }
}

__device__ __forceinline__ int tail_phase(int extra, int min_interval) {
  return extra > 0 ? (min_interval ? P_IC : P_FR) : kNodeDone;
}

__global__ void __launch_bounds__(kThreads) decode_blocks_kernel(
    CodecParams prm, const uint2* __restrict__ lut,
    const uint16_t* __restrict__ stream, long long last_word,
    const long long* __restrict__ states, const long long* __restrict__ ptrs,
    const int* __restrict__ starts, const int* __restrict__ ends,
    const int* __restrict__ ring_seed, int L, int window, int min_interval,
    int cap, uint32_t* __restrict__ out, int* __restrict__ counts,
    uint8_t* __restrict__ ok) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const int R = window + 1;
  uint32_t state = static_cast<uint32_t>(states[l]);
  long long ptr = ptrs[l];
  int x = starts[l];
  const int end = ends[l];
  int phase = x < end ? P_OUT : P_DONE;
  int ring[kMaxRing];
  for (int k = 0; k < R; ++k) ring[k] = ring_seed[static_cast<size_t>(l) * R + k];
  int xmod = x % R;
  int d = 0, bc = 0, brem = 0, bidx = 0, bsum = 0, copied = 0, refd = 0;
  int extra = 0, ivrem = 0, resrem = 0;
  bool cpy = false;
  uint32_t cpk = 0xFFFFFFFFu;
  const size_t nib_row0 = static_cast<size_t>(cap) * L;

  int s = 0;
  for (; s < cap && phase != P_DONE; ++s) {
    const int c = phase;   // 0..8: the component this token belongs to

    // ---- rANS step (reference: src/ans/decoder.rs:58-87) ----
    const uint32_t slot = state & prm.mask[c];
    uint32_t idx = prm.offset[c] + slot;
    if (idx >= prm.slots) idx = prm.slots - 1;
    const uint2 e = __ldg(lut + idx);
    const uint32_t freq = e.x & 0xFFFFu, cumul = e.x >> 16;
    const uint32_t sym = e.y & 0xFFFFu;
    const uint32_t folds = min(e.y >> 16, prm.max_folds);
    const uint32_t radix = prm.radix[c];
    // a u32 shift by >= 32 is undefined: folds*radix reaches 49 on cnr-2000,
    // and then the shifted base is 0
    const uint32_t sh = min(folds * radix, 31u);
    const uint32_t prefix = (sym - prm.fold_off[c] * folds) << sh;
    uint32_t st = (state >> prm.log_m[c]) * freq + slot - cumul;  // wraps mod 2^32
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
    const uint32_t value = prefix | fold;
    const int v = static_cast<int>(value);

    // ---- grammar FSM (executable spec: native/src/bvgraph.hpp) ----
    int nxt = kKeep;
    switch (c) {
      case P_OUT:
        d = v;
        ring[xmod] = v;
        copied = 0;
        if (v == 0) {
          nxt = kNodeDone;
        } else if (window > 0) {
          nxt = P_REF;
        } else {
          extra = d;
          nxt = tail_phase(extra, min_interval);
        }
        break;
      case P_REF: {
        long long r = (static_cast<long long>(xmod) - v) % R;
        if (r < 0) r += R;
        refd = ring[r];
        copied = 0;
        if (v > 0) {
          nxt = P_BC;
        } else {
          extra = d;
          nxt = tail_phase(extra, min_interval);
        }
        break;
      }
      case P_BC:
        bc = v;
        brem = v;
        bidx = 0;
        bsum = 0;
        cpy = true;
        // bc == 0: the whole reference list is tail-copied
        copied = v == 0 ? refd : 0;
        if (v > 0) {
          nxt = P_BLK;
        } else {
          extra = d - copied;
          nxt = tail_phase(extra, min_interval);
        }
        break;
      case P_BLK: {
        const int b = v + (bidx > 0 ? 1 : 0);
        bsum += b;
        if (cpy) copied += b;
        cpy = !cpy;
        ++bidx;
        --brem;
        if (brem == 0) {
          if ((bc & 1) == 0) copied += refd - bsum;
          extra = d - copied;
          nxt = tail_phase(extra, min_interval);
        }
        break;
      }
      case P_IC:
        ivrem = v;
        nxt = v > 0 ? P_IS : P_FR;
        break;
      case P_IS:
        nxt = P_IL;
        break;
      case P_IL:
        extra -= v + min_interval;
        --ivrem;
        nxt = ivrem > 0 ? P_IS : (extra > 0 ? P_FR : kNodeDone);
        break;
      default:   // P_FR, P_RES
        --resrem;
        break;
    }
    if (nxt == P_FR) resrem = extra;
    if (c >= P_FR) nxt = resrem > 0 ? P_RES : kNodeDone;
    if (nxt == kNodeDone) {
      ++x;
      if (++xmod == R) xmod = 0;
      nxt = x >= end ? P_DONE : P_OUT;
    }
    if (nxt != kKeep) phase = nxt;

    // ---- step-major output; nibbles flushed every 8 steps ----
    out[static_cast<size_t>(s) * L + l] = value;
    const int shift = 4 * (s & 7);
    cpk = (cpk & ~(0xFu << shift)) | (static_cast<uint32_t>(c) << shift);
    if ((s & 7) == 7) {
      out[nib_row0 + static_cast<size_t>(s >> 3) * L + l] = cpk;
      cpk = 0xFFFFFFFFu;
    }
  }
  if (s & 7) out[nib_row0 + static_cast<size_t>(s >> 3) * L + l] = cpk;
  counts[l] = s;
  ok[l] = phase == P_DONE ? 1 : 0;
}

}  // namespace

// params: 47 ints — 9 x (offset, log_m, mask, radix, fold_off), slots,
// max_folds. out must arrive with value rows zeroed and nibble rows set to
// 0xFFFFFFFF; the kernel writes only the steps each lane decodes. Returns
// cudaGetLastError() after the launch.
extern "C" int wgt_decode_blocks(
    const long long* params, const void* lut, const void* stream,
    long long stream_len, const void* states, const void* ptrs,
    const void* starts, const void* ends, const void* ring_seed, int L,
    int window, int min_interval, int cap, void* out, void* counts, void* ok,
    void* cuda_stream) {
  if (window < 0 || window + 1 > kMaxRing || cap % 8 != 0 || stream_len < 1 ||
      params[45] < 1)
    return static_cast<int>(cudaErrorInvalidValue);
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
  if (L > 0) {
    const dim3 grid((L + kThreads - 1) / kThreads);
    decode_blocks_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(cuda_stream)>>>(
        prm, static_cast<const uint2*>(lut),
        static_cast<const uint16_t*>(stream), stream_len - 1,
        static_cast<const long long*>(states),
        static_cast<const long long*>(ptrs), static_cast<const int*>(starts),
        static_cast<const int*>(ends), static_cast<const int*>(ring_seed), L,
        window, min_interval, cap, static_cast<uint32_t*>(out),
        static_cast<int*>(counts), static_cast<uint8_t*>(ok));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wgt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
