// Lane-parallel reverse rANS encode, one CUDA thread per lane (encode
// block). Same contract and bits as the plain PyTorch version
// encode_torch.encode_blocks_plain; bound to Python with ctypes by
// ops/encode_cuda.py (plain C interface, no PyTorch headers).
//
// Replaces the TPU kernel encode_blocks_pallas
// (webgraph_ans_tpu/ops/encode_pallas.py:291). The Pallas kernel's token
// slabs, two-bank [H, 256] table layout, where-tree gathers and [A, 128]
// register tiling exist for the TPU's VMEM and gather forms; here a lane
// reads its tokens straight from the [T, 2] array in device memory
// (index tstart + cursor - 1) and its table rows ([entries, 4] u32, 16
// bytes each) through the read-only cache. No lane is too fat for this
// layout, so there is no fallback path.
//
// What bounds it on an H100: latency. The least traffic is the tokens and
// the table read once and the emit, meta and state rows written once
// (about 24 B per token row per lane); the integer work is a few tens of
// operations per token. But a lane's steps form one dependent chain
// through the rANS state, and the block count fixes the lanes: 512 lanes
// are 16 warps on 132 SMs, each working through ~3.7k steps on cnr-2000.
// What the design does about it: the token and its table row do not
// depend on the state, so step s+1's are loaded while step s runs (a
// one-step software pipeline), leaving only the integer chain of the
// state update on the critical path; blocks are one warp each, so every
// warp has an SM and its L1 to itself; emitted words are packed into a
// pair register and stored as each pair completes (no dynamically
// indexed word array, which would spill to local memory), in step-major
// rows so the 32 lanes of a warp store 128 contiguous bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;
constexpr uint32_t kLowerBound = 1u << 16;
constexpr int kMaxFolds = 30;   // values are u31: at most 30 fold pushes

struct EncodeParams {
  uint32_t offset[9], log_m[9], radix[9], fidelity[9];
  uint32_t max_folds;
  int ep;
};

// Fold count of a token value: #{k in 1..max_folds : fid + k*radix - 1 <
// 32 and sym >= 2^(fid + k*radix - 1)}. The exponents grow with k and
// sym >= 2^e <=> e <= bitlen(sym) - 1 <= 31, so this is
// min(max_folds, (bitlen - fid) / radix) once sym reaches the threshold.
__device__ __forceinline__ uint32_t fold_count(uint32_t sym, uint32_t fid,
                                               uint32_t radix,
                                               uint32_t max_folds) {
  const uint32_t e1 = fid + radix - 1;
  if (e1 >= 32u) return 0u;
  if (sym < (1u << e1)) return 0u;
  const uint32_t bl = 32u - static_cast<uint32_t>(__clz(sym));
  uint32_t folds = (bl - fid) / radix;
  if (folds > max_folds) folds = max_folds;
  return folds;
}

// Table row index of a token: component offset + folded symbol, clipped
// to the table.
__device__ __forceinline__ uint32_t table_index(const EncodeParams& prm,
                                                uint2 tok, uint32_t entries) {
  const uint32_t c = tok.y;
  const uint32_t radix = prm.radix[c];
  const uint32_t folds = fold_count(tok.x, prm.fidelity[c], radix,
                                    prm.max_folds);
  uint32_t sym = tok.x;
  if (folds > 0u) {
    const uint32_t fold_off = ((1u << radix) - 1u) *
                              (1u << (prm.fidelity[c] - 1u));
    sym = (sym >> (folds * radix)) + fold_off * folds;
  }
  uint32_t idx = prm.offset[c] + sym;
  if (idx > entries - 1u) idx = entries - 1u;
  return idx;
}

__global__ void __launch_bounds__(kThreads) encode_blocks_kernel(
    EncodeParams prm, const uint4* __restrict__ tab, uint32_t entries,
    const uint2* __restrict__ tokens, const int* __restrict__ tstart,
    const int* __restrict__ tend, int L, int cap,
    uint32_t* __restrict__ emit, uint32_t* __restrict__ states,
    uint32_t* __restrict__ final_states, uint32_t* __restrict__ wtotals,
    uint8_t* __restrict__ ok) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const size_t Ls = static_cast<size_t>(L);
  const int EP = prm.ep;
  uint32_t* const meta = emit + static_cast<size_t>(cap) * EP * Ls + l;
  const int lo = tstart[l];
  int cur = tend[l];
  uint32_t state = kLowerBound;
  uint32_t wcnt = 0;

  uint2 tok = make_uint2(0u, 0u);
  uint4 row = make_uint4(0u, 0u, 0u, 0u);
  if (cur > lo) {
    tok = __ldg(&tokens[cur - 1]);
    row = __ldg(&tab[table_index(prm, tok, entries)]);
  }

  for (int s = 0; s < cap; ++s) {
    uint32_t* const prow = emit + static_cast<size_t>(s) * EP * Ls + l;
    if (cur <= lo) {   // finished lane: the rows a finished lane writes
      for (int p = 0; p < EP; ++p) prow[p * Ls] = 0u;
      meta[static_cast<size_t>(s) * Ls] = 0xFFu | (wcnt << 9);
      states[static_cast<size_t>(s) * Ls + l] = state;
      continue;
    }
    // the next step's token and table row, loaded while this one runs
    uint2 tok_n = make_uint2(0u, 0u);
    uint4 row_n = make_uint4(0u, 0u, 0u, 0u);
    if (cur - 1 > lo) {
      tok_n = __ldg(&tokens[cur - 2]);
      row_n = __ldg(&tab[table_index(prm, tok_n, entries)]);
    }

    const uint32_t c = tok.y;
    const uint32_t radix = prm.radix[c];
    const uint32_t rmask = (1u << radix) - 1u;
    const uint32_t folds = fold_count(tok.x, prm.fidelity[c], radix,
                                      prm.max_folds);
    int ne = 0;          // words this token emits
    uint32_t pend = 0;   // low word of the open pair
    uint32_t sym = tok.x;
    for (uint32_t k = 0; k < folds; ++k) {
      // renorm before a push when the top radix bits are in use
      if ((state >> (32u - radix)) != 0u) {
        if (ne & 1) {
          prow[(ne >> 1) * Ls] = pend | ((state & 0xFFFFu) << 16);
        } else {
          pend = state & 0xFFFFu;
        }
        ++ne;
        state >>= 16;
      }
      state = (state << radix) + (sym & rmask);
      sym >>= radix;
    }

    // row = (freq | cumul << 16, renorm bound - 1, M, sh)
    if (state > row.y) {
      if (ne & 1) {
        prow[(ne >> 1) * Ls] = pend | ((state & 0xFFFFu) << 16);
      } else {
        pend = state & 0xFFFFu;
      }
      ++ne;
      state >>= 16;
    }
    const uint32_t freq = row.x & 0xFFFFu;
    const uint32_t cumul = row.x >> 16;
    uint32_t sh = row.w;
    if (sh > 31u) sh = 31u;
    uint32_t q = __umulhi(state, row.z) >> sh;
    uint32_t r = state - q * freq;
    if (static_cast<int32_t>(r) < 0) {
      q -= 1u;
      r += freq;
    }
    if (r >= freq) {
      q += 1u;
      r -= freq;
    }
    state = (q << prm.log_m[c]) + cumul + r;

    if (ne & 1) prow[(ne >> 1) * Ls] = pend;   // open pair, high word 0
    for (int p = (ne + 1) >> 1; p < EP; ++p) prow[p * Ls] = 0u;
    wcnt += static_cast<uint32_t>(ne);
    uint32_t m = static_cast<uint32_t>(ne) | (wcnt << 9);
    if (c == 0u) m |= 1u << 8;
    meta[static_cast<size_t>(s) * Ls] = m;
    states[static_cast<size_t>(s) * Ls + l] = state;
    --cur;
    tok = tok_n;
    row = row_n;
  }
  final_states[l] = state;
  wtotals[l] = wcnt;
  ok[l] = cur <= lo ? 1 : 0;
}

}  // namespace

// params: 9 x (offset, log_m, radix, fidelity), then max_folds. Every
// output row is written. Returns cudaGetLastError() after the launch.
extern "C" int wgt_encode_blocks(const long long* params, const void* tab,
                                 long long entries, const void* tokens,
                                 const void* tstart, const void* tend, int L,
                                 int cap, void* emit, void* states,
                                 void* final_states, void* wtotals, void* ok,
                                 void* cuda_stream) {
  EncodeParams prm;
  const long long max_folds = params[36];
  if (cap % 8 != 0 || entries < 1 || entries > 0xFFFFFFFFll ||
      max_folds < 0 || max_folds > kMaxFolds)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int c = 0; c < 9; ++c) {
    const long long* p = params + 4 * c;
    if (p[0] < 0 || p[1] < 0 || p[1] > 16 || p[2] < 1 || p[2] > 31 ||
        p[3] < 1 || p[3] > 31)
      return static_cast<int>(cudaErrorInvalidValue);
    prm.offset[c] = static_cast<uint32_t>(p[0]);
    prm.log_m[c] = static_cast<uint32_t>(p[1]);
    prm.radix[c] = static_cast<uint32_t>(p[2]);
    prm.fidelity[c] = static_cast<uint32_t>(p[3]);
  }
  prm.max_folds = static_cast<uint32_t>(max_folds);
  prm.ep = static_cast<int>((max_folds + 2) / 2);
  if (L > 0) {
    const dim3 grid((L + kThreads - 1) / kThreads);
    encode_blocks_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(cuda_stream)>>>(
        prm, static_cast<const uint4*>(tab),
        static_cast<uint32_t>(entries), static_cast<const uint2*>(tokens),
        static_cast<const int*>(tstart), static_cast<const int*>(tend), L,
        cap, static_cast<uint32_t*>(emit), static_cast<uint32_t*>(states),
        static_cast<uint32_t*>(final_states),
        static_cast<uint32_t*>(wtotals), static_cast<uint8_t*>(ok));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wgt_encode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
