// Lane-parallel reverse rANS encode. Same contract and bits as the plain
// PyTorch version encode_torch.encode_blocks_plain; bound to Python with
// ctypes by ops/encode_cuda.py (plain C interface, no PyTorch headers).
//
// Replaces the TPU kernel encode_blocks_pallas
// (webgraph_ans_tpu/ops/encode_pallas.py:291, body _encode_token :174).
// The Pallas kernel's token slabs, two-bank [H, 256] table layout,
// where-tree gathers and [A, 128] register tiling exist for the TPU's
// VMEM and gather forms; here every array stays in device memory.
//
// What bounds it on an H100: the longest lane's dependent chain, not
// bytes. The function needs about 20 MB moved (0.006 ms at 3.35 TB/s),
// but each lane (encode block) is one rANS state updated once per token
// in order, so the kernel cannot take less than the longest lane's step
// count (cap, 3,976 on cnr-2000 at 512 lanes) times the latency of one
// step's state update: the fold pushes with their renorm tests, the
// renorm against bound - 1 and the multiply-high division.
//
// What the design does about it, in two launches per call:
//  1. encode_records_kernel, one thread per token, fully parallel: all
//     the work that does not depend on the state. It computes each
//     token's fold count and folded symbol, reads the table row, and
//     writes one 20-byte record in token order: rec4 = (freq | cumul <<
//     16, bound - 1, M, value) and recp = sh | log_m << 5 | radix << 10 |
//     folds << 15 | is_out << 20 (the value's low folds * radix bits are
//     the fold digits). The per-component parameters are picked by
//     compare-and-select over the nine components, so no dynamically
//     indexed copy of the parameter struct lands in local memory. The
//     same threads zero emit's pair rows, so that a lane stores only the
//     pairs that hold words.
//  2. encode_lanes_kernel, one thread per lane and kLanesPerBlock (1)
//     lanes a block: one lane a warp, so a warp runs only its own lane's
//     fold count and renorm branches, and 512 lanes spread over all 132
//     SMs. A lane walks its records from the last token to the first; a
//     step does only the state update and its stores: a branch on the
//     fold count (no folds: one predicated renorm and one pair store),
//     the multiply-high division with both corrections tested at once,
//     the meta and state rows. Records arrive kDepth - 1 steps ahead
//     through a ring in shared memory filled with cp.async, and each
//     step reads the next step's record into registers, so no load in a
//     step depends on a value loaded in that step and none waits out
//     device-memory latency. The loop is unrolled twice so that one
//     step's bookkeeping overlaps the other's chain. Emitted words are
//     packed into a pair register and stored as each pair completes (no
//     dynamically indexed word array). A finished lane leaves the step
//     loop and writes its remaining meta and state rows in one fill loop.
// The choices (one lane a block, ring depth, unroll, the division) were
// timed against their alternatives in turns on the card with
// tools/encode_kernel_ab.py (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanesPerBlock = 1;   // lanes (threads) a block
constexpr int kDepth = 16;          // record ring slots a lane
constexpr int kRecordThreads = 256; // threads a block of the records pass
constexpr uint32_t kLowerBound = 1u << 16;
constexpr int kMaxFolds = 30;   // values are u31: at most 30 fold pushes
static_assert(kDepth >= 2 && (kDepth & (kDepth - 1)) == 0,
              "kDepth is a power of two, at least 2");

struct EncodeParams {
  uint32_t offset[9], log_m[9], radix[9], fidelity[9];
  uint32_t max_folds;
};

// a[c] for a runtime c in 0..8, by compare-and-select over constant
// indices (a dynamic index into the by-value struct would copy it to
// local memory)
__device__ __forceinline__ uint32_t pick(const uint32_t (&a)[9],
                                         uint32_t c) {
  uint32_t v = a[0];
#pragma unroll
  for (uint32_t i = 1; i < 9; ++i) v = c == i ? a[i] : v;
  return v;
}

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

__global__ void __launch_bounds__(kRecordThreads) encode_records_kernel(
    EncodeParams prm, const uint4* __restrict__ tab, uint32_t entries,
    const uint2* __restrict__ tokens, long long T, uint4* __restrict__ rec4,
    uint32_t* __restrict__ recp, uint4* __restrict__ pairs,
    long long pairs16) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t < pairs16) pairs[t] = make_uint4(0u, 0u, 0u, 0u);
  if (t >= T) return;
  const uint2 tok = __ldg(&tokens[t]);
  const uint32_t c = tok.y;
  const uint32_t radix = pick(prm.radix, c);
  const uint32_t fid = pick(prm.fidelity, c);
  const uint32_t folds = fold_count(tok.x, fid, radix, prm.max_folds);
  uint32_t sym = tok.x;
  if (folds > 0u) {
    // folds * radix <= bitlen - fid <= 30: no shift reaches 32
    const uint32_t fold_off = ((1u << radix) - 1u) * (1u << (fid - 1u));
    sym = (sym >> (folds * radix)) + fold_off * folds;
  }
  uint32_t idx = pick(prm.offset, c) + sym;
  if (idx > entries - 1u) idx = entries - 1u;
  const uint4 row = __ldg(&tab[idx]);   // (freq | cumul << 16, bound-1, M, sh)
  uint32_t sh = row.w;
  if (sh > 31u) sh = 31u;
  rec4[t] = make_uint4(row.x, row.y, row.z, tok.x);
  recp[t] = sh | (pick(prm.log_m, c) << 5) | (radix << 10) | (folds << 15) |
            (c == 0u ? 1u << 20 : 0u);
}

// cp.async of one record into its ring slot; the host build of the CPU
// tests copies at once
__device__ __forceinline__ void fetch_record(uint4* s4, uint32_t* sp,
                                             const uint4* g4,
                                             const uint32_t* gp) {
#ifdef __CUDA_ARCH__
  const unsigned a4 = static_cast<unsigned>(__cvta_generic_to_shared(s4));
  const unsigned ap = static_cast<unsigned>(__cvta_generic_to_shared(sp));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a4),
               "l"(g4) : "memory");
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(ap),
               "l"(gp) : "memory");
#else
  *s4 = *g4;
  *sp = *gp;
#endif
}

__device__ __forceinline__ void commit_records() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// waits until at most N record groups of this thread are in flight
template <int N>
__device__ __forceinline__ void wait_records() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

// The pair rows of emit arrive zeroed (by the records pass), so a step
// stores only the pairs that hold words.
__global__ void __launch_bounds__(kLanesPerBlock) encode_lanes_kernel(
    const uint4* __restrict__ rec4, const uint32_t* __restrict__ recp,
    const int* __restrict__ tstart, const int* __restrict__ tend, int L,
    int cap, int EP, uint32_t* __restrict__ emit,
    uint32_t* __restrict__ states, uint32_t* __restrict__ final_states,
    uint32_t* __restrict__ wtotals, uint8_t* __restrict__ ok) {
  __shared__ __align__(16) uint4 ring4_s[kLanesPerBlock * kDepth];
  __shared__ uint32_t ringp_s[kLanesPerBlock * kDepth];
  const int l = blockIdx.x * kLanesPerBlock + threadIdx.x;
  if (l >= L) return;
  uint4* const ring4 = ring4_s + threadIdx.x * kDepth;
  uint32_t* const ringp = ringp_s + threadIdx.x * kDepth;
  const size_t Ls = static_cast<size_t>(L);
  const size_t row_step = static_cast<size_t>(EP) * Ls;
  const int n = tend[l] - tstart[l];
  const int steps = n < cap ? n : cap;
  const int last = tend[l] - 1;   // the token of step s is last - s
  uint32_t state = kLowerBound;
  uint32_t wcnt = 0;

  // the records of steps 0 .. kDepth-2 in flight, one group each
  for (int f = 0; f < kDepth - 1; ++f) {
    if (f < steps) fetch_record(ring4 + f, ringp + f, rec4 + (last - f),
                                recp + (last - f));
    commit_records();
  }
  // step 0's record in registers; each step reads the next one's from the
  // ring while it runs
  wait_records<kDepth - 2>();
  uint4 r = ring4[0];
  uint32_t pk = ringp[0];
  uint32_t* prow = emit + l;                                  // pair rows
  uint32_t* meta = emit + static_cast<size_t>(cap) * row_step + l;
  uint32_t* srow = states + l;
  // unrolled twice: once, four and eight times measured slower
#pragma unroll 2
  for (int s = 0; s < steps; ++s) {
    // step s + kDepth - 1's record into the slot of step s - 1, whose
    // record was read into registers and consumed before this point
    const int f = s + kDepth - 1;
    if (f < steps) {
      const int slot = f & (kDepth - 1);
      fetch_record(ring4 + slot, ringp + slot, rec4 + (last - f),
                   recp + (last - f));
    }
    commit_records();
    wait_records<kDepth - 2>();   // step s + 1's group has landed
    const uint4 r_next = ring4[(s + 1) & (kDepth - 1)];
    const uint32_t pk_next = ringp[(s + 1) & (kDepth - 1)];

    const uint32_t sh = pk & 31u;
    const uint32_t log_m = (pk >> 5) & 31u;
    const uint32_t folds = (pk >> 15) & 31u;
    uint32_t ne;   // words this token emits
    if (folds == 0u) {
      // renorm against bound - 1 (a frame-1 component's is 2^32 - 1:
      // never); the word is the low half of pair row 0
      ne = state > r.y ? 1u : 0u;
      prow[0] = ne ? state & 0xFFFFu : 0u;
      if (ne) state >>= 16;
    } else {
      const uint32_t radix = (pk >> 10) & 31u;   // 1..31
      const uint32_t rmask = (1u << radix) - 1u;
      const uint32_t top = 32u - radix;          // 1..31
      uint32_t pend = 0;   // low word of the open pair
      uint32_t digits = r.w;
      ne = 0;
      for (uint32_t k = 0; k < folds; ++k) {
        // renorm before a push when the top radix bits are in use
        if ((state >> top) != 0u) {
          if (ne & 1u) {
            prow[(ne >> 1) * Ls] = pend | ((state & 0xFFFFu) << 16);
          } else {
            pend = state & 0xFFFFu;
          }
          ++ne;
          state >>= 16;
        }
        state = (state << radix) + (digits & rmask);
        digits >>= radix;
      }
      if (state > r.y) {
        if (ne & 1u) {
          prow[(ne >> 1) * Ls] = pend | ((state & 0xFFFFu) << 16);
        } else {
          pend = state & 0xFFFFu;
        }
        ++ne;
        state >>= 16;
      }
      if (ne & 1u) prow[(ne >> 1) * Ls] = pend;   // open pair, high word 0
    }
    // the division-free update: q = umulhi(state, M) >> sh is at most
    // one off, so at most one of the two corrections applies (q - 1 when
    // the remainder went negative, q + 1 when it reached freq); both are
    // tested on the first remainder and fold into one adjustment of the
    // new state, (1 << log_m) - freq, off the multiply's chain
    const uint32_t freq = r.x & 0xFFFFu;
    const uint32_t cumul = r.x >> 16;
    const uint32_t q = __umulhi(state, r.z) >> sh;
    const uint32_t rem = state - q * freq;
    const bool down = static_cast<int32_t>(rem) < 0;
    const bool up = !down && rem >= freq;
    const uint32_t adj = (1u << log_m) - freq;
    state = (q << log_m) + cumul + rem;
    if (down) state -= adj;
    if (up) state += adj;

    wcnt += ne;
    *meta = ne | (pk >> 20 << 8) | (wcnt << 9);
    *srow = state;
    prow += row_step;
    meta += Ls;
    srow += Ls;
    r = r_next;
    pk = pk_next;
  }
  // a finished lane's rows up to cap (its pair rows are zero already)
  const uint32_t done_meta = 0xFFu | (wcnt << 9);
  for (int s = steps; s < cap; ++s) {
    *meta = done_meta;
    *srow = state;
    meta += Ls;
    srow += Ls;
  }
  final_states[l] = state;
  wtotals[l] = wcnt;
  ok[l] = n <= cap ? 1 : 0;
}

// The parameters from params (9 x (offset, log_m, radix, fidelity), then
// max_folds); false when one is out of the kernels' range.
bool encode_params(const long long* params, EncodeParams* prm) {
  const long long max_folds = params[36];
  if (max_folds < 0 || max_folds > kMaxFolds) return false;
  for (int c = 0; c < 9; ++c) {
    const long long* p = params + 4 * c;
    if (p[0] < 0 || p[1] < 0 || p[1] > 16 || p[2] < 1 || p[2] > 31 ||
        p[3] < 1 || p[3] > 31)
      return false;
    prm->offset[c] = static_cast<uint32_t>(p[0]);
    prm->log_m[c] = static_cast<uint32_t>(p[1]);
    prm->radix[c] = static_cast<uint32_t>(p[2]);
    prm->fidelity[c] = static_cast<uint32_t>(p[3]);
  }
  prm->max_folds = static_cast<uint32_t>(max_folds);
  return true;
}

}  // namespace

// Host launch code. Both launchers return cudaGetLastError() after their
// launch; one encode_blocks call is encode_records then encode_lanes on
// one stream (two kernel launches).

// rec4 (T x 16 bytes, 16-byte aligned) and recp (T x 4 bytes) are scratch
// the caller allocates. The pass also zeroes emit's pair rows (cap * EP *
// L words from emit, 16-byte aligned), which encode_lanes then fills.
extern "C" int wgt_encode_records(const long long* params, const void* tab,
                                  long long entries, const void* tokens,
                                  long long T, void* rec4, void* recp,
                                  void* emit, int L, int cap,
                                  void* cuda_stream) {
  EncodeParams prm;
  if (!encode_params(params, &prm) || entries < 1 ||
      entries > 0xFFFFFFFFll || T < 0 || L < 0 || cap < 0 || cap % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // cap is a multiple of 8, so the pair rows are whole 16-byte pieces
  const long long pairs16 = static_cast<long long>(cap) *
                            ((params[36] + 2) / 2) * L / 4;
  const long long work = T > pairs16 ? T : pairs16;
  if (work > 0) {
    const long long blocks = (work + kRecordThreads - 1) / kRecordThreads;
    if (blocks > 0x7FFFFFFFll) return static_cast<int>(cudaErrorInvalidValue);
    encode_records_kernel<<<static_cast<unsigned>(blocks), kRecordThreads, 0,
                            static_cast<cudaStream_t>(cuda_stream)>>>(
        prm, static_cast<const uint4*>(tab), static_cast<uint32_t>(entries),
        static_cast<const uint2*>(tokens), T, static_cast<uint4*>(rec4),
        static_cast<uint32_t*>(recp), static_cast<uint4*>(emit), pairs16);
  }
  return static_cast<int>(cudaGetLastError());
}

// Every output row up to cap is written, the pair rows only where they
// hold words (encode_records zeroed them). EP = (max_folds + 2) / 2.
extern "C" int wgt_encode_lanes(const void* rec4, const void* recp,
                                const void* tstart, const void* tend, int L,
                                int cap, int EP, void* emit, void* states,
                                void* final_states, void* wtotals, void* ok,
                                void* cuda_stream) {
  if (cap % 8 != 0 || cap < 0 || EP < 1 || EP > (kMaxFolds + 2) / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (L > 0) {
    const dim3 grid((L + kLanesPerBlock - 1) / kLanesPerBlock);
    encode_lanes_kernel<<<grid, kLanesPerBlock, 0,
                          static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<const uint4*>(rec4), static_cast<const uint32_t*>(recp),
        static_cast<const int*>(tstart), static_cast<const int*>(tend), L,
        cap, EP, static_cast<uint32_t*>(emit),
        static_cast<uint32_t*>(states),
        static_cast<uint32_t*>(final_states),
        static_cast<uint32_t*>(wtotals), static_cast<uint8_t*>(ok));
  }
  return static_cast<int>(cudaGetLastError());
}

// The launch shape: lanes a block, record ring slots a lane, threads a
// block of the records pass, static shared memory of a lanes block.
extern "C" void wgt_encode_geometry(int* lanes_per_block, int* depth,
                                    int* record_threads, int* smem_bytes) {
  *lanes_per_block = kLanesPerBlock;
  *depth = kDepth;
  *record_threads = kRecordThreads;
  *smem_bytes = kLanesPerBlock * kDepth * (16 + 4);
}

extern "C" const char* wgt_encode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
