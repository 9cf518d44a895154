// Dirty-chain fixup of the merged-emit post-pass, on every call: the nodes
// that decode_emit left dirty get their sorted successor lists, every
// chain in one launch. Same contract and bits as the plain PyTorch
// version fixup_cuda.emit_fixup_plain; bound to Python with ctypes by
// ops/fixup_cuda.py (plain C interface).
//
// What it computes. A dirty node's elements sit in its own rows of the
// [S, G] val channel, unsorted, with placeholders where it copies from its
// reference (the parent), which may be dirty too. The node layout, built
// by emit_post.build_fixup_cache from a plan's first decode, cuts the
// dirty nodes that read a dirty parent's list into paths (each follows a
// node's child of the deepest subtree) and lists each node's element
// sources: a flat index into val (its own row, or a clean parent's row),
// or the rank of the parent's successor it copies. For each node the
// kernel gathers its elements, ranks them and writes the sorted list to
// val[start + rank * G], in place: a node's val reads are its own rows,
// read before it writes them, and clean parents' rows, which no node
// writes; a dirty parent's rows are read only after its flag.
//
// It replaces no TPU kernel: the JAX package's fixup is XLA (its
// post_steady: one gather, one sort and one scatter a chain level), as
// was the port's until this kernel. It was added because that form costs
// a sort and a dozen small launches for each level of the dirty chains,
// ~40 us a level on an H100, and the high-compression artifact's chains
// run 94 levels deep for 659 dirty nodes.
//
// What bounds it on an H100. The bytes are small (24.9 MB of node table,
// sources, gathers and writes on the reference's break-free cnr-2000
// artifact, 1.2 MB at window 7); the work is ordered by chain depth,
// because a placeholder indexes the parent's *sorted* list, so its time
// is the dependent chain's latency: the longest path's rows one after
// another (4,464 on that artifact), and its next longest. What the design
// does about it:
// - one persistent launch: blocks take rows from an atomic counter, a
//   path's first row before the rest, and follow the path to its end;
// - a path's rows of at most 64 elements (nearly all) go in batches of up
//   to kBatch rows: the whole block gathers the batch's own values with
//   one set of loads, then one warp finishes the rows in order from
//   shared memory and registers, with warp barriers only; along a path
//   the parent's sorted list stays in shared memory, and no flag is read;
// - no copy of the channel: the lists are patched into val itself;
// - where a path starts at a dirty parent of another path, the parent
//   publishes a ready flag (a barrier, then one thread's release store)
//   and the first row polls it with acquire loads, sleeping between
//   polls, and reads the parent's rows past L1 (__ldcg). Only a path's
//   first row waits, and on an earlier path's row, so a wait cannot
//   deadlock, whatever number of blocks is resident;
// - ranks, not a sort: an emitted dirty list is a few sorted runs
//   (copies, intervals, residuals), so each element's rank is its place
//   in its run plus a binary search in each other run, in shared memory
//   for lists up to kSmemInts elements (a device scratch region beyond);
//   a longer row's list of more than kMaxRuns runs is ranked by counting;
// - wide, shallow layouts (cnr-2000: 760 nodes in 4 levels, lists of
//   ~120 elements) spread over every SM: one block a path.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemInts = 2048;
constexpr int kMaxRuns = 32;
constexpr int kCols = 5;
constexpr int kFollows = -2;   // a row's link: it continues the row before
constexpr int kWarp = 32;
constexpr int kBatch = 64;     // rows a batch holds at most

// Elements of buf[lo, hi) (non-decreasing) below v, or up to v with
// `upto`.
__device__ __forceinline__ int count_below(const int* buf, int lo, int hi,
                                           int v, bool upto) {
  int a = lo, b = hi;
  while (a < b) {
    const int m = (a + b) >> 1;
    const int u = buf[m];
    if (u < v || (upto && u == v)) a = m + 1; else b = m;
  }
  return a - lo;
}

// Warp-level steps: on the host build (one thread a block) the warp is
// that thread.
__device__ __forceinline__ int popc(unsigned m) {
#ifdef __CUDA_ARCH__
  return __popc(m);
#else
  return __builtin_popcount(m);
#endif
}

__device__ __forceinline__ unsigned warp_ballot(bool p) {
#ifdef __CUDA_ARCH__
  return __ballot_sync(0xffffffffu, p);
#else
  return p ? 1u : 0u;
#endif
}

__device__ __forceinline__ void warp_sync() {
#ifdef __CUDA_ARCH__
  __syncwarp();
#endif
}

__device__ __forceinline__ void sleep_ns(int ns) {
#ifdef __CUDA_ARCH__
  __nanosleep(ns);
#endif
}

// The ready flags' release (after the rows' writes) and acquire (before
// the parent's rows are read), at the GPU's scope.
__device__ __forceinline__ void store_release(int* p, int v) {
#ifdef __CUDA_ARCH__
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
#else
  *p = v;
#endif
}

__device__ __forceinline__ int load_acquire(const int* p) {
#ifdef __CUDA_ARCH__
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
#else
  return *reinterpret_cast<const volatile int*>(p);
#endif
}

// Waits for a ready flag, sleeping between polls (up to ~1 us) so that
// the blocks that wait leave the memory system to those that work.
__device__ __forceinline__ void wait_ready(const int* flag) {
  for (int ns = 32; load_acquire(flag) == 0; ns = ns < 1024 ? 2 * ns : ns)
    sleep_ns(ns);
}

// nodes: [nd, kCols] int32 rows (element base, degree, flat index of the
// first output row, link, publish), a path's rows one after another, the
// paths in the order of their first rows' chain depth. link: kFollows
// when the row's parent is the row before (its list is in shared memory),
// else the row of the parent whose output rows it reads, or -1. publish:
// 1 when a row of another path reads this one (it sets its flag). srcs:
// [E] int32 element sources (>= 0: val index; < 0: ~j, the parent's j-th
// successor). val is read and patched in place, so its loads are plain
// (no read-only path); the values at the sources are successors, never
// negative. flags [nd] and *next arrive zeroed; spill holds 2 E ints for
// lists past kSmemInts.
//
// A path's rows of at most 2 W elements (W = 32 lanes on the card) go in
// batches: the whole block loads the headers of up to kBatch rows that
// follow one another with their elements one after another, and gathers
// all their own values at once (placeholders kept as ~j); then the first
// warp finishes the batch's rows one by one, each lane holding the
// elements at slots lane and lane + W, with no global load and no block
// barrier, while the other warps wait: its runs from two ballots, each
// element's rank from binary searches in the other runs. A longer row is
// ranked by the whole block from its runs.
__global__ void __launch_bounds__(kThreads) emit_fixup_kernel(
    int* val, const int* __restrict__ nodes, const int* __restrict__ srcs,
    int nd, int E, int G, int* flags, int* next, int* spill) {
  __shared__ int cur_s[kSmemInts], list_s[2][kSmemInts];
  __shared__ int runs_s[kMaxRuns];
  __shared__ int hdr_s[kBatch][kCols], off_s[kBatch + 1];
  __shared__ int wruns_s[2 * kWarp + 1];
  __shared__ int row_s, nrun_s, batch_s;
  const int t = threadIdx.x, T = blockDim.x;
  const int W = T < kWarp ? T : kWarp;   // the batches' lanes
  for (;;) {
    if (t == 0) row_s = atomicAdd(next, 1);
    __syncthreads();
    int q = row_s;
    __syncthreads();
    if (q >= nd) break;
    if (nodes[kCols * q + 3] == kFollows) continue;   // its path's block
    const int* prev = nullptr;    // the sorted list of the row before
    int side = 0;
    for (;;) {
      if (nodes[kCols * q + 1] <= 2 * W) {
        // a batch from row q: the headers, then its length and offsets
        for (int i = t; i < kBatch * kCols; i += T) {
          const int r = q + i / kCols, c = i % kCols;
          hdr_s[i / kCols][c] = r < nd ? nodes[kCols * q + i]
                                       : (c == 3 ? -1 : 0);
        }
        __syncthreads();
        if (t == 0) {
          int b = 0, off = 0;
          for (; b < kBatch; ++b) {
            const int* h = hdr_s[b];
            if (b > 0 && (h[3] != kFollows || h[0] != hdr_s[0][0] + off))
              break;
            if (h[1] > 2 * W || off + h[1] > kSmemInts) break;
            off_s[b] = off;
            off += h[1];
          }
          off_s[b] = off;
          batch_s = b;
        }
        __syncthreads();
        const int B = batch_s, e0 = hdr_s[0][0];
        for (int i = t; i < off_s[B]; i += T) {
          const int s = srcs[e0 + i];
          cur_s[i] = s >= 0 ? val[s] : s;
        }
        __syncthreads();
        if (t < W) {
          const int lane = t;
          for (int b = 0; b < B; ++b) {
            const int* h = hdr_s[b];
            const int n = h[1], link = h[3], off = off_s[b];
            int va = lane < n ? cur_s[off + lane] : 0;
            int vb = lane + W < n ? cur_s[off + lane + W] : 0;
            if (link >= 0) {
              if (lane == 0) wait_ready(flags + link);
              warp_sync();
              const int* parent = val + nodes[kCols * link + 2];
              if (lane < n && va < 0)
                va = __ldcg(parent + static_cast<long long>(~va) * G);
              if (lane + W < n && vb < 0)
                vb = __ldcg(parent + static_cast<long long>(~vb) * G);
            } else if (link == kFollows) {
              if (lane < n && va < 0) va = prev[~va];
              if (lane + W < n && vb < 0) vb = prev[~vb];
            }
            // the row's elements in shared memory, then its sorted runs:
            // run starts where an element is below the one before
            int* cur = cur_s + off;
            if (lane < n) cur[lane] = va;
            if (lane + W < n) cur[lane + W] = vb;
            warp_sync();
            const bool da = lane > 0 && lane < n && cur[lane - 1] > va;
            const bool db = lane + W < n && cur[lane + W - 1] > vb;
            const unsigned ma = warp_ballot(da), mb = warp_ballot(db);
            const unsigned below = (1u << lane) - 1u;   // lanes before
            const int na = popc(ma);
            if (lane == 0) wruns_s[0] = 0;
            if (da) wruns_s[1 + popc(ma & below)] = lane;
            if (db) wruns_s[1 + na + popc(mb & below)] = lane + W;
            warp_sync();
            const int R = 1 + na + popc(mb);
            // rank = elements below v, and equal ones before it: its place
            // in its run, and a search in each other run
            const int r_a = popc(ma & (below | (1u << lane)));
            const int r_b = na + popc(mb & (below | (1u << lane)));
            int ra = lane - wruns_s[r_a], rb = lane + W - wruns_s[r_b];
            for (int j = 0; j < R; ++j) {
              const int lo = wruns_s[j], hi = j + 1 < R ? wruns_s[j + 1] : n;
              if (j != r_a && lane < n)
                ra += count_below(cur, lo, hi, va, j < r_a);
              if (j != r_b && lane + W < n)
                rb += count_below(cur, lo, hi, vb, j < r_b);
            }
            int* dst = val + h[2];
            int* sorted = list_s[side];
            if (lane < n) {
              dst[static_cast<long long>(ra) * G] = va;
              sorted[ra] = va;
            }
            if (lane + W < n) {
              dst[static_cast<long long>(rb) * G] = vb;
              sorted[rb] = vb;
            }
            warp_sync();
            if (h[4] && lane == 0) store_release(flags + q + b, 1);
            prev = sorted;
            side ^= 1;
          }
        }
        __syncthreads();
        if (t >= W) {   // the warp's side and list, as it left them
          side ^= B & 1;
          prev = list_s[side ^ 1];
        }
        q += B;
        if (q >= nd || nodes[kCols * q + 3] != kFollows) break;
        continue;
      }
      const int* row = nodes + kCols * q;
      const int ebase = row[0], n = row[1], start = row[2], link = row[3];
      const int* src = srcs + ebase;
      int* cur = n <= kSmemInts ? cur_s : spill + ebase;
      int* sorted = n <= kSmemInts ? list_s[side] : spill + E + ebase;
      if (t == 0) {
        nrun_s = 1;
        runs_s[0] = 0;
      }
      for (int k = t; k < n; k += T) {
        const int s = src[k];
        if (s >= 0) cur[k] = val[s];
      }
      if (link >= 0) {
        if (t == 0) wait_ready(flags + link);
        __syncthreads();
        const int* parent = val + nodes[kCols * link + 2];
        for (int k = t; k < n; k += T) {
          const int s = src[k];
          if (s < 0) cur[k] = __ldcg(parent + static_cast<long long>(~s) * G);
        }
      } else if (link == kFollows) {
        for (int k = t; k < n; k += T) {
          const int s = src[k];
          if (s < 0) cur[k] = prev[~s];
        }
      }
      __syncthreads();
      for (int k = t + 1; k < n; k += T) {
        if (cur[k - 1] > cur[k]) {
          const int r = atomicAdd(&nrun_s, 1);
          if (r < kMaxRuns) runs_s[r] = k;
        }
      }
      __syncthreads();
      const int R = nrun_s;
      if (R <= kMaxRuns && t == 0) {
        for (int a = 1; a < R; ++a) {   // run starts in order
          const int s = runs_s[a];
          int b = a;
          for (; b > 0 && runs_s[b - 1] > s; --b) runs_s[b] = runs_s[b - 1];
          runs_s[b] = s;
        }
      }
      __syncthreads();
      // rank = elements below v, and equal ones before k: a permutation
      int* dst = val + start;
      for (int k = t; k < n; k += T) {
        const int v = cur[k];
        int rank = 0;
        if (R <= kMaxRuns) {
          int r = 0;
          while (r + 1 < R && runs_s[r + 1] <= k) ++r;
          rank = k - runs_s[r];
          for (int j = 0; j < R; ++j) {
            if (j == r) continue;
            const int hi = j + 1 < R ? runs_s[j + 1] : n;
            rank += count_below(cur, runs_s[j], hi, v, j < r);
          }
        } else {
          for (int j = 0; j < n; ++j) {
            const int u = cur[j];
            rank += (u < v) || (u == v && j < k);
          }
        }
        dst[static_cast<long long>(rank) * G] = v;
        sorted[rank] = v;
      }
      __syncthreads();
      if (row[4] && t == 0) store_release(flags + q, 1);
      prev = sorted;
      side ^= 1;
      if (q + 1 >= nd || nodes[kCols * (q + 1) + 3] != kFollows) break;
      ++q;
    }
  }
}

// Host launch code.
// Blocks the card holds at once (all SMs), queried once per device
// before any capture.
int resident_blocks() {
  static int cached[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, emit_fixup_kernel,
                                                  kThreads, 0);
    cached[dev] = sms * per_sm;
  }
  return cached[dev];
}

}  // namespace

// val: [S, G] int32 channel, patched in place; nodes [nd, 5], srcs [E]
// int32 (see the kernel); work: nd + 1 + 2 E int32, the first nd + 1
// zeroed (ready flags, the row counter), then the spill region. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for bad sizes or no resident block.
extern "C" int wgt_emit_fixup(void* val, const void* nodes, const void* srcs,
                              int nd, int E, int G, void* work,
                              void* cuda_stream) {
  if (nd < 0 || E < 0 || G < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nd == 0) return static_cast<int>(cudaGetLastError());
  const int resident = resident_blocks();
  if (resident < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = nd < resident ? nd : resident;
  int* w = static_cast<int*>(work);
  emit_fixup_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<int*>(val), static_cast<const int*>(nodes),
      static_cast<const int*>(srcs), nd, E, G, w, w + nd, w + nd + 1);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wgt_fixup_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
