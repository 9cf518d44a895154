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
// What bounds it on an H100. The bytes are small (under 1.2 MB of
// gathers and writes on cnr-2000); the work is ordered by chain depth,
// because a placeholder indexes the parent's *sorted* list, so its time
// is the dependent chain's latency. What the design does about it:
// - one persistent launch: blocks take rows from an atomic counter, a
//   path's first row before the rest, and follow the path to its end;
// - along a path the parent's sorted list stays in the block's shared
//   memory: a level costs the node's own gathers (L2), a rank and a few
//   barriers, and no flag;
// - no copy of the channel: the lists are patched into val itself;
// - where a path starts at a dirty parent of another path, the parent
//   publishes a ready flag (fence, then store) and the first node polls
//   it with volatile loads, fences, and reads the parent's rows past L1
//   (__ldcg). Only a path's first row waits, and on an earlier path's
//   row, so a wait cannot deadlock, whatever number of blocks is
//   resident;
// - ranks, not a sort: an emitted dirty list is a few sorted runs
//   (copies, intervals, residuals), so each element's rank is its place
//   in its run plus a binary search in each other run, in shared memory
//   for lists up to kSmemInts elements (a device scratch region beyond);
//   a list of more than kMaxRuns runs is ranked by counting;
// - wide, shallow layouts (cnr-2000: 760 nodes in 4 levels) spread over
//   every SM: one block a path.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemInts = 2048;
constexpr int kMaxRuns = 32;
constexpr int kCols = 5;
constexpr int kFollows = -2;   // a row's link: it continues the row before

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

// nodes: [nd, kCols] int32 rows (element base, degree, flat index of the
// first output row, link, publish), a path's rows one after another, the
// paths in the order of their first rows' chain depth. link: kFollows
// when the row's parent is the row before (its list is in shared memory),
// else the row of the parent whose output rows it reads, or -1. publish:
// 1 when a row of another path reads this one (it sets its flag). srcs:
// [E] int32 element sources (>= 0: val index; < 0: ~j, the parent's j-th
// successor). val is read and patched in place, so its loads are plain
// (no read-only path). flags [nd] and *next arrive zeroed; spill holds
// 2 E ints for lists past kSmemInts.
__global__ void __launch_bounds__(kThreads) emit_fixup_kernel(
    int* val, const int* __restrict__ nodes, const int* __restrict__ srcs,
    int nd, int E, int G, int* flags, int* next, int* spill) {
  __shared__ int cur_s[kSmemInts], list_s[2][kSmemInts];
  __shared__ int runs_s[kMaxRuns];
  __shared__ int row_s, nrun_s;
  const int t = threadIdx.x, T = blockDim.x;
  for (;;) {
    if (t == 0) row_s = atomicAdd(next, 1);
    __syncthreads();
    int q = row_s;
    __syncthreads();
    if (q >= nd) break;
    if (nodes[kCols * q + 3] == kFollows) continue;   // its path's block
    const int* prev = nullptr;    // the sorted list of the row before
    for (int side = 0;; ++q, side ^= 1) {
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
        if (t == 0) {
          while (*reinterpret_cast<volatile int*>(flags + link) == 0) {
          }
          __threadfence();
        }
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
      if (row[4]) __threadfence();
      __syncthreads();
      if (row[4] && t == 0) atomicExch(flags + q, 1);
      prev = sorted;
      if (q + 1 >= nd || nodes[kCols * (q + 1) + 3] != kFollows) break;
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
