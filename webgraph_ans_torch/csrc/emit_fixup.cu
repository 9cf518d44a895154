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
// another (4,464 on that artifact), and its next longest. The rule of the
// design: a path's per-row chain holds only the work that waits on the
// parent's sorted list. What it does:
// - one persistent launch: blocks take rows from an atomic counter, a
//   path's first row before the rest, and follow the path to its end;
// - a path's rows of at most 64 elements (nearly all) go in batches of up
//   to kBatch rows, which the first warp finishes one after another from
//   shared memory and registers, with warp barriers only; along a path
//   the parent's sorted list stays in shared memory, and no flag is read;
// - batches prepared ahead: while the first warp finishes a batch, the
//   other warps prepare the next in a second buffer (its headers, its own
//   values in one set of loads, and for each two-run row its known values
//   sorted into one run and its copies' mask); the batch boundary's block
//   barrier hands the buffer over. A path's first batch is prepared by
//   the whole block;
// - two runs: the layout (emit_post.two_run_layout) lists a row's copies
//   of its parent's list first, in ascending position j, so their values
//   (the parent's sorted list at those positions) form one non-decreasing
//   run; the known values, sorted ahead, form the other. On the chain an
//   element's rank is its place in its run plus the elements of the other
//   run below it, counted by broadcasting the shorter run over the warp:
//   one ballot an element, with no dependent load, no search and no run
//   to find. Rows on long reference chains copy nearly all of their
//   parent's list, so the shorter run is a few known values. A path's
//   first row reads its copies from the other path's rows;
// - a longer row (or one the layout left out of that form) is ranked by
//   the whole block: an emitted dirty list is a few sorted runs (copies,
//   intervals, residuals), so each element's rank is its place in its
//   run plus a binary search in each other run, in shared memory for
//   lists up to kSmemInts elements (a device scratch region beyond); a
//   list of more than kMaxRuns runs is ranked by counting;
// - no copy of the channel: the lists are patched into val itself;
// - where a path starts at a dirty parent of another path, the parent
//   publishes a ready flag and the first row polls it with acquire loads,
//   sleeping between polls, and reads the parent's rows past L1 (__ldcg).
//   A batch publishes once, after its last row: one fence, then the flags
//   of its rows that another path reads; a longer row publishes after its
//   block barrier (one thread's release store). Only a path's first row
//   waits, and on a row of an earlier path; a batch holds rows of one
//   path, of which only the first may wait, so finishing the batch that
//   publishes a row waits on earlier paths alone. A wait cannot deadlock,
//   whatever number of blocks is resident;
// - wide, shallow layouts (cnr-2000: 760 nodes in 4 levels, lists of
//   ~120 elements) spread over every SM: one block a path.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemInts = 2048;
constexpr int kBatchInts = kSmemInts / 2;   // elements a batch holds at most
constexpr int kMaxRuns = 32;
constexpr int kCols = 6;
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

// Lane `from`'s v, to every lane.
__device__ __forceinline__ int warp_shfl(int v, int from) {
#ifdef __CUDA_ARCH__
  return __shfl_sync(0xffffffffu, v, from);
#else
  return v;
#endif
}

__device__ __forceinline__ void warp_sync() {
#ifdef __CUDA_ARCH__
  __syncwarp();
#endif
}

// The barrier of the threads that prepare a batch: the block, or the n
// threads past the first warp (named barrier 1).
__device__ __forceinline__ void prep_sync(bool all, int n) {
  if (all) {
    __syncthreads();
    return;
  }
#ifdef __CUDA_ARCH__
  asm volatile("bar.sync 1, %0;" ::"r"(n) : "memory");
#endif
}

__device__ __forceinline__ void sleep_ns(int ns) {
#ifdef __CUDA_ARCH__
  __nanosleep(ns);
#endif
}

// The ready flags, at the GPU's scope: a release store (after a longer
// row's writes), a fence and relaxed stores (after a batch's), and the
// acquire load (before the parent's rows are read).
__device__ __forceinline__ void store_release(int* p, int v) {
#ifdef __CUDA_ARCH__
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
#else
  *p = v;
#endif
}

__device__ __forceinline__ void fence_release() {
#ifdef __CUDA_ARCH__
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
#endif
}

__device__ __forceinline__ void store_relaxed(int* p, int v) {
#ifdef __CUDA_ARCH__
  asm volatile("st.relaxed.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
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

// A batch's row as the first warp finishes it: its length, first output
// row, link and copies, its elements in the batch buffer and the two the
// lane holds.
struct Row {
  int n, start, link, C, va, vb;
  int* cur;
};

// A batch's rows in shared memory (their elements are in a buffer of
// kBatchInts ints beside it): the rows' headers, each row's first element
// in the buffer (off[len]: the batch's elements), the number of rows,
// whether one of them publishes, and whether the next batch of its path
// is prepared in the other buffer.
struct Batch {
  int hdr[kBatch][kCols];
  int off[kBatch + 1];
  int len, publish, next;
};

// Prepares the batch of rows from q into bt and cur, by the threads p in
// [0, P) (whole warps of W lanes; the whole block with `all`): the rows
// that follow q on its path, of at most wmax elements each, while their
// elements fit, all in the two-run form (column 5, their copies, >= 0):
// their own values gathered, placeholders kept as ~j, and in each row the
// known values after the copies sorted into one run.
__device__ void prepare(Batch& bt, int* cur, int q, const int* val,
                        const int* __restrict__ nodes,
                        const int* __restrict__ srcs, int nd, int wmax,
                        int p, int P, int W, bool all) {
  for (int i = p; i < kBatch * kCols; i += P) {
    const int r = q + i / kCols, c = i % kCols;
    bt.hdr[i / kCols][c] = r < nd ? nodes[kCols * q + i] : (c == 3 ? -1 : 0);
  }
  prep_sync(all, P);
  if (p == 0) {
    int b = 0, off = 0, pub = 0;
    for (; b < kBatch; ++b) {
      const int* h = bt.hdr[b];
      if (b > 0 && (h[3] != kFollows || h[0] != bt.hdr[0][0] + off)) break;
      if (h[1] > wmax || h[5] < 0 || off + h[1] > kBatchInts) break;
      bt.off[b] = off;
      off += h[1];
      pub |= h[4];
    }
    bt.off[b] = off;
    bt.len = b;
    bt.publish = pub;
  }
  prep_sync(all, P);
  const int B = bt.len, e0 = bt.hdr[0][0];
  for (int i = p; i < bt.off[B]; i += P) {
    const int s = srcs[e0 + i];
    cur[i] = s >= 0 ? val[s] : s;
  }
  prep_sync(all, P);
  // a warp a row, each lane holding the elements at slots lane, lane + W
  const int lane = p % W, ka = lane, kb = lane + W;
  for (int b = p / W; b < B; b += P / W) {
    const int n = bt.hdr[b][1], C = bt.hdr[b][5];
    int* row = cur + bt.off[b];
    const int va = ka < n ? row[ka] : 0, vb = kb < n ? row[kb] : 0;
    int ra = 0, rb = 0;   // places among the known values
    for (int k = C; k < n; ++k) {
      const int u = row[k];
      ra += u < va || (u == va && k < ka);
      rb += u < vb || (u == vb && k < kb);
    }
    warp_sync();
    if (ka >= C && ka < n) row[C + ra] = va;
    if (kb >= C && kb < n) row[C + rb] = vb;
  }
}

// Row b of batch bt (elements in cb), for the lane holding slots ka, kb.
__device__ __forceinline__ Row load_row(const Batch& bt, int* cb, int b,
                                        int ka, int kb) {
  const int* h = bt.hdr[b];
  Row r;
  r.n = h[1];
  r.start = h[2];
  r.link = h[3];
  r.C = h[5];
  r.cur = cb + bt.off[b];
  r.va = ka < r.n ? r.cur[ka] : 0;
  r.vb = kb < r.n ? r.cur[kb] : 0;
  return r;
}

// nodes: [nd, kCols] int32 rows (element base, degree, flat index of the
// first output row, link, publish, copies), a path's rows one after
// another, the paths in the order of their first rows' chain depth. link:
// kFollows when the row's parent is the row before (its list is in shared
// memory), else the row of the parent whose output rows it reads, or -1.
// publish: 1 when a row of another path reads this one (it sets its
// flag). copies: in a two-run row, the number of its first sources that
// copy the parent's list (in ascending position), else -1. srcs: [E]
// int32 element sources (>= 0: val index; < 0: ~j, the parent's j-th
// successor). val is read and patched in place, so its loads are plain
// (no read-only path); the values at the sources are successors, never
// negative. flags [nd] and *next arrive zeroed; spill holds 2 E ints for
// lists past kSmemInts.
//
// A path's two-run rows of at most 2 W elements (W = 32 lanes on the
// card) go in batches (prepare); the first warp finishes the batch's rows
// one by one, each lane holding the elements at slots lane and lane + W,
// with no global load but a first row's copies and no block barrier. Any
// other row is ranked by the whole block from its runs.
__global__ void __launch_bounds__(kThreads) emit_fixup_kernel(
    int* val, const int* __restrict__ nodes, const int* __restrict__ srcs,
    int nd, int E, int G, int* flags, int* next, int* spill) {
  __shared__ Batch bat_s[2];
  // batch buffer b at cur_s + b * kBatchInts; a longer row's elements
  __shared__ int cur_s[2 * kBatchInts], list_s[2][kSmemInts];
  __shared__ int runs_s[kMaxRuns];
  __shared__ int row_s, nrun_s;
  const int t = threadIdx.x, T = blockDim.x;
  const int W = T < kWarp ? T : kWarp;   // the batches' lanes
  const int wmax = 2 * W < kBatchInts ? 2 * W : kBatchInts;
  // the other warps prepare the next batch while the first finishes one;
  // a block of one warp prepares it first, then finishes
  const bool split = T > W;
  const int p = split ? t - W : t, P = split ? T - W : T;
  for (;;) {
    if (t == 0) row_s = atomicAdd(next, 1);
    __syncthreads();
    int q = row_s;
    __syncthreads();
    if (q >= nd) break;
    if (nodes[kCols * q + 3] == kFollows) continue;   // its path's block
    const int* prev = nullptr;    // the sorted list of the row before
    int side = 0, buf = 0;        // the lists' and the batches' buffer
    bool ready = false;           // the batch from q is prepared
    for (;;) {
      if (ready || (nodes[kCols * q + 1] <= wmax &&
                    nodes[kCols * q + 5] >= 0)) {
        Batch& bt = bat_s[buf];
        int* const cb = cur_s + buf * kBatchInts;
        if (!ready) {
          prepare(bt, cb, q, val, nodes, srcs, nd, wmax, t, T, W, true);
          __syncthreads();
        }
        const int B = bt.len, qn = q + B;
        if (!split || t >= W) {   // the first warp does not wait on it
          const bool more = qn < nd && nodes[kCols * qn + 3] == kFollows &&
                            nodes[kCols * qn + 1] <= wmax &&
                            nodes[kCols * qn + 5] >= 0;
          if (p == 0) bt.next = more;
          if (more)
            prepare(bat_s[buf ^ 1], cur_s + (buf ^ 1) * kBatchInts, qn,
                    val, nodes, srcs, nd, wmax, p, P, W, !split);
        }
        if (t < W) {
          const int lane = t, ka = lane, kb = lane + W;
          Row r = load_row(bt, cb, 0, ka, kb);
          for (int b = 0; b < B; ++b) {
            // the next row's fields, which do not wait on this row
            const Row nx = load_row(bt, cb, b + 1 < B ? b + 1 : b, ka, kb);
            const int n = r.n, C = r.C;
            int va = r.va, vb = r.vb, ra = ka, rb = kb;
            if (C > 0) {
              // two runs: the copies at [0, C), resolved from the
              // parent's list, and the known values at [C, n), sorted
              // ahead. An element's rank is its place in its run plus
              // the elements of the other run below it (a known value
              // counts the copies below it, a copy the known values at
              // or below it), counted by broadcasting the shorter run
              // over the warp, one ballot an element
              const int K = n - C;
              const bool ca = ka < C, cbb = kb < C;
              const bool xa = !ca && ka < n, xb = !cbb && kb < n;
              if (r.link >= 0) {   // a path's first row: another path's
                if (lane == 0) wait_ready(flags + r.link);   // rows
                warp_sync();
                const int* parent = val + nodes[kCols * r.link + 2];
                if (ca)
                  va = __ldcg(parent + static_cast<long long>(~va) * G);
                if (cbb)
                  vb = __ldcg(parent + static_cast<long long>(~vb) * G);
              } else {
                if (ca) va = prev[~va];
                if (cbb) vb = prev[~vb];
              }
              ra = ca ? ka : ka - C;
              rb = cbb ? kb : kb - C;
              if (K <= C) {
                const int* known = r.cur + C;
                for (int i = 0; i < K; ++i) {
                  const int u = known[i];
                  ra += ca && u <= va;
                  rb += cbb && u <= vb;
                  const int below = popc(warp_ballot(ca && va < u)) +
                                    popc(warp_ballot(cbb && vb < u));
                  if (ka == C + i) ra += below;
                  if (kb == C + i) rb += below;
                }
              } else {   // fewer copies than known values: all in slot a
                for (int k = 0; k < C; ++k) {
                  const int c = warp_shfl(va, k);
                  ra += xa && c < va;
                  rb += xb && c < vb;
                  const int upto = popc(warp_ballot(xa && va <= c)) +
                                   popc(warp_ballot(xb && vb <= c));
                  if (ka == k) ra += upto;
                }
              }
            }   // no copy: the known values alone, already sorted
            int* dst = val + r.start;
            int* sorted = list_s[side];
            if (ka < n) {
              dst[static_cast<long long>(ra) * G] = va;
              sorted[ra] = va;
            }
            if (kb < n) {
              dst[static_cast<long long>(rb) * G] = vb;
              sorted[rb] = vb;
            }
            warp_sync();
            prev = sorted;
            side ^= 1;
            r = nx;
          }
          if (bt.publish) {   // the batch's rows that other paths read
            fence_release();
            for (int b = lane; b < B; b += W)
              if (bt.hdr[b][4]) store_relaxed(flags + q + b, 1);
          }
        }
        __syncthreads();
        ready = bt.next;
        if (t >= W) side ^= B & 1;   // the warp's side and list, as it
        prev = list_s[side ^ 1];     // left them
        q = qn;
        buf ^= 1;
        if (!ready && (q >= nd || nodes[kCols * q + 3] != kFollows)) break;
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

// val: [S, G] int32 channel, patched in place; nodes [nd, 6], srcs [E]
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
