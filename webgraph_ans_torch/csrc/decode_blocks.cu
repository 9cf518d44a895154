// Grammar-FSM rANS token decode of independent node ranges (lanes), one
// CUDA thread per lane. Same contract and bits as the plain PyTorch version
// decode_torch.decode_blocks_plain; bound to Python with ctypes by
// ops/decode_cuda.py (plain C interface, no PyTorch headers). The rANS step
// and the grammar FSM live in ans_fsm.cuh, shared with decode_emit.cu.
//
// Replaces the TPU kernel decode_blocks_pallas
// (webgraph_ans_tpu/ops/decode_pallas.py:440), in both of its modes: token
// mode, and aux mode (emit_aux), where every token also carries two
// pre-resolved reconstruction fields (rows cap..3cap) and each node ends
// with one summary pseudo-step (nibble 0x9) -- the mode the merged-emit
// planner decodes once to find reference-safe lane bounds. The Pallas
// kernel's stream slab, where-tree gathers and [A,128] register tiling
// exist for the TPU's VMEM and gather forms; here a lane reads its u16
// words straight from device memory at a 64-bit pointer that walks
// downwards, and the LUT ([slots, 2] u32, 263 KB on cnr-2000, over a
// block's shared memory) is read through the read-only cache.
//
// What bounds it on an H100. Its least time is set by bytes (the stream
// words the lanes consume and the LUT read once, each lane's steps and
// nibbles written once: ~10 MB in token mode on cnr-2000, ~0.003 ms),
// but each token's LUT slot depends on the previous token's state, so a
// lane is one chain of dependent steps and the longest lane sets the
// time. What limits it is the instructions a warp issues per step: the
// lanes of a warp sit in different grammar phases, and a warp runs the
// union of their paths through the FSM switch, the fold loop and the
// refills. On an H100 (PERF.md) fewer lanes per warp ran faster all the
// way down to one (token mode at 4096 lanes: 1.18 ms at 32 lanes a
// block, 0.73 at 8, 0.60-0.66 at 1). So a block is one thread:
// a warp follows one lane's path alone, and the lanes spread over every
// SM, up to 32 one-warp blocks an SM (4,224 lanes at once on 132 SMs),
// enough warps for each sub-partition to hide the others' latency. The
// codec parameters are read from shared memory at the lane's component,
// each token's LUT row is requested a step ahead (lut_row), and the
// window's outdegree ring lives in dynamic shared memory (window + 1 ints
// a lane, so any window up to kMaxBlocksWindow, the sort path's windows
// past the merged-emit kernel's 16 among them), not in a runtime-indexed
// local array.

#include "ans_fsm.cuh"

namespace {

using namespace wgt;

// the ring of a block's lanes fits the 48 KB of dynamic shared memory a
// launch gets without an opt-in
constexpr int kMaxBlocksWindow = 4095;
constexpr int kThreads = 1;

// Outdegree ring with a runtime window (slot node % R), one column of the
// block's shared ring: entry k of this lane at a[k * kThreads].
struct RuntimeRing {
  int* a;
  int R;
  int xmod;
  __device__ void store(int v) { a[xmod * kThreads] = v; }
  __device__ int ref(int v) const {
    long long r = (static_cast<long long>(xmod) - v) % R;
    if (r < 0) r += R;
    return a[r * kThreads];
  }
};

template <bool kAux>
__global__ void __launch_bounds__(kThreads) decode_blocks_kernel(
    CodecParams prm, const uint2* __restrict__ lut,
    const uint16_t* __restrict__ stream, long long last_word,
    const long long* __restrict__ states, const long long* __restrict__ ptrs,
    const int* __restrict__ starts, const int* __restrict__ ends,
    const int* __restrict__ ring_seed, int L, int window, int min_interval,
    int cap, uint32_t* __restrict__ out, int* __restrict__ counts,
    uint8_t* __restrict__ ok) {
  __shared__ CodecParams sp;
  extern __shared__ int ring_s[];   // [window + 1, kThreads]
  stage_params(prm, sp);
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const int R = window + 1;
  uint32_t state = static_cast<uint32_t>(states[l]);
  long long ptr = ptrs[l];
  int x = starts[l];
  const int end = ends[l];
  int phase = x < end ? P_OUT : P_DONE;
  uint2 e = make_uint2(0u, 0u);   // the LUT row of the next token
  if (phase < P_DONE) e = lut_row(sp, lut, phase, state);
  int* ring_a = ring_s + threadIdx.x;
  for (int k = 0; k < R; ++k)
    ring_a[k * kThreads] = ring_seed[static_cast<size_t>(l) * R + k];
  RuntimeRing ring{ring_a, R, x % R};
  Grammar g;
  // aux registers: running residual, interval element count, interval
  // left/end tracker, first-interval flag, tail length
  int prevres = 0, ivsum = 0, ivl = 0, fiv = 0, tail = 0;
  int outn = 0;
  uint32_t cpk = 0xFFFFFFFFu;
  const size_t Ls = static_cast<size_t>(L);
  const size_t nib_row0 = static_cast<size_t>(kAux ? 3 * cap : cap) * Ls;

  int s = 0;
  for (; s < cap && phase != P_DONE; ++s) {
    uint32_t value, a1 = 0, a2 = 0, nib;
    if (kAux && phase == P_SUM) {
      // summary pseudo-step: (copied, interval elements, tail length)
      value = static_cast<uint32_t>(g.copied);
      a1 = static_cast<uint32_t>(ivsum);
      a2 = static_cast<uint32_t>(tail);
      nib = 9;
      phase = x >= end ? P_DONE : P_OUT;
    } else {
      const int c = phase;   // 0..8: the component of this token
      value = ans_step(sp, e, stream, last_word, c, state, ptr);
      const int v = static_cast<int>(value);
      nib = static_cast<uint32_t>(c);
      ++outn;
      const int bsum_pre = g.bsum, copied_pre = g.copied, cpy_pre = g.cpy;
      const int resrem_pre = g.resrem;
      const GrammarStep r = grammar_step(g, c, v, ring, window,
                                         min_interval);
      if (kAux) {
        const int n2i = (v >> 1) ^ -(v & 1);   // nat2int
        switch (c) {
          case P_OUT:
            ivsum = 0;
            tail = 0;
            break;
          case P_REF:
            break;
          case P_BC:
            if (v == 0) tail = g.refd;
            break;
          case P_BLK:
            a1 = static_cast<uint32_t>(bsum_pre);
            a2 = static_cast<uint32_t>((copied_pre << 1) | cpy_pre);
            if (r.blocks_done) tail = r.tail_len;
            break;
          case P_IC:
            fiv = 1;
            break;
          case P_IS: {
            const int left = fiv ? x + n2i : ivl + 1 + v;
            a1 = static_cast<uint32_t>(left);
            a2 = static_cast<uint32_t>(g.copied + ivsum);
            ivl = left;
            fiv = 0;
            break;
          }
          case P_IL: {
            const int ilen = v + min_interval;
            a1 = static_cast<uint32_t>(ivl);
            a2 = static_cast<uint32_t>(g.copied + ivsum);
            ivl += ilen;
            ivsum += ilen;
            break;
          }
          default: {   // P_FR, P_RES
            const int resval = c == P_FR ? x + n2i : prevres + v + 1;
            prevres = resval;
            a1 = static_cast<uint32_t>(resval);
            a2 = static_cast<uint32_t>(g.d - resrem_pre);
            break;
          }
        }
      }
      int nxt = r.nxt;
      if (nxt == kNodeDone) {
        ++x;
        if (++ring.xmod == R) ring.xmod = 0;
        nxt = kAux ? P_SUM : (x >= end ? P_DONE : P_OUT);
      }
      if (nxt != kKeep) phase = nxt;
    }
    if (phase < P_DONE) e = lut_row(sp, lut, phase, state);

    // step-major output; nibbles flushed every 8 steps
    out[static_cast<size_t>(s) * Ls + l] = value;
    if (kAux) {
      out[static_cast<size_t>(cap + s) * Ls + l] = a1;
      out[static_cast<size_t>(2 * cap + s) * Ls + l] = a2;
    }
    const int shift = 4 * (s & 7);
    cpk = (cpk & ~(0xFu << shift)) | (nib << shift);
    if ((s & 7) == 7) {
      out[nib_row0 + static_cast<size_t>(s >> 3) * Ls + l] = cpk;
      cpk = 0xFFFFFFFFu;
    }
  }
  if (s & 7) out[nib_row0 + static_cast<size_t>(s >> 3) * Ls + l] = cpk;
  counts[l] = outn;
  ok[l] = phase == P_DONE ? 1 : 0;
}

}  // namespace

// out must arrive with value (and aux) rows zeroed and nibble rows set to
// 0xFFFFFFFF; the kernel writes only the steps each lane decodes. Returns
// cudaGetLastError() after the launch.
extern "C" int wgt_decode_blocks(
    const long long* params, const void* lut, const void* stream,
    long long stream_len, const void* states, const void* ptrs,
    const void* starts, const void* ends, const void* ring_seed, int L,
    int window, int min_interval, int cap, int emit_aux, void* out,
    void* counts, void* ok, void* cuda_stream) {
  if (window < 0 || window > kMaxBlocksWindow || cap % 8 != 0 ||
      stream_len < 1 || params[45] < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const CodecParams prm = codec_params(params);
  if (L > 0) {
    const dim3 grid((L + kThreads - 1) / kThreads);
    auto kernel = emit_aux ? decode_blocks_kernel<true>
                           : decode_blocks_kernel<false>;
    const size_t ring_bytes =
        static_cast<size_t>(window + 1) * kThreads * sizeof(int);
    kernel<<<grid, kThreads, ring_bytes,
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
