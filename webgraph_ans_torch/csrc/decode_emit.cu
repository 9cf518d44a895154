// Merged-emit decode: BvGraph decode and successor reconstruction in one
// per-lane step machine, one CUDA thread per lane. Same contract and bits
// as the plain PyTorch version emit_torch.decode_emit_plain; bound to
// Python with ctypes by ops/emit_cuda.py (plain C interface).
//
// Replaces the TPU kernel decode_emit_pallas
// (webgraph_ans_tpu/ops/emit_pallas.py:501, step body _step :136). Each
// step runs the grammar FSM of ans_fsm.cuh for one token (stalling while
// a queue it must push to is full) into bounded queues of copy runs
// (QC = 16), interval runs (QI = 16), residuals (QR = 12) and node metas
// (QN = 4); an emission side merges the queue heads by value and writes
// one final sorted successor per step. Copy values are read back from a
// T-row ring of the lane's own emitted rows: scratch [T, L] int32 in
// device memory, row = global step & (T-1), so neighbouring lanes touch
// neighbouring words and the whole ring (4.2 MB at T = 512, 2048 lanes)
// stays in the 50 MB L2. Nodes the lane cannot resolve are written
// grouped (row codes 3, 7, 8, 9 with placeholders) for the post-pass.
//
// The TPU kernel keeps its 169-196 registers per lane in VMEM rows, reads
// the stream from a per-lane slab and builds every dynamic access from
// where-trees. Here the window rings and the queues are arrays with
// compile-time indices (the kernel is a template on the window), the
// one-hot push and the shift-down pop are fully unrolled predicated moves,
// and the stream is read at absolute 64-bit pointers through the
// read-only cache, as decode_blocks does.
//
// What bounds it on an H100: integer operations (a few hundred per step:
// the unrolled queue pushes and shifts are one compare and one select per
// slot and field) above bytes (the stream and the LUT read once, val, xch
// and nib written once: 8.5 B per step per lane), and, far above both,
// latency. Each step of a lane depends on the previous one (the rANS state
// chain plus the queues), each token's LUT and stream reads are dependent
// global loads, and the lanes of a warp diverge across grammar phases.
// The whole register file stays in registers (nvcc 12.8: 214 at window 7,
// 240 at window 16, no spills), so an SM holds few warps; 32 threads a
// block spread 2048 lanes over 64 SMs. Lane groups per warp, the ring in
// shared memory and asynchronous stream prefetch are later work.

#include "ans_fsm.cuh"

namespace {

using namespace wgt;

constexpr int QC = 16, QI = 16, QR = 12, QN = 4;
constexpr int C_EL = 0, C_FIRST = 1, C_HOLE = 2, C_REFINFO = 3, C_PLACE = 4,
              C_EMPTY = 5, C_DONE = 0xF;
constexpr int kThreads = 32;
constexpr int kUnroll = 8;
constexpr int NFIX = 45;

// register rows of the [nreg, L] file (emit_torch._layout)
enum {
  D_STATE, D_PTR, D_LEFT, D_PHASE, D_D, D_BC, D_BREM, D_BIDX, D_BSUM,
  D_CPY, D_COPIED, D_REFD, D_EXTRA, D_IVREM, D_RESREM, D_XMOD, D_X,
  D_PREVRES, D_IVL, D_FIV, D_REF, D_METASENT,
  E_ACTIVE, E_X, E_XMOD, E_D, E_REF, E_DIRTY, E_EMITTED, E_FIRST,
  E_PBASE, E_CCJ, E_CCLEFT, E_CSRC, E_CIVAL, E_CILEFT, E_DONEROW,
  E_LSTART, E_RSTART, E_MARKROW, E_MDIRTY,
  N_QC, N_QI, N_QR, N_QN
};

// R-entry register ring: reads and writes at a runtime slot, unrolled
// over the compile-time entries so the ring stays in registers.
template <int R>
__device__ __forceinline__ int ring_get(const int (&a)[R], int idx) {
  int v = a[0];
#pragma unroll
  for (int k = 1; k < R; ++k) v = idx == k ? a[k] : v;
  return v;
}

template <int R>
__device__ __forceinline__ void ring_put(int (&a)[R], int idx, int v,
                                         bool on) {
#pragma unroll
  for (int k = 0; k < R; ++k)
    if (on && idx == k) a[k] = v;
}

// Ring slot `back` entries behind `mod`, clipped to [0, R) as the TPU
// kernel clips it (emit_pallas.py:208-211, :343-345). Written with two ifs:
// the same clip as one nested conditional expression came out of nvcc
// 12.8 at -O3 (with the ring reads unrolled) reading slot R-1 for every
// slot, which -G and an unrolled-free build did not.
template <int R>
__device__ __forceinline__ int ring_slot(int mod, int back) {
  int s = mod - back;
  if (s < 0) s += R;
  if (s < 0) s = 0;
  if (s > R - 1) s = R - 1;
  return s;
}

// Outdegree ring of the decode side.
template <int R>
struct EmitRing {
  int (&a)[R];
  int xmod;
  __device__ void store(int v) { ring_put<R>(a, xmod, v, true); }
  __device__ int ref(int v) const {
    return ring_get<R>(a, ring_slot<R>(xmod, v));
  }
};

// One-hot push of (a, b[, c]) at position cnt; a push at a full queue
// writes nothing and still counts.
template <int Q>
__device__ __forceinline__ void qpush(int (&qa)[Q], int (&qb)[Q], int& cnt,
                                      bool on, int a, int b) {
#pragma unroll
  for (int k = 0; k < Q; ++k)
    if (on && cnt == k) {
      qa[k] = a;
      qb[k] = b;
    }
  cnt += on ? 1 : 0;
}

template <int Q>
__device__ __forceinline__ void qpush3(int (&qa)[Q], int (&qb)[Q],
                                       int (&qc)[Q], int& cnt, bool on,
                                       int a, int b, int c) {
#pragma unroll
  for (int k = 0; k < Q; ++k)
    if (on && cnt == k) {
      qa[k] = a;
      qb[k] = b;
      qc[k] = c;
    }
  cnt += on ? 1 : 0;
}

// Shift-down pop of the front entry (the last entry keeps its value).
template <int Q>
__device__ __forceinline__ void qshift(int (&q)[Q], bool on) {
  if (on) {
#pragma unroll
    for (int k = 0; k < Q - 1; ++k) q[k] = q[k + 1];
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads) decode_emit_kernel(
    CodecParams prm, const uint2* __restrict__ lut,
    const uint16_t* __restrict__ stream, long long last_word,
    const int* __restrict__ regs, const long long* __restrict__ ptrs, int L,
    int min_interval, int cap, int T, int mark_deg, int* __restrict__ val,
    int* __restrict__ xch, uint32_t* __restrict__ nib,
    int* __restrict__ rows_used, uint8_t* __restrict__ ok,
    int* __restrict__ diag, int* __restrict__ ring) {
  constexpr int R = W + 1;
  constexpr int DEG = NFIX, BASE = DEG + R, DIRT = BASE + R;
  constexpr int QC0 = DIRT + R, QI0 = QC0 + 2 * QC, QR0 = QI0 + 2 * QI;
  constexpr int QN0 = QR0 + 2 * QR;
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const size_t Ls = static_cast<size_t>(L);
  auto reg = [&](int row) { return regs[static_cast<size_t>(row) * Ls + l]; };

  uint32_t state = static_cast<uint32_t>(reg(D_STATE));
  long long ptr = ptrs[l];
  int left = reg(D_LEFT), phase = reg(D_PHASE);
  Grammar g;
  g.d = reg(D_D); g.bc = reg(D_BC); g.brem = reg(D_BREM);
  g.bidx = reg(D_BIDX); g.bsum = reg(D_BSUM); g.cpy = reg(D_CPY);
  g.copied = reg(D_COPIED); g.refd = reg(D_REFD); g.extra = reg(D_EXTRA);
  g.ivrem = reg(D_IVREM); g.resrem = reg(D_RESREM);
  int xmod = reg(D_XMOD), x = reg(D_X), prevres = reg(D_PREVRES);
  int ivl = reg(D_IVL), fiv = reg(D_FIV), refreg = reg(D_REF);
  int metasent = reg(D_METASENT);
  int e_active = reg(E_ACTIVE), e_x = reg(E_X), e_xmod = reg(E_XMOD);
  int e_d = reg(E_D), e_ref = reg(E_REF), e_dirty = reg(E_DIRTY);
  int e_emitted = reg(E_EMITTED), e_first = reg(E_FIRST);
  int e_pbase = reg(E_PBASE), cc_j = reg(E_CCJ), cc_left = reg(E_CCLEFT);
  int cc_src = reg(E_CSRC), ci_val = reg(E_CIVAL), ci_left = reg(E_CILEFT);
  int e_donerow = reg(E_DONEROW);
  const int e_lstart = reg(E_LSTART), e_rstart = reg(E_RSTART);
  int e_markrow = reg(E_MARKROW), e_mdirty = reg(E_MDIRTY);
  int qc_n = reg(N_QC), qi_n = reg(N_QI), qr_n = reg(N_QR), qn_n = reg(N_QN);
  int deg[R], base[R], dirt[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    deg[k] = reg(DEG + k);
    base[k] = reg(BASE + k);
    dirt[k] = reg(DIRT + k);
  }
  int qca[QC], qcb[QC], qia[QI], qib[QI], qra[QR], qrb[QR];
  int qna[QN], qnb[QN], qnc[QN];
#pragma unroll
  for (int k = 0; k < QC; ++k) {
    qca[k] = reg(QC0 + 2 * k);
    qcb[k] = reg(QC0 + 2 * k + 1);
  }
#pragma unroll
  for (int k = 0; k < QI; ++k) {
    qia[k] = reg(QI0 + 2 * k);
    qib[k] = reg(QI0 + 2 * k + 1);
  }
#pragma unroll
  for (int k = 0; k < QR; ++k) {
    qra[k] = reg(QR0 + 2 * k);
    qrb[k] = reg(QR0 + 2 * k + 1);
  }
#pragma unroll
  for (int k = 0; k < QN; ++k) {
    qna[k] = reg(QN0 + 3 * k);
    qnb[k] = reg(QN0 + 3 * k + 1);
    qnc[k] = reg(QN0 + 3 * k + 2);
  }

  uint32_t cpk = 0xFFFFFFFFu;
  const int tmask = T - 1;
  int row = 0;
  for (; row < cap; ++row) {
    const int p = phase;
    const bool active = p != P_DONE;
    // done at step start: the lane is frozen from here on
    if (!active && e_active == 0 && qn_n == 0) break;

    // ---------------- decode stall / early meta ----------------
    const bool meta_unsent = metasent == 0;
    const bool qfull_c = (p == P_BC || p == P_BLK) && qc_n > QC - 2;
    const bool qfull_i = p == P_IL && qi_n > QI - 1;
    const bool qfull_r = (p == P_FR || p == P_RES) && qr_n > QR - 1;
    const bool meta_phase = p == P_OUT || p == P_BC || p == P_BLK ||
                            p == P_IL || p == P_FR;
    const bool qfull_n = meta_phase && meta_unsent && qn_n > QN - 1;
    const bool stall = active && (qfull_c || qfull_i || qfull_r || qfull_n);
    // early dirty meta only on true self-deadlock (emission idle)
    const bool early = active && meta_unsent && (qfull_c || qfull_i) &&
                       e_active == 0 && qn_n == 0;
    const int tagd = x & 0xFF;
    qpush3<QN>(qna, qnb, qnc, qn_n, early, g.d,
               (refreg << 10) | (1 << 9) | tagd, 0);
    if (early) metasent = 1;

    const bool dec_active = active && !stall;
    // ---------------- rANS step + grammar FSM ----------------
    int v = 0;
    int nxt = kKeep;
    if (dec_active) {
      const int c = p;
      v = static_cast<int>(ans_step(prm, lut, stream, last_word, c, state,
                                    ptr));
      const int bsum_pre = g.bsum;
      EmitRing<R> dring{deg, xmod};
      const GrammarStep r = grammar_step(g, c, v, dring, W, min_interval);
      nxt = r.nxt;
      const int n2i = (v >> 1) ^ -(v & 1);
      switch (c) {
        case P_OUT:
          refreg = 0;
          break;
        case P_REF:
          refreg = v;
          break;
        case P_BC:
          // whole reference list copied (bc == 0)
          qpush<QC>(qca, qcb, qc_n, v == 0 && g.refd > 0, 0,
                    g.refd | (tagd << 20));
          break;
        case P_BLK:
          qpush<QC>(qca, qcb, qc_n, r.blk_copy && r.b > 0, bsum_pre,
                    r.b | (tagd << 20));
          qpush<QC>(qca, qcb, qc_n, r.blocks_done && r.tail_len > 0, g.bsum,
                    r.tail_len | (tagd << 20));
          break;
        case P_IC:
          fiv = 1;
          break;
        case P_IS:
          ivl = fiv != 0 ? x + n2i : ivl + 1 + v;
          fiv = 0;
          break;
        case P_IL: {
          const int ilen = v + min_interval;
          ivl += ilen;
          qpush<QI>(qia, qib, qi_n, ilen > 0, ivl - ilen,
                    ilen | (tagd << 20));
          break;
        }
        default: {   // P_FR, P_RES
          const int resval = c == P_FR ? x + n2i : prevres + v + 1;
          prevres = resval;
          qpush<QR>(qra, qrb, qr_n, true, resval, tagd);
          break;
        }
      }
      const bool node_done = nxt == kNodeDone;
      // meta: first residual, or node end without residuals
      const bool push_meta = (c == P_FR || node_done) && metasent == 0;
      qpush3<QN>(qna, qnb, qnc, qn_n, push_meta, g.d, (refreg << 10) | tagd,
                 g.copied);
      if (push_meta) metasent = 1;
      if (node_done) {
        metasent = 0;
        --left;
        ++x;
        if (++xmod >= R) xmod = 0;
        nxt = left <= 0 ? P_DONE : P_OUT;
      }
      if (nxt != kKeep) phase = nxt;
    }

    // =================== emission substep ===================
    const bool em_active = e_active != 0;
    const int ex = e_x, exmod = e_xmod;
    const int tagx = ex & 0xFF;

    // ---- pop the next node meta ----
    const bool can_pop = !em_active && qn_n > 0;
    const int md = qna[0], mp = qnb[0], mncop = qnc[0];
    const int mref = mp >> 10;
    const int mdirty0 = (mp >> 9) & 1;
    const bool hasref = mref > 0;
    const int psel = ring_slot<R>(exmod, W > 0 ? mref % R : 0);
    const int pbase = ring_get<R>(base, psel);
    const int ptaint = ring_get<R>(dirt, psel);
    const bool crossl = hasref && ex - mref < e_lstart;
    const bool qc_match_pop = qc_n > 0 && (qcb[0] >> 20) == tagx;
    const int firstsrc = pbase + qca[0];
    // ring-overflow bound (emit_pallas.py:354-358)
    const bool tover = hasref && qc_match_pop &&
                       (row + md - mncop - firstsrc) > (T - kUnroll);
    const bool dirty = mdirty0 != 0 || (hasref && (ptaint != 0 || crossl)) ||
                       tover;
    const int dcause = mdirty0 != 0 ? C_REFINFO
                       : (hasref && crossl) ? 7
                       : (hasref && ptaint != 0) ? 8 : 9;
    const bool empty = md == 0;
    qshift<QN>(qna, can_pop);
    qshift<QN>(qnb, can_pop);
    qshift<QN>(qnc, can_pop);
    qn_n -= can_pop ? 1 : 0;

    const bool popped_dirty = can_pop && !empty && dirty;
    const bool popped_empty = can_pop && empty;
    ring_put<R>(base, exmod, row + (dirty ? 1 : 0), can_pop);
    ring_put<R>(dirt, exmod, dirty ? 1 : 0, can_pop);
    const bool em_active2 = (can_pop && !empty) || em_active;
    if (can_pop) {
      e_d = md;
      e_ref = mref;
      e_dirty = dirty ? 1 : 0;
      e_emitted = 0;
      e_first = 1;
      e_pbase = pbase;
      cc_left = 0;
      ci_left = 0;
    }
    int ex2 = ex, exmod2 = exmod;
    if (popped_empty) {
      ++ex2;
      if (++exmod2 >= R) exmod2 = 0;
    }

    // ---- run activation (not on the refinfo / empty step) ----
    const bool emit_now = em_active2 && !popped_dirty && !popped_empty;
    const int tagx2 = can_pop ? (ex & 0xFF) : tagx;
    const bool act_c = emit_now && cc_left == 0 && qc_n > 0 &&
                       (qcb[0] >> 20) == tagx2;
    if (act_c) {
      cc_j = qca[0];
      cc_left = qcb[0] & 0xFFFFF;
      cc_src = e_pbase + qca[0];
    }
    qshift<QC>(qca, act_c);
    qshift<QC>(qcb, act_c);
    qc_n -= act_c ? 1 : 0;
    const bool act_i = emit_now && ci_left == 0 && qi_n > 0 &&
                       (qib[0] >> 20) == tagx2;
    if (act_i) {
      ci_val = qia[0];
      ci_left = qib[0] & 0xFFFFF;
    }
    qshift<QI>(qia, act_i);
    qshift<QI>(qib, act_i);
    qi_n -= act_i ? 1 : 0;

    // ---- group-done signals (decode position checks) ----
    const bool dec_past = x > ex2;
    const bool dec_past_blk = dec_past || (x == ex2 && phase >= P_IC);
    const bool dec_past_iv = dec_past || (x == ex2 && phase >= P_FR);
    const bool qc_match2 = qc_n > 0 && (qcb[0] >> 20) == tagx2;
    const bool qi_match2 = qi_n > 0 && (qib[0] >> 20) == tagx2;
    const bool cop_av = cc_left > 0;
    const bool cop_done = !cop_av && !qc_match2 && dec_past_blk;
    const bool iv_av = ci_left > 0;
    const bool iv_done = !iv_av && !qi_match2 && dec_past_iv;
    const bool res_av = qr_n > 0 && qrb[0] == tagx2;
    const bool res_done = !res_av && dec_past;

    // ---- heads and merge ----
    const int hc = ring[static_cast<size_t>(cc_src & tmask) * Ls + l];
    const int hi = ci_val;
    const int hr = qra[0];
    const bool clean = e_dirty == 0;
    const int BIG = 0x7FFFFFFF;
    const int hc_k = emit_now && cop_av && clean ? hc : BIG;
    const int hi_k = emit_now && iv_av ? hi : BIG;
    const int hr_k = emit_now && res_av ? hr : BIG;
    const bool gate = emit_now && (cop_av || cop_done) &&
                      (iv_av || iv_done) && (res_av || res_done) && clean;
    bool emit_c = gate && cop_av && hc_k <= hi_k && hc_k <= hr_k;
    bool emit_i = gate && iv_av && !emit_c && hi_k <= hr_k;
    bool emit_r = gate && res_av && !emit_c && !emit_i;
    // dirty nodes emit grouped: copies (placeholders), intervals, residuals
    const bool dgate = emit_now && !clean;
    emit_c = emit_c || (dgate && cop_av);
    emit_i = emit_i || (dgate && !cop_av && cop_done && iv_av);
    emit_r = emit_r ||
             (dgate && !cop_av && cop_done && !iv_av && iv_done && res_av);
    const bool emitted = emit_c || emit_i || emit_r;

    int out_v = emit_c ? (clean ? hc : cc_j) : (emit_i ? hi : hr);
    if (emit_c) {
      ++cc_j;
      ++cc_src;
      --cc_left;
    }
    if (emit_i) {
      ++ci_val;
      --ci_left;
    }
    qshift<QR>(qra, emit_r);
    qshift<QR>(qrb, emit_r);
    qr_n -= emit_r ? 1 : 0;

    e_emitted += emitted ? 1 : 0;
    const bool node_fin = em_active2 && e_emitted >= e_d && emitted;
    int ex3 = ex2, exmod3 = exmod2;
    if (node_fin) {
      ++ex3;
      if (++exmod3 >= R) exmod3 = 0;
    }
    const bool em_active3 = em_active2 && !node_fin;

    // ---- output row ----
    const bool lane_done = phase == P_DONE && !em_active3 && qn_n == 0;
    const bool halo = ex < e_rstart;   // halo nodes feed the ring, unmarked
    int code = C_HOLE;
    if (emitted)
      code = (emit_c && !clean) ? C_PLACE
             : (e_first != 0 && clean && !halo) ? C_FIRST : C_EL;
    if (popped_dirty && !halo) code = dcause;
    if ((popped_dirty || popped_empty) && halo) code = C_HOLE;
    if (popped_empty && !halo) code = C_EMPTY;
    if (lane_done && !emitted && !can_pop) code = C_DONE;
    if (popped_dirty) out_v = e_ref;
    const int out_x = mark_deg ? md : ex;
    if (emitted) e_first = 0;

    e_active = em_active3 ? 1 : 0;
    e_x = ex3;
    e_xmod = exmod3;
    e_donerow = row + 1;
    if (can_pop && !halo) {
      e_markrow = row;
      e_mdirty = (dirty ? 1 : 0) | (empty ? 2 : 0);
    }

    val[static_cast<size_t>(row) * Ls + l] = out_v;
    xch[static_cast<size_t>(row) * Ls + l] = out_x;
    ring[static_cast<size_t>(row & tmask) * Ls + l] = out_v;
    const int shift = 4 * (row & 7);
    cpk = (cpk & ~(0xFu << shift)) | (static_cast<uint32_t>(code) << shift);
    if ((row & 7) == 7) {
      nib[static_cast<size_t>(row >> 3) * Ls + l] = cpk;
      cpk = 0xFFFFFFFFu;
    }
  }
  // a finished lane is frozen: every later row repeats its stale
  // residual-queue head (val), its meta head or node (xch) and code 0xF
  const int fill_v = qra[0];
  const int fill_x = mark_deg ? qna[0] : e_x;
  for (int r = row; r < cap; ++r) {
    val[static_cast<size_t>(r) * Ls + l] = fill_v;
    xch[static_cast<size_t>(r) * Ls + l] = fill_x;
    cpk |= 0xFu << (4 * (r & 7));
    if ((r & 7) == 7) {
      nib[static_cast<size_t>(r >> 3) * Ls + l] = cpk;
      cpk = 0xFFFFFFFFu;
    }
  }
  const bool done = phase == P_DONE && e_active == 0 && qn_n == 0;
  rows_used[l] = e_donerow;
  ok[l] = done ? 1 : 0;
  diag[0 * Ls + l] = e_markrow;
  diag[1 * Ls + l] = e_mdirty;
  diag[2 * Ls + l] = x;
  diag[3 * Ls + l] = e_x;
  diag[4 * Ls + l] = e_active * 1000000 + e_emitted;
  diag[5 * Ls + l] = qn_n * 1000 + qc_n * 100 + qi_n * 10 + qr_n;
}

template <int W>
void launch(const CodecParams& prm, const void* lut, const void* stream,
            long long stream_len, const void* regs, const void* ptrs, int L,
            int min_interval, int cap, int T, int mark_deg, void* val,
            void* xch, void* nib, void* rows, void* ok, void* diag,
            void* ring, cudaStream_t s) {
  decode_emit_kernel<W><<<(L + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      prm, static_cast<const uint2*>(lut),
      static_cast<const uint16_t*>(stream), stream_len - 1,
      static_cast<const int*>(regs), static_cast<const long long*>(ptrs), L,
      min_interval, cap, T, mark_deg, static_cast<int*>(val),
      static_cast<int*>(xch), static_cast<uint32_t*>(nib),
      static_cast<int*>(rows), static_cast<uint8_t*>(ok),
      static_cast<int*>(diag), static_cast<int*>(ring));
}

using LaunchFn = void (*)(const CodecParams&, const void*, const void*,
                          long long, const void*, const void*, int, int, int,
                          int, int, void*, void*, void*, void*, void*, void*,
                          void*, cudaStream_t);

template <int... Ws>
struct Table {
  static constexpr LaunchFn fns[sizeof...(Ws)] = {&launch<Ws>...};
};

}  // namespace

// regs: [nreg, L] int32 register file (emit_torch.emit_init_regs), ptrs:
// [L] int64 absolute entry pointers, ring: [T, L] int32 scratch. Every row
// of val, xch, nib is written. Returns cudaGetLastError() after the launch.
extern "C" int wgt_decode_emit(
    const long long* params, const void* lut, const void* stream,
    long long stream_len, const void* regs, const void* ptrs, int L,
    int window, int min_interval, int cap, int T, int mark_deg, void* val,
    void* xch, void* nib, void* rows, void* ok, void* diag, void* ring,
    void* cuda_stream) {
  if (window < 0 || window > kMaxWindow || cap % kUnroll != 0 || T < 8 ||
      (T & (T - 1)) != 0 || stream_len < 1 || params[45] < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const CodecParams prm = codec_params(params);
  using Fns = Table<0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
                    16>;
  if (L > 0)
    Fns::fns[window](prm, lut, stream, stream_len, regs, ptrs, L,
                     min_interval, cap, T, mark_deg, val, xch, nib, rows, ok,
                     diag, ring, static_cast<cudaStream_t>(cuda_stream));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wgt_emit_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
