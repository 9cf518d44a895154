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
// T-row ring of the lane's own emitted rows (row = global step & (T-1)).
// Nodes the lane cannot resolve are written grouped (row codes 3, 7, 8, 9
// with placeholders) for the post-pass.
//
// The TPU kernel keeps its 169-196 registers per lane in VMEM rows, reads
// the stream from a per-lane slab and builds every dynamic access from
// where-trees: one-hot pushes and shift-down pops over every queue slot.
//
// What bounds it on an H100. Its least time is set by bytes (the stream
// and the LUT read once, val, xch and a nibble written for each row a
// lane uses: ~34 MB on cnr-2000, ~0.01 ms), but every step of a lane
// depends on the previous one (the rANS state chain and the queues), and
// a step is a long instruction path that depends on the lane's grammar
// phase and queue state, so a warp runs the union of its lanes' paths and
// the lanes' steps, not bytes, set the time. What the design
// does about it:
// - a block holds kLanesPerBlock = 2 lanes (one warp): on an H100, fewer
//   lanes a warp ran faster (2048 lanes on cnr-2000: 5.8 ms at 32 a
//   block, 3.2-3.6 at 4, 2.7-2.8 at 2 or 1; PERF.md), and the 1024 warps
//   spread over every SM;
// - each lane's state lives in its own region of the block's dynamic
//   shared memory: the queues, the three window rings and the T-row ring
//   (T + 100 + 3(W+1) ints: 2,544 B at T = 512, W = 7), so no per-slot
//   select and no device-memory round trip is left on the step;
// - each queue is a circular buffer with O(1) push and pop that keeps,
//   slot for slot, what the reference's shift-down array keeps (Queue);
// - the codec parameters come from shared memory, and each token's LUT
//   row is requested a step ahead, while the emission substep runs
//   (ans_fsm.cuh);
// - run folding: while the decode side is stalled or finished, a row that
//   only continues a copy or interval run is written by a tight loop that
//   updates the run alone, not by a full step (~40% of cnr-2000's rows).
//   On an H100 a folded row took ~250 cycles, a full step that only emits
//   ~1,300-1,900 and one that decodes ~2,100-2,300, so the kernel still
//   ends with the lanes that decode the most rows (PERF.md). The loop and
//   why its rows are exact are at the end of the step; fold_rows counts
//   its rows.
// The launcher halves the lanes a block when T's ring would not fit the
// card's per-block shared memory, and refuses a T for which even one lane
// does not fit.

#include "ans_fsm.cuh"

namespace {

using namespace wgt;

constexpr int QC = 16, QI = 16, QR = 12, QN = 4;
constexpr int C_EL = 0, C_FIRST = 1, C_HOLE = 2, C_REFINFO = 3, C_PLACE = 4,
              C_EMPTY = 5, C_DONE = 0xF;
constexpr int kLanesPerBlock = 2;
constexpr int kUnroll = 8;
constexpr int NFIX = 45;
// shared-memory ints per lane besides the T-row ring: the queues' fields
constexpr int kQueueInts = 2 * QC + 2 * QI + 2 * QR + 3 * QN;

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

// Outdegree ring of the decode side, in the lane's shared memory.
template <int R>
struct EmitRing {
  int* a;
  int xmod;
  __device__ void store(int v) { a[xmod] = v; }
  __device__ int ref(int v) const { return a[ring_slot<R>(xmod, v)]; }
};

// A bounded queue of F int fields (F = 2 or 3) in the lane's shared
// memory: field f of physical slot s at a[f * Q + s], logical slot k at
// physical slot (h + k) mod Q. It holds, slot for slot,
// what the reference's shift-down array holds (emit_torch._Queue), stale
// slots included, at O(1) a push or pop:
// - push at logical slot n, unless the queue is full: a push at a full
//   queue writes nothing and still counts;
// - pop advances h after copying the old last logical slot (physical
//   h - 1) into the vacated physical slot h, which becomes the new last
//   logical slot: the shift-down pop leaves the last entry in place.
// So slot 0 of an empty queue reads what the reference's does (val on a
// row that emits nothing, xch in mark_deg mode, the fill rows).
template <int Q, int F>
struct Queue {
  int* a;
  int h, n;
  __device__ __forceinline__ int& at(int f, int s) const {
    return a[f * Q + s];
  }
  __device__ __forceinline__ int head(int f) const { return at(f, h); }
  __device__ __forceinline__ void push(bool on, int v0, int v1, int v2 = 0) {
    if (on) {
      if (n < Q) {
        int s = h + n;
        if (s >= Q) s -= Q;
        at(0, s) = v0;
        at(1, s) = v1;
        if (F > 2) at(2, s) = v2;
      }
      ++n;
    }
  }
  __device__ __forceinline__ void pop(bool on) {
    if (on) {
      int t = h - 1;
      if (t < 0) t += Q;
#pragma unroll
      for (int f = 0; f < F; ++f) at(f, h) = at(f, t);
      if (++h == Q) h = 0;
      --n;
    }
  }
};

// Dynamic shared memory: one region per lane of the block, holding the
// queues, the three window rings (outdegree, emission base, emission dirty
// flag) and the T-row ring, in that order, so every offset but the ring
// row's is a constant.
__host__ __device__ inline int smem_ints_per_lane(int window, int T) {
  return T + kQueueInts + 3 * (window + 1);
}

template <int W>
__global__ void __launch_bounds__(kLanesPerBlock) decode_emit_kernel(
    CodecParams prm, const uint2* __restrict__ lut,
    const uint16_t* __restrict__ stream, long long last_word,
    const int* __restrict__ regs,
    const long long* __restrict__ ptrs, int L, int min_interval, int cap,
    int T, int mark_deg, int* __restrict__ val, int* __restrict__ xch,
    uint32_t* __restrict__ nib, int* __restrict__ rows_used,
    uint8_t* __restrict__ ok, int* __restrict__ diag,
    int* __restrict__ fold_rows) {
  constexpr int R = W + 1;
  constexpr int DEG = NFIX, BASE = DEG + R, DIRT = BASE + R;
  constexpr int QC0 = DIRT + R, QI0 = QC0 + 2 * QC, QR0 = QI0 + 2 * QI;
  constexpr int QN0 = QR0 + 2 * QR;
  extern __shared__ int smem[];
  __shared__ CodecParams sp;
  stage_params(prm, sp);
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const size_t Ls = static_cast<size_t>(L);
  auto reg = [&](int row) { return regs[static_cast<size_t>(row) * Ls + l]; };

  // this lane's region: the queues, the window rings, the ring's T rows
  int* const lane = smem + threadIdx.x * smem_ints_per_lane(W, T);
  Queue<QC, 2> qc{lane, 0, reg(N_QC)};
  Queue<QI, 2> qi{lane + 2 * QC, 0, reg(N_QI)};
  Queue<QR, 2> qr{lane + 2 * QC + 2 * QI, 0, reg(N_QR)};
  Queue<QN, 3> qn{lane + 2 * QC + 2 * QI + 2 * QR, 0, reg(N_QN)};
  int* const deg = lane + kQueueInts;
  int* const base = deg + R;
  int* const dirt = base + R;
  int* const ring = dirt + R;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    deg[k] = reg(DEG + k);
    base[k] = reg(BASE + k);
    dirt[k] = reg(DIRT + k);
  }
#pragma unroll
  for (int k = 0; k < QC; ++k) {
    qc.at(0, k) = reg(QC0 + 2 * k);
    qc.at(1, k) = reg(QC0 + 2 * k + 1);
  }
#pragma unroll
  for (int k = 0; k < QI; ++k) {
    qi.at(0, k) = reg(QI0 + 2 * k);
    qi.at(1, k) = reg(QI0 + 2 * k + 1);
  }
#pragma unroll
  for (int k = 0; k < QR; ++k) {
    qr.at(0, k) = reg(QR0 + 2 * k);
    qr.at(1, k) = reg(QR0 + 2 * k + 1);
  }
#pragma unroll
  for (int k = 0; k < QN; ++k) {
    qn.at(0, k) = reg(QN0 + 3 * k);
    qn.at(1, k) = reg(QN0 + 3 * k + 1);
    qn.at(2, k) = reg(QN0 + 3 * k + 2);
  }

  uint32_t state = static_cast<uint32_t>(reg(D_STATE));
  long long ptr = ptrs[l];
  int left = reg(D_LEFT), phase = reg(D_PHASE);
  uint2 e = make_uint2(0u, 0u);   // the LUT row of the next token
  if (phase < P_DONE) e = lut_row(sp, lut, phase, state);
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

  uint32_t cpk = 0xFFFFFFFFu;
  const int tmask = T - 1;
  int row = 0, folded = 0;
  for (; row < cap; ++row) {
    const int p = phase;
    const bool active = p != P_DONE;
    // done at step start: the lane is frozen from here on
    if (!active && e_active == 0 && qn.n == 0) break;

    // ---------------- decode stall / early meta ----------------
    const bool meta_unsent = metasent == 0;
    const bool qfull_c = (p == P_BC || p == P_BLK) && qc.n > QC - 2;
    const bool qfull_i = p == P_IL && qi.n > QI - 1;
    const bool qfull_r = (p == P_FR || p == P_RES) && qr.n > QR - 1;
    const bool meta_phase = p == P_OUT || p == P_BC || p == P_BLK ||
                            p == P_IL || p == P_FR;
    const bool qfull_n = meta_phase && meta_unsent && qn.n > QN - 1;
    const bool stall = active && (qfull_c || qfull_i || qfull_r || qfull_n);
    // early dirty meta only on true self-deadlock (emission idle)
    const bool early = active && meta_unsent && (qfull_c || qfull_i) &&
                       e_active == 0 && qn.n == 0;
    const int tagd = x & 0xFF;
    qn.push(early, g.d, (refreg << 10) | (1 << 9) | tagd, 0);
    if (early) metasent = 1;
    // set by each event that moves a queue or the decode side (run folding)
    int moved = early ? 1 : 0;

    // ---------------- rANS step + grammar FSM ----------------
    if (active && !stall) {
      moved = 1;
      const int c = p;
      const int v = static_cast<int>(
          ans_step(sp, e, stream, last_word, c, state, ptr));
      const int bsum_pre = g.bsum;
      EmitRing<R> dring{deg, xmod};
      const GrammarStep r = grammar_step(g, c, v, dring, W, min_interval);
      int nxt = r.nxt;
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
          qc.push(v == 0 && g.refd > 0, 0, g.refd | (tagd << 20));
          break;
        case P_BLK:
          qc.push(r.blk_copy && r.b > 0, bsum_pre, r.b | (tagd << 20));
          qc.push(r.blocks_done && r.tail_len > 0, g.bsum,
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
          qi.push(ilen > 0, ivl - ilen, ilen | (tagd << 20));
          break;
        }
        default: {   // P_FR, P_RES
          const int resval = c == P_FR ? x + n2i : prevres + v + 1;
          prevres = resval;
          qr.push(true, resval, tagd);
          break;
        }
      }
      const bool node_done = nxt == kNodeDone;
      // meta: first residual, or node end without residuals
      const bool push_meta = (c == P_FR || node_done) && metasent == 0;
      qn.push(push_meta, g.d, (refreg << 10) | tagd, g.copied);
      if (push_meta) metasent = 1;
      if (node_done) {
        metasent = 0;
        --left;
        ++x;
        if (++xmod >= R) xmod = 0;
        nxt = left <= 0 ? P_DONE : P_OUT;
      }
      if (nxt != kKeep) phase = nxt;
      // the next token's LUT row loads while the emission substep runs
      if (phase != P_DONE) e = lut_row(sp, lut, phase, state);
    }

    // =================== emission substep ===================
    const bool em_active = e_active != 0;
    const int ex = e_x, exmod = e_xmod;
    const int tagx = ex & 0xFF;

    // ---- pop the next node meta ----
    const bool can_pop = !em_active && qn.n > 0;
    const int md = qn.head(0);   // xch of every row in mark_deg mode
    bool dirty = false, empty = false;
    int dcause = 0;
    if (can_pop) {
      moved = 1;
      const int mp = qn.head(1), mncop = qn.head(2);
      const int mref = mp >> 10;
      const int mdirty0 = (mp >> 9) & 1;
      const bool hasref = mref > 0;
      const int psel = ring_slot<R>(exmod, W > 0 ? mref % R : 0);
      const int pbase = base[psel];
      const int ptaint = dirt[psel];
      const bool crossl = hasref && ex - mref < e_lstart;
      const bool qc_match_pop = qc.n > 0 && (qc.head(1) >> 20) == tagx;
      const int firstsrc = pbase + qc.head(0);
      // ring-overflow bound (emit_pallas.py:354-358)
      const bool tover = hasref && qc_match_pop &&
                         (row + md - mncop - firstsrc) > (T - kUnroll);
      dirty = mdirty0 != 0 || (hasref && (ptaint != 0 || crossl)) || tover;
      dcause = mdirty0 != 0 ? C_REFINFO
               : (hasref && crossl) ? 7
               : (hasref && ptaint != 0) ? 8 : 9;
      empty = md == 0;
      qn.pop(true);
      base[exmod] = row + (dirty ? 1 : 0);
      dirt[exmod] = dirty ? 1 : 0;
      e_d = md;
      e_ref = mref;
      e_dirty = dirty ? 1 : 0;
      e_emitted = 0;
      e_first = 1;
      e_pbase = pbase;
      cc_left = 0;
      ci_left = 0;
    }
    const bool popped_dirty = can_pop && !empty && dirty;
    const bool popped_empty = can_pop && empty;
    const bool em_active2 = (can_pop && !empty) || em_active;
    int ex2 = ex, exmod2 = exmod;
    if (popped_empty) {
      ++ex2;
      if (++exmod2 >= R) exmod2 = 0;
    }

    // ---- run activation (not on the refinfo / empty step) ----
    const bool emit_now = em_active2 && !popped_dirty && !popped_empty;
    const bool act_c = emit_now && cc_left == 0 && qc.n > 0 &&
                       (qc.head(1) >> 20) == tagx;
    if (act_c) {
      moved = 1;
      cc_j = qc.head(0);
      cc_left = qc.head(1) & 0xFFFFF;
      cc_src = e_pbase + cc_j;
    }
    qc.pop(act_c);
    const bool act_i = emit_now && ci_left == 0 && qi.n > 0 &&
                       (qi.head(1) >> 20) == tagx;
    if (act_i) {
      moved = 1;
      ci_val = qi.head(0);
      ci_left = qi.head(1) & 0xFFFFF;
    }
    qi.pop(act_i);

    // ---- group-done signals (decode position checks) ----
    const bool dec_past = x > ex2;
    const bool dec_past_blk = dec_past || (x == ex2 && phase >= P_IC);
    const bool dec_past_iv = dec_past || (x == ex2 && phase >= P_FR);
    const bool qc_match2 = qc.n > 0 && (qc.head(1) >> 20) == tagx;
    const bool qi_match2 = qi.n > 0 && (qi.head(1) >> 20) == tagx;
    const bool cop_av = cc_left > 0;
    const bool cop_done = !cop_av && !qc_match2 && dec_past_blk;
    const bool iv_av = ci_left > 0;
    const bool iv_done = !iv_av && !qi_match2 && dec_past_iv;
    const bool res_av = qr.n > 0 && qr.head(1) == tagx;
    const bool res_done = !res_av && dec_past;

    // ---- heads and merge ----
    const int hc = ring[cc_src & tmask];
    const int hi = ci_val;
    const int hr = qr.head(0);
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
    qr.pop(emit_r);

    e_emitted += emitted ? 1 : 0;
    const bool node_fin = em_active2 && e_emitted >= e_d && emitted;
    int ex3 = ex2, exmod3 = exmod2;
    if (node_fin) {
      ++ex3;
      if (++exmod3 >= R) exmod3 = 0;
    }
    const bool em_active3 = em_active2 && !node_fin;

    // ---- output row ----
    const bool lane_done = phase == P_DONE && !em_active3 && qn.n == 0;
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

    // row r's val, xch, ring slot and code nibble (the packed word at
    // every 8th row)
    auto put = [&](int r, int v, int c) {
      val[static_cast<size_t>(r) * Ls + l] = v;
      xch[static_cast<size_t>(r) * Ls + l] = out_x;
      ring[r & tmask] = v;
      const int shift = 4 * (r & 7);
      cpk = (cpk & ~(0xFu << shift)) | (static_cast<uint32_t>(c) << shift);
      if ((r & 7) == 7) {
        nib[static_cast<size_t>(r >> 3) * Ls + l] = cpk;
        cpk = 0xFFFFFFFFu;
      }
    };
    put(row, out_v, code);

    // ---- run folding ----
    // A row that emitted from a copy or interval run while the decode side
    // did nothing (stalled or finished) and no queue moved (no early meta,
    // no meta pop, no run activation) leaves every input of the next step
    // as it found it but the run's own registers: stall and phase, the four
    // queue counts and heads, metasent and x, md (xch in mark_deg mode), ex
    // and halo, the group-done signals; e_first is 0 after an emitted row.
    // The next row then runs the same merge over the same residual head
    // (and, for a copy run, the same interval head), so it either takes the
    // run again, with nothing else to do but write the row, or differs.
    // The loops below write those rows with the run's update alone, one at
    // a time, and stop before the first row at which the full step could
    // do anything else: the run spent (the next row activates a run), the
    // node finished (that row is still written, with node_fin's update),
    // the cap, or, for a clean node, the merge choosing another head. The
    // copy source is read from the ring row by row before the row is
    // written, in the full step's order, so a source row the fold itself
    // wrote reads as it would have. Every channel stays bit for bit what
    // one full step a row writes (emit_torch.decode_emit_plain, which
    // counts the same rows). One flag, `moved`, stands for every event that
    // rules a fold out (the decode step, an early meta, a meta pop, a run
    // activation): keeping the five predicates alive to the row's end
    // instead slowed every step by ~5% on an H100 (PERF.md).
    const bool quiet = moved == 0 && em_active3;
    if (quiet && (emit_c || emit_i)) {
      const int fcode = (emit_c && !clean) ? C_PLACE : C_EL;
      int r1 = row + 1;
      bool fin = false;
      if (emit_c) {
        for (; cc_left > 0 && r1 < cap; ++r1) {
          const int v = clean ? ring[cc_src & tmask] : cc_j;
          if (clean && (v > hi_k || v > hr_k)) break;
          ++cc_j;
          ++cc_src;
          --cc_left;
          put(r1, v, fcode);
          if (++e_emitted >= e_d) {
            fin = true;
            ++r1;
            break;
          }
        }
      } else {
        for (; ci_left > 0 && r1 < cap; ++r1) {
          const int v = ci_val;
          if (clean) {
            if (v > hr_k) break;
            if (cop_av) {   // a copy run waits: its head may take the row
              const int hcv = ring[cc_src & tmask];
              if (hcv <= v && hcv <= hr_k) break;
            }
          }
          ++ci_val;
          --ci_left;
          put(r1, v, fcode);
          if (++e_emitted >= e_d) {
            fin = true;
            ++r1;
            break;
          }
        }
      }
      folded += r1 - row - 1;
      row = r1 - 1;
      e_donerow = r1;
      if (fin) {
        e_active = 0;
        ++e_x;
        if (++e_xmod >= R) e_xmod = 0;
      }
    }
  }
  // a finished lane is frozen: every later row repeats its stale
  // residual-queue head (val), its meta head or node (xch) and code 0xF
  const int fill_v = qr.head(0);
  const int fill_x = mark_deg ? qn.head(0) : e_x;
  for (int r = row; r < cap; ++r) {
    val[static_cast<size_t>(r) * Ls + l] = fill_v;
    xch[static_cast<size_t>(r) * Ls + l] = fill_x;
    cpk |= 0xFu << (4 * (r & 7));
    if ((r & 7) == 7) {
      nib[static_cast<size_t>(r >> 3) * Ls + l] = cpk;
      cpk = 0xFFFFFFFFu;
    }
  }
  const bool done = phase == P_DONE && e_active == 0 && qn.n == 0;
  rows_used[l] = e_donerow;
  ok[l] = done ? 1 : 0;
  diag[0 * Ls + l] = e_markrow;
  diag[1 * Ls + l] = e_mdirty;
  diag[2 * Ls + l] = x;
  diag[3 * Ls + l] = e_x;
  diag[4 * Ls + l] = e_active * 1000000 + e_emitted;
  diag[5 * Ls + l] = qn.n * 1000 + qc.n * 100 + qi.n * 10 + qr.n;
  fold_rows[l] = folded;
}

// Lanes per block for a ring of T rows: kLanesPerBlock, halved until the
// block's dynamic shared memory fits the card's per-block limit (the
// static CodecParams beside it). 0 when not even one lane fits.
int lanes_per_block(int window, int T, long long* smem_bytes) {
  static int optin = 0;   // queried once: no query inside a graph capture
  if (optin == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
  }
  const long long avail =
      static_cast<long long>(optin) - static_cast<long long>(sizeof(CodecParams));
  const long long per_lane = smem_ints_per_lane(window, T) * 4LL;
  for (int lanes = kLanesPerBlock; lanes >= 1; lanes /= 2) {
    if (lanes * per_lane <= avail) {
      *smem_bytes = lanes * per_lane;
      return lanes;
    }
  }
  *smem_bytes = per_lane;
  return 0;
}

template <int W>
int launch(const CodecParams& prm, const void* lut, const void* stream,
           long long stream_len, const void* regs, const void* ptrs, int L,
           int min_interval, int cap, int T, int mark_deg, void* val,
           void* xch, void* nib, void* rows, void* ok, void* diag,
           void* fold, int lanes, long long smem, cudaStream_t s) {
  // the opt-in above 48 KB, once per instance and size (never inside a
  // CUDA-graph capture that follows a launch of the same shape)
  static long long granted = 0;
  if (smem > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_emit_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    granted = smem;
  }
  decode_emit_kernel<W><<<(L + lanes - 1) / lanes, lanes,
                          static_cast<size_t>(smem), s>>>(
      prm, static_cast<const uint2*>(lut),
      static_cast<const uint16_t*>(stream), stream_len - 1,
      static_cast<const int*>(regs),
      static_cast<const long long*>(ptrs), L, min_interval, cap, T, mark_deg,
      static_cast<int*>(val), static_cast<int*>(xch),
      static_cast<uint32_t*>(nib), static_cast<int*>(rows),
      static_cast<uint8_t*>(ok), static_cast<int*>(diag),
      static_cast<int*>(fold));
  return static_cast<int>(cudaGetLastError());
}

using LaunchFn = int (*)(const CodecParams&, const void*, const void*,
                         long long, const void*, const void*, int, int, int,
                         int, int, void*, void*, void*, void*, void*, void*,
                         void*, int, long long, cudaStream_t);

template <int... Ws>
struct Table {
  static constexpr LaunchFn fns[sizeof...(Ws)] = {&launch<Ws>...};
};

}  // namespace

// The launch shape for a window and ring depth: lanes per block and the
// dynamic shared memory of each block. Returns 0, or cudaErrorInvalidValue
// when the arguments are out of range or not even one lane's ring fits.
extern "C" int wgt_decode_emit_geometry(int window, int T, int* lanes,
                                        long long* smem_bytes) {
  if (window < 0 || window > kMaxWindow || T < 8 || (T & (T - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  *lanes = lanes_per_block(window, T, smem_bytes);
  return *lanes > 0 ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// regs: [nreg, L] int32 register file (emit_torch.emit_init_regs), ptrs:
// [L] int64 absolute entry pointers. Every row of val, xch, nib is
// written; fold: [L] int32, the rows each lane wrote by run folding.
// Returns cudaGetLastError() after the launch, or the error of the
// shared-memory opt-in, or cudaErrorInvalidValue when no block of even one
// lane fits the ring.
extern "C" int wgt_decode_emit(
    const long long* params, const void* lut, const void* stream,
    long long stream_len, const void* regs, const void* ptrs, int L,
    int window, int min_interval, int cap, int T, int mark_deg, void* val,
    void* xch, void* nib, void* rows, void* ok, void* diag, void* fold,
    void* cuda_stream) {
  if (window < 0 || window > kMaxWindow || cap % kUnroll != 0 || T < 8 ||
      (T & (T - 1)) != 0 || stream_len < 1 || params[45] < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const CodecParams prm = codec_params(params);
  long long smem = 0;
  const int lanes = lanes_per_block(window, T, &smem);
  if (lanes == 0) return static_cast<int>(cudaErrorInvalidValue);
  using Fns = Table<0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
                    16>;
  if (L > 0)
    return Fns::fns[window](prm, lut, stream, stream_len, regs, ptrs, L,
                            min_interval, cap, T, mark_deg, val, xch, nib,
                            rows, ok, diag, fold, lanes, smem,
                            static_cast<cudaStream_t>(cuda_stream));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wgt_emit_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
