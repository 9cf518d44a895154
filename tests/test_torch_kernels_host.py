"""The kernels' CUDA sources, built for the host, against their plain
PyTorch versions.

csrc/decode_blocks.cu, csrc/decode_emit.cu and csrc/encode_blocks.cu are
compiled with g++ against a stub cuda_runtime.h that runs one thread at a
time: each block's threads run one after another, shared memory is a host
buffer and __ldg a plain load (neither decode kernel synchronises its
threads after the parameters are staged; the encode kernels share nothing
between threads, and their cp.async record ring copies at once on the
host). Every output channel must equal the plain version's bit for bit
(tolerance 0) on small artifacts that cover the grammar variants, every
dirty row code of the merged emit, both mark_deg modes, and block sizes
that do and do not divide the lane count; the encode kernels on models
with max_folds 0, 1 and 7, a fold-threshold exponent past 31, a frame-1
component, a real graph's model, lanes shorter than cap and a cap shorter
than a lane, built with several lanes a block and ring depths. The card's
compiler is not the host's (ROADMAP §3 records an nvcc miscompile that a
host build did not show), so chip_smoke.py still holds the built kernels
against the plain versions on the card.
"""

import ctypes
import dataclasses
import os
import re
import subprocess

import numpy as np
import pytest
import torch

from webgraph_ans_torch.ans.model import ANSModel, ComponentModel, fold_one
from webgraph_ans_torch.bvgraph.graph import Adjacency
from webgraph_ans_torch.bvgraph.random_access import ANSBvGraph
from webgraph_ans_torch.bvgraph.store import compress_adjacency, dump_tokens
from webgraph_ans_torch.bvgraph.synth import synth_web_graph
from webgraph_ans_torch.ops import cuda_build
from webgraph_ans_torch.ops.decode_torch import decode_blocks_plain
from webgraph_ans_torch.ops.encode_torch import (_emit_pairs,
                                                 encode_blocks_plain,
                                                 encode_plan)
from webgraph_ans_torch.ops.emit_torch import decode_emit_plain
from webgraph_ans_torch.ops.graph_decode import TorchGraphDecoder

STUB = r"""
#pragma once
#include <cstddef>
#include <cstdint>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static
#define __restrict__
#define __align__(n) __attribute__((aligned(n)))
struct uint2 { uint32_t x, y; };
struct uint4 { uint32_t x, y, z, w; };
struct Dim { unsigned x = 0, y = 0, z = 0; };
inline Dim threadIdx, blockIdx, blockDim;
inline void __syncthreads() {}
template <class T> inline T __ldg(const T* p) { return *p; }
inline uint2 make_uint2(uint32_t x, uint32_t y) { return {x, y}; }
inline uint4 make_uint4(uint32_t x, uint32_t y, uint32_t z, uint32_t w) {
  return {x, y, z, w};
}
inline uint32_t min(uint32_t a, uint32_t b) { return a < b ? a : b; }
inline int __clz(uint32_t x) { return x ? __builtin_clz(x) : 32; }
inline uint32_t __umulhi(uint32_t a, uint32_t b) {
  return static_cast<uint32_t>((static_cast<uint64_t>(a) * b) >> 32);
}
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
"""

# the host drivers replace each source's launch code (from the marker on)
EMIT_DRIVER = r"""
}  // namespace
template <int W>
static void run_w(const long long* params, const void* lut,
                  const void* stream, long long stream_len,
                  const int* regs, const long long* ptrs,
                  int L, int mi, int cap, int T, int mark_deg, int* val,
                  int* xch, uint32_t* nib, int* rows, uint8_t* ok, int* diag,
                  int lanes) {
  const CodecParams prm = codec_params(params);
  std::vector<int> buf(smem_ints_per_lane(W, T) * lanes, 0x5a5a5a5a);
  g_smem = buf.data();
  blockDim.x = lanes;
  for (int b = 0; b < (L + lanes - 1) / lanes; ++b)
    for (int t = 0; t < lanes; ++t) {
      blockIdx.x = b;
      threadIdx.x = t;
      decode_emit_kernel<W>(prm, static_cast<const uint2*>(lut),
          static_cast<const uint16_t*>(stream), stream_len - 1,
          regs, ptrs, L, mi, cap, T, mark_deg, val, xch, nib, rows, ok,
          diag);
    }
}
extern "C" int run_emit(int window, const long long* params, const void* lut,
                        const void* stream, long long stream_len,
                        const int* regs,
                        const long long* ptrs, int L, int mi, int cap, int T,
                        int mark_deg, int* val, int* xch, uint32_t* nib,
                        int* rows, uint8_t* ok, int* diag, int lanes) {
  auto fn = window == 0 ? run_w<0> : window == 7 ? run_w<7>
            : window == 16 ? run_w<16> : nullptr;
  if (!fn) return 1;
  fn(params, lut, stream, stream_len, regs, ptrs, L, mi, cap, T,
     mark_deg, val, xch, nib, rows, ok, diag, lanes);
  return 0;
}
"""

BLOCKS_DRIVER = r"""
extern "C" void run_blocks(const long long* params, const void* lut,
                           const void* stream, long long stream_len,
                           const void* states,
                           const void* ptrs, const void* starts,
                           const void* ends, const void* ring_seed, int L,
                           int window, int mi, int cap, int emit_aux,
                           void* out, void* counts, void* ok) {
  const CodecParams prm = codec_params(params);
  blockDim.x = kThreads;
  auto kernel = emit_aux ? decode_blocks_kernel<true>
                         : decode_blocks_kernel<false>;
  for (int b = 0; b < (L + kThreads - 1) / kThreads; ++b)
    for (int t = 0; t < kThreads; ++t) {
      blockIdx.x = b;
      threadIdx.x = t;
      kernel(prm, static_cast<const uint2*>(lut),
             static_cast<const uint16_t*>(stream), stream_len - 1,
             static_cast<const long long*>(states),
             static_cast<const long long*>(ptrs),
             static_cast<const int*>(starts), static_cast<const int*>(ends),
             static_cast<const int*>(ring_seed), L, window, mi, cap,
             static_cast<uint32_t*>(out), static_cast<int*>(counts),
             static_cast<uint8_t*>(ok));
    }
}
"""


def _host_source(name: str, marker: str, driver: str) -> str:
    src = open(os.path.join(cuda_build.CSRC_DIR, name)).read()
    assert src.count(marker) == 1, f"{name}: launch-code marker moved"
    body = src[:src.index(marker)].rstrip()
    if name == "decode_emit.cu":
        dyn = "extern __shared__ int smem[];"
        assert body.count(dyn) == 1
        body = body.replace(dyn, "int* smem = g_smem;")
        body = body.replace("namespace {", "int* g_smem;\nnamespace {", 1)
    return "#include <vector>\n" + body + "\n" + driver


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """Both kernels built for the host with g++ (-O2), loaded by ctypes."""
    d = tmp_path_factory.mktemp("host_kernels")
    (d / "cuda_runtime.h").write_text(STUB)
    libs = {}
    for name, marker, driver in (
            ("decode_emit.cu", "// Lanes per block for a ring", EMIT_DRIVER),
            ("decode_blocks.cu", "// out must arrive with value",
             BLOCKS_DRIVER)):
        cpp = d / name.replace(".cu", ".cpp")
        cpp.write_text(_host_source(name, marker, driver))
        so = d / name.replace(".cu", ".so")
        subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                        "-I", str(d), "-I", cuda_build.CSRC_DIR, "-o",
                        str(so), str(cpp)], check=True, capture_output=True)
        libs[name] = ctypes.CDLL(str(so))
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs["decode_emit.cu"].run_emit.argtypes = (
        [ci, ctypes.POINTER(cl), vp, vp, cl, vp, vp] + [ci] * 5
        + [vp] * 6 + [ci])
    libs["decode_blocks.cu"].run_blocks.argtypes = (
        [ctypes.POINTER(cl), vp, vp, cl] + [vp] * 5 + [ci] * 5 + [vp] * 3)
    return libs


def _sampled(res, step: int):
    prelude, states, pointers = res.prelude, res.states, res.pointers
    if step > 1:
        prelude = dataclasses.replace(prelude, phase_step=step)
        n = prelude.num_nodes
        rev_idx = (n - 1 - np.arange(0, n, step))[::-1]
        states = np.ascontiguousarray(states[rev_idx])
        pointers = np.ascontiguousarray(pointers[rev_idx])
    return ANSBvGraph(prelude, states, pointers)


# (name, window, max_ref_count, min_interval_length, phase_step)
CONFIGS = [("w7_r3_i2", 7, 3, 2, 1), ("w0_no_refs", 0, 0, 2, 1),
           ("no_intervals", 7, 3, 0, 1),
           ("w16_deep_refs", 16, 2_000_000_000, 4, 1),
           ("phase_step4", 7, 3, 2, 4)]
LANES = 24


def _decoder(adj, cfg):
    _, w, r, mi, step = cfg
    res = compress_adjacency(adj, w, r, mi)
    return TorchGraphDecoder(_sampled(res, step), device="cpu")


@pytest.fixture(scope="module")
def small_adj():
    rng = np.random.default_rng(2026)
    return Adjacency.from_lists(
        [sorted(rng.choice(600, size=int(rng.integers(0, 24)),
                           replace=False).tolist()) for _ in range(600)])


@pytest.mark.parametrize("aux", [False, True], ids=["token", "aux"])
@pytest.mark.parametrize("cfg", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_decode_blocks_host_build_matches_plain(host_libs, small_adj, cfg,
                                                aux):
    dec = _decoder(small_adj, cfg)
    _, _, cap = dec.decode_raw(LANES, emit_aux=aux)
    pl = dec.plan(LANES)
    t = dec.tables
    L = LANES
    want = decode_blocks_plain(t, pl["states"], pl["ptrs"], pl["starts"],
                               pl["ends"], pl["ring"], dec.window,
                               dec.min_interval, cap, emit_aux=aux)
    assert bool(want[2].all())
    vrows = 3 * cap if aux else cap
    out = torch.zeros((vrows + cap // 8, L), dtype=torch.int32)
    out[vrows:] = -1
    counts = torch.empty(L, dtype=torch.int32)
    ok = torch.empty(L, dtype=torch.bool)
    host_libs["decode_blocks.cu"].run_blocks(
        cuda_build.codec_params(t.params), t.lut.data_ptr(),
        t.stream.data_ptr(), t.stream.shape[0], pl["states"].data_ptr(),
        pl["ptrs"].data_ptr(), pl["starts"].data_ptr(), pl["ends"].data_ptr(),
        pl["ring"].data_ptr(), L, dec.window, dec.min_interval, cap, int(aux),
        out.data_ptr(), counts.data_ptr(), ok.data_ptr())
    for got, exp in zip((out, counts, ok), want):
        assert torch.equal(got, exp)


def _emit_host(lib, dec, pl, cap, T, mark_deg, lanes):
    regs, ptrs = pl["regs"], pl["ptrs"]
    L = regs.shape[1]
    i32 = torch.int32
    val, xch = torch.empty((cap, L), dtype=i32), torch.empty((cap, L),
                                                              dtype=i32)
    nib = torch.empty((cap // 8, L), dtype=i32)
    rows, ok = torch.empty(L, dtype=i32), torch.empty(L, dtype=torch.bool)
    diag = torch.empty((6, L), dtype=i32)
    t = dec.tables
    assert lib.run_emit(dec.window, cuda_build.codec_params(t.params),
                        t.lut.data_ptr(), t.stream.data_ptr(),
                        t.stream.shape[0], regs.data_ptr(),
                        ptrs.data_ptr(), L, dec.min_interval, cap, T,
                        int(mark_deg), val.data_ptr(), xch.data_ptr(),
                        nib.data_ptr(), rows.data_ptr(), ok.data_ptr(),
                        diag.data_ptr(), lanes) == 0
    return val, xch, nib, rows, ok, diag


def _codes(nib):
    words = nib.long() & 0xFFFFFFFF
    shifts = torch.arange(8) * 4
    return set(((words[:, None, :] >> shifts[None, :, None]) & 0xF)
               .reshape(-1).tolist())


@pytest.fixture(scope="module")
def emit_adj():
    lists = synth_web_graph(500, seed=4).to_lists()
    # 20 interval runs and no reference: the interval queue overflows
    # before the node's meta is sent (row code 3)
    lists[250] = [v for k in range(20) for v in (3 * k, 3 * k + 1)]
    return Adjacency.from_lists(lists)


# (config, ring depth T or None for the plan's, mark_deg): a 32-row ring
# puts copy sources out of reach (codes 8 and 9); the phase-sampled
# artifact has no halo (cross-lane parents: code 7)
EMIT_CASES = [(CONFIGS[0], 32, False), (CONFIGS[0], 8, True),
              (CONFIGS[0], None, True), (CONFIGS[1], None, False),
              (CONFIGS[2], None, True), (CONFIGS[3], None, True),
              (CONFIGS[4], None, False), (CONFIGS[4], None, True)]


def _case_id(case):
    cfg, T, mark_deg = case
    return f"{cfg[0]}-T{T}-md{int(mark_deg)}"


@pytest.fixture(scope="module")
def emit_runs(emit_adj):
    """The plain version's outputs for each case, at a cap every lane
    finishes within, with the decoder and plan that produced them."""
    runs = {}
    for case in EMIT_CASES:
        cfg, T, mark_deg = case
        dec = _decoder(emit_adj, cfg)
        pl = dec._emit_plan(LANES)
        T = T or pl["T"]
        cap = pl["cap"]
        while True:
            want = decode_emit_plain(dec.tables, pl["regs"], pl["ptrs"],
                                     dec.window, dec.min_interval, cap, T,
                                     mark_deg)
            if bool(want[4].all()):
                break
            cap *= 2
        runs[_case_id(case)] = dec, pl, cap, T, want
    return runs


@pytest.mark.parametrize("case", EMIT_CASES, ids=_case_id)
def test_decode_emit_host_build_matches_plain(host_libs, emit_runs, case):
    mark_deg = case[2]
    dec, pl, cap, T, want = emit_runs[_case_id(case)]
    lib = host_libs["decode_emit.cu"]
    for lanes in (32, 5, 2, 1):
        got = _emit_host(lib, dec, pl, cap, T, mark_deg, lanes)
        for ch, (g, w) in enumerate(zip(got, want)):
            assert torch.equal(g, w), (lanes, ch)


def test_emit_cases_hit_every_dirty_code(emit_runs):
    """Together the cases write rows of every dirty cause."""
    seen = set()
    for *_, want in emit_runs.values():
        seen |= _codes(want[2])
    assert {3, 7, 8, 9} <= seen


ENCODE_HOST_RUN = r"""
extern "C" int run_encode(const long long* params, const void* tab,
                          long long entries, const void* tokens, long long T,
                          void* rec4, void* recp, const void* tstart,
                          const void* tend, int L, int cap, int EP,
                          void* emit, void* states, void* final_states,
                          void* wtotals, void* ok) {
  EncodeParams prm;
  if (!encode_params(params, &prm)) return 1;
  const long long pairs16 = static_cast<long long>(cap) * EP * L / 4;
  const long long work = T > pairs16 ? T : pairs16;
  blockDim.x = kRecordThreads;
  for (long long b = 0; b < (work + kRecordThreads - 1) / kRecordThreads;
       ++b)
    for (int t = 0; t < kRecordThreads; ++t) {
      blockIdx.x = static_cast<unsigned>(b);
      threadIdx.x = t;
      encode_records_kernel(prm, static_cast<const uint4*>(tab),
                            static_cast<uint32_t>(entries),
                            static_cast<const uint2*>(tokens), T,
                            static_cast<uint4*>(rec4),
                            static_cast<uint32_t*>(recp),
                            static_cast<uint4*>(emit), pairs16);
    }
  blockDim.x = kLanesPerBlock;
  for (int b = 0; b < (L + kLanesPerBlock - 1) / kLanesPerBlock; ++b)
    for (int t = 0; t < kLanesPerBlock; ++t) {
      blockIdx.x = b;
      threadIdx.x = t;
      encode_lanes_kernel(static_cast<const uint4*>(rec4),
                          static_cast<const uint32_t*>(recp),
                          static_cast<const int*>(tstart),
                          static_cast<const int*>(tend), L, cap, EP,
                          static_cast<uint32_t*>(emit),
                          static_cast<uint32_t*>(states),
                          static_cast<uint32_t*>(final_states),
                          static_cast<uint32_t*>(wtotals),
                          static_cast<uint8_t*>(ok));
    }
  return 0;
}
"""

# the source as it ships, and with lanes a block and ring depths that
# leave partial blocks and wrap the ring every other step
ENCODE_VARIANTS = {"shipped": {},
                   "lanes4_depth2": {"kLanesPerBlock": 4, "kDepth": 2},
                   "lanes32_depth2": {"kLanesPerBlock": 32, "kDepth": 2}}


@pytest.fixture(scope="module")
def encode_libs(tmp_path_factory):
    """csrc/encode_blocks.cu built for the host once per variant."""
    d = tmp_path_factory.mktemp("host_encode")
    (d / "cuda_runtime.h").write_text(STUB)
    base = _host_source("encode_blocks.cu", "// Host launch code.",
                        ENCODE_HOST_RUN)
    libs = {}
    for name, consts in ENCODE_VARIANTS.items():
        src = base
        for key, value in consts.items():
            src, n = re.subn(rf"(constexpr int {key} = )[^;]+;",
                             rf"\g<1>{value};", src)
            assert n == 1, key
        cpp, so = d / f"encode_{name}.cpp", d / f"encode_{name}.so"
        cpp.write_text(src)
        subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                        "-I", str(d), "-o", str(so), str(cpp)], check=True,
                       capture_output=True)
        lib = ctypes.CDLL(str(so))
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.run_encode.argtypes = ([ctypes.POINTER(cl), vp, cl, vp, cl, vp,
                                    vp, vp, vp] + [ci] * 3 + [vp] * 5)
        lib.run_encode.restype = ci
        libs[name] = lib
    return libs


def _component(n, log_m, radix, fid):
    """n folded symbols whose frequencies fill the frame 2^log_m, or the
    frequencies n when n is a list."""
    if isinstance(n, list):
        return ComponentModel(np.array(n, np.uint16), log_m, radix, fid)
    if n == 0:
        return ComponentModel(np.zeros(0, np.uint16), 0, radix, fid)
    freqs = np.full(n, (1 << log_m) // n, np.int64)
    freqs[:(1 << log_m) - int(freqs.sum())] += 1
    return ComponentModel(freqs.astype(np.uint16), log_m, radix, fid)


def _values(rng, comp, k, wild=False):
    """k raw values of this component: every bit length up to 31, kept
    where the folded symbol is in the table unless wild (then the fold
    count passes max_folds and the table index is clipped, as both
    versions define it for values no model was built from)."""
    thr = comp.folding_threshold
    out = []
    while len(out) < k:
        bl = int(rng.integers(0, 32))
        v = int(rng.integers(1 << bl >> 1, 1 << bl)) if bl else 0
        f = v if v < thr else fold_one(v, comp.radix, comp.fidelity)
        if wild or f < len(comp.freqs):
            out.append(v)
    return out


def _synth_tokens(model, nodes, seed, wild=0.0):
    """A node start (component 0) then 0-6 tokens of the other components
    that have symbols, per node; a `wild` share of those unfiltered."""
    rng = np.random.default_rng(seed)
    others = [c for c in range(1, 9) if len(model.components[c].freqs)]
    vals, comps = [], []
    for _ in range(nodes):
        vals += _values(rng, model.components[0], 1)
        comps.append(0)
        for c in rng.choice(others, size=int(rng.integers(0, 7))):
            vals += _values(rng, model.components[int(c)], 1,
                            wild=rng.random() < wild)
            comps.append(int(c))
    return np.array(vals, np.uint64), np.array(comps, np.uint8)


# component specs (n, log_m, radix, fidelity); unlisted components empty
_BASE = (8, 5, 2, 2)   # n = threshold: never folds
ENCODE_MODELS = {
    "mf0": {0: _BASE, 1: (6, 4, 2, 2), 5: (8, 3, 2, 2), 8: (8, 8, 2, 2)},
    # one fold level: n = threshold + offset; with wild values
    "mf1": {0: _BASE, 5: (14, 6, 2, 2), 8: (8, 16, 2, 2)},
    # radix 6, fidelity 1 folds up to 7 times in the table, but the
    # threshold exponent of fold 6 is 36 (never reached by a u31 value);
    # component 4 has one symbol in a frame of 1 (never renormalises);
    # component 8's frame of 2^16 renormalises on most tokens
    "mf7_wide_exp_frame1": {0: _BASE, 3: (443, 12, 6, 1), 4: (1, 0, 2, 2),
                            7: (244, 10, 4, 3), 8: (101, 16, 3, 2)},
    # a symbol that fills 7/8 of its frame: the reciprocal overestimates
    # the quotient for states just below the renorm bound, so the
    # division's downward correction runs; the other symbol has frequency
    # 1 (the upward correction)
    "dominant": {0: _BASE, 2: ([7, 1], 3, 2, 2)},
}
ENCODE_NODES = {"dominant": 3000}   # node count, 160 unless named


def _model(spec):
    return ANSModel([_component(*spec.get(c, (0, 0, 2, 2)))
                     for c in range(9)])


@pytest.fixture(scope="module")
def encode_inputs(small_adj):
    """(model, values, components) per case: the synthetic models, and a
    real 600-node graph's model and tokens under the port's store."""
    out = {}
    for i, (name, spec) in enumerate(ENCODE_MODELS.items()):
        model = _model(spec)
        out[name] = (model, *_synth_tokens(
            model, ENCODE_NODES.get(name, 160), 40 + i,
            wild=0.2 if name == "mf1" else 0))
    res = compress_adjacency(small_adj, 7, 3, 2)
    out["graph600"] = (res.prelude.model,
                       *dump_tokens(small_adj, 7, 3, 2, res.est_tables))
    return out


def test_encode_models_cover_the_edge_cases(encode_inputs):
    """The synthetic models fold 0, 1 and 7 times at most, one has a fold
    threshold exponent >= 32 and one a frame-1 component."""
    mf = {name: encode_plan(*inp, 1, device="cpu").params[9]
          for name, inp in encode_inputs.items()}
    assert mf["mf0"] == 0 and mf["mf1"] == 1
    assert mf["mf7_wide_exp_frame1"] == 7
    plan = encode_plan(*encode_inputs["mf7_wide_exp_frame1"], 1,
                       device="cpu")
    assert any(p[3] + 7 * p[2] - 1 >= 32 for p in plan.params[:9])
    assert any(p[1] == 0 for p in plan.params[:9])   # log_m 0: frame 1
    for name, (model, vals, comps) in encode_inputs.items():
        used = set(np.unique(comps).tolist())
        assert used - {0}, name


# (case, lanes asked of encode_plan, cap cut by 8 rows: the longest lane
# does not finish and reports ok False)
ENCODE_CASES = [(name, nb, short) for name in
                ("mf0", "mf1", "mf7_wide_exp_frame1", "graph600")
                for nb in (1, 5, 32) for short in (False,)]
ENCODE_CASES += [("dominant", 64, False), ("mf7_wide_exp_frame1", 5, True),
                 ("graph600", 32, True)]


def _encode_id(case):
    name, nb, short = case
    return f"{name}-L{nb}" + ("-short" if short else "")


@pytest.fixture(scope="module")
def encode_runs(encode_inputs):
    """The plan and the plain version's outputs per case."""
    runs = {}
    for case in ENCODE_CASES:
        name, nb, short = case
        plan = encode_plan(*encode_inputs[name], nb, device="cpu")
        cap = plan.cap - 8 if short else plan.cap
        args = (plan.params, plan.tab, plan.tokens, plan.tstart, plan.tend,
                cap)
        runs[_encode_id(case)] = args, encode_blocks_plain(*args)
    return runs


@pytest.mark.parametrize("variant", list(ENCODE_VARIANTS))
@pytest.mark.parametrize("case", ENCODE_CASES, ids=_encode_id)
def test_encode_blocks_host_build_matches_plain(encode_libs, encode_runs,
                                                case, variant):
    args, want = encode_runs[_encode_id(case)]
    params, tab, tokens, tstart, tend, cap = args
    L, T = tstart.shape[0], tokens.shape[0]
    EP = _emit_pairs(params[9])
    if case[2]:
        assert not bool(want[4].all())
    else:
        assert bool(want[4].all())
        if L > 1:   # some lane ends before cap
            assert int((tend - tstart).min()) < cap
    i32 = torch.int32
    rec = torch.full((5 * T + 4,), 0x5A5A5A5A, dtype=i32)
    emit = torch.full((cap * EP + cap, L), 0x5A5A5A5A, dtype=i32)
    states = torch.full((cap, L), 0x5A5A5A5A, dtype=i32)
    final_states = torch.empty(L, dtype=i32)
    wtotals = torch.empty(L, dtype=i32)
    ok = torch.empty(L, dtype=torch.bool)
    flat = [int(v) for c in range(9) for v in params[c]] + [int(params[9])]
    assert encode_libs[variant].run_encode(
        (ctypes.c_longlong * len(flat))(*flat), tab.data_ptr(),
        tab.shape[0], tokens.data_ptr(), T, rec.data_ptr(),
        rec.data_ptr() + 16 * T, tstart.data_ptr(), tend.data_ptr(), L, cap,
        EP, emit.data_ptr(), states.data_ptr(), final_states.data_ptr(),
        wtotals.data_ptr(), ok.data_ptr()) == 0
    for ch, (g, w) in enumerate(zip((emit, states, final_states, wtotals,
                                     ok), want)):
        assert torch.equal(g, w), ch
