"""The decode kernels' CUDA sources, built for the host, against their
plain PyTorch versions.

csrc/decode_blocks.cu and csrc/decode_emit.cu are compiled with g++
against a stub cuda_runtime.h that runs one thread at a time: each
block's threads run one after another, shared memory is a host buffer and
__ldg a plain load (neither kernel synchronises its threads after the
parameters are staged). Every output channel must equal the plain
version's bit for bit (tolerance 0) on small artifacts that cover the
grammar variants, every dirty row code of the merged emit, both mark_deg
modes, and block sizes that do and do not divide the lane count. The
card's compiler is not the host's (ROADMAP §3
records an nvcc miscompile that a host build did not show), so
chip_smoke.py still holds the built kernels against the plain versions on
the card.
"""

import ctypes
import dataclasses
import os
import subprocess

import numpy as np
import pytest
import torch

from webgraph_ans_torch.bvgraph.graph import Adjacency
from webgraph_ans_torch.bvgraph.random_access import ANSBvGraph
from webgraph_ans_torch.bvgraph.store import compress_adjacency
from webgraph_ans_torch.bvgraph.synth import synth_web_graph
from webgraph_ans_torch.ops import cuda_build
from webgraph_ans_torch.ops.decode_torch import decode_blocks_plain
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
struct uint2 { uint32_t x, y; };
struct Dim { unsigned x = 0, y = 0, z = 0; };
inline Dim threadIdx, blockIdx, blockDim;
inline void __syncthreads() {}
template <class T> inline T __ldg(const T* p) { return *p; }
inline uint2 make_uint2(uint32_t x, uint32_t y) { return {x, y}; }
inline uint32_t min(uint32_t a, uint32_t b) { return a < b ? a : b; }
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
