"""The port's sort-path reconstruction (ops/reconstruct_device.py,
TorchGraphDecoder.decode_to_csr_device) against the JAX package's on the
same artifacts, the fallbacks of decode_to_adjacency_device onto it, and
the bounded cap-doubling loops. Plain PyTorch on the CPU; the JAX side
runs its XLA decoder (WGT_PALLAS=0), as its own CPU tests do. Everything
is integer and compared exactly (tolerance 0)."""

import logging
import math

import numpy as np
import pytest
import torch

from webgraph_ans_tpu.bvgraph.graph import Adjacency
from webgraph_ans_tpu.bvgraph.random_access import ANSBvGraph as JaxGraph
from webgraph_ans_tpu.bvgraph.store import compress_adjacency
from webgraph_ans_tpu.ops import reconstruct_device as jrd
from webgraph_ans_tpu.ops.graph_decode import TpuGraphDecoder
from webgraph_ans_torch.bvgraph.random_access import ANSBvGraph as TorchGraph
from webgraph_ans_torch.ops import emit_post, graph_decode
from webgraph_ans_torch.ops import reconstruct_device as trd
from webgraph_ans_torch.ops.cuda_build import KernelError
from webgraph_ans_torch.ops.decode_torch import NIB_SUM
from webgraph_ans_torch.ops.graph_decode import TorchGraphDecoder
import jax_native_build

# the JAX package's native library, built once before any test loads it
jax_native_build.ensure()


def _random(n, seed, dmax):
    rng = np.random.default_rng(seed)
    return [sorted(rng.choice(n, size=int(rng.integers(0, dmax)),
                              replace=False).tolist()) for _ in range(n)]


def _structured():
    lists = []
    for i in range(200):
        base = list(range(10, 10 + (i % 13)))           # interval-friendly
        extra = [((i * 37 + k * 11) % 200) for k in range(i % 5)]
        lists.append(sorted(set(base + extra)))
    return lists


def _chain(n, d):
    """n equal lists: every node copies the one before, a chain n - 1
    deep under unbounded reference counts."""
    return [list(range(0, 3 * d, 3))] * n


# The graphs of tests/test_tpu_reconstruct.py:90-140, a window past 16
# and a window-16 artifact without safe breaks:
# name -> (lists, (window, max_ref, min_interval), encode_blocks, lanes)
GRAPHS = {
    "random600_b1": (_random(600, 55, 16), (7, 3, 2), 1, 16),
    "random600_b8": (_random(600, 55, 16), (7, 3, 2), 8, 16),
    "structured": (_structured(), (7, 3, 2), 1, 8),
    "deep_chains": ([sorted({1, 3, 5, 7, 9} | {i % 11}) for i in range(160)],
                    (7, 150, 2), 1, 4),
    "window20": (_random(300, 3, 10), (20, 3, 2), 1, 8),
    "w16_no_breaks": (_random(100, 4, 8) + _chain(30, 4),
                      (16, 2_000_000_000, 4), 1, 8),
}
# a small serial artifact for the merged-emit path's control flow
SERIAL = _random(200, 8, 10)


@pytest.fixture(scope="module")
def results():
    return {name: compress_adjacency(Adjacency.from_lists(lists), *args,
                                     encode_blocks=blocks)
            for name, (lists, args, blocks, _) in GRAPHS.items()}


@pytest.fixture()
def xla_decoder(monkeypatch):
    monkeypatch.setenv("WGT_PALLAS", "0")


def _torch_dec(res):
    return TorchGraphDecoder(TorchGraph(res.prelude, res.states,
                                        res.pointers), device="cpu")


def _lists(offsets, succs, E):
    return Adjacency(np.asarray(offsets).astype(np.uint64),
                     np.asarray(succs)[:E].astype(np.uint32)).to_lists()


@pytest.mark.parametrize("name", list(GRAPHS))
def test_csr_matches_jax(results, name, xla_decoder):
    """decode_to_csr_device: offsets, succs[:E], E and the meta vector
    equal the JAX package's, cold and with the cached meta."""
    lists, _, _, lanes = GRAPHS[name]
    res = results[name]
    jdec = TpuGraphDecoder(JaxGraph(res.prelude, res.states, res.pointers))
    off_j, succs_j, E_j = jdec.decode_to_csr_device(num_lanes=lanes)
    tdec = _torch_dec(res)
    for _ in range(2):
        off_t, succs_t, E_t = tdec.decode_to_csr_device(num_lanes=lanes)
        assert E_t == E_j == sum(map(len, lists))
        np.testing.assert_array_equal(off_t.numpy(), np.asarray(off_j))
        np.testing.assert_array_equal(succs_t[:E_t].numpy(),
                                      np.asarray(succs_j)[:E_j])
    np.testing.assert_array_equal(
        tdec.plan(lanes)["recon_meta"]["meta"],
        jdec.plan(lanes)["recon_meta"]["meta"])
    assert _lists(off_t, succs_t, E_t) == lists


def test_deep_chains_take_the_deep_rounds(results):
    """Chains past the 63 depths of the histogram: the meta saturates and
    the reconstruction resolves them round by round."""
    tdec = _torch_dec(results["deep_chains"])
    tdec.decode_to_csr_device(num_lanes=4)
    meta = tdec.plan(4)["recon_meta"]["meta"]
    assert meta[3] > trd.DEPTH_BUCKETS - 1


@pytest.mark.parametrize("name", ["window20", "w16_no_breaks"])
def test_adjacency_device_returns_lists(results, name):
    """decode_to_adjacency_device serves a window past 16 and a window-16
    artifact without safe breaks, twice; the window-20 one by the sort
    path from the first call."""
    lists, _, _, lanes = GRAPHS[name]
    dec = _torch_dec(results[name])
    for _ in range(2):
        got = emit_post.to_host_lists(*dec.decode_to_adjacency_device(lanes),
                                      len(lists))
        assert [x.tolist() for x in got] == lists
    broken = dec._plans[("emit", lanes)].get("emit_broken")
    assert (broken == "window 20 > 16") == (name == "window20")


def test_postpass_deep_dirty_chain_resolves_on_the_merged_emit(
        monkeypatch):
    """On a window-16 chain 199 deep with no safe break, an 8-row first
    ring makes node 1's copy source fall out of the ring, and every later
    node copies from a dirty parent: a dirty chain 199 deep, past the 192
    rounds the post-pass once took. The fixup resolves it at that depth,
    and the plan goes on to its steady merged emit, every call returning
    the lists. (A post-pass RuntimeError still sends a plan to the sort
    path: test_torch_emit_pipeline.py test_postpass_error_propagates.)"""
    lists = _chain(200, 9)
    res = compress_adjacency(Adjacency.from_lists(lists), 16,
                             2_000_000_000, 4)
    dec = _torch_dec(res)
    dec.EMIT_RING_T = 8
    real, rounds = emit_post._dirty_chains, []

    def spy(mc, tabs, n):
        real(mc, tabs, n)
        rounds.append(mc["rounds"])

    monkeypatch.setattr(emit_post, "_dirty_chains", spy)
    for _ in range(5):
        out = dec.decode_to_adjacency_device(1)
        got = emit_post.to_host_lists(*out, 200)
        assert [x.tolist() for x in got] == lists
    assert rounds[0] == 199
    assert dec.emit_steady(1)
    assert not dec._plans[("emit", 1)].get("emit_broken")


@pytest.fixture()
def serial():
    return SERIAL, _torch_dec(compress_adjacency(
        Adjacency.from_lists(SERIAL), 7, 3, 2))


def test_plan_the_kernel_cannot_serve_falls_back(serial, caplog):
    lists, dec = serial
    dec._emit_servable = lambda T: False
    with caplog.at_level(logging.WARNING, logger=graph_decode.__name__):
        got = emit_post.to_host_lists(*dec.decode_to_adjacency_device(8),
                                      len(lists))
    assert [x.tolist() for x in got] == lists
    assert "merged-emit kernel unavailable" in dec._plans[
        ("emit", 8)]["emit_broken"]
    assert "does not fit" in caplog.text


def test_safe_boundary_failure_keeps_the_halo(serial, caplog):
    """The reference-safe bounds cannot be computed: the rebalanced plan
    keeps the halo re-decode and stays on the merged-emit path."""
    lists, dec = serial

    def broken():
        raise ValueError("token stream inconsistent")

    dec._safe_boundaries = broken
    with caplog.at_level(logging.WARNING, logger=graph_decode.__name__):
        for _ in range(4):
            got = emit_post.to_host_lists(
                *dec.decode_to_adjacency_device(8), len(lists))
            assert [x.tolist() for x in got] == lists
    pl = dec._plans[("emit", 8)]
    assert pl["safe_np"] is None and not pl.get("emit_broken")
    assert pl["hstarts_np"][1] < pl["starts_np"][1]       # a halo
    assert "halo re-decode" in caplog.text


@pytest.mark.parametrize("where", ["decode_emit", "postprocess",
                                   "safe_boundaries"])
def test_kernel_errors_propagate(serial, monkeypatch, where):
    """A kernel's build or launch failure never falls back."""
    lists, dec = serial

    def fail(*args, **kw):
        raise KernelError("decode_emit kernel launch failed: too many "
                          "resources requested for launch")

    if where == "decode_emit":
        monkeypatch.setattr(graph_decode, "decode_emit", fail)
    elif where == "postprocess":
        monkeypatch.setattr(emit_post, "postprocess", fail)
    else:
        dec._safe_boundaries = fail
    with pytest.raises(KernelError, match="launch failed"):
        for _ in range(2):
            dec.decode_to_adjacency_device(8)
    assert not dec._plans[("emit", 8)].get("emit_broken")


def test_meta_cache_verifies_and_refuses_a_changed_stream(serial):
    lists, dec = serial
    out, _, cap = dec.decode_raw(8, emit_aux=True)
    n, m = dec.num_nodes, dec.num_arcs
    cache = {}
    off1, s1, E = trd.reconstruct_device(out, n, m, cap, cache)
    meta = cache["meta"].copy()
    off2, s2, _ = trd.reconstruct_device(out, n, m, cap, cache)
    assert torch.equal(off1, off2) and torch.equal(s1, s2)
    np.testing.assert_array_equal(cache["meta"], meta)
    # one node summary's interval count changes: so does total_iv
    nib = trd.unpack_nibbles(out[3 * cap:], cap)
    r, c = map(int, torch.nonzero(nib == NIB_SUM)[0])
    bad = out.clone()
    bad[cap + r, c] += 1
    with pytest.raises(ValueError, match="changed under a cached"):
        trd.reconstruct_device(bad, n, m, cap, cache)
    assert "meta" not in cache
    assert _lists(off1, s1, E) == lists


@pytest.mark.parametrize("N", [1, 100, 20000])
def test_ffill_valid_matches_jax(N):
    rng = np.random.default_rng(N)
    val = rng.integers(-(1 << 29), 1 << 29, size=(2, N)).astype(np.int32)
    ch = np.where(rng.random((2, N)) < 0.05, (val << 1) | 1, 0).astype(
        np.int32)
    ch[0, 0] = 0                       # nothing valid before the first
    got = trd._ffill_valid(torch.from_numpy(ch))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jrd._ffill_valid(ch)))


def test_cumsum_rows_match_numpy():
    """The per-row int32 cumulative sum taken as one flat scan."""
    rng = np.random.default_rng(3)
    x = rng.integers(-(1 << 30), 1 << 30, size=(4, 999)).astype(np.int32)
    want = np.cumsum(x.astype(np.int64), axis=-1).astype(np.int32)
    np.testing.assert_array_equal(trd._cumsum(torch.from_numpy(x)).numpy(),
                                  want)
    np.testing.assert_array_equal(
        trd._cumsum_tok(torch.from_numpy(x[:3].reshape(3, 37, 27))).numpy(),
        np.cumsum(x[:3].reshape(3, 37, 27).transpose(0, 2, 1).reshape(3, -1)
                  .astype(np.int64), axis=-1).astype(np.int32)
        .reshape(3, 27, 37).transpose(0, 2, 1))


def test_sort_segments_breaks_ties_by_value():
    rng = np.random.default_rng(7)
    seg = rng.integers(0, 20, size=5000).astype(np.int32)
    s = rng.integers(-(1 << 31), (1 << 31) - 1, size=5000,
                     dtype=np.int64).astype(np.int32)
    got = trd.sort_segments(torch.from_numpy(seg), torch.from_numpy(s))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jrd.sort_segments(seg, s)))


def test_depth_matches_the_wavefront_on_a_self_reference():
    """A corrupt node 0 that references itself (and its descendants)
    never resolve, as in the reference's wavefront; depth_iters cuts
    chains past it."""
    parent = torch.tensor([0, 0, 1, 2, 0, 4], dtype=torch.int32)
    has_ref = torch.tensor([True, True, True, True, False, True])
    assert trd._chain_depth(parent, has_ref, 0).tolist() == [-1] * 4 + [0, 1]
    has_ref[0] = False
    assert trd._chain_depth(parent, has_ref, 0).tolist() == [0, 1, 2, 3,
                                                             0, 1]
    assert trd._chain_depth(parent, has_ref, 2).tolist() == [0, 1, 2, -1,
                                                             0, 1]


class _Calls:
    def __init__(self):
        self.caps = []


def _never_done(calls, rows_of, outputs):
    """A kernel stub whose lanes never finish: records each call's cap and
    returns outputs of the right shapes with every ok flag False."""
    def stub(*args, **kw):
        cap = rows_of(args, kw)
        calls.caps.append(cap)
        return outputs(args, cap)
    return stub


def _blocks_outputs(args, cap):
    L = args[1].shape[0]
    return (torch.zeros((cap + cap // 8, L), dtype=torch.int32),
            torch.zeros(L, dtype=torch.int32),
            torch.zeros(L, dtype=torch.bool))


def _emit_outputs(args, cap):
    L = args[1].shape[1]
    z = torch.zeros((cap, L), dtype=torch.int32)
    return (z, z, z[:cap // 8], torch.zeros(L, dtype=torch.int32),
            torch.zeros(L, dtype=torch.bool),
            torch.zeros((6, L), dtype=torch.int32),
            torch.zeros(L, dtype=torch.int32))


def _assert_bounded(calls, cap0, bound):
    assert calls.caps[0] == cap0
    assert len(calls.caps) <= math.ceil(math.log2(bound / cap0)) + 1
    assert calls.caps[-1] >= bound


def test_token_cap_loop_is_bounded(serial, monkeypatch):
    _, dec = serial
    calls = _Calls()
    monkeypatch.setattr(graph_decode, "decode_blocks", _never_done(
        calls, lambda a, kw: a[8], _blocks_outputs))
    cap0 = dec.plan(8)["cap"]
    with pytest.raises(RuntimeError, match="lane 0 has not finished"):
        dec.decode_raw(8)
    _assert_bounded(calls, cap0, dec.step_bound("token"))


def test_emit_cap_loop_is_bounded(serial, monkeypatch):
    _, dec = serial
    calls = _Calls()
    monkeypatch.setattr(graph_decode, "decode_emit", _never_done(
        calls, lambda a, kw: a[5], _emit_outputs))
    cap0 = dec._emit_plan(8)["cap"]
    with pytest.raises(RuntimeError, match="decode_emit: lane 0"):
        dec.decode_emit_raw(8)
    _assert_bounded(calls, cap0, dec.step_bound("emit"))


def _counting(lanes, stuck=None):
    """decode_blocks, recording each call's lane count and holding the
    lane that starts at node `stuck` unfinished at every cap."""
    kernel = graph_decode.decode_blocks

    def run(tables, states, ptrs, starts, *rest, **kw):
        lanes.append(int(states.shape[0]))
        out, counts, ok = kernel(tables, states, ptrs, starts, *rest, **kw)
        if stuck is not None:
            ok = ok & (starts != stuck)
        return out, counts, ok
    return run


def test_cap_loop_relaunches_only_unfinished_lanes(serial, monkeypatch):
    """From a cap too short for most lanes, decode_raw grows the cap on
    the unfinished lanes alone, then decodes every lane once at that cap:
    the tokens equal the default plan's. A lane that never finishes is
    relaunched alone until the bound, and named."""
    _, dec = serial
    want = dec.decode_tokens(8)
    lanes = []
    monkeypatch.setattr(graph_decode, "decode_blocks", _counting(lanes))
    got = dec.decode_tokens(8, cap=16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert lanes[0] == lanes[-1] == 8 and len(lanes) >= 3
    assert lanes[1:-1] == sorted(lanes[1:-1], reverse=True)

    monkeypatch.undo()
    lanes.clear()
    stuck = int(dec.plan(8)["starts_np"][3])
    monkeypatch.setattr(graph_decode, "decode_blocks",
                        _counting(lanes, stuck))
    with pytest.raises(RuntimeError, match="lane 3 has not finished"):
        dec.decode_raw(8, cap=16)
    bound = dec.step_bound("token")
    assert lanes[0] == 8 and lanes[-1] == 1
    assert len(lanes) <= math.ceil(math.log2(bound / 16)) + 1


@pytest.mark.parametrize("name", list(GRAPHS))
def test_step_bounds_cover_valid_lanes(results, name):
    """The bounds never fire on valid artifacts: the whole graph's steps
    (what one lane decoding every node would take) fit them."""
    dec = _torch_dec(results[name])
    lanes = GRAPHS[name][3]
    for aux, mode in ((False, "token"), (True, "aux")):
        _, counts, _ = dec.decode_raw(lanes, emit_aux=aux)
        steps = int(counts.sum()) + (dec.num_nodes if aux else 0)
        assert steps <= dec.step_bound(mode)
