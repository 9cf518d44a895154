"""The port's batch random access (ops/random_torch.py): TorchRandomAccess,
TorchCsrServer and TorchEmitRandomAccess against the JAX package's
counterparts on the same artifacts and queries (the shapes of
tests/test_tpu_random.py and tests/test_emit_random.py), and their device
gathers against the JAX functions on seeded arrays. Plain PyTorch on the
CPU; the JAX side runs its XLA decoder (WGT_PALLAS=0) or, for the
merged-emit kernel, the Pallas kernel in interpret mode. Integer outputs,
compared exactly (tolerance 0)."""

import dataclasses

import numpy as np
import pytest
import torch

from webgraph_ans_tpu.bvgraph.graph import Adjacency
from webgraph_ans_tpu.bvgraph.random_access import ANSBvGraph as JaxGraph
from webgraph_ans_tpu.bvgraph.store import compress_adjacency
from webgraph_ans_tpu.bvgraph.synth import synth_web_graph
from webgraph_ans_tpu.ops import random_tpu
from webgraph_ans_tpu.ops.graph_decode import TpuGraphDecoder
from webgraph_ans_torch.bvgraph.random_access import ANSBvGraph as TorchGraph
from webgraph_ans_torch.ops import graph_decode, random_torch
from webgraph_ans_torch.ops.graph_decode import TorchGraphDecoder
from webgraph_ans_torch.ops.random_torch import (TorchCsrServer,
                                                 TorchEmitRandomAccess,
                                                 TorchRandomAccess)
import jax_native_build

# the JAX package's native library, built once before any test loads it
jax_native_build.ensure()


def _random(n, seed, dmax):
    rng = np.random.default_rng(seed)
    return [sorted(rng.choice(n, size=int(rng.integers(0, dmax)),
                              replace=False).tolist()) for _ in range(n)]


def _structured():
    lists = []
    for i in range(64):
        if i % 4 in (0, 1):
            lists.append(list(range(0, 32)))
        elif i % 4 == 2:
            lists.append([j for j in range(0, 32) if j % 3 != 0])
        else:
            lists.append([1, 5, 50, 63])
    return lists


def _sampled(res, step):
    """(prelude, states, pointers) stored with phase_step=step."""
    if step == 1:
        return res.prelude, res.states, res.pointers
    n = res.prelude.num_nodes
    keep = (n - 1 - np.arange(0, n, step))[::-1]
    return (dataclasses.replace(res.prelude, phase_step=step),
            np.ascontiguousarray(res.states[keep]),
            np.ascontiguousarray(res.pointers[keep]))


# name -> (lists, (window, max_ref, min_interval), encode_blocks,
# phase_step, queries)
CASES = {
    "dummy": ([[2, 3], [5], [], [], [0], []], (7, 3, 2), 1, 1,
              [4, 0, 2, 0, 5]),
    "structured": (_structured(), (7, 3, 4), 1, 1, [63, 3, 17, 17, 0, 62]),
    "random": (_random(500, 9, 16), (7, 3, 2), 1, 1,
               np.random.default_rng(9).integers(0, 500, size=200)),
    "phase_sampled": (_random(400, 17, 12), (7, 3, 2), 1, 8,
                      [0, 7, 8, 9, 133, 399, 250, 250, 31]),
    # block-encoded and phase-sampled: the native random access is wrong
    # here (nodes 92, 136, 137), so the input lists are the reference
    "blocks4_sampled3": (_random(180, 17, 11), (7, 3, 2), 4, 3,
                         [92, 136, 137, 0, 47, 48, 179, 136]),
}


@pytest.fixture(scope="module")
def graphs():
    made = {}
    for name, (lists, args, blocks, step, _) in CASES.items():
        res = compress_adjacency(Adjacency.from_lists(lists), *args,
                                 encode_blocks=blocks)
        made[name] = _sampled(res, step)
    return made


@pytest.fixture()
def xla_decoder(monkeypatch):
    monkeypatch.setenv("WGT_PALLAS", "0")


def _want(name):
    lists, *_, queries = CASES[name]
    return [lists[q] for q in queries]


@pytest.mark.parametrize("name", ["dummy", "structured", "random",
                                  "phase_sampled"])
def test_wave_random_access_matches_jax(graphs, name, xla_decoder):
    queries = CASES[name][-1]
    jra = random_tpu.TpuRandomAccess(TpuGraphDecoder(JaxGraph(*graphs[name])))
    tra = TorchRandomAccess(TorchGraphDecoder(TorchGraph(*graphs[name]),
                                              device="cpu"))
    got = tra.successors_batch(queries)
    assert got.to_lists() == jra.successors_batch(queries).to_lists()
    assert got.to_lists() == _want(name)


@pytest.mark.parametrize("name", ["random", "phase_sampled"])
def test_wave_halo_takes_the_chains_in_the_first_wave(graphs, name):
    """With a halo of 4 * window nodes before each query, the first wave
    holds every reference chain of max_ref 3 on the serial artifact, so
    one wave serves the batch; the lists stay the input's."""
    queries = CASES[name][-1]
    ra = TorchRandomAccess(TorchGraphDecoder(TorchGraph(*graphs[name]),
                                             device="cpu"))
    assert ra.successors_batch(queries, halo=28).to_lists() == _want(name)
    if name == "random":
        assert len(ra.last_waves) == 1
        ra.successors_batch(queries)
        assert len(ra.last_waves) > 1


@pytest.mark.parametrize("name", ["random", "dummy"])
def test_csr_server_matches_jax(graphs, name, xla_decoder):
    """The random graph's batch, and the dummy graph's empty rows and
    repeats."""
    queries = CASES[name][-1] if name == "random" else [5, 5, 0, 3, 3, 3, 1]
    lanes = 16 if name == "random" else 4
    jsrv = random_tpu.TpuCsrServer(TpuGraphDecoder(JaxGraph(*graphs[name])),
                                   num_lanes=lanes)
    tsrv = TorchCsrServer(TorchGraphDecoder(TorchGraph(*graphs[name]),
                                            device="cpu"), num_lanes=lanes)
    got = tsrv.successors_batch(queries)
    assert got.to_lists() == jsrv.successors_batch(queries).to_lists()
    lists = CASES[name][0]
    assert got.to_lists() == [lists[q] for q in queries]
    # the out_cap retry: a batch past 8 successors a query
    out, out_off, total = tsrv.serve(queries, out_cap=16)
    assert int(total) == int(out_off[-1]) == sum(len(lists[q])
                                                  for q in queries)


def test_block_sampled_artifact(graphs):
    """Block-encoded and phase-sampled: the wave decode and the CSR server
    return the input lists; the merged-emit random access refuses it, as
    the reference does."""
    g = graphs["blocks4_sampled3"]
    want = _want("blocks4_sampled3")
    queries = CASES["blocks4_sampled3"][-1]
    dec = TorchGraphDecoder(TorchGraph(*g), device="cpu")
    assert TorchRandomAccess(dec).successors_batch(queries).to_lists() == want
    assert TorchCsrServer(dec, num_lanes=8).successors_batch(
        queries).to_lists() == want
    with pytest.raises(ValueError, match="serial artifact"):
        TorchEmitRandomAccess(dec)
    with pytest.raises(ValueError, match="serial artifact"):
        random_tpu.TpuEmitRandomAccess(TpuGraphDecoder(JaxGraph(*g)))


def test_gather_rows_matches_jax():
    rng = np.random.default_rng(4)
    degs = rng.integers(0, 9, size=300)
    degs[::7] = 0                                   # empty rows
    offsets = np.concatenate([[0], np.cumsum(degs)]).astype(np.int32)
    succs = rng.integers(0, 1 << 30, size=int(offsets[-1]) + 11).astype(
        np.int32)
    q = rng.integers(0, 300, size=120).astype(np.int32)
    for out_cap in (64, 1024):                      # overflowing, roomy
        want = random_tpu.gather_rows(offsets, succs, q, out_cap)
        got = random_torch.gather_rows(torch.from_numpy(offsets),
                                       torch.from_numpy(succs),
                                       torch.from_numpy(q), out_cap)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_gather_padded_matches_jax():
    rng = np.random.default_rng(5)
    n, G = 200, 16
    degs = rng.integers(0, 7, size=n).astype(np.int32)
    starts = rng.integers(0, 40 * G, size=n).astype(np.int32)
    succs2d = rng.integers(0, 1 << 30, size=(48, G)).astype(np.int32)
    qp = rng.integers(0, n, size=90).astype(np.int32)
    qp[[3, 50, 89]] = -1                            # padding
    for out_cap in (32, 512):
        want = random_tpu._gather_padded(succs2d, starts, degs, qp, out_cap)
        got = random_torch._gather_padded(
            *(torch.from_numpy(a) for a in (succs2d, starts, degs, qp)),
            out_cap)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.fixture(scope="module")
def emit_graph():
    """tests/test_emit_random.py's artifact."""
    adj = synth_web_graph(400, seed=5)
    res = compress_adjacency(adj)
    return adj, (res.prelude, res.states, res.pointers)


def test_emit_random_access_matches_jax(emit_graph, monkeypatch):
    """Per-query lanes (a batch below the full-decode point), against the
    JAX package's merged-emit kernel in interpret mode; then a batch past
    that point, through the full merged-emit decode."""
    monkeypatch.setenv("WGT_PALLAS", "interpret")
    adj, g = emit_graph
    lists = adj.to_lists()
    jra = random_tpu.TpuEmitRandomAccess(TpuGraphDecoder(JaxGraph(*g)))
    tra = TorchEmitRandomAccess(TorchGraphDecoder(TorchGraph(*g),
                                                  device="cpu"))
    rng = np.random.default_rng(3)
    small = np.concatenate([rng.integers(0, adj.num_nodes, 8),
                            [0, adj.num_nodes - 1, 7, 7]])
    assert not tra._full_decode_cheaper(len(np.unique(small)))
    got = tra.successors_batch(small).to_lists()
    assert got == jra.successors_batch(small).to_lists()
    assert got == [lists[q] for q in small]
    big = rng.integers(0, adj.num_nodes, 40)
    assert tra._full_decode_cheaper(len(np.unique(big)))
    assert tra.successors_batch(big).to_lists() == [lists[q] for q in big]
    assert tra.successors_batch([]).to_lists() == []


def test_emit_random_access_sends_unclean_lanes_native(emit_graph,
                                                       monkeypatch):
    """Lanes the kernel leaves unresolved stay on the decoder's device:
    lanes past the cap (here: every lane, at a cap too short for any
    query) run again alone at twice the cap until they finish; lanes
    dirty past the halo (a reference chain deeper than 4 * window) go to
    the wave decode, up to max(64, B // 2) of them. The native per-node
    decoder is never called."""
    adj, g = emit_graph
    lists = adj.to_lists()
    tra = TorchEmitRandomAccess(TorchGraphDecoder(TorchGraph(*g),
                                                  device="cpu"))
    monkeypatch.setattr(tra.dec.graph, "successors_batch", None)
    q = [5, 100, 101, 399]
    assert tra.successors_batch(q, cap=8).to_lists() == [lists[x] for x in q]
    rounds = tra.last_rounds
    assert rounds[0]["cap"] == 8 and rounds[0]["over_cap"] == 4
    assert [r["cap"] for r in rounds] == [8 << i for i in range(len(rounds))]
    assert [r["T"] for r in rounds] == [max(8, r["cap"]) for r in rounds]
    assert rounds[-1]["over_cap"] == 0 and tra.last_unclean == 0
    assert all(r["queries"] == p["over_cap"]
               for p, r in zip(rounds, rounds[1:]))

    # window 1, at most 20 references a chain: node x copies node x - 1
    # up to a root every 21 nodes, so nodes 5-20 past a root (x % 21 >= 5)
    # hang on a chain deeper than the halo of 4
    chain = [list(range(0, 90, 3))] * 400
    res = compress_adjacency(Adjacency.from_lists(chain), 1, 20, 2)
    cra = TorchEmitRandomAccess(TorchGraphDecoder(
        TorchGraph(res.prelude, res.states, res.pointers), device="cpu"))
    monkeypatch.setattr(cra.dec.graph, "successors_batch", None)
    q = [3, 50, 60, 50, 399]
    assert cra.successors_batch(q).to_lists() == [chain[x] for x in q]
    assert cra.last_unclean == 2 and cra.last_rounds[0]["dirty"] == 2
    deep = np.nonzero(np.arange(400) % 21 >= 5)[0][:70]
    assert not cra._full_decode_cheaper(len(deep))
    with pytest.raises(RuntimeError, match="70/70 lanes unresolved"):
        cra.successors_batch(deep)


def test_wave_cap_loop_is_bounded(graphs, monkeypatch):
    dec = TorchGraphDecoder(TorchGraph(*graphs["random"]), device="cpu")
    caps = []

    def never_done(tables, states, *args):
        cap = args[-1]
        caps.append(cap)
        L = states.shape[0]
        return (torch.zeros((cap + cap // 8, L), dtype=torch.int32),
                torch.zeros(L, dtype=torch.int32),
                torch.zeros(L, dtype=torch.bool))

    monkeypatch.setattr(random_torch, "decode_blocks", never_done)
    with pytest.raises(RuntimeError, match="lane 0 has not finished"):
        TorchRandomAccess(dec).successors_batch([3, 4])
    bound = dec.step_bound("token")
    assert len(caps) <= int(np.ceil(np.log2(bound / caps[0]))) + 1
    assert caps[-1] >= bound


SERIAL = ["dummy", "structured", "random", "synth400"]


def _serial(graphs, emit_graph, name):
    """(lists, the wave decoder with the per-node phases that
    TorchEmitRandomAccess holds on the device, queries) of a serial
    artifact of the cases above or of emit_graph."""
    if name == "synth400":
        adj, g = emit_graph
        lists, queries = adj.to_lists(), [5, 100, 101, 399, 0, 250, 5]
    else:
        lists, g, queries = CASES[name][0], graphs[name], CASES[name][-1]
    era = TorchEmitRandomAccess(TorchGraphDecoder(TorchGraph(*g),
                                                  device="cpu"))
    return lists, TorchRandomAccess(
        era.dec, phases=(era.states_d, era.ptrs_d, era.ctab)), queries


@pytest.mark.parametrize("layout", ["lane-major", "kernel"])
@pytest.mark.parametrize("lanes,cap", [(0, 16), (3, 8), (115, 576)])
def test_unpack_tokens_matches_the_nibble_formula(lanes, cap, layout):
    """The wave's host unpack of decode_blocks' output, lane-major (the
    replayed wave's read-back) or the kernel's [rows, L] transposed (the
    eager wave's), against step s's nibble at bits 4 * (s % 8) of row
    cap + s // 8."""
    rng = np.random.default_rng(lanes + cap)
    out_t = rng.integers(0, 1 << 32, (lanes, cap + cap // 8),
                         dtype=np.uint64).astype(np.uint32)
    if layout == "kernel":
        out_t = np.ascontiguousarray(out_t.T).T
    steps = np.arange(cap)
    want = ((out_t[:, cap + steps // 8] >> ((steps % 8) * 4)) & 0xF
            ).astype(np.uint8)
    vals, comps = random_torch._unpack_tokens(out_t, cap)
    assert np.array_equal(vals, out_t[:, :cap]) and vals.dtype == np.uint32
    assert np.array_equal(comps, want) and comps.dtype == np.uint8


@pytest.mark.parametrize("name", SERIAL)
def test_wave_device_inputs_equal_host_inputs(graphs, emit_graph, name):
    """The wave's lanes gathered on the device from the per-node phases
    (states, pointers, starts, ends, ring seeds) equal the host-built
    ones bit for bit: every node's segment, then the padding lanes,
    empty at start == end == n."""
    _, ra, _ = _serial(graphs, emit_graph, name)
    n, G = ra.dec.num_nodes, ra.WAVE_LANES
    segs = np.arange(n)
    padded = np.full(G, -1, np.int32)
    padded[:n] = segs
    got = ra._device_inputs(torch.from_numpy(padded))
    starts, ends = ra._seg_bounds(segs)
    fill = np.full(G - n, n)
    want = ra._range_inputs(np.concatenate([starts, fill]),
                            np.concatenate([ends, fill]))
    for g, w, live in zip(got, want, ra._segment_inputs(segs)):
        assert g.dtype == w.dtype and torch.equal(g, w)
        assert torch.equal(g[:n], live)


@pytest.mark.parametrize("cap", [512, 8])
@pytest.mark.parametrize("name", SERIAL)
def test_wave_padded_lanes_match_the_eager_wave(graphs, emit_graph, name,
                                                cap):
    """The replayed wave's step, run eagerly here: the padded lanes'
    decode read back in one packed copy gives the eager wave's tokens,
    counts and cap; the padding lanes finish with no token. At cap 8 the
    lanes past the cap finish through the eager cap loop."""
    _, ra, queries = _serial(graphs, emit_graph, name)
    segs = np.unique(ra._seg_of(np.maximum(
        np.asarray(queries)[:, None] - np.arange(29), 0)))
    got = ra._decode_captured(segs, cap)
    want = ra._decode_lanes(ra._segment_inputs(segs), cap)
    assert got[3] == want[3]
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    padded = np.full(ra.WAVE_LANES, -1, np.int32)
    padded[:len(segs)] = segs
    _, packed = ra._wave_lanes(torch.from_numpy(padded), got[3])
    G = ra.WAVE_LANES
    assert packed[len(segs):G].all()
    assert not packed[G + len(segs):2 * G].any()


@pytest.mark.parametrize("name", SERIAL)
def test_wave_through_the_replay_path_matches_jax(graphs, emit_graph, name,
                                                  xla_decoder, monkeypatch):
    """Every wave of a batch through the replay path's step (forced here;
    on the CPU it runs eagerly) gives the JAX package's lists without a
    halo, in several waves, and the input lists with the halo of the
    merged-emit random access, in one."""
    lists, ra, queries = _serial(graphs, emit_graph, name)
    monkeypatch.setattr(ra, "_replays", lambda lanes: True)
    g = (emit_graph[1] if name == "synth400" else graphs[name])
    jra = random_tpu.TpuRandomAccess(TpuGraphDecoder(JaxGraph(*g)))
    got = ra.successors_batch(queries).to_lists()
    assert got == jra.successors_batch(queries).to_lists()
    assert got == [lists[q] for q in queries]
    assert ra.successors_batch(queries, halo=28).to_lists() == got


# duplicates (3 three times, 0 and the last node twice) and both ends
DEVICE_QUERIES = [3, 3, 0, 399, 17, 250, 3, 0, 399, 128]
SMALL_OUT_CAP = 16


JAX_FULL_DECODE_LANES = 16


@pytest.fixture(scope="module")
def jax_device_batches(emit_graph):
    """The JAX package's successors_batch_device on DEVICE_QUERIES, with
    the default out_cap and with SMALL_OUT_CAP, Pallas in interpret mode.
    Its decoder's full merged-emit decode runs once, at 16 lanes in place
    of 2048, and both calls gather from it: the lists do not depend on
    the lane count, and in interpret mode each lane count and cap traces
    the kernel anew (2048 lanes: ~90 s for the first decode alone). The
    safe boundaries, which only plan the decoder's later calls, are
    skipped (their aux-mode decode runs at 2048 lanes)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WGT_PALLAS", "interpret")
        dec = TpuGraphDecoder(JaxGraph(*emit_graph[1]))
        decode, made = dec.decode_to_adjacency_device, []

        def decode_once(num_lanes):
            assert num_lanes == 2048
            if not made:
                made.append(decode(JAX_FULL_DECODE_LANES))
            return made[0]

        def skip():
            raise RuntimeError("safe boundaries skipped")

        mp.setattr(dec, "decode_to_adjacency_device", decode_once)
        mp.setattr(dec, "_safe_boundaries", skip)
        jra = random_tpu.TpuEmitRandomAccess(dec)
        q = np.asarray(DEVICE_QUERIES)
        return {cap: tuple(np.asarray(x) for x in
                           jra.successors_batch_device(q, cap))
                for cap in (None, SMALL_OUT_CAP)}


@pytest.fixture(scope="module")
def torch_emit_ra(emit_graph):
    """The port's emit random access on the CPU, its full decode at the
    JAX side's 16 lanes: the plain merged emit's CPU time grows with the
    lanes, and 2048 of them on this 400-node graph are nearly all empty
    (test_emit_random_access_matches_jax runs the default 2048)."""
    ra = TorchEmitRandomAccess(TorchGraphDecoder(TorchGraph(*emit_graph[1]),
                                                 device="cpu"))
    ra.FULL_DECODE_LANES = JAX_FULL_DECODE_LANES
    return ra


def _assert_device_batch(got, want, lists=None):
    outv, offs, total = got
    joutv, joffs, jtotal = want
    assert outv.dtype == offs.dtype == torch.int32
    assert int(total) == int(jtotal)
    np.testing.assert_array_equal(offs.numpy(), joffs)
    if lists is None:                 # an out_cap below total: all of outv
        np.testing.assert_array_equal(outv.numpy(), joutv)
        return
    np.testing.assert_array_equal(outv[:int(total)].numpy(),
                                  joutv[:int(jtotal)])
    assert [outv[offs[i]:offs[i + 1]].tolist()
            for i in range(len(DEVICE_QUERIES))] == [lists[q]
                                                     for q in DEVICE_QUERIES]


@pytest.mark.parametrize("form", ["array", "tensor"])
def test_successors_batch_device_matches_jax(emit_graph, jax_device_batches,
                                             torch_emit_ra, form):
    """Duplicated queries as a host array and as an int64 tensor: offs,
    total and outv[:total] equal the JAX package's (tolerance 0), and
    each query's slice is its list in the graph."""
    q = (np.asarray(DEVICE_QUERIES) if form == "array"
         else torch.tensor(DEVICE_QUERIES))
    _assert_device_batch(torch_emit_ra.successors_batch_device(q),
                         jax_device_batches[None], emit_graph[0].to_lists())


def test_successors_batch_device_out_cap_below_total(jax_device_batches,
                                                     torch_emit_ra):
    """With out_cap below the batch's total, offs and total stay exact and
    outv is cut off at out_cap, as in the JAX package; the method does not
    gather again."""
    got = torch_emit_ra.successors_batch_device(
        torch.tensor(DEVICE_QUERIES, dtype=torch.int32), SMALL_OUT_CAP)
    assert got[0].shape == (SMALL_OUT_CAP,)
    assert int(got[2]) > SMALL_OUT_CAP
    _assert_device_batch(got, jax_device_batches[SMALL_OUT_CAP])


def test_successors_batch_device_steady_state(emit_graph, jax_device_batches,
                                              torch_emit_ra, monkeypatch):
    """Once the 2048-lane plan is verified, a batch runs decode_emit once
    (mark_deg) and the cached post-pass and gather with no tensor read to
    the host outside the kernels' plain versions (decode_emit's, and the
    fixup's where the layout has dirty nodes), and gives the same
    batch."""
    from test_torch_emit_pipeline import _NoHostSync, _spy_kernels

    ra = torch_emit_ra
    q = torch.tensor(DEVICE_QUERIES)
    pl = {}
    for _ in range(4):
        ra.successors_batch_device(q)
        pl = ra.dec._plans[("emit", ra.FULL_DECODE_LANES)]
        if ra.dec.emit_steady(ra.FULL_DECODE_LANES):
            break
    assert ra.dec.emit_steady(ra.FULL_DECODE_LANES), \
        "plan never reached the verified state"
    guard = _NoHostSync()
    calls, fixups = _spy_kernels(monkeypatch, guard)
    with guard:
        got = ra.successors_batch_device(q)
    assert calls == [True]
    assert fixups == (["cpu"] if pl["post_meta"]["fx_nodes"].shape[0]
                      else [])
    _assert_device_batch(got, jax_device_batches[None],
                         emit_graph[0].to_lists())


@pytest.fixture(scope="module")
def cpu_csr_server(emit_graph):
    """One CPU decoder for the wave and CSR cases below, its CSR built
    once for the csr and serve cases."""
    dec = TorchGraphDecoder(TorchGraph(*emit_graph[1]), device="cpu")
    return TorchCsrServer(dec, num_lanes=16)


@pytest.mark.parametrize("api", ["wave", "csr", "serve", "emit_lanes",
                                 "emit_full"])
def test_host_apis_take_tensor_queries(emit_graph, torch_emit_ra,
                                       cpu_csr_server, api):
    """Each batch API takes a torch tensor of queries (moved to the host
    once; serve keeps it on its device) and gives what the numpy input
    gives: the input graph's lists."""
    adj = emit_graph[0]
    lists = adj.to_lists()
    rng = np.random.default_rng(8)
    q = (rng.integers(0, adj.num_nodes, 40) if api == "emit_full"
         else np.array([5, 0, 399, 5, 77]))
    srv = cpu_csr_server
    if api == "serve":
        for a, b in zip(srv.serve(torch.from_numpy(q)), srv.serve(q)):
            assert torch.equal(a, b)
        return
    ra = {"wave": lambda: TorchRandomAccess(srv.dec),
          "csr": lambda: srv,
          "emit_lanes": lambda: torch_emit_ra,
          "emit_full": lambda: torch_emit_ra}[api]()
    if api.startswith("emit"):
        assert ra._full_decode_cheaper(len(np.unique(q))) == (
            api == "emit_full")
    got = ra.successors_batch(torch.from_numpy(q)).to_lists()
    assert got == ra.successors_batch(q).to_lists() == [lists[x] for x in q]


def test_hc_safe_break_artifact_keeps_the_merged_emit(monkeypatch):
    """A small high-compression artifact with safe breaks (window 16,
    unbounded references, min interval 4, a reference root every 32
    nodes), the JAX bench's hc format: decode_to_adjacency_device splits
    at reference-safe nodes and runs the merged emit with no halo into its
    verified steady state, never the sort path, and gives the input lists
    on every call."""
    from test_torch_emit_pipeline import _assert_lists

    adj = synth_web_graph(300, seed=13)
    res = compress_adjacency(adj, 16, 2_000_000_000, 4,
                             safe_break_interval=32)
    dec = TorchGraphDecoder(TorchGraph(res.prelude, res.states,
                                       res.pointers), device="cpu")
    real, calls = graph_decode.decode_emit, []

    def counted(*args, **kw):
        calls.append(kw.get("mark_deg", False))
        return real(*args, **kw)

    def no_sort_path(*args):
        raise AssertionError("the sort path served the hc artifact")

    monkeypatch.setattr(graph_decode, "decode_emit", counted)
    monkeypatch.setattr(dec, "_adjacency_via_sort_path", no_sort_path)
    for _ in range(4):
        _assert_lists(adj, *dec.decode_to_adjacency_device(16))
        pl = dec._plans[("emit", 16)]
        if dec.emit_steady(16):
            break
    assert dec.emit_steady(16) and pl.get("safe_np") is not None
    assert np.array_equal(pl["hstarts_np"], pl["starts_np"])
    calls.clear()
    _assert_lists(adj, *dec.decode_to_adjacency_device(16))
    assert calls == [True] and not pl.get("emit_broken")
