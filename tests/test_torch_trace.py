"""The port's spans, stages and counters (webgraph_ans_torch/utils/trace.py)
on its two entry points: batch random access
(TorchEmitRandomAccess.successors_batch) and the full decode
(TorchGraphDecoder.decode_to_adjacency_device). Plain PyTorch on the CPU
on small graphs; the host synchronisations against
torch.cuda.set_sync_debug_mode on cnr-2000 need the card (marker `cuda`:
`python -m pytest tests/test_torch_trace.py -m cuda -s` there)."""

import collections
import json
import os
import sys
import warnings

import numpy as np
import pytest
import torch

from webgraph_ans_torch.bvgraph.graph import Adjacency, load_bvgraph
from webgraph_ans_torch.bvgraph.random_access import ANSBvGraph
from webgraph_ans_torch.bvgraph.store import compress_adjacency, store
from webgraph_ans_torch.bvgraph.synth import synth_web_graph
from webgraph_ans_torch.ops import (cuda_build, decode_cuda, emit_cuda,
                                    fixup_cuda, graph_decode)
from webgraph_ans_torch.ops.decode_torch import round_cap
from webgraph_ans_torch.ops.graph_decode import TorchGraphDecoder
from webgraph_ans_torch.ops.random_torch import (TorchEmitRandomAccess,
                                                 TorchRandomAccess)
from webgraph_ans_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
from benchmark.reference import lists as ref_lists  # noqa: E402
from benchmark.reference import synth_plain  # noqa: E402

CPU = torch.profiler.ProfilerActivity.CPU
PLAN = ["plan.bounds", "plan.first", "plan.refine", "plan.safe",
        "plan.verify"]
LANES = 16
CNR = os.path.join(os.path.dirname(__file__), "data", "cnr-2000", "cnr-2000")
# the benchmark's high-compression deployment (cnr2000hc): its store
# parameters, window 16, unbounded chains, safe breaks every 128 nodes
with open(os.path.join(ROOT, "benchmark", "configs", "cnr2000hc.json")) as f:
    HC = json.load(f)
HC_LANES = 8


def _last_id():
    recorded = trace.spans() + trace.stages()
    return max((s.id for s in recorded), default=0)


def _since(mark, recorded):
    return [s for s in recorded if s.id > mark]


@pytest.fixture(scope="module")
def steady_decoder():
    """A 400-node graph's decoder taken into the steady state with the
    profiler off, and the stages its cold calls recorded."""
    adj = synth_web_graph(400, seed=5)
    res = compress_adjacency(adj)
    dec = TorchGraphDecoder(ANSBvGraph(res.prelude, res.states,
                                       res.pointers), device="cpu")
    mark = _last_id()
    while not dec.emit_steady(LANES):
        dec.decode_to_adjacency_device(LANES)
    return adj, dec, _since(mark, trace.stages())


@pytest.fixture(scope="module")
def hc_decoder():
    """The benchmark's plain side's seeded 1,000-node synthetic graph,
    stored at the high-compression configuration's parameters and decoded
    at HC_LANES lanes through the plan into the steady state with the
    profiler off: (the decoder, the lists each call got wrong against the
    plain side's, the stages its calls recorded)."""
    offsets, succs = synth_plain.synth_web_graph(1000, seed=1)
    res = compress_adjacency(Adjacency(offsets.astype(np.uint64),
                                       succs.astype(np.uint32)),
                             **HC["store"])
    dec = TorchGraphDecoder(ANSBvGraph(res.prelude, res.states,
                                       res.pointers), device="cpu")
    mark = _last_id()
    ro, rs = torch.from_numpy(offsets), torch.from_numpy(succs)
    nodes = torch.arange(len(offsets) - 1)
    wrong = []
    # the first call, the split and its verification, a steady call
    for _ in range(3):
        s2d, starts, degs = dec.decode_to_adjacency_device(HC_LANES)
        wrong.append(ref_lists.count_wrong(ro, rs, nodes, starts, degs,
                                           s2d.shape[1], s2d))
    return dec, wrong, _since(mark, trace.stages())


@pytest.fixture(scope="module")
def chain_ra():
    """Random access on a graph whose reference chains run past the
    per-query lanes' halo (window 1, chains of 20): a batch at cap 8 runs
    rounds at caps 8..256 and sends two queries to the wave decode."""
    chain = [list(range(0, 90, 3))] * 400
    res = compress_adjacency(Adjacency.from_lists(chain), 1, 20, 2)
    dec = TorchGraphDecoder(ANSBvGraph(res.prelude, res.states,
                                       res.pointers), device="cpu")
    return chain, TorchEmitRandomAccess(dec)


QUERIES = [3, 50, 60, 50, 399]


@pytest.fixture(scope="module")
def profiled_batch(chain_ra, tmp_path_factory):
    """One batch under torch.profiler: (ra, its answer, the spans it
    recorded, the host_syncs it counted, the exported trace's events)."""
    _, ra = chain_ra
    mark = _last_id()
    syncs = trace.counters().get("host_syncs", 0)
    with torch.profiler.profile(activities=[CPU]) as prof:
        adj = ra.successors_batch(QUERIES, cap=8)
    syncs = trace.counters().get("host_syncs", 0) - syncs
    path = str(tmp_path_factory.mktemp("trace") / "batch.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return ra, adj, _since(mark, trace.spans()), syncs, events


def test_a_batch_is_one_call_under_one_root(chain_ra, profiled_batch):
    lists, _ = chain_ra
    ra, adj, spans, syncs, _ = profiled_batch
    assert adj.to_lists() == [lists[q] for q in QUERIES]
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ["ra.batch"]
    root = roots[0]
    assert {s.call for s in spans} == {root.id}
    assert root.attrs == {"queries": 5, "unique": 4}
    names = collections.Counter(s.name for s in spans)
    assert names["ra.round"] == len(ra.last_rounds) == 6
    assert ra.last_unclean == 2
    assert names["ra.wave"] == names["wave"] == names["ra.assemble"] == 1
    assert names["wave.segments"] == names["wave.follow"] >= 1
    # every read-back is a fetch span; the batch counts what its call did
    assert root.syncs == syncs > names["fetch"] >= 2 * len(ra.last_rounds)
    ids = {s.id: s for s in spans}
    for s in spans:
        if s.parent is not None:
            up = ids[s.parent]
            assert up.start <= s.start <= s.end <= up.end


def test_round_and_wave_seconds_are_the_spans_lengths(profiled_batch):
    ra, _, spans, _, _ = profiled_batch
    rounds = [s for s in spans if s.name == "ra.round"]
    assert [r["seconds"] for r in ra.last_rounds] == [s.seconds
                                                      for s in rounds]
    assert [r["cap"] for r in ra.last_rounds] == [s.attrs["cap"]
                                                  for s in rounds]
    (wave,) = [s for s in spans if s.name == "ra.wave"]
    assert ra.last_wave_seconds == wave.seconds


def test_the_chrome_trace_holds_a_range_for_each_span(profiled_batch):
    _, _, spans, _, events = profiled_batch
    ranges = collections.Counter(
        e["name"] for e in events if e.get("ph") == "X"
        and e.get("cat") == "user_annotation"
        and e["name"].startswith("wgans."))
    assert ranges == collections.Counter("wgans." + s.name for s in spans)


def test_cold_decode_records_each_plan_stage_once(steady_decoder):
    """With the profiler off: one stage for each planning step, the two
    splits inside the split and the verification, and no span."""
    _, dec, stages = steady_decoder
    top = [s for s in stages if s.name.startswith("plan.")]
    assert sorted(s.name for s in top) == PLAN
    assert all(s.parent is None and s.seconds > 0 for s in top)
    by_id = {s.id: s for s in stages}
    splits = [s for s in stages if s.name == "emit.split"]
    assert [(s.attrs["model"], by_id[s.parent].name) for s in splits] == [
        ("elements", "plan.bounds"), ("rows", "plan.verify")]
    # a planning call reads back what it plans from; the steady state
    # reads nothing back
    assert all(s.syncs > 0 for s in top if s.name != "plan.refine")


def test_hc_store_decodes_to_the_plain_lists(hc_decoder):
    """At window 16 with unbounded chains and safe breaks, every call's
    lists are the plain side's, through the plan into the steady state,
    on the merged emit: no call fell back to the sort path."""
    dec, wrong, stages = hc_decoder
    assert wrong == [0, 0, 0]
    pl = dec._plans[("emit", HC_LANES)]
    assert dec.emit_steady(HC_LANES)
    assert pl["safe_np"] is not None
    assert not [s for s in stages if s.name == "plan.fallback"]


@pytest.mark.parametrize("case", ["standard", "hc"])
def test_verify_stage_records_the_steady_layout(case, request):
    """plan.verify keeps the layout it verified: the fixup's rounds,
    dirty nodes, their elements and the rows that take the fixup kernel's
    two-run step from the post-pass's cache, the empty lanes, all lanes,
    the bounds not at a safe node and the encode blocks (none: a serial
    artifact) from the plan, the longest and the mean lane's rows from its
    decode, and that decode's folded rows and each lane's full steps
    (rows less folded rows: the longest and the mean); plan.safe keeps
    its safe nodes. The high-compression graph's steady state has dirty
    chains to fix up."""
    if case == "hc":
        dec, _, stages = request.getfixturevalue("hc_decoder")
        lanes = HC_LANES
    else:
        _, dec, stages = request.getfixturevalue("steady_decoder")
        lanes = LANES
    pl = dec._plans[("emit", lanes)]
    (verify,) = [s for s in stages if s.name == "plan.verify"]
    (safe,) = [s for s in stages if s.name == "plan.safe"]
    mc = pl["post_meta"]
    steps = pl["rows_np"] - pl["fold_np"]
    assert verify.attrs == {
        "lanes": len(pl["starts_np"]), "fixup_rounds": mc["rounds"],
        "dirty_nodes": len(mc["order_np"]),
        "dirty_elements": int(mc["fx_srcs"].shape[0]),
        "two_run_rows": mc["two_run_rows"],
        "empty_lanes": int((pl["starts_np"] >= pl["ends_np"]).sum()),
        "rows_max": int(pl["rows_np"].max()),
        "rows_mean": float(pl["rows_np"].mean()), "encode_blocks": 0,
        "fold_rows": int(pl["fold_np"].sum()), "steps_max": int(steps.max()),
        "steps_mean": float(steps.mean()),
        "unsafe_cuts": graph_decode.unsafe_cuts(pl["starts_np"],
                                                pl["safe_np"])}
    assert verify.attrs["lanes"] == pl["regs"].shape[1] == lanes
    assert 0 <= verify.attrs["empty_lanes"] < verify.attrs["lanes"]
    assert 0 < verify.attrs["fold_rows"] < pl["rows_np"].sum()
    assert verify.attrs["steps_max"] <= verify.attrs["rows_max"]
    assert safe.attrs == {"safe_nodes": int(pl["safe_np"].sum())}
    if case == "hc":
        assert 1 <= verify.attrs["fixup_rounds"] <= verify.attrs[
            "dirty_nodes"]
        assert 0 < verify.attrs["two_run_rows"] <= verify.attrs[
            "dirty_nodes"]


def test_steady_decode_under_a_profiler_syncs_nothing(steady_decoder):
    adj, dec, _ = steady_decoder
    mark = _last_id()
    with torch.profiler.profile(activities=[CPU]):
        succs2d, starts, degs = dec.decode_to_adjacency_device(LANES)
    # on the CPU the plain merged emit runs its rANS steps' unfolds
    spans = [s for s in _since(mark, trace.spans()) if s.name != "rans.fold"]
    assert [s.name for s in spans] == ["decode.steady", "decode"]
    steady, root = spans
    assert root.parent is None and steady.parent == root.id
    assert {s.call for s in _since(mark, trace.spans())} == {root.id}
    assert root.syncs == steady.syncs == 0
    assert root.attrs == {"lanes": LANES}
    assert np.array_equal(degs.numpy(), np.diff(adj.offsets.astype(
        np.int64)))


def test_no_span_without_a_profiler(steady_decoder, chain_ra):
    """Steady calls of both entry points record nothing per call while no
    profiler runs; the round and wave records keep their seconds."""
    _, dec, _ = steady_decoder
    _, ra = chain_ra
    mark = _last_id()
    dec.decode_to_adjacency_device(LANES)
    ra.successors_batch(QUERIES, cap=8)
    assert _since(mark, trace.spans() + trace.stages()) == []
    assert all(r["seconds"] > 0 for r in ra.last_rounds)
    assert ra.last_wave_seconds > 0


@pytest.mark.parametrize("case", ["vector", "scalar", "bool", "empty",
                                  "upload", "empty upload"])
def test_each_copy_counts_one_host_sync(case):
    """A copy between host and device counts one host synchronisation; an
    empty one copies nothing and counts none."""
    host = np.arange(6, dtype=np.int32).reshape(2, 3)
    if case.startswith("empty"):
        host = host[:0]
    before = trace.counters().get("host_syncs", 0)
    mark = _last_id()
    with torch.profiler.profile(activities=[CPU]):
        if case.endswith("upload"):
            got = trace.upload(host, "cpu").numpy()
            want = host
        else:
            t = {"vector": torch.from_numpy(host),
                 "empty": torch.from_numpy(host),
                 "scalar": torch.tensor(7, dtype=torch.int64),
                 "bool": torch.tensor([True, False]).all()}[case]
            got, want = trace.fetch(t), t.numpy()
    assert trace.counters().get("host_syncs", 0) == before + (
        not case.startswith("empty"))
    assert np.array_equal(got, want) and got.dtype == want.dtype
    spans = _since(mark, trace.spans())
    if case.endswith("upload"):
        assert spans == []
    else:
        (s,) = spans
        assert (s.name, s.syncs, s.attrs["bytes"]) == (
            "fetch", int(case != "empty"), want.nbytes)


def test_stages_nest_and_timed_spans_keep_seconds():
    mark = _last_id()
    with trace.stage("outer", k=1) as outer:
        with trace.stage("inner") as inner:
            with trace.timed("off") as t:
                pass
        outer.set(k=2)
    assert _since(mark, trace.stages()) == [inner, outer]
    assert (outer.parent, outer.call, outer.attrs) == (None, outer.id,
                                                       {"k": 2})
    assert (inner.parent, inner.call) == (outer.id, outer.id)
    assert t.seconds >= 0 and _since(mark, trace.spans()) == []
    assert outer.start <= inner.start <= inner.end <= outer.end


@pytest.mark.parametrize("fresh", [True, False])
def test_kernel_build_is_a_stage(fresh, tmp_path, monkeypatch):
    source = tmp_path / "k.cu"
    source.write_text("// nothing\n")
    lib = str(tmp_path / "libk.so")
    monkeypatch.setattr(cuda_build, "_fresh", lambda s, p: fresh)
    monkeypatch.setattr(cuda_build, "_command",
                        lambda s, tmp: ["touch", tmp])
    before = trace.counters().get("kernel_builds", 0)
    mark = _last_id()
    (res,) = cuda_build.build_many([(str(source), lib)])
    (st,) = _since(mark, trace.stages())
    assert (st.name, st.attrs["sources"]) == ("kernel.build", ["k.cu"])
    assert st.attrs["built"] == ([] if fresh else ["k.cu"])
    assert res["built"] is (not fresh)
    assert trace.counters().get("kernel_builds", 0) == before + (not fresh)
    assert fresh or os.path.exists(lib)


def test_counters_carry_the_launch_counts():
    c = trace.counters()
    assert c["decode_emit"] == emit_cuda.decode_emit.launches
    assert c["decode_blocks"] == decode_cuda.decode_blocks.launches
    assert c["decode_blocks_aux"] == decode_cuda.decode_blocks.aux_launches


def _sync_warnings(fn):
    """(fn's result, the synchronisations torch.cuda.set_sync_debug_mode
    reported during it as file:line, the host_syncs it counted)."""
    before = trace.counters().get("host_syncs", 0)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    where = [f"{os.path.basename(w.filename)}:{w.lineno}" for w in seen
             if "synchroniz" in str(w.message)]
    return out, where, trace.counters().get("host_syncs", 0) - before


@pytest.fixture(scope="module")
def cnr_decoder(tmp_path_factory):
    """On the card: cnr-2000 stored at the benchmark's parameters, and its
    decoder."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    base = str(tmp_path_factory.mktemp("cnr") / "cnr")
    store(CNR, base, 7, 3, 2)
    return TorchGraphDecoder(ANSBvGraph.load(base))


@pytest.mark.cuda
def test_host_syncs_match_sync_debug_mode(cnr_decoder):
    """On the card, cnr-2000 at the benchmark's store parameters: each
    call's host_syncs equals the synchronisations that
    set_sync_debug_mode("warn") reports, for the batches and the steady
    decodes (0) after the warm-up; the cold calls are printed."""
    dec = cnr_decoder
    ra = TorchEmitRandomAccess(dec)
    rng = np.random.default_rng(2147483659)
    rows = []
    for i in range(20):
        q = rng.integers(0, dec.num_nodes, 4096)
        caps = trace.counters().get("ra_graph_captures", 0)
        _, where, syncs = _sync_warnings(lambda: ra.successors_batch(q))
        rows.append({"call": "batch", "i": i, "warned": len(where),
                     "host_syncs": syncs,
                     "captures": trace.counters()["ra_graph_captures"]
                     - caps, "rounds": len(ra.last_rounds),
                     "unclean": ra.last_unclean,
                     "sites": dict(collections.Counter(where))})
    for i in range(12):
        _, where, syncs = _sync_warnings(
            lambda: dec.decode_to_adjacency_device(2048))
        torch.cuda.synchronize()
        rows.append({"call": "decode", "i": i, "warned": len(where),
                     "host_syncs": syncs,
                     "sites": dict(collections.Counter(where))})
    for r in rows:
        print(json.dumps(r))
    warm = [r for r in rows if r["i"] >= 8]
    assert [(r["warned"], r["host_syncs"]) for r in warm] == [
        (r["host_syncs"], r["host_syncs"]) for r in warm]
    assert all(r["host_syncs"] == 0 for r in warm if r["call"] == "decode")


@pytest.mark.cuda
def test_wave_replays_one_cuda_graph(cnr_decoder, monkeypatch):
    """On the card, cnr-2000: the queries that 4,096-query batches send to
    the wave decode, through the wave that replays its CUDA graph, give
    the eager wave's lists and the input lists (the CPU tests hold the
    same path to the JAX package's lists); each wave after the first
    replays the graph and counts one decode_blocks launch; a steady
    wave's decode costs at most 2 host synchronisations, as
    set_sync_debug_mode("warn") reports them; lanes past a short cap
    finish through the eager cap loop with the eager wave's tokens."""
    dec = cnr_decoder
    lists = load_bvgraph(CNR)[0]
    ra = TorchEmitRandomAccess(dec)
    sent, real = [], TorchRandomAccess.successors_batch

    def spy(self, query_nodes, cap=512, halo=0):
        sent.append(np.asarray(query_nodes))
        return real(self, query_nodes, cap, halo)

    monkeypatch.setattr(TorchRandomAccess, "successors_batch", spy)
    rng = np.random.default_rng(2147483693)
    for _ in range(6):
        ra.successors_batch(rng.integers(0, dec.num_nodes, 4096))
    monkeypatch.undo()
    assert len(sent) >= 3
    wave = TorchRandomAccess(dec, phases=(ra.states_d, ra.ptrs_d, ra.ctab))
    eager = TorchRandomAccess(dec)
    c0 = trace.counters()
    waves = 0
    for q in sent:
        got = wave.successors_batch(q, halo=ra.H)
        waves += len(wave.last_waves)
        assert all(lanes <= wave.WAVE_LANES for lanes, _ in wave.last_waves)
        want = eager.successors_batch(q, halo=ra.H)
        assert wave.last_waves == eager.last_waves
        assert np.array_equal(got.offsets, want.offsets)
        assert np.array_equal(got.succs, want.succs)
        off = lists.offsets.astype(np.int64)
        assert got.to_lists() == [lists.succs[off[x]:off[x + 1]].tolist()
                                  for x in q]
    c1 = trace.counters()
    assert c1["ra_graph_captures"] - c0.get("ra_graph_captures", 0) == 1
    assert c1["ra_wave_replays"] - c0.get("ra_wave_replays", 0) == waves - 1

    uq = np.unique(sent[0])
    segs = np.unique(wave._seg_of(np.maximum(
        uq[:, None] - np.arange(ra.H + 1), 0)))
    launches = decode_cuda.decode_blocks.launches
    got, where, syncs = _sync_warnings(
        lambda: wave._decode_segments(segs, 512))
    print(json.dumps({"wave_lanes": len(segs), "warned": len(where),
                      "host_syncs": syncs,
                      "sites": dict(collections.Counter(where))}))
    assert len(where) == syncs <= 2
    assert decode_cuda.decode_blocks.launches == launches + 1
    want = eager._decode_segments(segs, 512)
    assert got[3] == want[3]
    assert all(np.array_equal(g, w) for g, w in zip(got[:3], want[:3]))

    for _ in range(2):      # the capture at cap 8, then its replay
        got = wave._decode_segments(segs, 8)
        want = eager._decode_segments(segs, 8)
        assert got[3] == want[3] > round_cap(dec.params, 8)
        assert all(np.array_equal(g, w) for g, w in zip(got[:3], want[:3]))


@pytest.mark.cuda
def test_hc_steady_decode_makes_no_host_sync(tmp_path):
    """On the card, cnr-2000 at the high-compression configuration's store
    parameters and lanes: once the plan is verified and its CUDA graph
    captured, a steady decode under set_sync_debug_mode("error") raises
    nothing, runs decode_emit and the fixup kernel once each (counted on
    the wrapper and as fixup_kernel_launches) and gives the BV file's
    lists; the plan's stages are printed."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    base = str(tmp_path / "cnr_hc")
    store(CNR, base, **HC["store"])
    dec = TorchGraphDecoder(ANSBvGraph.load(base))
    lanes = HC["decode_lanes"]
    mark = _last_id()
    for _ in range(3):  # first call, split and verification, capture
        dec.decode_to_adjacency_device(lanes)
    pl = dec._plans[("emit", lanes)]
    assert pl.get("graph") is not None and not pl.get("emit_broken")
    for st in _since(mark, trace.stages()):
        print(json.dumps({"stage": st.name, "seconds": st.seconds,
                          **st.attrs}))
    launches = emit_cuda.decode_emit.launches
    fixups = fixup_cuda.emit_fixup.launches
    counted = trace.counters().get("fixup_kernel_launches", 0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        s2d, starts, degs = dec.decode_to_adjacency_device(lanes)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert emit_cuda.decode_emit.launches == launches + 1
    assert fixup_cuda.emit_fixup.launches == fixups + 1
    assert trace.counters()["fixup_kernel_launches"] == counted + 1
    adj = load_bvgraph(CNR)[0]
    ro = torch.from_numpy(adj.offsets.astype(np.int64)).cuda()
    rs = torch.from_numpy(adj.succs.astype(np.int64)).cuda()
    nodes = torch.arange(adj.num_nodes, device="cuda")
    assert ref_lists.count_wrong(ro, rs, nodes, starts, degs, s2d.shape[1],
                                 s2d) == 0
