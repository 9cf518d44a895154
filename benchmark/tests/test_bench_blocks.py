"""The block-parallel artifact's cell, cnr2000_blocks.decode, on the CPU:
the cell runs cnr2000's graph and store at 512 encode blocks with the
device model search; a tiny configuration stored at a few encode blocks
comes out correct through the harness, the control comes out not
correct on it, and the reader of the lanes a block
(emit_block_lanes.decode) gives None on a run without its attributes
and numbers from a planted stage and from a traced run's stages."""

import collections
import math
import time
import types

import pytest

from benchmark import control, harness, system
from benchmark import trace as bench_trace
from webgraph_ans_torch.utils import trace

from conftest import TINY_DECODE

CELL = "cnr2000_blocks.decode"
READER = "emit_block_lanes.decode"
TINY_BLOCKS = {"name": "tiny_blocks",
               "graph": {"kind": "synth", "nodes": 600, "seed": 7},
               "nodes": 600, "arcs": 5989,
               "store": {"compression_window": 7, "max_ref_count": 3,
                         "min_interval_length": 2, "encode_blocks": 4,
                         "use_tpu_model_search": True, "device": "cpu"},
               "decode_lanes": 32}


def run_cell(make_system, cache, traced=False):
    return harness.run(CELL, 2**31 + 37, 0.01, traced,
                       t0=time.perf_counter(), cfg=TINY_BLOCKS,
                       mix=TINY_DECODE, device="cpu", cache_root=cache,
                       make_system=make_system)


def test_the_cell_uses_the_configuration():
    spec = harness.load_spec()
    cell = harness.find(spec["workloads"], CELL, "workload")
    cfg = harness.load_config(cell["config"])
    base = harness.load_config("cnr2000")
    assert cfg["store"] == {**base["store"], "encode_blocks": 512,
                            "use_tpu_model_search": True}
    assert cfg["graph"] == base["graph"] and cfg["reduced"] == []
    assert (cfg["nodes"], cfg["arcs"]) == (base["nodes"], base["arcs"])
    assert cfg["decode_lanes"] == 2048 and cell["traffic"] == "decode_full"
    assert cell["chips"] == 1
    names = [m["name"] for m in harness.cell_metrics(spec, CELL, True)]
    for name in (READER, "emit_fixup_rounds.decode", "emit_dirty_nodes.decode",
                 "emit_empty_lanes.decode", "post_ms.decode",
                 "decode_emit_roofline.decode", "emit_plan_s"):
        assert name in names
    (m,) = [m for m in spec["per_layer"] if m["name"] == READER]
    assert m["workloads"] == [CELL] and m["moves"] == "decode_ns_per_arc"
    assert "decode_ns_per_arc" in [
        m["name"] for m in harness.cell_metrics(spec, CELL, False)]


def test_block_run_is_correct(tiny_cache):
    res = run_cell(system.PortSystem, tiny_cache)
    assert res["correct"], res["checks"]
    assert res["checks"]["answers_checked"]["value"] >= 2


def test_control_is_not_correct(tiny_cache):
    res = run_cell(control.ControlSystem, tiny_cache)
    assert not res["correct"]
    assert res["checks"]["wrong_lists"]["value"] > 0


def _stage(name, start, attrs):
    s = trace.Span(name, dict(attrs), None)
    s.id, s.parent, s.call, s.syncs = 1, None, 1, 0
    s.start, s.end = round(start * 1e9), round((start + 0.1) * 1e9)
    return s


def _run(stages, monkeypatch, peak=1):
    monkeypatch.setattr(trace, "_stages", collections.deque(stages))
    spans = types.SimpleNamespace(items=[
        {"name": "cold_decode", "start": 1.0, "end": 2.0}])
    return types.SimpleNamespace(entry="decode", peak_bytes=peak,
                                 spans=spans, arcs=2000, trace=None)


FULL = {"lanes": 2048, "empty_lanes": 32, "encode_blocks": 512,
        "fixup_rounds": 3, "dirty_nodes": 40}


def test_reader_takes_the_newest_verified_layout(monkeypatch):
    run = _run([_stage("plan.verify", 1.2, {**FULL, "empty_lanes": 1536}),
                _stage("plan.verify", 1.5, FULL),
                # a plan verified outside the warm-up is not read
                _stage("plan.verify", 2.5, {**FULL, "empty_lanes": 0})],
               monkeypatch)
    assert math.isclose(harness.load_reader(READER)(run), 2016 / 512)


@pytest.mark.parametrize("case", ["no attributes", "serial artifact",
                                  "off the card", "other entry",
                                  "no stage"])
def test_reader_gives_none(case, monkeypatch):
    # the parent's plan.verify stage: the layout without encode_blocks
    old = {k: v for k, v in FULL.items() if k != "encode_blocks"}
    run = _run([_stage("plan.verify", 1.5, old)], monkeypatch)
    if case == "serial artifact":
        run = _run([_stage("plan.verify", 1.5, {**FULL, "encode_blocks": 0})],
                   monkeypatch)
    elif case == "off the card":
        run = _run([_stage("plan.verify", 1.5, FULL)], monkeypatch, None)
    elif case == "other entry":
        run = _run([_stage("plan.verify", 1.5, FULL)], monkeypatch)
        run.entry = "query"
    elif case == "no stage":
        run = _run([], monkeypatch)
    assert harness.load_reader(READER)(run) is None


class KeptSpans(bench_trace.Spans):
    """The benchmark's spans of the last run, kept for the test."""

    last = None

    def __init__(self):
        super().__init__()
        KeptSpans.last = self


def test_traced_cpu_run_reads_the_plan(tiny_cache, monkeypatch):
    """A whole traced CPU run leaves the reader's metric out (off the
    card); on its recorded spans and the port's stages the reader gives
    the verified plan's lanes a block: more than one, within the lanes
    over the blocks."""
    monkeypatch.setattr(bench_trace, "Spans", KeptSpans)
    real = bench_trace.read_chrome_trace

    def reader(path, *args, **kw):
        try:
            return real(path, *args, **kw)
        except ValueError:      # a CPU trace has no device side
            return {"window_s": 1.0, "busy_s": 0.0, "device_s": {},
                    "device_total_s": 0.0, "idle": {}}

    monkeypatch.setattr(bench_trace, "read_chrome_trace", reader)
    res = run_cell(system.PortSystem, tiny_cache, traced=True)
    assert res["correct"], res["checks"]
    assert READER not in res["metrics"]
    run = types.SimpleNamespace(entry="decode", peak_bytes=1,
                                spans=KeptSpans.last, arcs=5989, trace=None)
    got = harness.load_reader(READER)(run)
    assert 1 < got <= TINY_BLOCKS["decode_lanes"] / 4
