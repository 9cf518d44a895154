"""The high-compression cell, cnr2000hc.decode, on the CPU: a tiny
configuration at its store parameters (window 16, unbounded chains,
min_interval 4) with safe breaks every 16 nodes comes out correct through
the harness, the control comes out not correct on it, and the readers of
the verified plan's layout (emit_fixup_rounds.decode,
emit_dirty_nodes.decode, emit_empty_lanes.decode) give None on a run
without its attributes and numbers from a traced run's stages."""

import collections
import math
import sys
import time
import types

import pytest

import webgraph_ans_torch.utils
from benchmark import control, harness, system
from benchmark import trace as bench_trace
from webgraph_ans_torch.utils import trace

from conftest import TINY_DECODE

CELL = "cnr2000hc.decode"
TINY_HC = {"name": "tiny_hc", "graph": {"kind": "synth", "nodes": 600,
                                        "seed": 7},
           "nodes": 600, "arcs": 5989,
           "store": {"compression_window": 16,
                     "max_ref_count": 2000000000,
                     "min_interval_length": 4, "safe_break_interval": 16},
           "decode_lanes": 64}
LAYOUT = ["emit_fixup_rounds.decode", "emit_dirty_nodes.decode",
          "emit_empty_lanes.decode"]


def run_cell(make_system, cache, traced=False):
    return harness.run(CELL, 2**31 + 29, 0.01, traced,
                       t0=time.perf_counter(), cfg=TINY_HC,
                       mix=TINY_DECODE, device="cpu", cache_root=cache,
                       make_system=make_system)


def test_the_cell_uses_the_configuration():
    spec = harness.load_spec()
    cell = harness.find(spec["workloads"], CELL, "workload")
    cfg = harness.load_config(cell["config"])
    assert cfg["store"] == {**TINY_HC["store"], "safe_break_interval": 128}
    assert cfg["decode_lanes"] == 1024 and cell["traffic"] == "decode_full"
    for name in LAYOUT:
        assert name in [m["name"] for m in
                        harness.cell_metrics(spec, CELL, True)]


def test_unbroken_run_is_correct(tiny_cache):
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
        {"name": "cold_decode", "start": 1.0, "end": 2.0},
        {"name": "decode", "start": 3.0, "end": 3.1, "traced": True}])
    return types.SimpleNamespace(entry="decode", peak_bytes=peak,
                                 spans=spans)


FULL = {"lanes": 8, "fixup_rounds": 3, "dirty_nodes": 40, "empty_lanes": 2}


def test_readers_take_the_newest_verified_layout(monkeypatch):
    run = _run([_stage("plan.verify", 1.2, {**FULL, "fixup_rounds": 9}),
                _stage("plan.verify", 1.5, FULL),
                # a plan verified outside the warm-up is not read
                _stage("plan.verify", 2.5, {**FULL, "dirty_nodes": 7})],
               monkeypatch)
    got = {n: harness.load_reader(n)(run) for n in LAYOUT}
    assert got["emit_fixup_rounds.decode"] == 3
    assert got["emit_dirty_nodes.decode"] == 40
    assert math.isclose(got["emit_empty_lanes.decode"], 25.0)


@pytest.mark.parametrize("name", LAYOUT)
@pytest.mark.parametrize("case", ["no attributes", "off the card",
                                  "other entry", "no stage",
                                  "no trace module"])
def test_readers_give_none(name, case, monkeypatch):
    # the parent's plan.verify stage: the lane count alone
    run = _run([_stage("plan.verify", 1.5, {"lanes": 8}),
                _stage("plan.safe", 1.4, {})], monkeypatch)
    if case == "off the card":
        run = _run([_stage("plan.verify", 1.5, FULL)], monkeypatch, None)
    elif case == "other entry":
        run = _run([_stage("plan.verify", 1.5, FULL)], monkeypatch)
        run.entry = "query"
    elif case == "no stage":
        run = _run([], monkeypatch)
    elif case == "no trace module":
        run = _run([_stage("plan.verify", 1.5, FULL)], monkeypatch)
        monkeypatch.delattr(webgraph_ans_torch.utils, "trace")
        monkeypatch.setitem(sys.modules, "webgraph_ans_torch.utils.trace",
                            None)
    assert harness.load_reader(name)(run) is None


class KeptSpans(bench_trace.Spans):
    """The benchmark's spans of the last run, kept for the test."""

    last = None

    def __init__(self):
        super().__init__()
        KeptSpans.last = self


def test_traced_cpu_run_reads_the_plan(tiny_cache, monkeypatch):
    """A whole traced CPU run leaves the layout metrics out (off the
    card); on its recorded spans and the port's stages the readers give
    the verified plan's layout."""
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
    assert not set(LAYOUT) & set(res["metrics"])
    run = types.SimpleNamespace(entry="decode", peak_bytes=1,
                                spans=KeptSpans.last)
    got = {n: harness.load_reader(n)(run) for n in LAYOUT}
    assert got["emit_fixup_rounds.decode"] >= 0
    assert got["emit_dirty_nodes.decode"] >= got["emit_fixup_rounds.decode"]
    assert 0 <= got["emit_empty_lanes.decode"] < 100
