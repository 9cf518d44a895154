"""The reference's own high-compression cell, cnr2000hcref.decode, on the
CPU: a tiny configuration at its store parameters (window 16, unbounded
chains, min_interval 4, no safe breaks) comes out correct through the
harness, the control comes out not correct on it, and the readers of the
fixup's layout (emit_dirty_arcs.decode, emit_unsafe_cuts.decode,
fixup_roofline.decode, all three through benchmark/fixup_layout.py) give
None on a run without their attributes and numbers from a traced run's
stages."""

import collections
import math
import sys
import time
import types

import pytest

import webgraph_ans_torch.utils
from benchmark import control, fixup_layout, harness, roofline, system
from benchmark import trace as bench_trace
from webgraph_ans_torch.utils import trace

from conftest import TINY_DECODE

CELL = "cnr2000hcref.decode"
TINY_HCREF = {"name": "tiny_hcref", "graph": {"kind": "synth", "nodes": 600,
                                              "seed": 7},
              "nodes": 600, "arcs": 5989,
              "store": {"compression_window": 16,
                        "max_ref_count": 2000000000,
                        "min_interval_length": 4},
              "decode_lanes": 64}
READERS = ["emit_dirty_arcs.decode", "emit_unsafe_cuts.decode",
           "fixup_roofline.decode"]
DECODE_CELLS = ["cnr2000.decode", "cnr2000hc.decode", CELL]


def run_cell(make_system, cache, traced=False):
    return harness.run(CELL, 2**31 + 31, 0.01, traced,
                       t0=time.perf_counter(), cfg=TINY_HCREF,
                       mix=TINY_DECODE, device="cpu", cache_root=cache,
                       make_system=make_system)


def test_the_cell_uses_the_configuration():
    spec = harness.load_spec()
    cell = harness.find(spec["workloads"], CELL, "workload")
    cfg = harness.load_config(cell["config"])
    hc = harness.load_config("cnr2000hc")
    assert cfg["store"] == TINY_HCREF["store"]
    assert "safe_break_interval" not in cfg["store"]
    assert {k: v for k, v in hc["store"].items()
            if k != "safe_break_interval"} == cfg["store"]
    assert cfg["graph"] == hc["graph"] and cfg["reduced"] == []
    assert cfg["decode_lanes"] == 1024 and cell["traffic"] == "decode_full"
    assert cell["chips"] == 1
    names = [m["name"] for m in harness.cell_metrics(spec, CELL, True)]
    for name in READERS + ["emit_fixup_rounds.decode",
                           "emit_dirty_nodes.decode", "post_ms.decode"]:
        assert name in names
    for name in READERS:
        (m,) = [m for m in spec["per_layer"] if m["name"] == name]
        assert m["workloads"] == DECODE_CELLS
    assert "decode_ns_per_arc" in [
        m["name"] for m in harness.cell_metrics(spec, CELL, False)]


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
    tr = {"ops": 4, "device_s": {"void emit_fixup_kernel(int*)": 2e-3,
                                 "decode_emit_kernel_16_": 0.02}}
    return types.SimpleNamespace(entry="decode", peak_bytes=peak,
                                 spans=spans, arcs=2000, trace=tr)


FULL = {"lanes": 8, "fixup_rounds": 3, "dirty_nodes": 40, "empty_lanes": 0,
        "dirty_elements": 500, "unsafe_cuts": 2}


def test_readers_take_the_newest_verified_layout(monkeypatch):
    run = _run([_stage("plan.verify", 1.2, {**FULL, "unsafe_cuts": 6}),
                _stage("plan.verify", 1.5, FULL),
                # a plan verified outside the warm-up is not read
                _stage("plan.verify", 2.5, {**FULL, "dirty_elements": 7})],
               monkeypatch)
    got = {n: harness.load_reader(n)(run) for n in READERS}
    assert math.isclose(got["emit_dirty_arcs.decode"], 25.0)
    assert math.isclose(got["emit_unsafe_cuts.decode"], 25.0)
    # 40 nodes x 20 B + 500 elements x 12 B over HBM, over 0.5 ms a decode
    bound = (40 * 20 + 500 * 12) / roofline.HBM_BYTES_PER_S
    assert math.isclose(got["fixup_roofline.decode"], 100 * bound / 5e-4)
    assert fixup_layout.fixup_bytes(40, 500) == 6800


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("case", ["no attributes", "off the card",
                                  "other entry", "no stage",
                                  "no trace module"])
def test_readers_give_none(name, case, monkeypatch):
    # the parent's plan.verify stage: the layout without the new keys
    old = {k: v for k, v in FULL.items()
           if k not in ("dirty_elements", "unsafe_cuts")}
    run = _run([_stage("plan.verify", 1.5, old),
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


def test_roofline_gives_none_without_the_fixup_kernel(monkeypatch):
    """A layout with no dirty node launches no fixup: the trace shows no
    such kernel, and the roofline reads nothing."""
    run = _run([_stage("plan.verify", 1.5, FULL)], monkeypatch)
    del run.trace["device_s"]["void emit_fixup_kernel(int*)"]
    assert harness.load_reader("fixup_roofline.decode")(run) is None


class KeptSpans(bench_trace.Spans):
    """The benchmark's spans of the last run, kept for the test."""

    last = None

    def __init__(self):
        super().__init__()
        KeptSpans.last = self


def test_traced_cpu_run_reads_the_plan(tiny_cache, monkeypatch):
    """A whole traced CPU run leaves the layout metrics out (off the
    card); on its recorded spans and the port's stages the readers of the
    layout give the verified plan's dirty arcs and unsafe cuts."""
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
    assert not set(READERS) & set(res["metrics"])
    run = types.SimpleNamespace(entry="decode", peak_bytes=1,
                                spans=KeptSpans.last, arcs=5989,
                                trace={"ops": 1, "device_s": {}})
    got = {n: harness.load_reader(n)(run) for n in READERS}
    assert 0 < got["emit_dirty_arcs.decode"] <= 100
    assert 0 <= got["emit_unsafe_cuts.decode"] <= 100
    assert got["fixup_roofline.decode"] is None
