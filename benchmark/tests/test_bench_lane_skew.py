"""The reader of the verified plan's lane skew, emit_lane_skew.decode:
100 x (rows_max / rows_mean - 1) of the newest plan.verify stage inside
the warm-up decodes, and None off the card, on another entry, without
the stage or its attributes (the stage of a program that records none),
or without the port's trace module."""

import collections
import math
import sys
import types

import pytest

import webgraph_ans_torch.utils
from benchmark import harness
from webgraph_ans_torch.utils import trace

NAME = "emit_lane_skew.decode"
ROWS = {"lanes": 8, "fixup_rounds": 3, "dirty_nodes": 40, "empty_lanes": 0,
        "rows_max": 150, "rows_mean": 120.0}


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


def test_the_metric_is_declared_for_both_decode_cells():
    spec = harness.load_spec()
    (m,) = [m for m in spec["per_layer"] if m["name"] == NAME]
    assert m["workloads"] == ["cnr2000.decode", "cnr2000hc.decode"]
    assert m["moves"] == "decode_ns_per_arc" and m["layer"] == "emit planner"


def test_reads_the_newest_verified_plan(monkeypatch):
    run = _run([_stage("plan.verify", 1.2, {**ROWS, "rows_max": 400}),
                _stage("plan.verify", 1.5, ROWS),
                # a plan verified outside the warm-up is not read
                _stage("plan.verify", 2.5, {**ROWS, "rows_max": 999})],
               monkeypatch)
    assert math.isclose(harness.load_reader(NAME)(run), 25.0)


@pytest.mark.parametrize("case", ["no attributes", "off the card",
                                  "other entry", "no stage",
                                  "no trace module", "no rows"])
def test_reader_gives_none(case, monkeypatch):
    # the parent's plan.verify stage: the layout without the rows
    layout = {k: v for k, v in ROWS.items() if not k.startswith("rows")}
    run = _run([_stage("plan.verify", 1.5, layout)], monkeypatch)
    if case == "off the card":
        run = _run([_stage("plan.verify", 1.5, ROWS)], monkeypatch, None)
    elif case == "other entry":
        run = _run([_stage("plan.verify", 1.5, ROWS)], monkeypatch)
        run.entry = "query"
    elif case == "no stage":
        run = _run([_stage("plan.safe", 1.4, {})], monkeypatch)
    elif case == "no trace module":
        run = _run([_stage("plan.verify", 1.5, ROWS)], monkeypatch)
        monkeypatch.delattr(webgraph_ans_torch.utils, "trace")
        monkeypatch.setitem(sys.modules, "webgraph_ans_torch.utils.trace",
                            None)
    elif case == "no rows":
        run = _run([_stage("plan.verify", 1.5, {**ROWS, "rows_mean": 0.0})],
                   monkeypatch)
    assert harness.load_reader(NAME)(run) is None
