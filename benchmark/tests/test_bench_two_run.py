"""The reader of the fixup layout's two-run share,
fixup_two_run_rows.decode: 100 x two_run_rows / dirty_nodes of the
newest plan.verify stage inside the warm-up decodes
(benchmark/fixup_layout.py), declared for the three decode cells, and
None off the card, on another entry, without the stage or its new
attribute (the stage of a program that records none), without dirty
nodes, or without the port's trace module."""

import collections
import math
import sys
import types

import pytest

import webgraph_ans_torch.utils
from benchmark import harness
from webgraph_ans_torch.utils import trace

NAME = "fixup_two_run_rows.decode"
DECODE_CELLS = ["cnr2000.decode", "cnr2000hc.decode", "cnr2000hcref.decode"]
LAYOUT = {"lanes": 8, "fixup_rounds": 3, "dirty_nodes": 40,
          "dirty_elements": 500, "two_run_rows": 36, "empty_lanes": 0}


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
                                 spans=spans, arcs=2000)


def test_the_metric_is_declared_for_the_decode_cells():
    spec = harness.load_spec()
    (m,) = [m for m in spec["per_layer"] if m["name"] == NAME]
    assert m["workloads"] == DECODE_CELLS
    assert m["moves"] == "decode_ns_per_arc" and m["layer"] == "post-pass"
    assert m["source"] == "program_counter" and m["unit"] == "%"
    for cell in DECODE_CELLS:
        assert NAME in [x["name"]
                        for x in harness.cell_metrics(spec, cell, True)]
    assert NAME not in [x["name"] for x in harness.cell_metrics(
        spec, "cnr2000.query_uniform", True)]


def test_reads_the_newest_verified_layout(monkeypatch):
    run = _run([_stage("plan.verify", 1.2, {**LAYOUT, "two_run_rows": 4}),
                _stage("plan.verify", 1.5, LAYOUT),
                # a plan verified outside the warm-up is not read
                _stage("plan.verify", 2.5, {**LAYOUT, "two_run_rows": 0})],
               monkeypatch)
    assert math.isclose(harness.load_reader(NAME)(run), 90.0)


@pytest.mark.parametrize("case", ["no attribute", "off the card",
                                  "other entry", "no stage",
                                  "no trace module", "no dirty nodes"])
def test_reader_gives_none(case, monkeypatch):
    # the parent's plan.verify stage: the layout without two_run_rows
    old = {k: v for k, v in LAYOUT.items() if k != "two_run_rows"}
    run = _run([_stage("plan.verify", 1.5, old)], monkeypatch)
    if case == "off the card":
        run = _run([_stage("plan.verify", 1.5, LAYOUT)], monkeypatch, None)
    elif case == "other entry":
        run = _run([_stage("plan.verify", 1.5, LAYOUT)], monkeypatch)
        run.entry = "query"
    elif case == "no stage":
        run = _run([_stage("plan.safe", 1.4, {})], monkeypatch)
    elif case == "no trace module":
        run = _run([_stage("plan.verify", 1.5, LAYOUT)], monkeypatch)
        monkeypatch.delattr(webgraph_ans_torch.utils, "trace")
        monkeypatch.setitem(sys.modules, "webgraph_ans_torch.utils.trace",
                            None)
    elif case == "no dirty nodes":
        run = _run([_stage("plan.verify", 1.5, {**LAYOUT, "dirty_nodes": 0,
                                                "two_run_rows": 0})],
                   monkeypatch)
    assert harness.load_reader(NAME)(run) is None
