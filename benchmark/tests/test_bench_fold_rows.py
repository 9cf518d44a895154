"""The reader of the merged-emit kernel's folded rows,
emit_fold_rows.decode: 100 x fold_rows over rows_mean x lanes of the
newest plan.verify stage inside the warm-up decodes
(benchmark/fixup_layout.py), declared for the four decode cells, and None
off the card, on another entry, without the stage or its new attribute
(the stage of a program that records none), without rows, or without
the port's trace module."""

import collections
import math
import sys
import types

import pytest

import webgraph_ans_torch.utils
from benchmark import harness
from webgraph_ans_torch.utils import trace

NAME = "emit_fold_rows.decode"
DECODE_CELLS = ["cnr2000.decode", "cnr2000hc.decode", "cnr2000hcref.decode",
                "cnr2000_blocks.decode"]
LAYOUT = {"lanes": 8, "fixup_rounds": 3, "dirty_nodes": 40,
          "dirty_elements": 500, "two_run_rows": 36, "empty_lanes": 0,
          "rows_max": 150, "rows_mean": 125.0, "fold_rows": 400,
          "steps_max": 120, "steps_mean": 75.0}


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
    assert m["moves"] == "decode_ns_per_arc"
    assert m["layer"] == "merged-emit kernel"
    assert m["source"] == "program_counter" and m["unit"] == "%"
    assert m["better"] == "higher"
    for cell in DECODE_CELLS:
        assert NAME in [x["name"]
                        for x in harness.cell_metrics(spec, cell, True)]
    assert NAME not in [x["name"] for x in harness.cell_metrics(
        spec, "cnr2000.query_uniform", True)]


def test_reads_the_newest_verified_layout(monkeypatch):
    run = _run([_stage("plan.verify", 1.2, {**LAYOUT, "fold_rows": 10}),
                _stage("plan.verify", 1.5, LAYOUT),
                # a plan verified outside the warm-up is not read
                _stage("plan.verify", 2.5, {**LAYOUT, "fold_rows": 0})],
               monkeypatch)
    assert math.isclose(harness.load_reader(NAME)(run), 40.0)


@pytest.mark.parametrize("case", ["no attribute", "off the card",
                                  "other entry", "no stage",
                                  "no trace module", "no rows"])
def test_reader_gives_none(case, monkeypatch):
    # the parent's plan.verify stage: the layout without the fold's counts
    old = {k: v for k, v in LAYOUT.items()
           if k not in ("fold_rows", "steps_max", "steps_mean")}
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
    elif case == "no rows":
        run = _run([_stage("plan.verify", 1.5, {**LAYOUT, "rows_mean": 0.0})],
                   monkeypatch)
    assert harness.load_reader(NAME)(run) is None
