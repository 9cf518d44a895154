"""The per-layer metrics that read the port's own spans, stages and
counters (webgraph_ans_torch.utils.trace): each reader on synthetic runs
and span lists, None off the card, on the other entry and without the
port's trace module; then whole traced CPU runs of the tiny configuration,
which report each of them or nothing, and whose recorded spans the readers
turn into numbers."""

import collections
import math
import sys
import types

import pytest

import webgraph_ans_torch.utils
from benchmark import harness
from benchmark import trace as bench_trace
from webgraph_ans_torch.utils import trace

from conftest import TINY, TINY_DECODE, TINY_QUERY

QUERY = ["ra_host_ms.query", "ra_fetch_ms.query", "ra_syncs.query",
         "ra_captures.query"]
DECODE = ["emit_plan_spans_s.decode", "decode_host_us.decode",
          "decode_syncs.decode"]
CELLS = {"decode": ("cnr2000.decode", TINY_DECODE),
         "query": ("cnr2000.query_uniform", TINY_QUERY)}


def rec(name, id_, start, end, parent=None, call=None, syncs=0):
    """A recorded span or stage, times in seconds."""
    s = trace.Span(name, {}, None)
    s.id, s.parent, s.call, s.syncs = id_, parent, call or id_, syncs
    s.start, s.end = round(start * 1e9), round(end * 1e9)
    return s


def bench(*items):
    return types.SimpleNamespace(items=[
        {"name": n, "start": a, "end": b, **attrs}
        for n, a, b, attrs in items])


@pytest.fixture
def recorded(monkeypatch):
    """Replaces the port's recorded spans and stages with given lists."""
    def put(spans=(), stages=()):
        monkeypatch.setattr(trace, "_spans", collections.deque(spans))
        monkeypatch.setattr(trace, "_stages", collections.deque(stages))
    return put


def run_of(entry, spans, peak=1):
    return types.SimpleNamespace(entry=entry, peak_bytes=peak, spans=spans)


def read(name, run):
    return harness.load_reader(name)(run)


QUERY_SPANS = [
    # a batch before the traced window (not read)
    rec("ra.batch", 1, 0.5, 0.6, syncs=99),
    # two batches in it: 10 ms with 4 ms of fetches, 20 ms with 2 ms
    rec("fetch", 3, 10.002, 10.004, parent=2, call=2, syncs=1),
    rec("ra.round", 4, 10.001, 10.009, parent=2, call=2, syncs=3),
    rec("fetch", 5, 10.005, 10.007, parent=4, call=2, syncs=1),
    rec("ra.batch", 2, 10.0, 10.010, syncs=9),
    rec("fetch", 7, 11.010, 11.012, parent=6, call=6, syncs=1),
    rec("ra.batch", 6, 11.0, 11.020, syncs=13),
]
QUERY_ITEMS = [("batch", 0.4, 0.7, {"warmup": True}),
               ("batch", 5.0, 5.1, {}), ("batch", 6.0, 6.1, {}),
               ("batch", 9.99, 10.02, {"traced": True}),
               ("batch", 10.99, 11.03, {"traced": True})]
QUERY_BENCH = bench(*QUERY_ITEMS)


@pytest.mark.parametrize("name,want", [
    ("ra_host_ms.query", (6 + 18) / 2), ("ra_fetch_ms.query", (4 + 2) / 2),
    ("ra_syncs.query", (9 + 13) / 2)])
def test_batch_readers_average_the_traced_window(name, want, recorded):
    recorded(QUERY_SPANS)
    assert math.isclose(read(name, run_of("query", QUERY_BENCH)), want,
                        rel_tol=1e-6)


def test_captures_count_those_in_the_measured_window(recorded):
    caps = [rec("ra.capture", 10 + i, t, t + 0.01)
            for i, t in enumerate((0.45, 5.05, 6.02, 6.5, 10.0))]
    recorded(stages=caps + [rec("plan.capture", 20, 5.06, 5.07)])
    assert read("ra_captures.query", run_of("query", QUERY_BENCH)) == 2
    recorded()
    assert read("ra_captures.query", run_of("query", QUERY_BENCH)) == 0


def test_plan_stages_sum_once_over_set_up(recorded):
    stages = [rec("plan.first", 1, 0.1, 0.6),
              rec("cap.grow", 2, 0.2, 0.3, parent=1, call=1),
              rec("plan.safe", 3, 0.6, 0.9),
              rec("plan.capture", 5, 2.0, 2.25),
              rec("plan.fallback", 6, 2.1, 2.2, parent=5, call=5),
              rec("kernel.build", 7, 0.05, 0.08),
              rec("plan.first", 8, 30.0, 31.0)]
    recorded(stages=stages)
    spans = bench(("cold_decode", 0.0, 1.0, {"index": 0}),
                  ("cold_decode", 1.9, 2.3, {"index": 1}),
                  ("decode", 30.0, 31.5, {"index": 0}))
    assert math.isclose(read("emit_plan_spans_s.decode",
                             run_of("decode", spans)), 0.5 + 0.3 + 0.25,
                        rel_tol=1e-6)


def test_decode_readers_take_the_steady_calls(recorded):
    recorded([
        rec("decode.steady", 2, 20.0001, 20.0002, parent=1, call=1),
        rec("decode", 1, 20.0, 20.0003),
        rec("decode.steady", 4, 20.0101, 20.0104, parent=3, call=3),
        rec("decode", 3, 20.01, 20.0105),
        # a call that planned (no steady span) is not read
        rec("decode", 5, 20.02, 20.5, syncs=40),
        # nor a steady call outside the traced window
        rec("decode.steady", 7, 3.0, 3.5, parent=6, call=6),
        rec("decode", 6, 3.0, 3.6, syncs=7)])
    spans = bench(("decode", 19.99, 20.006, {"traced": True}),
                  ("decode", 20.0099, 20.6, {"traced": True}))
    run = run_of("decode", spans)
    assert math.isclose(read("decode_host_us.decode", run), 200.0,
                        rel_tol=1e-6)
    assert read("decode_syncs.decode", run) == 0


@pytest.mark.parametrize("name", QUERY + DECODE)
@pytest.mark.parametrize("case", ["off the card", "other entry", "no spans",
                                  "no trace module"])
def test_readers_give_none(name, case, recorded, monkeypatch):
    recorded(QUERY_SPANS, [rec("plan.first", 30, 0.1, 0.2),
                           rec("ra.capture", 31, 5.01, 5.02)])
    entry = "query" if name in QUERY else "decode"
    spans = bench(*QUERY_ITEMS, ("cold_decode", 0.0, 1.0, {}),
                  ("decode", 10.0, 10.1, {"traced": True}))
    run = run_of(entry, spans)
    if case == "off the card":
        run.peak_bytes = None
    elif case == "other entry":
        run.entry = "decode" if entry == "query" else "query"
    elif case == "no spans":
        run.spans = bench()
    else:
        monkeypatch.delattr(webgraph_ans_torch.utils, "trace")
        monkeypatch.setitem(sys.modules, "webgraph_ans_torch.utils.trace",
                            None)
    assert read(name, run) is None


class KeptSpans(bench_trace.Spans):
    """The benchmark's spans of the last run, kept for the test."""

    last = None

    def __init__(self):
        super().__init__()
        KeptSpans.last = self


def _cpu_trace(read_chrome_trace):
    """The trace reader, with a CPU trace's empty device side."""
    def reader(path, *args, **kw):
        try:
            return read_chrome_trace(path, *args, **kw)
        except ValueError:
            return {"window_s": 1.0, "busy_s": 0.0, "device_s": {},
                    "device_total_s": 0.0, "idle": {}}
    return reader


@pytest.mark.parametrize("entry", ["decode", "query"])
def test_traced_cpu_run_reports_nothing_and_raises_nothing(
        entry, tiny_cache, monkeypatch):
    """A whole traced run on the CPU: the new metrics are left out (off
    the card); the port's spans of the traced window are there, and the
    readers make numbers of them."""
    cell, mix = CELLS[entry]
    monkeypatch.setattr(bench_trace, "Spans", KeptSpans)
    monkeypatch.setattr(bench_trace, "read_chrome_trace",
                        _cpu_trace(bench_trace.read_chrome_trace))
    res = harness.run(cell, 2147483659, 0.01, True, t0=0.0, cfg=TINY,
                      mix=mix, device="cpu", cache_root=tiny_cache)
    assert res["correct"], res["checks"]
    names = QUERY if entry == "query" else DECODE
    assert not set(names) & set(res["metrics"])
    got = {n: read(n, run_of(entry, KeptSpans.last)) for n in names}
    assert all(v is not None and v >= 0 for v in got.values()), got
    if entry == "query":
        assert got["ra_syncs.query"] >= 2 and got["ra_captures.query"] == 0
        assert got["ra_host_ms.query"] > 0 and got["ra_fetch_ms.query"] > 0
    else:
        assert got["decode_syncs.decode"] == 0
        assert got["emit_plan_spans_s.decode"] > 0
        assert got["decode_host_us.decode"] > 0
