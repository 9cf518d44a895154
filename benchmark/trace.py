"""The benchmark's spans and its reading of a torch.profiler trace.

Spans are kept in memory: name, start and end on the host clock, the
index of the span that caused them, and a few attributes. In the traced
window each span is also a `torch.profiler.record_function` range named
`bench.<name>`, so that the profiler's timeline says which span the host
was in when the card sat idle.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import re
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10


class Spans:
    """Spans of one run, in the order they opened."""

    def __init__(self):
        self.items: list[dict] = []
        self.annotate = False     # also open a record_function range

    @contextlib.contextmanager
    def __call__(self, name: str, parent: int | None = None, **attrs):
        rec = {"name": name, "parent": parent, **attrs}
        self.items.append(rec)
        index = len(self.items) - 1
        ctx = (torch.profiler.record_function("bench." + name)
               if self.annotate else contextlib.nullcontext())
        with ctx:
            rec["start"] = time.perf_counter()
            try:
                yield index
            finally:
                rec["end"] = time.perf_counter()

    def add(self, name: str, seconds: float, parent: int | None = None,
            **attrs):
        """A span that the program timed itself (its own record of a
        round or a wave decode): its length, without a start."""
        self.items.append({"name": name, "parent": parent,
                           "seconds": seconds, **attrs})

    def seconds(self, name: str) -> list[float]:
        """The lengths of the spans called `name`, in order."""
        return [s["end"] - s["start"] if "end" in s else s["seconds"]
                for s in self.items if s["name"] == name]

    def dump(self, path: str):
        with open(path, "w") as f:
            for s in self.items:
                f.write(json.dumps(s) + "\n")


def short_name(name: str) -> str:
    """A kernel's or operator's name without its parameter list and
    return type, at most 100 characters."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    return name[:cut][:100]


def _merge(intervals):
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def _innermost(starts, events, t):
    """The name of the latest-starting event of `events` (sorted by
    start) that covers time t, or None."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 400, -1), -1):
        ts, end, name = events[j]
        if end >= t:
            return name
    return None


def read_chrome_trace(path: str, window: str = "bench.window") -> dict:
    """Reduces a chrome trace exported by torch.profiler to what the
    readers use, over the host range called `window`:
    - window_s: the range's length; busy_s: the union of device
      activity (kernels, copies, fills) inside it;
    - device_s: device seconds by short operation name, and the total;
    - idle: the idle seconds of the card, summed by what the host was in
      when each gap began (`<benchmark span>/<innermost host event>`).
    Raises when the trace holds no such range or no device activity."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X"]
    win = [e for e in spans if e.get("name") == window
           and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError(f"the trace has no {window!r} range")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    device, by_name = [], {}
    for e in spans:
        if e.get("cat") not in DEVICE_CATS:
            continue
        lo, hi = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        lo, hi = max(lo, w0), min(hi, w1)
        if hi <= lo:
            continue
        device.append((lo, hi))
        key = short_name(e.get("name", "?"))
        by_name[key] = by_name.get(key, 0.0) + (hi - lo) * 1e-6
    if not device:
        raise ValueError("the trace holds no device activity in the window")
    busy = _merge(device)
    busy_s = sum(hi - lo for lo, hi in busy) * 1e-6
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                   e.get("name", "?")) for e in spans
                  if e.get("cat") in HOST_CATS and e.get("name") != window)
    bench = [h for h in host if h[2].startswith("bench.")]
    host_starts = [h[0] for h in host]
    bench_starts = [h[0] for h in bench]
    idle, edge = {}, w0
    for lo, hi in busy + [[w1, w1]]:
        if lo > edge:
            where = _innermost(bench_starts, bench, edge) or window
            what = _innermost(host_starts, host, edge)
            label = short_name(where[len("bench."):] if where.startswith(
                "bench.") else where)
            if what and what != where:
                label += "/" + short_name(what)
            idle[label] = idle.get(label, 0.0) + (lo - edge) * 1e-6
        edge = max(edge, hi)
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_s,
            "device_s": by_name, "device_total_s": sum(by_name.values()),
            "idle": idle}


def breakdown(tr: dict) -> dict:
    """The traced run's `breakdown`: the device operations that took most
    time and the idle time by what the host was doing, at most TOP each."""
    ops = sorted(tr["device_s"].items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(tr["idle"].items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in idle]}


def kernel_seconds(tr: dict, kernel: str) -> float | None:
    """Device seconds of the kernels whose name holds `kernel` (None when
    the trace shows none)."""
    hits = [v for k, v in tr["device_s"].items() if kernel in k]
    return sum(hits) if hits else None
