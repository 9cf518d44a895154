"""Spans, stages and counters of the port's host work, kept in memory and
read beside a torch.profiler trace.

- `span(name, **attrs)`: a stretch of one public call's host work. It is
  recorded only while a profiler is active (`torch.profiler.profile` or
  the autograd profiler); it then keeps its name, an id, its parent's id,
  the id of the public call it belongs to, start and end on
  `time.perf_counter_ns()`'s clock, the host synchronisations made inside
  it and its attributes, and is also a `record_function` range named
  `wgans.<name>`, so that the profiler's timeline shows it beside the
  card's kernels. With the profiler off a span costs one flag check and
  enters a shared no-op.
- `timed(name, **attrs)`: a span whose length the caller keeps
  (`.seconds`), read from its own two clock reads whether or not the span
  is recorded.
- `stage(name, **attrs)`: a one-off stretch (a plan step, a CUDA graph
  capture, a kernel build, a cap regrowth, a fall back to another path),
  recorded always, the last MAX_STAGES of them.
- `count(name, n)`: an integer counter, always on; `counters()` returns
  them with the kernels' launch counts.
- `fetch(t)` and `upload(a, device)`: a read-back to the host and a copy
  from host memory, each counted as one host synchronisation
  (`host_syncs`) unless empty: a copy from pageable memory waits for the
  stream as a read-back does, an empty one copies nothing. Other
  synchronising operations (a boolean mask, a `nonzero`) are counted
  where they run. The counts follow the code, so a CPU run counts the
  synchronisations that the same calls make on a card, where they equal
  what `torch.cuda.set_sync_debug_mode` reports.

Nothing is written anywhere: `spans()`, `stages()` and `counters()` are
read in the same process, e.g. after a profiled window.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time

import numpy as np
import torch

MAX_SPANS = 200_000
MAX_STAGES = 4096

_spans: collections.deque = collections.deque(maxlen=MAX_SPANS)
_stages: collections.deque = collections.deque(maxlen=MAX_STAGES)
_counts: collections.Counter = collections.Counter()
_ids = itertools.count(1)
_local = threading.local()

if hasattr(torch.autograd.profiler, "_is_profiler_enabled"):
    def recording() -> bool:
        """Whether a profiler is active, so that spans are recorded."""
        return torch.autograd.profiler._is_profiler_enabled
else:   # pragma: no cover - older PyTorch
    recording = torch._C._autograd._profiler_enabled


def _open() -> list:
    """This thread's open spans and stages, innermost last."""
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Off:
    """The shared no-op of a span that is not recorded."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


_OFF = _Off()


class _Timer(_Off):
    """A timed span that is not recorded: its two clock reads alone."""

    __slots__ = ("start", "end")

    def __enter__(self):
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        return False

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-9


class Span(_Timer):
    """A recorded span or stage: name, id, parent (the id of the span or
    stage open around it, None at a public call's root), call (the root's
    id), start and end (perf_counter_ns), syncs (host_syncs counted
    between them) and attrs."""

    __slots__ = ("name", "attrs", "id", "parent", "call", "syncs", "_into",
                 "_range", "_syncs0")

    def __init__(self, name: str, attrs: dict, into):
        self.name, self.attrs, self._into = name, attrs, into
        self._range = None

    def __enter__(self):
        stack = _open()
        up = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = up.id if up is not None else None
        self.call = up.call if up is not None else self.id
        if recording():
            self._range = torch.profiler.record_function("wgans." + self.name)
            self._range.__enter__()
        stack.append(self)
        self._syncs0 = _counts["host_syncs"]
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        self.syncs = _counts["host_syncs"] - self._syncs0
        _open().pop()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        self._into.append(self)
        return False

    def set(self, **attrs):
        self.attrs.update(attrs)


def span(name: str, **attrs):
    """A span of host work, recorded while a profiler is active."""
    if not recording():
        return _OFF
    return Span(name, attrs, _spans)


def timed(name: str, **attrs):
    """A span whose `.seconds` the caller keeps, recorded while a profiler
    is active."""
    if not recording():
        return _Timer()
    return Span(name, attrs, _spans)


def stage(name: str, **attrs) -> Span:
    """A one-off stretch of work, recorded always."""
    return Span(name, attrs, _stages)


def count(name: str, n: int = 1):
    _counts[name] += n


def fetch(t: torch.Tensor) -> np.ndarray:
    """t's values as a host array: one host synchronisation unless t is
    empty, inside a `fetch` span."""
    with span("fetch", bytes=t.numel() * t.element_size()):
        if t.numel():
            _counts["host_syncs"] += 1
        return t.cpu().numpy()


def upload(a: np.ndarray, device) -> torch.Tensor:
    """The host array a as a tensor on `device` (shared with a on the
    CPU): one host synchronisation unless a is empty."""
    if a.size:
        _counts["host_syncs"] += 1
    return torch.from_numpy(a).to(device)


def counters() -> dict:
    """Every counter, with the kernels' launch counts (kept on their
    wrappers: decode_emit.launches, decode_blocks.launches and
    aux_launches, encode_blocks.launches)."""
    from ..ops import decode_cuda, emit_cuda, encode_cuda
    out = dict(_counts)
    out.update(decode_emit=emit_cuda.decode_emit.launches,
               decode_blocks=decode_cuda.decode_blocks.launches,
               decode_blocks_aux=decode_cuda.decode_blocks.aux_launches,
               encode_blocks=encode_cuda.encode_blocks.launches)
    return out


def spans() -> list:
    """The recorded spans, in the order they closed."""
    return list(_spans)


def stages() -> list:
    """The recorded stages, in the order they closed."""
    return list(_stages)


def calls(name: str, lo: float = float("-inf"),
          hi: float = float("inf")) -> list:
    """[(root, the spans of its call)] for each recorded root span called
    `name` whose start lies in [lo, hi] (seconds, time.perf_counter()'s
    clock)."""
    recorded = list(_spans)
    by_call: dict = {}
    for s in recorded:
        by_call.setdefault(s.call, []).append(s)
    return [(s, by_call[s.call]) for s in recorded
            if s.name == name and s.parent is None
            and lo <= s.start * 1e-9 <= hi]
