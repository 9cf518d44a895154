"""One run of one cell: set-up, the measured window, the traced window,
the comparison with the plain side and the metrics, all found by name.

A cell of BENCHMARK.json names a configuration (`configs/<name>.json`)
and a traffic mix (`traffic/<name>.json`); each metric is read by
`metrics/<name>.py`, whose `read(run)` returns a number or None when the
run has nothing for it to read.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import torch

from . import generator, system, trace

BENCH_DIR = system.BENCH_DIR
ROOT = system.ROOT
CACHE_DIR = os.path.join(BENCH_DIR, ".cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "webgraph_ans_tpu")
TRACE_SECONDS = 1.0


class ForbiddenModules(RuntimeError):
    """The process loaded JAX or the JAX package."""


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def find(items: list, name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"unknown {what} {name!r}")


def _named_file(kind: str, name: str, ext: str) -> str:
    path = os.path.join(BENCH_DIR, kind, name + ext)
    if not os.path.isfile(path):
        raise KeyError(f"unknown {kind[:-1] if kind.endswith('s') else kind}"
                       f" {name!r}: no {os.path.relpath(path, ROOT)}")
    return path


def load_config(name: str) -> dict:
    return load_json(_named_file("configs", name, ".json"))


def load_traffic(name: str) -> dict:
    return load_json(_named_file("traffic", name, ".json"))


def load_reader(name: str):
    """The `read` function of `metrics/<name>.py`."""
    path = _named_file("metrics", name, ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(spec: dict, cell: str, traced: bool) -> list[dict]:
    """The metrics a run of `cell` reports: the end-to-end ones untraced,
    the per-layer ones traced; a metric with `workloads` only in those."""
    group = spec["per_layer"] if traced else spec["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def card_line() -> str:
    """nvidia-smi's name and power limit of the card, or why not."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True)
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"


def run(cell_name: str, seed: int, seconds: float, traced: bool, *,
        t0: float, spec: dict | None = None, cfg: dict | None = None,
        mix: dict | None = None, device: str = "cuda",
        cache_root: str = CACHE_DIR, make_system=system.PortSystem,
        log=sys.stderr) -> dict:
    """One run; returns the result line's object (`checks` last).
    Raises ForbiddenModules when JAX or the JAX package was loaded."""
    spec = spec or load_spec()
    cell = find(spec["workloads"], cell_name, "workload")
    cfg = cfg or load_config(cell["config"])
    mix = mix or load_traffic(cell["traffic"])
    wanted = cell_metrics(spec, cell_name, traced)
    readers = {m["name"]: load_reader(m["name"]) for m in wanted}
    if importlib.util.find_spec(system.PORT) is None:
        raise ModuleNotFoundError(f"the program under test ({system.PORT}) "
                                  "is not in this checkout")
    cuda = device.startswith("cuda")
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    cache = system.Cache(os.path.join(cache_root, cell["config"]))
    system.reference_lists(cfg, cache, load=False)
    ref_meta = cache.meta("reference")
    base = system.artifact(cfg, cache)
    sut = make_system(cfg, base, device)
    spans = trace.Spans()
    driver = generator.make_driver(mix, sut, ref_meta["nodes"], seed, spans)
    driver.warmup()
    before = sut.counters()
    # what set-up left is not the window's to collect
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t0

    window = driver.measure(seconds)
    peak = torch.cuda.max_memory_allocated() if cuda else None
    gc.unfreeze()
    counts = {k: v - before[k] for k, v in sut.counters().items()}

    tr = None
    if traced:
        tr = _traced_window(driver, spans, cell_name, cuda, cache_root)

    sut.close()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    offsets, succs = system.reference_lists(cfg, cache)
    chk = driver.check(offsets, succs)
    driver.release()
    check_s = time.perf_counter() - t_check

    run_rec = types.SimpleNamespace(
        entry=driver.entry, setup_s=setup_s, peak_bytes=peak,
        nodes=ref_meta["nodes"], arcs=ref_meta["arcs"],
        ans_bytes=os.path.getsize(base + ".ans"), window=window,
        records=getattr(driver, "records", []), spans=spans, trace=tr)
    metrics = {}
    for m in wanted:
        value = readers[m["name"]](run_rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak or 0}
    if tr is not None:
        dev.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
    checks = {"wrong_lists": {"value": chk["wrong"], "max": 0},
              "answers_checked": {"value": chk["answers"], "min": 1},
              **driver.path_checks(counts, window["count"])}
    correct = all(_within(c) for c in checks.values())
    lat = [r["latency"] * 1e3 for r in run_rec.records]
    tail = (f" (batch ms: median {np.median(lat):.3f}, max {max(lat):.3f})"
            if lat else "")
    print(f"bench: {cell_name} seed {seed}: {window['count']} "
          f"{driver.entry} calls in {window['seconds']:.3f} s{tail}; launches "
          f"{counts}; {chk['lists']} lists checked in {check_s:.2f} s; "
          f"card {card_line() if cuda else 'none'}", file=log)
    result = {"correct": bool(correct), "attempted": int(window["count"]),
              "failed": int(chk["failed"]), "metrics": metrics,
              "device": dev}
    if tr is not None:
        result["breakdown"] = trace.breakdown(tr)
    result["checks"] = checks
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(", ".join(found))
    return result


def _within(check: dict) -> bool:
    return (check["value"] <= check["max"] if "max" in check
            else check["value"] >= check["min"])


def _traced_window(driver, spans, cell_name: str, cuda: bool,
                   cache_root: str) -> dict:
    """TRACE_SECONDS more of the cell's calls under torch.profiler (host
    and device activity), reduced by trace.read_chrome_trace; `ops` is
    the number of calls traced."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out_dir = os.path.join(cache_root, "traces")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, cell_name + ".trace.json")
    spans.annotate = True
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("bench.window"):
            ops = driver.traced(TRACE_SECONDS)
        if cuda:
            torch.cuda.synchronize()
    spans.annotate = False
    prof.export_chrome_trace(path)
    spans.dump(os.path.join(out_dir, cell_name + ".spans.jsonl"))
    tr = trace.read_chrome_trace(path)
    tr["ops"] = ops
    return tr


def print_checks(result: dict, log=sys.stderr):
    """The numbers compared, each beside its limit: the run's last lines
    on standard error."""
    for name, c in result["checks"].items():
        limit = (f"max {c['max']}" if "max" in c else f"min {c['min']}")
        print(f"check {name}: {c['value']} ({limit})", file=log)
    print(f"correct: {result['correct']}", file=log)
