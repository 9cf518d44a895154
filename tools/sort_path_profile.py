"""Where the time of the sort path and of the wave random access goes, on
one NVIDIA GPU, on cnr-2000 (tests/data/cnr-2000).

    python3 tools/sort_path_profile.py [--out FILE] [--root DIR]

--root names a directory holding the webgraph_ans_torch package to
measure (default: this checkout), e.g. an archive of another commit in an
ignored directory; run such versions in turns (A B B A) within one call.

Stores cnr-2000 with the port's host store, then:

- the sort-path reconstruction (reconstruct_device, cached meta) on the
  2048-lane aux decode: CUDA-event ms of the call, and a torch.profiler
  trace of three calls, summed by operator (device and host time, call
  counts), with the device's busy share of the traced wall time;
- the wave random access (TorchRandomAccess.successors_batch) on 10,000
  seeded random queries: host seconds by stage, from cProfile's
  cumulative times of the module's functions;
- the per-query merged-emit lanes (TorchEmitRandomAccess) on batches of
  4,096 seeded random queries, after three batches that record the
  rounds' CUDA graphs: each batch's seconds, its rounds (cap, lanes,
  lanes past the cap, dirty lanes, host seconds) and its wave decode,
  and a cProfile of one batch;
- the wave decode alone on batches of 1-8 queries (what the per-query
  lanes leave to it).

Prints one JSON line per section and, with --out, writes them all to
FILE. Needs a GPU; exits 1 without one.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import os
import pstats
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CNR = os.path.join(REPO, "tests", "data", "cnr-2000", "cnr-2000")
LANES = 2048


def cuda_ms(fn, runs: int = 10) -> dict:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return {"median": statistics.median(times), "min": min(times),
            "max": max(times), "runs": runs}


def op_table(prof, top: int = 25) -> dict:
    """Operators by device time (and host time), and the device's busy
    share of the traced wall time."""
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        rows.append({"op": e.key, "calls": e.count,
                     "self_device_ms": dev_us / 1e3,
                     "self_host_ms": e.self_cpu_time_total / 1e3})
    rows.sort(key=lambda r: -r["self_device_ms"])
    busy_us = 0.0
    t_lo, t_hi = None, None
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            busy_us += ev.time_range.elapsed_us()
        lo, hi = ev.time_range.start, ev.time_range.end
        t_lo = lo if t_lo is None else min(t_lo, lo)
        t_hi = hi if t_hi is None else max(t_hi, hi)
    wall_us = (t_hi - t_lo) if t_lo is not None else 0
    return {"ops": rows[:top],
            "device_ms_total": sum(r["self_device_ms"] for r in rows),
            "traced_wall_ms": wall_us / 1e3,
            "device_busy_share": busy_us / wall_us if wall_us else None}


def host_stages(prof_h, mods, top: int = 20) -> list:
    """The functions of the named modules by cumulative host seconds
    (cProfile)."""
    stages = []
    for (file, _, fn), (_, ncalls, tt, ct, _) in pstats.Stats(
            prof_h).stats.items():
        if any(m in file for m in mods):
            stages.append({"function": f"{os.path.basename(file)}:{fn}",
                           "calls": ncalls, "cumulative_s": ct,
                           "self_s": tt})
    stages.sort(key=lambda r: -r["cumulative_s"])
    return stages[:top]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out")
    ap.add_argument("--root", default=REPO)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sort_path_profile: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from webgraph_ans_torch import ANSBvGraph, TorchGraphDecoder, store
    from webgraph_ans_torch.ops.random_torch import (TorchEmitRandomAccess,
                                                     TorchRandomAccess)
    from webgraph_ans_torch.ops.reconstruct_device import reconstruct_device

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    lines = [{"section": "device", "nvidia_smi": smi,
              "torch": torch.__version__, "root": args.root}]
    print(json.dumps(lines[-1]), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        store(CNR, os.path.join(tmp, "cnr"))
        g = ANSBvGraph.load(os.path.join(tmp, "cnr"))
    n, arcs = g.num_nodes, g.num_arcs

    dec = TorchGraphDecoder(g)
    dec.decode_to_csr_device(LANES)           # plan, cap and meta cache
    out, _, cap = dec.decode_raw(LANES, emit_aux=True)
    mc = dec.plan(LANES)["recon_meta"]
    t_call = cuda_ms(lambda: reconstruct_device(out, n, arcs, cap, mc))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            reconstruct_device(out, n, arcs, cap, mc)
        torch.cuda.synchronize()
    lines.append({"section": "reconstruct_device", "graph": "cnr-2000",
                  "lanes": LANES, "cap": cap, "ms": t_call,
                  "profiled_calls": 3, **op_table(prof)})
    print(json.dumps(lines[-1]), flush=True)
    del out

    ra = TorchRandomAccess(TorchGraphDecoder(g))
    rng = np.random.default_rng(2026)
    ra.successors_batch(rng.integers(0, n, 10_000))     # warm up
    q = rng.integers(0, n, 10_000)
    prof_h = cProfile.Profile()
    t0 = time.perf_counter()
    prof_h.enable()
    got = ra.successors_batch(q)
    prof_h.disable()
    sec = time.perf_counter() - t0
    mods = ("random_torch", "reconstruct_torch", "graph_decode",
            "decode_torch", "decode_cuda", "random_access")
    lines.append({"section": "wave_random_access", "graph": "cnr-2000",
                  "queries": len(q), "arcs": len(got.succs),
                  "seconds": sec, "stages": host_stages(prof_h, mods)})
    print(json.dumps(lines[-1]), flush=True)

    # per-query merged-emit lanes: each batch's rounds and its wave decode
    era = TorchEmitRandomAccess(TorchGraphDecoder(g))
    for _ in range(3):                  # the rounds' CUDA graphs recorded
        era.successors_batch(rng.integers(0, n, 4096))
    batches = []
    for _ in range(6):
        q = rng.integers(0, n, 4096)
        t0 = time.perf_counter()
        got = era.successors_batch(q)
        batches.append({"seconds": time.perf_counter() - t0,
                        "arcs": len(got.succs), "rounds": era.last_rounds,
                        "to_wave": era.last_unclean,
                        "wave_seconds": era.last_wave_seconds})
    prof_h = cProfile.Profile()
    prof_h.enable()
    era.successors_batch(rng.integers(0, n, 4096))
    prof_h.disable()
    lines.append({"section": "emit_random_access", "graph": "cnr-2000",
                  "queries": 4096, "batches": batches,
                  "stages": host_stages(prof_h, mods + ("emit_cuda",
                                                        "emit_torch"))})
    print(json.dumps(lines[-1]), flush=True)
    # the wave decode of the few queries a batch leaves to it
    small = []
    for k in (1, 4, 8, 8):
        q = rng.integers(0, n, k)
        t0 = time.perf_counter()
        ra.successors_batch(q)
        small.append({"queries": k, "seconds": time.perf_counter() - t0,
                      "waves": ra.last_waves})
    lines.append({"section": "wave_random_access_small",
                  "graph": "cnr-2000", "batches": small})
    print(json.dumps(lines[-1]), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            for ln in lines:
                f.write(json.dumps(ln) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
