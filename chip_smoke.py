"""Drives the PyTorch/CUDA port on one NVIDIA GPU and checks it.

    python3 chip_smoke.py

Builds the CUDA decode kernel from webgraph_ans_torch/csrc, holds it
bit-exact against its plain PyTorch version (tolerance 0: every output is
an integer), times it with CUDA events, and runs the main path end to end
on cnr-2000 (tests/data/cnr-2000: 325,557 nodes, 3,216,152 arcs): the
port's store, ANSBvGraph.load, TorchGraphDecoder.decode_tokens at 4096
lanes, reconstruct, compared bit for bit with the BVGraph input. Each
phase prints one JSON line; any failure raises and exits non-zero. The
last line is the device record. Exits 1 without printing a result when
CUDA is not available.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
CNR = os.path.join(REPO, "tests", "data", "cnr-2000", "cnr-2000")
LANES = 4096
WIDE_LANES = 32768
TIMED_RUNS = 20

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and 32-bit integer ALU
# operations/s (the fp32 pipe's 67 TFLOP/s counts an FMA as two operations;
# one 32-bit integer operation per lane per clock is half of that).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12
# Integer operations per decoded token (LUT address, state update, prefix,
# FSM update, output) and per refilled stream word, counted from the
# kernel source.
OPS_PER_TOKEN = 40
OPS_PER_WORD = 6
# (name, window, max_ref_count, min_interval_length, phase_step)
SMALL_CONFIGS = [
    ("w7_r3_i2", 7, 3, 2, 1),
    ("w0_no_refs", 0, 0, 2, 1),
    ("no_intervals", 7, 3, 0, 1),
    ("w16_deep_refs", 16, 2_000_000_000, 4, 1),
    ("phase_step4", 7, 3, 2, 4),
]


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, runs: int = TIMED_RUNS, warmup: int = 3) -> dict:
    """Median, min and max of `runs` CUDA-event timings of fn()."""
    for _ in range(warmup):
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


def max_abs_err(a, b) -> int:
    """Largest difference of the u32 bit patterns of two int tensors."""
    a = a.long() & 0xFFFFFFFF
    b = b.long() & 0xFFFFFFFF
    return int((a - b).abs().max()) if a.numel() else 0


def compare(kernel_res, plain_res) -> dict:
    (out_k, counts_k, ok_k), (out_p, counts_p, ok_p) = kernel_res, plain_res
    equal = (torch.equal(out_k, out_p) and torch.equal(counts_k, counts_p)
             and torch.equal(ok_k, ok_p))
    err = max(max_abs_err(out_k, out_p), max_abs_err(counts_k, counts_p),
              int((ok_k != ok_p).sum()))
    return {"bit_equal": equal, "max_abs_err": err, "tolerance": 0}


def decode_args(dec, pl, cap):
    return (dec.tables, pl["states"], pl["ptrs"], pl["starts"], pl["ends"],
            pl["ring"], dec.window, dec.min_interval, cap)


def decode_bound(dec, pl, cap, counts) -> dict:
    """Least time for one decode_blocks call on these inputs: each input
    read once, each output written once, and the integer operations this
    run's tokens and stream words need."""
    L = pl["states"].shape[0]
    R = dec.window + 1
    t = dec.tables
    read = (t.lut.numel() * 4 + t.stream.numel() * 2
            + L * (8 + 8 + 4 + 4 + 4 * R))
    written = (cap + cap // 8) * L * 4 + L * 4 + L
    starts, ends = pl["starts_np"], pl["ends_np"]
    n = dec.num_nodes
    end_ptr = np.where(ends < n, dec.pointers[np.minimum(ends, n - 1)], 0)
    words = int(np.where(starts < ends,
                         pl["ptrs"].cpu().numpy() - end_ptr, 0).sum())
    tokens = int(counts.sum())
    ops = OPS_PER_TOKEN * tokens + OPS_PER_WORD * words
    bytes_ms = (read + written) / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": read + written, "operations": ops, "tokens": tokens,
            "stream_words": words}


def sampled_graph(graph_cls, res, step: int):
    """The reader of a CompressionResult stored with phase_step=step."""
    prelude, states, pointers = res.prelude, res.states, res.pointers
    if step > 1:
        prelude = dataclasses.replace(prelude, phase_step=step)
        n = prelude.num_nodes
        rev_idx = (n - 1 - np.arange(0, n, step))[::-1]
        states = np.ascontiguousarray(states[rev_idx])
        pointers = np.ascontiguousarray(pointers[rev_idx])
    return graph_cls(prelude, states, pointers)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from webgraph_ans_torch import (ANSBvGraph, TorchGraphDecoder,
                                    reconstruct, store)
    from webgraph_ans_torch.bvgraph.graph import Adjacency, load_bvgraph
    from webgraph_ans_torch.bvgraph.store import compress_adjacency
    from webgraph_ans_torch.ops import decode_cuda
    from webgraph_ans_torch.ops.decode_torch import (decode_blocks_plain,
                                                     fetch_block_tokens)

    cuda = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(smi, flush=True)
    emit("device", name=kind, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, count=torch.cuda.device_count())

    # ---- 2. build the kernel from the checkout's sources ----
    info = decode_cuda.build(force=True)
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", kernel="decode_blocks", seconds=info["seconds"],
         ptxas=ptxas)

    with tempfile.TemporaryDirectory() as tmp:
        # ---- 3. compress cnr-2000 with the port's store ----
        t0 = time.perf_counter()
        store(CNR, os.path.join(tmp, "cnr"))
        g = ANSBvGraph.load(os.path.join(tmp, "cnr"))
        emit("store", graph="cnr-2000", seconds=time.perf_counter() - t0,
             nodes=g.num_nodes, arcs=g.num_arcs,
             stream_words=len(g.prelude.stream),
             ans_bytes=os.path.getsize(os.path.join(tmp, "cnr.ans")))

        # ---- 4. kernel vs plain on small seeded random graphs, one per
        # grammar variant (window 0, no intervals, the widest ring,
        # phase-sampled entry points) ----
        rng = np.random.default_rng(2026)
        lists = [sorted(rng.choice(2000, size=int(rng.integers(0, 24)),
                                   replace=False).tolist())
                 for _ in range(2000)]
        adj_small = Adjacency.from_lists(lists)
        small = []
        for name, w, r, mi, step in SMALL_CONFIGS:
            res = compress_adjacency(adj_small, w, r, mi)
            sdec = TorchGraphDecoder(sampled_graph(ANSBvGraph, res, step),
                                     device=cuda)
            spl = sdec.plan(64)
            args = decode_args(sdec, spl, spl["cap"])
            cmp_s = compare(decode_cuda.decode_blocks(*args),
                            decode_blocks_plain(*args))
            vals, comps = sdec.decode_tokens(64)
            off, succs = reconstruct(vals, comps, sdec.num_nodes, mi)
            small.append({"config": name, "cap": spl["cap"],
                          "lists_exact": Adjacency(off, succs).to_lists()
                          == lists, **cmp_s})
        emit("kernel_vs_plain_small", nodes=2000, lanes=64, results=small)
        if not all(c["bit_equal"] and c["lists_exact"] for c in small):
            raise SystemExit("small graphs: kernel and plain version differ")

        # ---- 5. kernel vs plain on the cnr-2000 plan, all lanes ----
        dec = TorchGraphDecoder(g)
        pl = dec.plan(LANES)
        _, _, cap = dec.decode_raw(LANES)      # settles the cap
        args = decode_args(dec, pl, cap)
        kres = decode_cuda.decode_blocks(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pres = decode_blocks_plain(*args)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        cmp_cnr = compare(kres, pres)
        emit("kernel_vs_plain_cnr", lanes=LANES, cap=cap,
             tokens=int(kres[1].sum()), plain_seconds=plain_s, **cmp_cnr)
        if not cmp_cnr["bit_equal"]:
            raise SystemExit("cnr-2000: kernel and plain version differ")

        # ---- 6. kernel times ----
        t_k = cuda_ms(lambda: decode_cuda.decode_blocks(*args))
        bound = decode_bound(dec, pl, cap, kres[1])
        wpl = dec.plan(WIDE_LANES)
        _, _, wcap = dec.decode_raw(WIDE_LANES)
        wargs = decode_args(dec, wpl, wcap)
        wres = decode_cuda.decode_blocks(*wargs)
        t_w = cuda_ms(lambda: decode_cuda.decode_blocks(*wargs))
        wbound = decode_bound(dec, wpl, wcap, wres[1])
        emit("kernel_time", kernel="decode_blocks",
             lanes={str(LANES): {"cap": cap, "ms": t_k, **bound},
                    str(WIDE_LANES): {"cap": wcap, "ms": t_w, **wbound}},
             plain_ms_4096=plain_s * 1e3)

        # ---- 7. main path end to end on cuda ----
        adj, _ = load_bvgraph(CNR)
        decode_cuda.decode_blocks.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dec2 = TorchGraphDecoder(g)
        vals, comps = dec2.decode_tokens(num_lanes=LANES)
        offsets, succs = reconstruct(vals, comps, g.num_nodes,
                                     g.prelude.min_interval_length)
        torch.cuda.synchronize()
        e2e_s = time.perf_counter() - t0
        launches = decode_cuda.decode_blocks.launches
        exact = (np.array_equal(offsets, adj.offsets)
                 and np.array_equal(succs, adj.succs))
        emit("e2e", graph="cnr-2000", lanes=LANES, seconds=e2e_s,
             ns_per_arc=e2e_s * 1e9 / g.num_arcs, succs_exact=exact,
             launches={"decode_blocks": launches})
        if not exact or launches < 1:
            raise SystemExit("end-to-end decode is not exact or never "
                             "launched the kernel")

        # warm repeat (plan and cap cached), stage by stage
        stages = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, counts, cap2 = dec2.decode_raw(LANES)
        torch.cuda.synchronize()
        stages["decode_raw"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        vals, comps = fetch_block_tokens(out, counts, cap2)
        stages["fetch_unpack"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        offsets, succs = reconstruct(vals, comps, g.num_nodes,
                                     g.prelude.min_interval_length)
        stages["reconstruct"] = time.perf_counter() - t0
        warm = sum(stages.values())
        emit("e2e_warm", seconds=warm, ns_per_arc=warm * 1e9 / g.num_arcs,
             stages=stages,
             succs_exact=bool(np.array_equal(succs, adj.succs)))

    # ---- 8. the kernels line ----
    kernels = [{
        "name": "decode_blocks", "route": "cuda",
        "source": "webgraph_ans_torch/csrc/decode_blocks.cu",
        "replaces": "webgraph_ans_tpu/ops/decode_pallas.py:440",
        "launches": launches, "bit_equal": cmp_cnr["bit_equal"],
        "max_abs_err": cmp_cnr["max_abs_err"], "ms": t_k["median"],
        "plain_ms": plain_s * 1e3, "bound_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"], "library_ms": None,
        "lanes": LANES, "ms_32768_lanes": t_w["median"],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
