"""Drives the PyTorch/CUDA port on one NVIDIA GPU and checks it.

    python3 chip_smoke.py

Builds the CUDA kernels from webgraph_ans_torch/csrc (the token decode,
decode_blocks, in token and aux mode, and the merged-emit decode,
decode_emit), holds each bit-exact against its plain PyTorch version
(tolerance 0: every output is an integer) and times it with CUDA events.
Then it runs both main paths on cnr-2000 (tests/data/cnr-2000: 325,557
nodes, 3,216,152 arcs), each compared bit for bit with the BVGraph input:
the token path (the port's store, ANSBvGraph.load,
TorchGraphDecoder.decode_tokens at 4096 lanes, reconstruct) and the
merged-emit path (TorchGraphDecoder.decode_to_adjacency_device at 2048
lanes, through rebalance and refinement into the verified steady state,
checked through to_dense_csr). Each phase prints one JSON line; any
failure raises and exits non-zero. The line before the last lists the
kernels; the last line is the device record. Exits 1 without printing a
result when CUDA is not available.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
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
EMIT_LANES = 2048
SMALL_LANES = 64
TIMED_RUNS = 20

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and 32-bit integer ALU
# operations/s (the fp32 pipe's 67 TFLOP/s counts an FMA as two operations;
# one 32-bit integer operation per lane per clock is half of that).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12
# Integer operations the function needs: per decoded token (LUT address,
# state update, prefix, FSM update, output), per refilled stream word, per
# aux-mode token or summary step (the reconstruction fields), and per
# merged-emit step beyond its token: one indexed queue push and one pop (3
# each), the three-way merge of the queue heads (2 compares, 2 selects),
# the run's next value (2), the ring write and the copy read (2 each) and
# the output row (val, xch, nibble: 4). The kernel's one-hot queue slots
# are its own layout, not work the function needs, and are not counted.
OPS_PER_TOKEN = 40
OPS_PER_WORD = 6
OPS_PER_AUX_STEP = 12
OPS_PER_EMIT_STEP = 20
# (name, window, max_ref_count, min_interval_length, phase_step)
SMALL_CONFIGS = [
    ("w7_r3_i2", 7, 3, 2, 1),
    ("w0_no_refs", 0, 0, 2, 1),
    ("no_intervals", 7, 3, 0, 1),
    ("w16_deep_refs", 16, 2_000_000_000, 4, 1),
    ("phase_step4", 7, 3, 2, 4),
]
# merged-emit cases forced into dirty rows: a ring of 32 rows on the
# window-7 artifact (copy sources fall out of the ring: codes 8 and 9);
# the phase-sampled artifact has no halo (cross-lane parents: code 7); the
# small graph's node 500 overflows the interval queue (code 3)
SMALL_RING_T = {"w7_r3_i2": 32}
DIRTY_CODES = (3, 7, 8, 9)


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


def timed(fn):
    """(fn(), seconds) on the host clock, synchronised on both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def max_abs_err(a, b) -> int:
    """Largest difference of the u32 bit patterns of two int tensors."""
    a = a.long() & 0xFFFFFFFF
    b = b.long() & 0xFFFFFFFF
    return int((a - b).abs().max()) if a.numel() else 0


def compare(kernel_res, plain_res) -> dict:
    """Bit equality and largest difference over every output tensor."""
    equal, err = True, 0
    for k, p in zip(kernel_res, plain_res):
        equal &= torch.equal(k, p)
        err = max(err, max_abs_err(k, p))
    return {"bit_equal": bool(equal), "max_abs_err": err, "tolerance": 0}


def decode_args(dec, pl, cap):
    return (dec.tables, pl["states"], pl["ptrs"], pl["starts"], pl["ends"],
            pl["ring"], dec.window, dec.min_interval, cap)


def emit_args(dec, epl, cap):
    return (dec.tables, epl["regs"], epl["ptrs"], dec.window,
            dec.min_interval, cap)


def _bound(read, written, ops) -> dict:
    bytes_ms = (read + written) / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": read + written, "operations": ops}


def _stream_words(dec, starts, ends, entry_ptrs) -> int:
    """Stream words the lanes [starts, ends) consume from their entries."""
    n = dec.num_nodes
    end_ptr = np.where(ends < n, dec.pointers[np.minimum(ends, n - 1)], 0)
    return int(np.where(starts < ends, entry_ptrs - end_ptr, 0).sum())


def decode_bound(dec, pl, cap, counts, aux: bool = False) -> dict:
    """Least time for one decode_blocks call on these inputs: each input
    read once, each output written once, and the integer operations this
    run's tokens and stream words need (aux mode: its fields and one
    summary step per node as well)."""
    L = pl["states"].shape[0]
    R = dec.window + 1
    t = dec.tables
    read = (t.lut.numel() * 4 + t.stream.numel() * 2
            + L * (8 + 8 + 4 + 4 + 4 * R))
    rows = 3 * cap if aux else cap
    written = (rows + cap // 8) * L * 4 + L * 4 + L
    words = _stream_words(dec, pl["starts_np"], pl["ends_np"],
                          pl["ptrs"].cpu().numpy())
    tokens = int(counts.sum())
    ops = OPS_PER_TOKEN * tokens + OPS_PER_WORD * words
    if aux:
        ops += OPS_PER_AUX_STEP * (tokens + dec.num_nodes)
    return {**_bound(read, written, ops), "tokens": tokens,
            "stream_words": words}


def emit_bound(dec, epl, cap, rows_used, tokens: int) -> dict:
    """Least time for one decode_emit call: the LUT, the stream, the
    register file and the pointers read once, val, xch, nib and the lane
    records written once (every row up to cap, as the contract has it),
    and the operations of this run's tokens (the token decode's count of
    the same nodes: the verified plan has no halo), stream words and lane
    steps. The ring is scratch, neither input nor output."""
    if not np.array_equal(epl["hstarts_np"], epl["starts_np"]):
        raise SystemExit("emit_bound: the plan decodes a halo, which the "
                         "token count leaves out")
    L = epl["regs"].shape[1]
    t = dec.tables
    read = (t.lut.numel() * 4 + t.stream.numel() * 2
            + epl["regs"].numel() * 4 + L * 8)
    written = (2 * cap + cap // 8) * L * 4 + L * (4 + 1 + 6 * 4)
    steps = int(rows_used.sum())
    words = _stream_words(dec, epl["hstarts_np"], epl["ends_np"],
                          epl["ptrs"].cpu().numpy())
    ops = (OPS_PER_TOKEN * tokens + OPS_PER_WORD * words
           + OPS_PER_EMIT_STEP * steps)
    return {**_bound(read, written, ops), "tokens": tokens,
            "stream_words": words, "steps": steps}


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


def ptxas_report(log: str) -> dict:
    """Registers and spills of each kernel instance in nvcc's -Xptxas -v
    log, keyed by its template argument (emit_aux, or the window)."""
    out, key = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '.*?I(Lb|Li)(\d+)E", ln)
        if m:
            key = ("aux" if m.group(2) == "1" else "token") \
                if m.group(1) == "Lb" else f"W{m.group(2)}"
        elif key and ("registers" in ln or "spill" in ln):
            out.setdefault(key, []).append(ln.strip())
    return out


def codes_hit(nib: torch.Tensor) -> dict:
    """Row counts of each dirty code in a packed nibble channel."""
    words = nib.long() & 0xFFFFFFFF
    shifts = torch.arange(8, device=nib.device) * 4
    codes = ((words[:, None, :] >> shifts[None, :, None]) & 0xF).reshape(-1)
    counts = torch.bincount(codes, minlength=16).tolist()
    return {str(c): counts[c] for c in DIRTY_CODES}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from webgraph_ans_torch import (ANSBvGraph, TorchGraphDecoder,
                                    reconstruct, store, to_dense_csr)
    from webgraph_ans_torch.bvgraph.graph import Adjacency, load_bvgraph
    from webgraph_ans_torch.bvgraph.store import compress_adjacency
    from webgraph_ans_torch.bvgraph.synth import synth_web_graph
    from webgraph_ans_torch.ops import cuda_build, decode_cuda, emit_cuda
    from webgraph_ans_torch.ops import emit_post
    from webgraph_ans_torch.ops.decode_torch import (decode_blocks_plain,
                                                     fetch_block_tokens)
    from webgraph_ans_torch.ops.emit_torch import decode_emit_plain
    from webgraph_ans_torch.ops.reconstruct_device import _quant

    cuda = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(smi, flush=True)
    emit("device", name=kind, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, count=torch.cuda.device_count())

    # ---- 1. build both kernels from the checkout's sources, at once ----
    t0 = time.perf_counter()
    built = cuda_build.build_many(
        [(decode_cuda.SOURCE, decode_cuda.LIB_PATH),
         (emit_cuda.SOURCE, emit_cuda.LIB_PATH)], force=True)
    emit("build", seconds=time.perf_counter() - t0, kernels=[
        {"kernel": name, "seconds": info["seconds"],
         "ptxas": ptxas_report(info["log"])}
        for name, info in zip(("decode_blocks", "decode_emit"), built)])

    with tempfile.TemporaryDirectory() as tmp:
        # ---- 2. compress cnr-2000 with the port's store ----
        t0 = time.perf_counter()
        store(CNR, os.path.join(tmp, "cnr"))
        g = ANSBvGraph.load(os.path.join(tmp, "cnr"))
        emit("store", graph="cnr-2000", seconds=time.perf_counter() - t0,
             nodes=g.num_nodes, arcs=g.num_arcs,
             stream_words=len(g.prelude.stream),
             ans_bytes=os.path.getsize(os.path.join(tmp, "cnr.ans")))

        # ---- 3. token kernel vs plain on small seeded random graphs, one
        # per grammar variant (window 0, no intervals, the widest ring,
        # phase-sampled entry points) ----
        rng = np.random.default_rng(2026)
        lists = [sorted(rng.choice(2000, size=int(rng.integers(0, 24)),
                                   replace=False).tolist())
                 for _ in range(2000)]
        adj_small = Adjacency.from_lists(lists)
        small, small_decs = [], []
        for name, w, r, mi, step in SMALL_CONFIGS:
            res = compress_adjacency(adj_small, w, r, mi)
            sdec = TorchGraphDecoder(sampled_graph(ANSBvGraph, res, step),
                                     device=cuda)
            spl = sdec.plan(SMALL_LANES)
            args = decode_args(sdec, spl, spl["cap"])
            cmp_s = compare(decode_cuda.decode_blocks(*args),
                            decode_blocks_plain(*args))
            vals, comps = sdec.decode_tokens(SMALL_LANES)
            off, succs = reconstruct(vals, comps, sdec.num_nodes, mi)
            small.append({"config": name, "cap": spl["cap"],
                          "lists_exact": Adjacency(off, succs).to_lists()
                          == lists, **cmp_s})
            small_decs.append((name, sdec))
        emit("kernel_vs_plain_small", nodes=2000, lanes=SMALL_LANES,
             results=small)
        if not all(c["bit_equal"] and c["lists_exact"] for c in small):
            raise SystemExit("small graphs: kernel and plain version differ")

        # ---- 4. token kernel vs plain on the cnr-2000 plan, all lanes ----
        dec = TorchGraphDecoder(g)
        pl = dec.plan(LANES)
        _, _, cap = dec.decode_raw(LANES)      # settles the cap
        args = decode_args(dec, pl, cap)
        kres = decode_cuda.decode_blocks(*args)
        pres, plain_s = timed(lambda: decode_blocks_plain(*args))
        cmp_cnr = compare(kres, pres)
        emit("kernel_vs_plain_cnr", lanes=LANES, cap=cap,
             tokens=int(kres[1].sum()), plain_seconds=plain_s, **cmp_cnr)
        if not cmp_cnr["bit_equal"]:
            raise SystemExit("cnr-2000: kernel and plain version differ")

        # ---- 5. token kernel times ----
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

        # ---- 6. token path end to end on cuda ----
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

        # ---- 7. aux-mode token kernel vs plain: the cnr-2000 token plan
        # at the merged-emit planner's 2048 lanes, and the small graphs ----
        apl = dec.plan(EMIT_LANES)
        _, _, acap = dec.decode_raw(EMIT_LANES, emit_aux=True)
        aargs = decode_args(dec, apl, acap)
        akres = decode_cuda.decode_blocks(*aargs, emit_aux=True)
        apres, aplain_s = timed(
            lambda: decode_blocks_plain(*aargs, emit_aux=True))
        cmp_aux = compare(akres, apres)
        t_aux = cuda_ms(lambda: decode_cuda.decode_blocks(*aargs,
                                                          emit_aux=True))
        abound = decode_bound(dec, apl, acap, akres[1], aux=True)
        aux_small = []
        for name, sdec in small_decs:
            _, _, scap = sdec.decode_raw(SMALL_LANES, emit_aux=True)
            sargs = decode_args(sdec, sdec.plan(SMALL_LANES), scap)
            aux_small.append({"config": name, "cap": scap, **compare(
                decode_cuda.decode_blocks(*sargs, emit_aux=True),
                decode_blocks_plain(*sargs, emit_aux=True))})
        emit("aux_vs_plain", lanes=EMIT_LANES, cap=acap,
             plain_seconds=aplain_s, ms=t_aux, small=aux_small, **cmp_aux,
             **abound)
        if not (cmp_aux["bit_equal"]
                and all(c["bit_equal"] for c in aux_small)):
            raise SystemExit("aux mode: kernel and plain version differ")

        # ---- 8. merged-emit kernel vs plain on small seeded web graphs,
        # both mark_deg modes, with cases forced into every dirty cause ----
        elists = synth_web_graph(1000, seed=4).to_lists()
        elists[500] = [v for k in range(20) for v in (3 * k, 3 * k + 1)]
        adj_e = Adjacency.from_lists(elists)
        emit_small, seen = [], {str(c): 0 for c in DIRTY_CODES}
        for name, w, r, mi, step in SMALL_CONFIGS:
            res = compress_adjacency(adj_e, w, r, mi)
            edec_s = TorchGraphDecoder(sampled_graph(ANSBvGraph, res, step),
                                       device=cuda)
            epl_s = edec_s._emit_plan(SMALL_LANES)
            cases = [(epl_s["T"], False), (epl_s["T"], True)]
            if name in SMALL_RING_T:
                cases.append((SMALL_RING_T[name], False))
            caps = {}
            for T, md in cases:
                if T not in caps:   # a cap just above the rows lanes need
                    caps[T] = epl_s["cap"]
                    while True:
                        *_, rows, ok, _ = emit_cuda.decode_emit(
                            *emit_args(edec_s, epl_s, caps[T]), T=T)
                        if bool(ok.all()):
                            break
                        caps[T] *= 2
                    caps[T] = (int(rows.max()) // 8 + 3) * 8
                ecap = caps[T]
                eargs = emit_args(edec_s, epl_s, ecap)
                k = emit_cuda.decode_emit(*eargs, T=T, mark_deg=md)
                p = decode_emit_plain(*eargs, T=T, mark_deg=md)
                hit = codes_hit(k[2])
                for c in hit:
                    seen[c] += hit[c]
                emit_small.append({"config": name, "T": T, "mark_deg": md,
                                   "cap": ecap, "all_done": bool(k[4].all()),
                                   "codes": hit, **compare(k, p)})
        emit("emit_vs_plain_small", nodes=1000, lanes=SMALL_LANES,
             results=emit_small, codes_hit=seen)
        if not all(c["bit_equal"] and c["all_done"] for c in emit_small):
            raise SystemExit("merged emit: kernel and plain version differ")
        if not all(seen[str(c)] > 0 for c in DIRTY_CODES):
            raise SystemExit(f"merged emit: a dirty cause was never hit "
                             f"({seen})")

        # ---- 9. merged-emit path end to end: first call, rebalance and
        # refinement until the plan is verified, then the steady state ----
        n, arcs = g.num_nodes, g.num_arcs
        E = _quant(arcs)

        def exact_adjacency(res3) -> bool:
            offs_d, succs_d = to_dense_csr(*res3, E)
            host = torch.cat([offs_d[:n + 1], succs_d[:arcs]]).cpu().numpy()
            return (np.array_equal(host[:n + 1].astype(np.int64),
                                   adj.offsets.astype(np.int64))
                    and np.array_equal(host[n + 1:].astype(np.uint32),
                                       adj.succs))

        edec = TorchGraphDecoder(g)
        host_s = {"emit_bounds": 0.0, "safe_boundaries": 0.0}

        def timing(key, fn):
            def run(*a, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    host_s[key] += time.perf_counter() - t0
            return run

        edec._emit_bounds = timing("emit_bounds", edec._emit_bounds)
        edec._safe_boundaries = timing("safe_boundaries",
                                       edec._safe_boundaries)
        decode_cuda.decode_blocks.launches = 0
        decode_cuda.decode_blocks.aux_launches = 0
        emit_cuda.decode_emit.launches = 0
        cold = []
        epl = {}
        for _ in range(4):
            res3, sec = timed(
                lambda: edec.decode_to_adjacency_device(EMIT_LANES))
            epl = edec._plans[("emit", EMIT_LANES)]
            cold.append({"seconds": sec, "ns_per_arc": sec * 1e9 / arcs,
                         "exact": exact_adjacency(res3),
                         "verified": bool(epl.get("verified"))})
            if epl.get("verified") and "fx_offs" in epl.get("post_meta", {}):
                break
        cold_launches = {
            "decode_emit": emit_cuda.decode_emit.launches,
            "decode_blocks_aux": decode_cuda.decode_blocks.aux_launches,
            "decode_blocks": decode_cuda.decode_blocks.launches}
        decode_cuda.decode_blocks.launches = 0
        decode_cuda.decode_blocks.aux_launches = 0
        emit_cuda.decode_emit.launches = 0
        steady = []
        for _ in range(5):
            res3, sec = timed(
                lambda: edec.decode_to_adjacency_device(EMIT_LANES))
            steady.append(sec)
        steady_exact = exact_adjacency(res3)
        steady_launches = {
            "decode_emit": emit_cuda.decode_emit.launches,
            "decode_blocks_aux": decode_cuda.decode_blocks.aux_launches,
            "decode_blocks": decode_cuda.decode_blocks.launches}
        mc = epl["post_meta"]
        path_launches = {k: cold_launches[k] + steady_launches[k]
                         for k in cold_launches}
        # the steady call on the device, and its post-pass alone
        t_steady = cuda_ms(
            lambda: edec.decode_to_adjacency_device(EMIT_LANES), runs=10)
        eargs = emit_args(edec, epl, epl["cap"])
        ek = emit_cuda.decode_emit(*eargs, T=epl["T"], mark_deg=True)
        t_post = cuda_ms(lambda: emit_post.post_steady(
            ek[0], ek[1], *(mc[k] for k in emit_post.STEADY_KEYS)), runs=10)
        steady_s = statistics.median(steady)
        emit("emit_e2e", graph="cnr-2000", lanes=len(epl["starts_np"]),
             T=epl["T"], cap=epl["cap"],
             dirty_nodes=int(np.sum(mc["pdirty_np"])),
             fixup_rounds=mc["rounds"], cold=cold,
             steady_seconds=steady_s, steady_ns_per_arc=steady_s * 1e9 / arcs,
             steady_runs=steady, steady_exact=steady_exact,
             steady_device_ms=t_steady, post_steady_ms=t_post,
             host_planner_seconds=host_s, launches=cold_launches,
             steady_launches=steady_launches)
        if not (all(c["exact"] for c in cold) and steady_exact
                and cold[-1]["verified"]):
            raise SystemExit("merged emit: end-to-end adjacency is not "
                             "exact, or the plan never verified")
        if (path_launches["decode_emit"] < 1
                or path_launches["decode_blocks_aux"] < 1
                or steady_launches["decode_emit"] < 1
                or steady_launches["decode_blocks_aux"]
                or steady_launches["decode_blocks"]):
            raise SystemExit(f"merged emit: unexpected launches "
                             f"{cold_launches} {steady_launches}")

        # ---- 10. merged-emit kernel vs plain on the verified cnr-2000
        # plan (the steady state's mark_deg mode), and its time ----
        ep, eplain_s = timed(
            lambda: decode_emit_plain(*eargs, T=epl["T"], mark_deg=True))
        cmp_emit = compare(ek, ep)
        emit("emit_vs_plain_cnr", lanes=len(epl["starts_np"]), T=epl["T"],
             cap=epl["cap"], plain_seconds=eplain_s, codes=codes_hit(ek[2]),
             **cmp_emit)
        if not cmp_emit["bit_equal"]:
            raise SystemExit("cnr-2000: merged-emit kernel and plain "
                             "version differ")
        t_emit = cuda_ms(lambda: emit_cuda.decode_emit(
            *eargs, T=epl["T"], mark_deg=True))
        ebound = emit_bound(edec, epl, epl["cap"], ek[3],
                            int(kres[1].sum()))
        emit("emit_kernel_time", kernel="decode_emit", mark_deg=True,
             ms=t_emit, plain_ms=eplain_s * 1e3, library_ms=None,
             rows_used_max=int(ek[3].max()), **ebound)

    # ---- 11. the kernels line ----
    kernels = [{
        "name": "decode_blocks", "route": "cuda",
        "source": "webgraph_ans_torch/csrc/decode_blocks.cu",
        "replaces": "webgraph_ans_tpu/ops/decode_pallas.py:440",
        "launches": launches, "bit_equal": cmp_cnr["bit_equal"],
        "max_abs_err": cmp_cnr["max_abs_err"], "ms": t_k["median"],
        "plain_ms": plain_s * 1e3, "bound_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"], "library_ms": None,
        "lanes": LANES, "ms_32768_lanes": t_w["median"],
    }, {
        "name": "decode_blocks_aux", "route": "cuda",
        "source": "webgraph_ans_torch/csrc/decode_blocks.cu",
        "replaces": "webgraph_ans_tpu/ops/decode_pallas.py:440",
        "launches": path_launches["decode_blocks_aux"],
        "bit_equal": cmp_aux["bit_equal"],
        "max_abs_err": cmp_aux["max_abs_err"], "ms": t_aux["median"],
        "plain_ms": aplain_s * 1e3, "bound_ms": abound["bound_ms"],
        "bound_by": abound["bound_by"], "library_ms": None,
        "lanes": EMIT_LANES,
    }, {
        "name": "decode_emit", "route": "cuda",
        "source": "webgraph_ans_torch/csrc/decode_emit.cu",
        "replaces": "webgraph_ans_tpu/ops/emit_pallas.py:501",
        "launches": path_launches["decode_emit"],
        "bit_equal": cmp_emit["bit_equal"],
        "max_abs_err": cmp_emit["max_abs_err"], "ms": t_emit["median"],
        "plain_ms": eplain_s * 1e3, "bound_ms": ebound["bound_ms"],
        "bound_by": ebound["bound_by"], "library_ms": None,
        "lanes": len(epl["starts_np"]),
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
