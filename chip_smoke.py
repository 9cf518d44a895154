"""Drives the PyTorch/CUDA port on one NVIDIA GPU and checks it.

    python3 chip_smoke.py

Builds the CUDA kernels from webgraph_ans_torch/csrc (the token decode,
decode_blocks, in token and aux mode, the merged-emit decode, decode_emit,
and the lane-parallel rANS encode, encode_blocks) and reports each
instance's registers, shared memory, stack and spills (-Xptxas -v; a
spill fails the run after the last phase), holds each kernel bit-exact
against its plain PyTorch version (tolerance 0: every output is an
integer) and times it with CUDA events beside its bound, counted from the
bytes the function needs (the padded output layout beside it as
layout_bytes). Then it runs the main paths on cnr-2000
(tests/data/cnr-2000: 325,557 nodes, 3,216,152 arcs), each compared bit
for bit with the BVGraph input: the token path (the port's store,
ANSBvGraph.load, TorchGraphDecoder.decode_tokens at 4096 lanes,
reconstruct), the merged-emit path
(TorchGraphDecoder.decode_to_adjacency_device at 2048 lanes, through
rebalance and refinement into the verified steady state, which replays
one CUDA graph, checked through to_dense_csr; the steady call also
without the graph, and at 4096 lanes), and block-parallel compression
(store with 512 encode blocks and the device model search, its artifact
decoded back through both device paths and the sequential reader). Each
phase prints one JSON line; any failure raises and exits non-zero. The
line before the last lists the kernels; the last line is the device
record. Exits 1 without printing a result when CUDA is not available.
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
WIDE_EMIT_LANES = 4096
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
# Encode: per token (token and table-row addresses, fold count, the
# division-free state update with its two corrections, the meta word and
# the state row: about 40) and per emitted stream word (renorm test,
# shift, pack and store: 6).
OPS_PER_ENC_TOKEN = 40
OPS_PER_ENC_WORD = 6
ENCODE_BLOCKS = 512
ENCODE_SMALL_BLOCKS = (8, 64)
EDGE_GRAPHS = ([[]], [[], [], []], [[1], [], [0, 2]])
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
    """Least time for one decode_blocks call on these inputs: read the
    LUT once, the stream words the lanes consume and the lane records;
    write each lane's steps (its tokens, and in aux mode one summary step
    per node too: 4 B a step, 12 B in aux mode, and a nibble) and the lane
    records; and the integer operations of this run's tokens and stream
    words (aux mode: its fields and summary steps as well). The padded
    output layout (every row up to cap) is printed beside it as
    layout_bytes."""
    L = pl["states"].shape[0]
    R = dec.window + 1
    t = dec.tables
    words = _stream_words(dec, pl["starts_np"], pl["ends_np"],
                          pl["ptrs"].cpu().numpy())
    read = t.lut.numel() * 4 + words * 2 + L * (8 + 8 + 4 + 4 + 4 * R)
    counts = counts.cpu().numpy().astype(np.int64)
    steps = counts + ((pl["ends_np"] - pl["starts_np"]) if aux else 0)
    row_bytes = 12 if aux else 4
    written = (int(steps.sum()) * row_bytes
               + int(((steps + 7) // 8).sum()) * 4 + L * (4 + 1))
    rows = 3 * cap if aux else cap
    layout = (rows + cap // 8) * L * 4 + L * (4 + 1)
    tokens = int(counts.sum())
    ops = OPS_PER_TOKEN * tokens + OPS_PER_WORD * words
    if aux:
        ops += OPS_PER_AUX_STEP * int(steps.sum())
    return {**_bound(read, written, ops), "tokens": tokens,
            "stream_words": words, "layout_bytes": read + layout}


def emit_bound(dec, epl, cap, rows_used, tokens: int) -> dict:
    """Least time for one decode_emit call: read the LUT once, the stream
    words the lanes consume, the register file and the pointers; write
    val, xch and a nibble for each row a lane uses (rows_used) and the
    lane records; and the operations of this run's tokens (the token
    decode's count of the same nodes: the verified plan has no halo),
    stream words and lane steps. The ring is scratch, neither input nor
    output. The padded layout (every row up to cap, as the contract
    writes it) is printed beside it as layout_bytes."""
    if not np.array_equal(epl["hstarts_np"], epl["starts_np"]):
        raise SystemExit("emit_bound: the plan decodes a halo, which the "
                         "token count leaves out")
    L = epl["regs"].shape[1]
    t = dec.tables
    words = _stream_words(dec, epl["hstarts_np"], epl["ends_np"],
                          epl["ptrs"].cpu().numpy())
    read = (t.lut.numel() * 4 + words * 2 + epl["regs"].numel() * 4
            + L * 8)
    rows = rows_used.cpu().numpy().astype(np.int64)
    lane_records = L * (4 + 1 + 6 * 4)
    written = (int(rows.sum()) * 8 + int(((rows + 7) // 8).sum()) * 4
               + lane_records)
    layout = (2 * cap + cap // 8) * L * 4 + lane_records
    steps = int(rows.sum())
    ops = (OPS_PER_TOKEN * tokens + OPS_PER_WORD * words
           + OPS_PER_EMIT_STEP * steps)
    return {**_bound(read, written, ops), "tokens": tokens,
            "stream_words": words, "steps": steps,
            "layout_bytes": read + layout}


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


PTXAS_FIELDS = (("registers", r"Used (\d+) registers"),
                ("smem_bytes", r"(\d+) bytes smem"),
                ("stack_bytes", r"(\d+) bytes stack frame"),
                ("spill_stores", r"(\d+) bytes spill stores"),
                ("spill_loads", r"(\d+) bytes spill loads"))


def _kernel_name(mangled: str) -> str:
    """The function's own name in an Itanium-mangled kernel symbol: the
    last length-prefixed component of its (nested) name."""
    nested = mangled.startswith("_ZN")
    i, name = (3 if nested else 2), "kernel"
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
        if not nested:
            break
    return name


def ptxas_report(log: str) -> dict:
    """Registers, static shared memory, stack and spills of each kernel
    instance in nvcc's -Xptxas -v log, keyed by its template argument
    (emit_aux, or the window), or by the kernel's name for a kernel that
    is no template."""
    out, key = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(.*?)'", ln)
        if m:
            t = re.search(r"I(Lb|Li)(\d+)E", m.group(1))
            if t is None:
                key = _kernel_name(m.group(1))
            elif t.group(1) == "Lb":
                key = "aux" if t.group(2) == "1" else "token"
            else:
                key = f"W{t.group(2)}"
            out[key] = {}
        elif key:
            for field, pat in PTXAS_FIELDS:
                f = re.search(pat, ln)
                if f:
                    out[key][field] = int(f.group(1))
    return out


def encode_args(plan):
    return (plan.params, plan.tab, plan.tokens, plan.tstart, plan.tend,
            plan.cap)


def encode_bound(plan, wtotals) -> dict:
    """Least time for one encode_blocks call: the table, the tokens and the
    lane bounds read once; the artifact written once: the stream words
    this run emitted (u16), a state (u32) and a pointer (u64) per node
    start, and the lane records; and the operations of this run's tokens
    and words. The kernel's padded layout (emit [cap*EP + cap, L], states
    [cap, L]) is its own, not bytes the function needs; its size is
    reported beside the bound as layout_bytes."""
    L = plan.tstart.shape[0]
    EP = (plan.params[9] + 2) // 2
    words = int((wtotals.long() & 0xFFFFFFFF).sum())
    nodes = int((plan.tokens[:, 1] == 0).sum())
    read = plan.tab.numel() * 4 + plan.tokens.numel() * 4 + L * 8
    written = words * 2 + nodes * (4 + 8) + L * (4 + 4 + 1)
    layout = ((plan.cap * EP + plan.cap) * L * 4 + plan.cap * L * 4
              + L * (4 + 4 + 1))
    tokens = plan.tokens.shape[0]
    ops = OPS_PER_ENC_TOKEN * tokens + OPS_PER_ENC_WORD * words
    return {**_bound(read, written, ops), "tokens": tokens,
            "stream_words": words, "node_starts": nodes,
            "layout_bytes": read + layout}


def dominant_symbol_tokens():
    """(model, values, components) of 3000 nodes whose tokens use a
    component with a symbol that fills 7/8 of its frame (and one of
    frequency 1): the division's reciprocal then overestimates the
    quotient on states just below the renorm bound and its downward
    correction runs (7 state rows of this seed depend on it), which no
    graph's model here does."""
    from webgraph_ans_torch.ans.model import ANSModel, ComponentModel
    empty = ComponentModel(np.zeros(0, np.uint16), 0, 2, 2)
    model = ANSModel([ComponentModel(np.full(8, 4, np.uint16), 5, 2, 2),
                      empty, ComponentModel(np.array([7, 1], np.uint16), 3,
                                            2, 2)] + [empty] * 6)
    rng = np.random.default_rng(0)
    per_node = rng.integers(0, 7, 3000)
    comps = np.concatenate([[0] + [2] * int(k) for k in per_node]) \
        .astype(np.uint8)
    vals = np.where(comps == 0, rng.integers(0, 8, len(comps)),
                    rng.integers(0, 2, len(comps))).astype(np.uint64)
    return model, vals, comps


def models_equal(a, b) -> bool:
    """Component by component: log_m, radix, fidelity and frequencies."""
    return all((ca.log_m, ca.radix, ca.fidelity) == (cb.log_m, cb.radix,
                                                     cb.fidelity)
               and np.array_equal(ca.freqs, cb.freqs)
               for ca, cb in zip(a.components, b.components))


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
    from webgraph_ans_torch.bvgraph.sequential import ANSBvGraphSeq
    from webgraph_ans_torch.bvgraph.store import (compress_adjacency,
                                                  dump_tokens)
    from webgraph_ans_torch.bvgraph.synth import synth_web_graph
    from webgraph_ans_torch.ops import (cuda_build, decode_cuda, emit_cuda,
                                        encode_cuda, emit_post)
    from webgraph_ans_torch.ops.encode_torch import (encode_blocks_plain,
                                                     encode_plan)
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

    # ---- 1. build the three kernels from the checkout's sources, at once
    t0 = time.perf_counter()
    built = cuda_build.build_many(
        [(decode_cuda.SOURCE, decode_cuda.LIB_PATH),
         (emit_cuda.SOURCE, emit_cuda.LIB_PATH),
         (encode_cuda.SOURCE, encode_cuda.LIB_PATH)], force=True)
    reports = {name: ptxas_report(info["log"]) for name, info in
               zip(("decode_blocks", "decode_emit", "encode_blocks"), built)}
    emit("build", seconds=time.perf_counter() - t0, kernels=[
        {"kernel": name, "seconds": info["seconds"], "ptxas": reports[name]}
        for name, info in zip(reports, built)])
    # checked after the last phase, so that one run reports everything
    spills = {f"{name}/{inst}": rep for name, insts in reports.items()
              for inst, rep in insts.items()
              if rep.get("spill_stores", 0) or rep.get("spill_loads", 0)}

    with tempfile.TemporaryDirectory() as tmp:
        # ---- 2. compress cnr-2000 with the port's store (host) ----
        t0 = time.perf_counter()
        res_cnr = store(CNR, os.path.join(tmp, "cnr"))
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
                                   "codes": hit, **compare(k, p),
                                   **emit_cuda.launch_geometry(edec_s.window,
                                                               T)})
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
        # the first steady call runs eagerly and captures the CUDA graph,
        # the later ones replay it; every result is checked once all five
        # calls have run, so a replay must not overwrite an earlier result
        steady, results = [], []
        for _ in range(5):
            res3, sec = timed(
                lambda: edec.decode_to_adjacency_device(EMIT_LANES))
            steady.append(sec)
            results.append(res3)
        steady_exact = all(exact_adjacency(r) for r in results)
        del results
        steady_launches = {
            "decode_emit": emit_cuda.decode_emit.launches,
            "decode_blocks_aux": decode_cuda.decode_blocks.aux_launches,
            "decode_blocks": decode_cuda.decode_blocks.launches}
        mc = epl["post_meta"]
        path_launches = {k: cold_launches[k] + steady_launches[k]
                         for k in cold_launches}
        # the steady call on the device (the graph's replay and copies),
        # the same call without the graph (its kernel and post-pass
        # launched one by one), and the post-pass alone
        t_steady = cuda_ms(
            lambda: edec.decode_to_adjacency_device(EMIT_LANES), runs=10)
        t_eager = cuda_ms(lambda: edec._steady(epl), runs=10)
        eager_s = statistics.median(
            [timed(lambda: edec._steady(epl))[1] for _ in range(5)])
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
             steady_device_ms=t_steady, steady_eager_seconds=eager_s,
             steady_eager_device_ms=t_eager, post_steady_ms=t_post,
             host_planner_seconds=host_s, launches=cold_launches,
             steady_launches=steady_launches)
        if not (all(c["exact"] for c in cold) and steady_exact
                and cold[-1]["verified"]):
            raise SystemExit("merged emit: end-to-end adjacency is not "
                             "exact, or the plan never verified")
        if (path_launches["decode_emit"] < 1
                or path_launches["decode_blocks_aux"] < 1
                or steady_launches["decode_emit"] != len(steady)
                or steady_launches["decode_blocks_aux"]
                or steady_launches["decode_blocks"]):
            raise SystemExit(f"merged emit: unexpected launches "
                             f"{cold_launches} {steady_launches}")

        # the same path at 4096 lanes: do more, shorter lanes shorten the
        # longest one?
        edec4 = TorchGraphDecoder(g)
        cold4 = []
        for _ in range(4):
            res3, sec = timed(
                lambda: edec4.decode_to_adjacency_device(WIDE_EMIT_LANES))
            epl4 = edec4._plans[("emit", WIDE_EMIT_LANES)]
            cold4.append({"seconds": sec, "exact": exact_adjacency(res3)})
            if epl4.get("verified") and "fx_offs" in epl4.get("post_meta",
                                                              {}):
                break
        steady4 = [timed(lambda: edec4.decode_to_adjacency_device(
            WIDE_EMIT_LANES)) for _ in range(3)]
        exact4 = all(exact_adjacency(r) for r, _ in steady4)
        t_steady4 = cuda_ms(
            lambda: edec4.decode_to_adjacency_device(WIDE_EMIT_LANES),
            runs=10)
        emit("emit_e2e_wide", graph="cnr-2000",
             lanes=len(epl4["starts_np"]), T=epl4["T"], cap=epl4["cap"],
             cold=cold4, verified=bool(epl4.get("verified")),
             steady_seconds=statistics.median(t for _, t in steady4),
             steady_device_ms=t_steady4, steady_exact=exact4)
        if not (exact4 and all(c["exact"] for c in cold4)
                and epl4.get("verified")):
            raise SystemExit(f"merged emit at {WIDE_EMIT_LANES} lanes: not "
                             "exact, or the plan never verified")
        del edec4, steady4

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
        geometry = emit_cuda.launch_geometry(edec.window, epl["T"])
        emit("emit_kernel_time", kernel="decode_emit", mark_deg=True,
             ms=t_emit, plain_ms=eplain_s * 1e3, library_ms=None,
             rows_used_max=int(ek[3].max()), **geometry, **ebound)

        # ---- 11. encode kernel vs plain on small inputs: the 2000-node
        # graph of phase 3 under each configuration, the edge graphs, a
        # cnr-2000 token prefix under the cnr-2000 model (the fold-threshold
        # exponent passes 31 there) and a dominant-symbol stream (the
        # division's downward correction) ----
        cases = []
        for name, w, r, mi, _step in SMALL_CONFIGS:
            res = compress_adjacency(adj_small, w, r, mi)
            vals_e, comps_e = dump_tokens(adj_small, w, r, mi,
                                          res.est_tables)
            cases += [(name, res.prelude.model, vals_e, comps_e, nb)
                      for nb in ENCODE_SMALL_BLOCKS]
        for lists_e in EDGE_GRAPHS:
            adj_g = Adjacency.from_lists(lists_e)
            res = compress_adjacency(adj_g, 7, 3, 2)
            cases.append((f"edge_{lists_e}", res.prelude.model,
                          *dump_tokens(adj_g, 7, 3, 2, res.est_tables), 4))
        vals_c, comps_c = dump_tokens(adj, 7, 3, 2, res_cnr.est_tables)
        K = int(np.nonzero(comps_c[:30000] == 0)[0][-1])
        cases.append(("cnr_prefix", res_cnr.prelude.model, vals_c[:K],
                      comps_c[:K], 8))
        cases.append(("dominant_symbol", *dominant_symbol_tokens(), 64))
        enc_small = []
        for name, model, vals_e, comps_e, nb in cases:
            eplan = encode_plan(model, vals_e, comps_e, nb, device=cuda)
            cmp_e = compare(encode_cuda.encode_blocks(*encode_args(eplan)),
                            encode_blocks_plain(*encode_args(eplan)))
            enc_small.append({"case": name, "blocks": nb,
                              "tokens": len(vals_e), "cap": eplan.cap,
                              "max_folds": eplan.params[9], **cmp_e})
        emit("encode_vs_plain_small", results=enc_small)
        if not all(c["bit_equal"] for c in enc_small):
            raise SystemExit("encode: kernel and plain version differ")

        # ---- 12. block-parallel compression of cnr-2000 on the card: 512
        # encode blocks, the device model search ----
        encode_cuda.encode_blocks.launches = 0
        base_b = os.path.join(tmp, "cnr_b512")
        res_b, store_s = timed(lambda: store(
            CNR, base_b, encode_blocks=ENCODE_BLOCKS,
            use_tpu_model_search=True))
        enc_launches = encode_cuda.encode_blocks.launches
        serial_words = len(g.prelude.stream)
        words_b = len(res_b.prelude.stream)
        same_model = models_equal(res_b.prelude.model, g.prelude.model)
        emit("store_blocks", graph="cnr-2000", blocks=ENCODE_BLOCKS,
             seconds=store_s, stage_seconds=res_b.seconds,
             ans_bytes=os.path.getsize(base_b + ".ans"),
             stream_words=words_b, serial_stream_words=serial_words,
             launches={"encode_blocks": enc_launches},
             model_equals_host=same_model)
        if enc_launches < 1:
            raise SystemExit("block store never launched the encode kernel")
        if words_b > serial_words + 2 * ENCODE_BLOCKS:
            raise SystemExit("block store: stream grew more than 2 words "
                             "per block")
        if not same_model:
            raise SystemExit("device model search chose another model")

        # ---- 13. encode kernel vs plain on the cnr-2000 512-lane plan, and
        # its times ----
        cplan = encode_plan(res_b.prelude.model, vals_c, comps_c,
                            ENCODE_BLOCKS, device=cuda)
        ekres = encode_cuda.encode_blocks(*encode_args(cplan))
        epres, enc_plain_s = timed(
            lambda: encode_blocks_plain(*encode_args(cplan)))
        cmp_enc = compare(ekres, epres)
        t_enc = cuda_ms(lambda: encode_cuda.encode_blocks(
            *encode_args(cplan)))
        # the launch alone, without the wrapper's component-id check (one
        # reduction and a host read), and each of its two kernel launches
        t_launch = cuda_ms(lambda: encode_cuda._launch(*encode_args(cplan)))
        cemit = torch.empty_like(ekres[0])
        crec = encode_cuda.records(cplan.params, cplan.tab, cplan.tokens,
                                   cemit, cplan.cap)
        t_records = cuda_ms(lambda: encode_cuda.records(
            cplan.params, cplan.tab, cplan.tokens, cemit, cplan.cap))
        t_lanes = cuda_ms(lambda: encode_cuda.lanes(
            crec, cemit, cplan.tstart, cplan.tend, cplan.cap,
            cplan.params[9]))
        del crec, cemit
        enc_geometry = encode_cuda.launch_geometry(
            cplan.tstart.shape[0], cplan.tokens.shape[0], cplan.cap,
            cplan.params[9])
        enc_bound = encode_bound(cplan, ekres[3])
        emit("encode_kernel_time", kernel="encode_blocks",
             lanes=cplan.tstart.shape[0], cap=cplan.cap,
             max_folds=cplan.params[9], ms=t_enc, launch_ms=t_launch,
             records_ms=t_records, lanes_ms=t_lanes,
             ns_per_step=t_launch["median"] * 1e6 / cplan.cap,
             plain_ms=enc_plain_s * 1e3, library_ms=None, **enc_geometry,
             **cmp_enc, **enc_bound)
        if not cmp_enc["bit_equal"]:
            raise SystemExit("cnr-2000: encode kernel and plain version "
                             "differ")

        # ---- 14. the card-written artifact decodes back exactly: token
        # drive, merged emit into the verified steady state, sequential ----
        gb = ANSBvGraph.load(base_b)
        t0 = time.perf_counter()
        vals_b, comps_b = TorchGraphDecoder(gb).decode_tokens(LANES)
        off_b, succs_b = reconstruct(vals_b, comps_b, n,
                                     gb.prelude.min_interval_length)
        tok_s = time.perf_counter() - t0
        tok_exact = (np.array_equal(off_b, adj.offsets)
                     and np.array_equal(succs_b, adj.succs))
        bdec = TorchGraphDecoder(gb)
        emit_calls = []
        for _ in range(6):
            res3, sec = timed(
                lambda: bdec.decode_to_adjacency_device(EMIT_LANES))
            bpl = bdec._plans[("emit", EMIT_LANES)]
            emit_calls.append({"seconds": sec,
                               "exact": exact_adjacency(res3),
                               "verified": bool(bpl.get("verified"))})
            if bpl.get("verified") and "fx_offs" in bpl.get("post_meta", {}):
                break
        res3, steady_b = timed(
            lambda: bdec.decode_to_adjacency_device(EMIT_LANES))
        emit_calls.append({"seconds": steady_b, "steady": True,
                           "exact": exact_adjacency(res3)})
        seq, seq_s = timed(lambda: ANSBvGraphSeq.load(base_b).decode_all())
        seq_exact = (np.array_equal(seq.offsets, adj.offsets)
                     and np.array_equal(seq.succs, adj.succs))
        emit("blocks_roundtrip", graph="cnr-2000",
             token_drive={"lanes": LANES, "seconds": tok_s,
                          "exact": tok_exact},
             merged_emit={"lanes": len(bpl["starts_np"]), "T": bpl["T"],
                          "cap": bpl["cap"], "calls": emit_calls},
             sequential={"seconds": seq_s, "exact": seq_exact})
        if not (tok_exact and seq_exact
                and all(c["exact"] for c in emit_calls)
                and emit_calls[-2]["verified"]):
            raise SystemExit("block artifact: a decode path is not exact, "
                             "or the merged-emit plan never verified")

    if spills:
        raise SystemExit(f"kernel instances spill registers: {spills}")

    # ---- 15. the kernels line ----
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
        "lanes": len(epl["starts_np"]), **geometry,
    }, {
        "name": "encode_blocks", "route": "cuda",
        "source": "webgraph_ans_torch/csrc/encode_blocks.cu",
        "replaces": "webgraph_ans_tpu/ops/encode_pallas.py:291",
        "launches": enc_launches, "bit_equal": cmp_enc["bit_equal"],
        "max_abs_err": cmp_enc["max_abs_err"], "ms": t_enc["median"],
        "plain_ms": enc_plain_s * 1e3, "bound_ms": enc_bound["bound_ms"],
        "bound_by": enc_bound["bound_by"], "library_ms": None,
        "lanes": cplan.tstart.shape[0], **enc_geometry,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
