"""Drives the PyTorch/CUDA port on one NVIDIA GPU and checks it.

    python3 chip_smoke.py [--parent DIR]

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
without the graph, and at 4096 lanes; its fixup kernel, emit_fixup, held
bit for bit against its plain version and timed beside its bound), and
block-parallel compression
(store with 512 encode blocks and the device model search, its artifact
decoded back through both device paths and the sequential reader, the
merged emit's steady plan split inside the encode blocks and timed
beside the serial artifact's, and a second store byte for byte the
first). Then
the paths built on the same kernels: the sort-path reconstruction
(decode_to_csr_device, the aux-mode decode and the device reconstruction)
on cnr-2000 and on its high-compression artifact (window 16, unbounded
reference chains: the deep rounds), the fallback of
decode_to_adjacency_device onto it (a window past 16) and a window-16
chain without safe breaks on the merged emit, the JAX bench's
high-compression mode (window 16 with a reference root every 128 nodes)
through the merged emit's window-16 kernel at 1024 lanes into its steady
state (failing if the sort path served; its fixup kernel held and timed
as on the window-7 plan), the reference's own high-compression artifact
(no safe breaks, chains 4,506 deep) the same way, its lanes cut inside
the long safe gaps and its fixup held on its layout, beside the sort
path's time on it, and batch
random access on cnr-2000 (wave decode, the device CSR server,
per-query merged-emit lanes, with their reruns at larger caps, and the
full-decode route), the device-resident serving contract
(successors_batch_device: the JAX bench's on-demand protocol, 262,144
queries drawn on the card a batch, one steady batch under
torch.cuda.set_sync_debug_mode("error")) and its serve protocol (2^20
queries gathered from the device CSR), and random access on a
block-encoded, phase-sampled artifact, each checked list for list, with
the token and merged-emit kernels held against their plain versions at
the shapes random access and the hc mode give them.
Then scale-out on the one card: the sharded token decode over four
entries of cuda:0 (serial and 512-block artifacts) and the sharded
merged emit (a fresh plan and the verified one), each bit for bit the
single-device call's, with one shard's kernel launch held against its
plain version; the launcher (python -m webgraph_ans_torch.launch) at four
ranks over gloo on the card, on the serial and the high-compression
artifact, and at one rank over NCCL on both, each rank's shard gathered
in node order and checked against the input; and dryrun_multichip(4).
Then every single-device path at the JAX package's bench size: the
4,000,000-node synthetic web graph (synth_web_graph(4_000_000, seed=7),
generated in the run), its serial artifact and a 512-block artifact
encoded on the card; the token path, the merged emit into its steady
state and the sort path at 8192 lanes, the merged emit and the sort path
on the block artifact with the sequential reader, and the three
random-access forms with the on-demand and serve protocols, each list
for list against the generated graph, with
each phase's peak device memory and its int32 layouts' largest sizes as
shares of 2^31, and each kernel timed at those shapes and held against its
plain version there: the token, aux-mode and both merged-emit plans'
launches on a slice of lanes holding the plan's longest lane at the
plan's cap, the on-demand plan's merged emit and the encode on every lane
at a shorter cap (a plain run to their caps of over 30,000 steps would
not finish in the run), each with the plain version's seconds per step. These holds, of
the hc mode's and the scale phases' shapes, run their plain versions on
copies of the inputs on the host CPU, in helper processes beside the main
path, and are settled before the kernels line (plain_holds). Each phase prints
one JSON line; any failure raises and exits non-zero. The line before the
last lists the kernels, with their launches summed over every path (the
launcher's ranks report their own); the last line is the device record.
On each merged-emit artifact of the benchmark (the serial, the 512-block
and both high-compression stores) a `fold` line gives the steady
decode_emit's rows written by run folding, each lane's full steps and the
lane with the most; with --parent DIR (a checkout, e.g. a `git archive`
of another commit, unpacked) it also builds that checkout's decode_emit,
holds it bit for bit against this one on every channel both write, and
times the two in turns.
Exits 1 without printing a result when CUDA is not available.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import logging
import multiprocessing
import multiprocessing.pool
import os
import re
import signal
import socket
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
# the calls of a merged-emit plan that run its full post-pass, each with
# one fixup launch where its layout has dirty nodes: plan.first,
# plan.bounds and plan.verify
PLANNING_CALLS = 3
SMALL_LANES = 64
TIMED_RUNS = 20
SHARDS = 4      # device entries of the sharded paths, all on DEVICE
RANKS = 4       # launcher ranks on the one card (gloo)
DEVICE = "cuda:0"
# The scale phases: the JAX package's bench fixture (bench.py:352-361),
# generated here (numpy versions differ in the graph they draw), its
# serial artifact and a 512-block artifact encoded on the card, decoded
# at the bench's 8192 lanes.
SYNTH_NODES = 4_000_000
SYNTH_SEED = 7
SCALE_LANES = 8192
SCALE_BLOCKS = 512
# the planner's bisection: 40 passes of the split and the final one
SPLIT_PASSES = 41
# The scale phases' holds against the plain versions: a slice of this
# many lanes holding the plan's longest lane, at the plan's cap; or, where
# a plain run to the cap would not finish in the run (the on-demand plan's
# merged emit and the encode, caps past 30,000), every lane at this cap.
SCALE_PLAIN_LANES = 512
SCALE_PLAIN_CAP = 4096
# Those holds' plain versions run on the host CPU (the plain versions are
# paced by their per-step operations, not by the device) in this many
# helper processes of this many threads each, beside the main path.
HOLD_WORKERS = 3
HOLD_THREADS = 2
# The JAX bench's high-compression mode (bench.py:293-340): cnr-2000 at
# window 16, unbounded references, min interval 4, a reference root every
# 128 nodes, decoded by the merged emit at 1024 lanes.
HC_SAFE_BREAK = 128
HC_LANES = 1024
# The JAX bench's device protocols (tools/bench_device.py): on-demand
# batches of 262,144 queries drawn on the card, two or more warm batches
# (until the plan is steady), five timed reps; serving 2^20 queries from a
# device CSR, out_cap at 1.3 times the mean degree.
ONDEMAND_BATCH = 262_144
ONDEMAND_REPS = 5
SERVE_BATCH = 1 << 20
SERVE_REPS = 5

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
# the token decode alone also serves windows past the merged-emit
# kernel's 16 (the sort path)
BLOCKS_ONLY_CONFIGS = [("w20", 20, 3, 2, 1)]
# merged-emit cases forced into dirty rows: a ring of 32 rows on the
# window-7 artifact (copy sources fall out of the ring: codes 8 and 9);
# the phase-sampled artifact has no halo (cross-lane parents: code 7); the
# small graph's node 500 overflows the interval queue (code 3)
SMALL_RING_T = {"w7_r3_i2": 32}
DIRTY_CODES = (3, 7, 8, 9)


RUN_START = time.perf_counter()


def _pending(obj):
    """JSON form of a hold still running in a helper process."""
    if isinstance(obj, multiprocessing.pool.AsyncResult):
        return "pending: see the plain_holds line"
    raise TypeError(f"{type(obj).__name__} is not JSON serialisable")


def emit(phase: str, **fields) -> None:
    """One phase line, with the seconds since the run started."""
    print(json.dumps({"phase": phase, **fields,
                      "run_seconds": time.perf_counter() - RUN_START},
                     default=_pending),
          flush=True)


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


def longest_slice(steps: torch.Tensor) -> slice:
    """SCALE_PLAIN_LANES consecutive lanes holding the lane of most
    steps."""
    L = steps.shape[0]
    lo = max(0, min(int(torch.argmax(steps)) - SCALE_PLAIN_LANES // 2,
                    L - SCALE_PLAIN_LANES))
    return slice(lo, min(lo + SCALE_PLAIN_LANES, L))


class _HostArray:
    """A tensor's host copy on its way to a helper process (as a numpy
    array: pickled through the pipe, not through shared memory)."""

    def __init__(self, t: torch.Tensor):
        self.a = t.cpu().numpy()


def _map_leaves(obj, fn):
    """obj with fn applied to every leaf, through tuples, named tuples
    and lists."""
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_map_leaves(x, fn) for x in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_map_leaves(x, fn) for x in obj)
    return fn(obj)


def _to_host(obj):
    return _map_leaves(obj, lambda x: _HostArray(x)
                       if isinstance(x, torch.Tensor) else x)


def _from_host(obj):
    return _map_leaves(obj, lambda x: torch.from_numpy(x.a)
                       if isinstance(x, _HostArray) else x)


def _hold_worker_init():
    torch.set_num_threads(HOLD_THREADS)


def _plain_hold(fn: str, args, kwargs, kernel_res, lanes, cap, steps):
    """In a helper process: the plain version `fn` ("module.function")
    on host copies of the inputs, against the kernel's outputs."""
    mod, name = fn.rsplit(".", 1)
    plain_fn = getattr(importlib.import_module(mod), name)
    args, kernel_res = _from_host(args), _from_host(kernel_res)
    t0 = time.perf_counter()
    plain = plain_fn(*args, **kwargs)
    sec = time.perf_counter() - t0
    return {"lanes": lanes, "cap": cap, "steps": steps,
            "plain_device": "cpu", "plain_seconds": sec,
            "plain_seconds_per_step": sec / steps,
            **compare(kernel_res, plain)}


class Holds:
    """The helper processes that run the plain holds on the host CPU."""

    def __init__(self):
        self.pool = multiprocessing.get_context("spawn").Pool(
            HOLD_WORKERS, initializer=_hold_worker_init)

    def close(self):
        self.pool.terminate()
        self.pool.join()


HOLDS: Holds | None = None


def hold_plain(kernel_res, fn: str, args, kwargs, lanes: slice, cap: int,
               steps: int):
    """Starts the hold of the kernel's outputs at `lanes` (the last
    dimension of each) against fn(*args, **kwargs), the plain version on
    those lanes, which runs `steps` steps: on host copies, in a helper
    process. Returns its pending result, settled by settle_holds (with
    the plain seconds and seconds per step)."""
    return HOLDS.pool.apply_async(_plain_hold, (
        fn, _to_host(args), kwargs,
        _to_host([k[..., lanes] for k in kernel_res]),
        [lanes.start, lanes.stop], cap, steps))


def settle_holds(kernels: dict) -> None:
    """Waits for every pending hold of kernels (name -> kernel record),
    puts its result in place, prints them on one line and fails the run
    if a kernel differs from its plain version."""
    t0 = time.perf_counter()
    for k in kernels.values():
        k["plain"] = k["plain"].get()
    emit("plain_holds", wait_seconds=time.perf_counter() - t0,
         holds={name: k["plain"] for name, k in kernels.items()})
    bad = [name for name, k in kernels.items()
           if not k["plain"]["bit_equal"]]
    if bad:
        raise SystemExit(f"kernels differ from their plain versions: {bad}")


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


def launch_counts(reset: bool = False) -> dict:
    """The kernels' launch counts; reset sets them to 0 first."""
    from webgraph_ans_torch.ops import (decode_cuda, emit_cuda, encode_cuda,
                                        fixup_cuda)
    blocks, emit_k = decode_cuda.decode_blocks, emit_cuda.decode_emit
    enc, fix = encode_cuda.encode_blocks, fixup_cuda.emit_fixup
    if reset:
        blocks.launches = blocks.aux_launches = emit_k.launches = 0
        enc.launches = fix.launches = 0
    return {"decode_blocks": blocks.launches,
            "decode_blocks_aux": blocks.aux_launches,
            "decode_emit": emit_k.launches, "encode_blocks": enc.launches,
            "emit_fixup": fix.launches}


class PathRuns:
    """Runs each path with the launch counts set to 0 just before and read
    just after, fails when a kernel the path needs never launched, and
    sums the counts over the paths."""

    def __init__(self):
        self.total = {k: 0 for k in launch_counts()}

    def __call__(self, name: str, fn, needs):
        launch_counts(reset=True)
        res = fn()
        counts = launch_counts()
        for k, v in counts.items():
            self.total[k] += v
        missing = [k for k in needs if counts[k] < 1]
        if missing:
            raise SystemExit(f"{name}: never launched {missing} ({counts})")
        return res, counts


def csr_exact(offsets, succs, E, adj) -> bool:
    """A device CSR (offsets [n+1], succs[:E]) equals the input graph."""
    return (E == adj.num_arcs
            and np.array_equal(offsets.cpu().numpy().astype(np.int64),
                               adj.offsets.astype(np.int64))
            and np.array_equal(succs[:E].cpu().numpy().astype(np.uint32),
                               adj.succs))


def adjacency_equal(a, b) -> bool:
    return (np.array_equal(a.offsets.astype(np.int64),
                           b.offsets.astype(np.int64))
            and np.array_equal(a.succs.astype(np.uint32),
                               b.succs.astype(np.uint32)))


def rand_lists(n: int, seed: int, dmax: int) -> list:
    rng = np.random.default_rng(seed)
    return [sorted(rng.choice(n, size=int(rng.integers(0, dmax)),
                              replace=False).tolist()) for _ in range(n)]


class Warnings(logging.Handler):
    """Collects the warnings a logger emits."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def sort_path_phases(g, adj, edec, runs: PathRuns, hc_base: str) -> float:
    """Phases 15-17: the sort path on cnr-2000 (serial and
    high-compression), the fallbacks of decode_to_adjacency_device and a
    window-16 chain without safe breaks on the merged emit. The
    high-compression artifact is also written to hc_base. Returns the
    sort path's warm seconds on it."""
    from webgraph_ans_torch import ANSBvGraph, TorchGraphDecoder
    from webgraph_ans_torch.ans.prelude import save_pointers, save_states
    from webgraph_ans_torch.bvgraph.graph import Adjacency
    from webgraph_ans_torch.bvgraph.store import compress_adjacency
    from webgraph_ans_torch.ops import graph_decode
    from webgraph_ans_torch.ops.emit_post import to_host_lists
    from webgraph_ans_torch.ops.reconstruct_device import (
        DEPTH_BUCKETS, parse_stats, reconstruct_device)

    n, arcs = g.num_nodes, g.num_arcs

    # ---- 15. the sort path on the serial artifact: cold (the aux cap
    # tightened by one observation decode, the meta fetched), then warm
    # (the cached meta only verified), and the reconstruction alone ----
    sdec = TorchGraphDecoder(g)
    (res, cold_s), counts = runs(
        "sort path", lambda: timed(
            lambda: sdec.decode_to_csr_device(EMIT_LANES)),
        ["decode_blocks_aux"])
    exact = [csr_exact(*res, adj)]
    warm = []
    for _ in range(5):
        res, sec = timed(lambda: sdec.decode_to_csr_device(EMIT_LANES))
        warm.append(sec)
        exact.append(csr_exact(*res, adj))
    del res
    out, _, acap = sdec.decode_raw(EMIT_LANES, emit_aux=True)
    mc = sdec.plan(EMIT_LANES)["recon_meta"]
    t_cached = cuda_ms(lambda: reconstruct_device(out, n, arcs, acap, mc),
                       runs=10)
    t_uncached = cuda_ms(lambda: reconstruct_device(out, n, arcs, acap),
                         runs=5)
    del out
    warm_s = statistics.median(warm)
    emit("sort_path", graph="cnr-2000", lanes=EMIT_LANES, cap=acap,
         cold_seconds=cold_s, cold_ns_per_arc=cold_s * 1e9 / arcs,
         warm_seconds=warm_s, warm_ns_per_arc=warm_s * 1e9 / arcs,
         warm_runs=warm, reconstruct_ms_cached_meta=t_cached,
         reconstruct_ms_uncached=t_uncached,
         meta=[int(x) for x in mc["meta"][:4]], exact=all(exact),
         launches=counts)
    if not all(exact):
        raise SystemExit("sort path: the CSR differs from the input graph")
    del sdec

    # ---- 16. the sort path on cnr-2000 hc (window 16, unbounded
    # reference chains, no safe breaks): the deep rounds ----
    res_hc, store_s = timed(
        lambda: compress_adjacency(adj, 16, 2_000_000_000, 4))
    res_hc.prelude.save(hc_base)
    save_states(hc_base, res_hc.states)
    save_pointers(hc_base, res_hc.pointers)
    hdec = TorchGraphDecoder(ANSBvGraph(res_hc.prelude, res_hc.states,
                                        res_hc.pointers))
    (res, hc_cold_s), counts = runs(
        "sort path hc", lambda: timed(
            lambda: hdec.decode_to_csr_device(EMIT_LANES)),
        ["decode_blocks_aux"])
    hc_exact = [csr_exact(*res, adj)]
    res, hc_warm_s = timed(lambda: hdec.decode_to_csr_device(EMIT_LANES))
    hc_exact.append(csr_exact(*res, adj))
    del res
    meta = hdec.plan(EMIT_LANES)["recon_meta"]["meta"]
    max_depth = int(meta[3])
    # pass 1 alone: its reference-chain depths by pointer jumping, a fixed
    # ceil(log2 n) rounds without a host synchronisation
    out, _, hcap = hdec.decode_raw(EMIT_LANES, emit_aux=True)
    t_parse = cuda_ms(lambda: parse_stats(out, n, hcap), runs=5)
    del out
    emit("sort_path_hc", graph="cnr-2000 hc", window=16,
         max_ref_count=2_000_000_000, min_interval_length=4,
         store_seconds=store_s, stream_words=len(res_hc.prelude.stream),
         lanes=EMIT_LANES, cold_seconds=hc_cold_s,
         cold_ns_per_arc=hc_cold_s * 1e9 / arcs, warm_seconds=hc_warm_s,
         warm_ns_per_arc=hc_warm_s * 1e9 / arcs, max_depth=max_depth,
         parse_stats_ms=t_parse, depth_jump_rounds=(n - 1).bit_length(),
         deep_rounds=max_depth if max_depth >= DEPTH_BUCKETS - 1 else 0,
         exact=all(hc_exact), launches=counts)
    if not all(hc_exact) or max_depth < DEPTH_BUCKETS - 1:
        raise SystemExit("sort path hc: not exact, or the deep rounds "
                         "never ran")
    del hdec, res_hc

    # ---- 17. decode_to_adjacency_device on the card: the fallback of a
    # window past 16 (two calls), and a window-16 chain 299 deep without
    # safe breaks on the merged emit (five calls, into the steady state):
    # its lanes are cut inside the chain and the first 512-row ring loses
    # node 1's copy source (600 rows back), so the fixup finishes dirty
    # chains hundreds of nodes deep ----
    caught = Warnings()
    logging.getLogger(graph_decode.__name__).addHandler(caught)
    cases = {"window20": (rand_lists(2000, 20, 24), (20, 3, 2), 2,
                          ["decode_blocks_aux"]),
             "w16_chain_no_breaks": ([list(range(0, 1800, 3))] * 300,
                                     (16, 2_000_000_000, 4), 5,
                                     ["decode_emit", "emit_fixup",
                                      "decode_blocks_aux"])}
    fallbacks = []
    for name, (lists_f, args, ncalls, needs) in cases.items():
        res_f = compress_adjacency(Adjacency.from_lists(lists_f), *args)
        fdec = TorchGraphDecoder(ANSBvGraph(res_f.prelude, res_f.states,
                                            res_f.pointers))
        caught.messages.clear()

        def calls():
            return [to_host_lists(*fdec.decode_to_adjacency_device(
                SMALL_LANES), len(lists_f)) for _ in range(ncalls)]

        got, counts = runs(f"fallback {name}", calls, needs)
        fpl = fdec._plans[("emit", SMALL_LANES)]
        fallbacks.append({
            "case": name, "cause": fpl.get("emit_broken"),
            "steady": fdec.emit_steady(SMALL_LANES),
            "fixup_rounds": fpl.get("post_meta", {}).get("rounds"),
            "warnings": caught.messages[:],
            "device": str(fdec.device), "launches": counts,
            "exact": all([x.tolist() for x in lists_got] == lists_f
                         for lists_got in got)})
    logging.getLogger(graph_decode.__name__).removeHandler(caught)
    steady_broken = edec._plans[("emit", EMIT_LANES)].get("emit_broken")
    emit("fallbacks", cases=fallbacks,
         cnr2000_steady_emit_broken=steady_broken)
    if not (all(f["exact"] for f in fallbacks)
            and fallbacks[0]["cause"] == "window 20 > 16"
            and fallbacks[1]["cause"] is None and fallbacks[1]["steady"]
            and not steady_broken):
        raise SystemExit("fallbacks: wrong lists or causes, the window-16 "
                         "chain left the merged emit, or cnr-2000's "
                         "merged-emit path fell back")
    return hc_warm_s


def wave_vs_plain(ra, q) -> dict:
    """decode_blocks in token mode against its plain version on the
    inputs of the first wave of ra's batch of the queries q: one lane a
    segment holding a query, at the cap that wave ran."""
    from webgraph_ans_torch.ops.decode_cuda import decode_blocks
    from webgraph_ans_torch.ops.decode_torch import decode_blocks_plain
    d = ra.dec
    segs = np.unique(ra._seg_of(np.unique(q)))
    lanes, cap = ra.last_waves[0]
    if len(segs) != lanes:
        raise SystemExit(f"wave inputs: {len(segs)} lanes, the batch's "
                         f"first wave ran {lanes}")
    args = (d.tables, *ra._segment_inputs(segs), d.window, d.min_interval,
            cap)
    return {"lanes": lanes, "cap": cap,
            **compare(decode_blocks(*args), decode_blocks_plain(*args))}


def emit_rounds_vs_plain(era, q, rounds: list, max_plain_cap: int) -> list:
    """decode_emit against its plain version on the per-query lanes of
    era's batch of the queries q, round by round up to max_plain_cap:
    the register files and pointers that batch built, its lane count, cap
    and T. Each round's queries are those the plain version's flags
    leave unfinished in the round before; the counts of lanes past the
    cap and of dirty lanes the batch recorded must be the plain
    version's."""
    from webgraph_ans_torch.ops.emit_cuda import decode_emit
    from webgraph_ans_torch.ops.emit_torch import decode_emit_plain
    d = era.dec
    todo = np.unique(q)
    out = []
    for r in rounds:
        if r["cap"] > max_plain_cap:
            break
        qp = era._padded(todo)
        regs, ptrs = era._lane_inputs(torch.from_numpy(qp).cuda())
        args = (d.tables, regs, ptrs, d.window, d.min_interval, r["cap"])
        k = decode_emit(*args, T=r["T"])
        p = decode_emit_plain(*args, T=r["T"])
        ok = p[4][:len(todo)].cpu().numpy()
        dirty = ((p[5][1][:len(todo)] & 1) != 0).cpu().numpy()
        res = {"cap": r["cap"], "T": r["T"], "lanes": len(qp),
               "queries": len(todo), **compare(k, p),
               "plain_over_cap": int((~ok).sum()),
               "plain_dirty": int((ok & dirty).sum()),
               "batch_over_cap": r["over_cap"], "batch_dirty": r["dirty"]}
        res["flags_agree"] = (len(qp) == r["lanes"]
                              and len(todo) == r["queries"]
                              and res["plain_over_cap"] == r["over_cap"]
                              and res["plain_dirty"] == r["dirty"])
        out.append(res)
        todo = todo[~ok]
    return out


def random_access_phases(g, adj, edec, runs: PathRuns, smi: str) -> dict:
    """Phases 18-19b: batch random access on cnr-2000, the device-resident
    serving contract and the serve protocol there, and random access on a
    block-encoded, phase-sampled artifact. Returns the comparisons of
    each kernel with its plain version at the shapes these paths give
    it."""
    from webgraph_ans_torch import (ANSBvGraph, TorchCsrServer,
                                    TorchEmitRandomAccess, TorchGraphDecoder,
                                    TorchRandomAccess)
    from webgraph_ans_torch.bvgraph.graph import Adjacency
    from webgraph_ans_torch.bvgraph.store import compress_adjacency
    from webgraph_ans_torch.ops.random_torch import gather_rows
    from webgraph_ans_torch.ops.reconstruct_device import _quant

    n = g.num_nodes
    rng = np.random.default_rng(2026)

    def native(q):
        return g.successors_batch(np.asarray(q).astype(np.uint64))

    # ---- 18. random access on cnr-2000, each batch against the port's
    # native per-node decoder ----
    ra = TorchRandomAccess(TorchGraphDecoder(g))
    wave = []
    for _ in range(3):
        q = rng.integers(0, n, 10_000)
        (got, sec), counts = runs("wave random access", lambda: timed(
            lambda: ra.successors_batch(q)), ["decode_blocks"])
        wave.append({"seconds": sec, "arcs": len(got.succs),
                     "ns_per_arc": sec * 1e9 / max(len(got.succs), 1),
                     "waves": ra.last_waves,
                     "decode_blocks_launches": counts["decode_blocks"],
                     "exact": adjacency_equal(got, native(q))})
    # the token kernel at the first wave's lanes and cap, against plain
    wave_cmp = wave_vs_plain(ra, q)
    emit("wave_kernel_vs_plain", **wave_cmp)
    if not wave_cmp["bit_equal"]:
        raise SystemExit("decode_blocks differs from its plain version on "
                         "a random-access wave")

    (srv, build_s), counts = runs("CSR server", lambda: timed(
        lambda: TorchCsrServer(TorchGraphDecoder(g), num_lanes=EMIT_LANES)),
        ["decode_blocks_aux"])
    q1m = rng.integers(0, n, 1_000_000)
    got = srv.successors_batch(q1m)
    csr_exact_1m = adjacency_equal(got, native(q1m))
    serve = [timed(lambda: srv.serve(q1m))[1] for _ in range(5)]
    qd = torch.from_numpy(q1m.astype(np.int32)).to(srv.succs.device)
    out_cap = _quant(len(got.succs))
    t_gather = cuda_ms(lambda: gather_rows(srv.offsets, srv.succs, qd,
                                           out_cap), runs=10)
    serve_s = statistics.median(serve)
    csr = {"build_seconds": build_s, "build_launches": counts,
           "queries": len(q1m), "arcs": len(got.succs),
           "batch_seconds": serve_s,
           "ns_per_arc": serve_s * 1e9 / len(got.succs),
           "gather_device_ms": t_gather, "exact": csr_exact_1m}
    del got, qd
    # ---- 19b. the device-resident serving contract
    # (successors_batch_device) and the serve protocol on cnr-2000 ----
    ondemand_phase(Scale(runs, smi, None, graph="cnr-2000"), g, adj, srv)
    del srv

    era = TorchEmitRandomAccess(edec)
    emit_runs = {}
    for B in (4096, 65_536):
        batches = []
        for _ in range(4):
            q = rng.integers(0, n, B)
            (got, sec), counts = runs(
                f"emit random access {B}",
                lambda: timed(lambda: era.successors_batch(q)),
                ["decode_emit"])
            rounds = era.last_rounds
            uniq = len(np.unique(q))
            batches.append({
                "seconds": sec, "arcs": len(got.succs),
                "ns_per_arc": sec * 1e9 / max(len(got.succs), 1),
                "rounds": rounds,
                "rerun_share": (rounds[0]["over_cap"] / uniq if rounds
                                else 0.0),
                "unclean_to_wave": era.last_unclean,
                "wave_seconds": era.last_wave_seconds,
                "decode_emit_launches": counts["decode_emit"],
                "decode_blocks_launches": counts["decode_blocks"],
                "exact": adjacency_equal(got, native(q)),
                # what is left to the wave decode: the dirty lanes of
                # every round and the lanes past the last cap whose ring
                # fits
                "unclean_consistent": era.last_unclean == (
                    sum(r["dirty"] for r in rounds)
                    + (rounds[-1]["over_cap"] if rounds else 0))})
            if B == 4096:
                last_q, last_rounds = q, rounds
        emit_runs[str(B)] = {
            "route": ("full decode" if era._full_decode_cheaper(B)
                      else "per-query lanes"), "batches": batches}
    emit("random_access", graph="cnr-2000", wave_10000=wave,
         csr_server=csr, emit=emit_runs,
         full_decode_from_unique=-(-n // (era.H + 1)))
    if not (all(w["exact"] for w in wave) and csr["exact"]
            and all(b["exact"] and b["unclean_consistent"]
                    for r in emit_runs.values() for b in r["batches"])):
        raise SystemExit("random access: a batch differs from the native "
                         "decoder, or its unclean count from its rounds")
    # the merged-emit kernel on the per-query lanes of the last
    # 4,096-query batch (its first round and the reruns up to cap 1536),
    # against plain
    emit_cmp = emit_rounds_vs_plain(era, last_q, last_rounds, 1536)
    emit("emit_lanes_kernel_vs_plain", rounds=emit_cmp)
    if not (emit_cmp and all(r["bit_equal"] and r["flags_agree"]
                             for r in emit_cmp)):
        raise SystemExit("decode_emit differs from its plain version on "
                         "the per-query lanes, or the batch's flags from "
                         "the plain version's")

    # ---- 19. random access on a block-encoded, phase-sampled artifact,
    # against the input lists (the reference's native decode is wrong
    # there: nodes 92, 136, 137) ----
    lists_b = rand_lists(180, 17, 11)
    res_b = compress_adjacency(Adjacency.from_lists(lists_b), 7, 3, 2,
                               encode_blocks=4)
    bdec = TorchGraphDecoder(sampled_graph(ANSBvGraph, res_b, 3))
    q = np.concatenate([np.arange(180), [92, 136, 137, 136]])
    want = [lists_b[x] for x in q]
    got_w, counts_w = runs(
        "wave random access, blocks",
        lambda: TorchRandomAccess(bdec).successors_batch(q).to_lists(),
        ["decode_blocks"])
    got_c, counts_c = runs("CSR server, blocks", lambda: TorchCsrServer(
        bdec, num_lanes=8).successors_batch(q).to_lists(),
        ["decode_blocks_aux"])
    emit("random_access_blocks_sampled", nodes=180, encode_blocks=4,
         phase_step=3, blocks=[int(x) for x in bdec.graph.prelude.blocks[0]],
         wave_exact=got_w == want, csr_exact=got_c == want,
         launches={"wave": counts_w, "csr": counts_c})
    if not (got_w == want and got_c == want):
        raise SystemExit("random access on the block-sampled artifact: "
                         "lists differ from the input")
    return {"decode_blocks": wave_cmp,
            "decode_emit": {"bit_equal": all(r["bit_equal"]
                                             for r in emit_cmp),
                            "max_abs_err": max(r["max_abs_err"]
                                               for r in emit_cmp)}}


def run_launcher(args: list, timeout: float):
    """python -m webgraph_ans_torch.launch with `args`, in a process group
    of its own that its ranks join: fails on a nonzero exit, kills the
    whole group at the timeout, and leaves no rank behind. Returns (the
    ranks' reports by rank, the gather's line or None, host seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "webgraph_ans_torch.launch", *args], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise SystemExit(f"launcher still running after {timeout} s: {args}")
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit(f"launcher exited with {proc.returncode} ({args}):\n"
                         f"{err[-4000:]}")
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    reports = sorted((x for x in lines if "process" in x),
                     key=lambda r: r["process"])
    gathered = [x for x in lines if "gathered" in x]
    return reports, (gathered[0] if gathered else None), seconds


def adjacency_exact(res3, adj) -> bool:
    """The merged-emit contract's (succs2d, starts_flat, degs) equals the
    input graph, through to_dense_csr."""
    from webgraph_ans_torch import to_dense_csr
    from webgraph_ans_torch.ops.reconstruct_device import _quant

    n, arcs = adj.num_nodes, adj.num_arcs
    offs_d, succs_d = to_dense_csr(*res3, _quant(arcs))
    host = torch.cat([offs_d[:n + 1], succs_d[:arcs]]).cpu().numpy()
    return (np.array_equal(host[:n + 1].astype(np.int64),
                           adj.offsets.astype(np.int64))
            and np.array_equal(host[n + 1:].astype(np.uint32), adj.succs))


def scale_out_phases(g, gb, adj, edec, runs: PathRuns, tmp: str,
                     hc_base: str) -> dict:
    """Phases 20-25: scale-out on the card. The sharded token decode over
    SHARDS entries of cuda:0 on the serial and the 512-block artifact, the
    sharded merged emit, the launcher's ranks over gloo on the one card
    (serial and hc artifact) and one NCCL rank on each, all gathered and
    checked,
    and the dry run. Returns the comparisons of each kernel with its plain
    version at one shard's shape."""
    from webgraph_ans_torch import (ShardedGraphDecoder, TorchGraphDecoder,
                                    reconstruct)
    from webgraph_ans_torch.dryrun import dryrun_multichip
    from webgraph_ans_torch.ops import decode_cuda, emit_cuda
    from webgraph_ans_torch.ops.decode_torch import decode_blocks_plain
    from webgraph_ans_torch.ops.emit_torch import decode_emit_plain
    from webgraph_ans_torch.parallel.sharded import sharded_emit_adjacency

    cuda0 = torch.device(DEVICE)
    devs = [cuda0] * SHARDS
    per_shard = LANES // SHARDS
    cmp_blocks = []

    # ---- 20-21. the sharded token decode, against the single-device
    # token drive and the input lists; the last shard's launch against
    # the plain version at its lanes and cap ----
    for name, graph in (("cnr-2000", g), ("cnr-2000 b512", gb)):
        single = TorchGraphDecoder(graph, device=cuda0)
        want_v, want_c = single.decode_tokens(LANES)
        sdec = ShardedGraphDecoder(graph, devs)
        (tok, cold_s), counts = runs(
            f"sharded tokens {name}", lambda: timed(
                lambda: sdec.decode_tokens(lanes_per_device=per_shard)),
            ["decode_blocks"])
        tokens_equal = (np.array_equal(tok[0], want_v)
                        and np.array_equal(tok[1], want_c))
        off, succs = reconstruct(*tok, graph.num_nodes,
                                 graph.prelude.min_interval_length,
                                 device=cuda0)
        lists_exact = (np.array_equal(off, adj.offsets)
                       and np.array_equal(succs, adj.succs))
        pl = sdec.single.plan(LANES, pad_to=SHARDS)
        L = len(pl["starts_np"])
        last = slice(L - L // SHARDS, L)
        args = (sdec.tables[cuda0],
                *(pl[k][last] for k in ("states", "ptrs", "starts", "ends",
                                        "ring")),
                sdec.single.window, sdec.single.min_interval, pl["cap"])
        shard_cmp = compare(decode_cuda.decode_blocks(*args),
                            decode_blocks_plain(*args))
        cmp_blocks.append(shard_cmp)
        t_sharded = cuda_ms(lambda: sdec.decode_raw(per_shard), runs=10)
        t_single = cuda_ms(lambda: single.decode_raw(LANES), runs=10)
        emit("sharded_tokens", graph=name, shards=[str(d) for d in devs],
             lanes=L, padded_lanes=int(np.sum(pl["starts_np"]
                                              == pl["ends_np"])),
             cap=pl["cap"], cold_seconds=cold_s, device_ms=t_sharded,
             single_device_ms=t_single, tokens_equal=tokens_equal,
             lists_exact=lists_exact, launches=counts,
             last_shard={"lanes": L // SHARDS, "cap": pl["cap"],
                         **shard_cmp})
        if not (tokens_equal and lists_exact and shard_cmp["bit_equal"]):
            raise SystemExit(f"sharded tokens {name}: not equal to the "
                             "single-device decode or the lists, or a "
                             "shard differs from the plain version")
        del sdec, single, tok

    # ---- 22. the sharded merged emit: on a fresh plan bit for bit what
    # the single-device call returns; on the verified plan of phase 9 (the
    # steady state: mark_deg launches and the cached-layout post-pass)
    # bit for bit the single-device steady call, timed beside it; the last
    # shard's launch against the plain version at its shape ----
    dec_a = TorchGraphDecoder(g, device=cuda0)
    dec_b = TorchGraphDecoder(g, device=cuda0)
    (first, first_s), counts = runs(
        "sharded emit", lambda: timed(
            lambda: sharded_emit_adjacency(devs, dec_a, EMIT_LANES)),
        ["decode_emit"])
    want, single_first_s = timed(
        lambda: dec_b.decode_to_adjacency_device(EMIT_LANES))
    first_equal = all(a.dtype == b.dtype and torch.equal(a, b)
                      for a, b in zip(first, want))
    first_exact = adjacency_exact(first, adj)
    del first, want, dec_a, dec_b
    epl = edec._plans[("emit", EMIT_LANES)]
    (verified, _), counts_v = runs(
        "sharded emit verified", lambda: timed(
            lambda: sharded_emit_adjacency(devs, edec, EMIT_LANES)),
        ["decode_emit"])
    verified_exact = adjacency_exact(verified, adj)
    verified_equal = all(torch.equal(a, b) for a, b in
                         zip(verified, edec._steady(epl)))
    del verified
    warm = [timed(lambda: sharded_emit_adjacency(devs, edec, EMIT_LANES))[1]
            for _ in range(3)]
    t_sharded = cuda_ms(
        lambda: sharded_emit_adjacency(devs, edec, EMIT_LANES), runs=5)
    t_steady = cuda_ms(lambda: edec.decode_to_adjacency_device(EMIT_LANES),
                       runs=10)
    t_eager = cuda_ms(lambda: edec._steady(epl), runs=10)
    L = epl["ptrs"].shape[0]
    last = slice(L - L // SHARDS, L)
    eargs = (edec.tables, epl["regs"][:, last].contiguous(),
             epl["ptrs"][last], edec.window, edec.min_interval, epl["cap"])
    (ek, ep), plain_s = timed(lambda: (
        emit_cuda.decode_emit(*eargs, T=epl["T"], mark_deg=True),
        decode_emit_plain(*eargs, T=epl["T"], mark_deg=True)))
    cmp_emit = compare(ek, ep)
    emit("sharded_emit", graph="cnr-2000", shards=[str(d) for d in devs],
         lanes=L, T=epl["T"], cap=epl["cap"], first_plan={
             "seconds": first_s, "single_device_seconds": single_first_s,
             "bit_equal_single_device": first_equal, "exact": first_exact,
             "launches": counts},
         verified_plan={"exact": verified_exact,
                        "bit_equal_single_device_steady": verified_equal,
                        "warm_seconds": warm,
                        "device_ms": t_sharded,
                        "steady_call_device_ms": t_steady,
                        "steady_eager_device_ms": t_eager,
                        "launches": counts_v},
         last_shard={"lanes": L // SHARDS, "cap": epl["cap"],
                     "plain_and_kernel_seconds": plain_s, **cmp_emit})
    if not (first_equal and first_exact and verified_exact
            and verified_equal and cmp_emit["bit_equal"]):
        raise SystemExit("sharded emit: not bit-equal to the single-device "
                         "call or not exact, or a shard differs from the "
                         "plain version")
    del ek, ep

    # ---- 23-24. the launcher: ranks on the one card over gloo (serial
    # and hc artifacts), then one NCCL rank on each; each gathered CSR
    # against the input lists ----
    def launcher(name, base, flags, timeout, ranks):
        out = os.path.join(tmp, f"{name}.npz")
        reports, gathered, sec = run_launcher(
            [base, *flags, "--gather", out], timeout)
        z = np.load(out)
        exact = (np.array_equal(z["offsets"].astype(np.int64),
                                adj.offsets.astype(np.int64))
                 and np.array_equal(z["succs"], adj.succs))
        nodes = [r["nodes"] for r in reports]
        covered = (len(reports) == ranks and nodes[0][0] == 0
                   and nodes[-1][1] == adj.num_nodes
                   and all(a[1] == b[0] for a, b in zip(nodes, nodes[1:])))
        launched = [r["launches"]["decode_blocks"] for r in reports]
        runs.total["decode_blocks"] += sum(launched)
        emit("launcher", case=name, args=flags, seconds=sec, ranks=reports,
             gathered=gathered, exact=exact)
        if not (exact and covered and min(launched, default=0) >= 1):
            raise SystemExit(f"launcher {name}: the gathered CSR is not the "
                             "graph, the ranks do not cover it, or a rank "
                             "never launched decode_blocks")

    cnr_base = os.path.join(tmp, "cnr")
    gloo = ["--local-dryrun", str(RANKS), "--device", DEVICE,
            "--reps", "1"]
    launcher("gloo_serial", cnr_base, gloo, 300, RANKS)
    launcher("gloo_hc", hc_base, gloo, 300, RANKS)
    for name, base in (("nccl_one_rank", cnr_base),
                       ("nccl_one_rank_hc", hc_base)):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        launcher(name, base,
                 ["--num-processes", "1", "--backend", "nccl",
                  "--coordinator", f"127.0.0.1:{port}", "--reps", "1"],
                 300, 1)

    # ---- 25. the dry run over SHARDS entries of the card ----
    dry, counts = runs("dry run", lambda: dryrun_multichip(SHARDS, DEVICE),
                       ["decode_blocks", "decode_emit"])
    emit("dryrun_multichip", **dry, launches=counts)
    return {"decode_blocks": {
        "bit_equal": all(c["bit_equal"] for c in cmp_blocks),
        "max_abs_err": max(c["max_abs_err"] for c in cmp_blocks)},
        "decode_emit": cmp_emit}


def lists_of(adj, q):
    """The input graph's lists of the nodes q, in query order."""
    from webgraph_ans_torch.bvgraph.graph import Adjacency
    offs = adj.offsets.astype(np.int64)
    q = np.asarray(q, np.int64)
    d = offs[q + 1] - offs[q]
    out_off = np.concatenate([[0], np.cumsum(d)])
    idx = np.repeat(offs[q] - out_off[:-1], d) + np.arange(out_off[-1])
    return Adjacency(out_off.astype(np.uint64), adj.succs[idx])


def scalar_split(cost, halo, safe, num_lanes, force_unsafe, target):
    """The merged-emit planner's split as a scalar Python loop, as the JAX
    package's _emit_bounds runs it SPLIT_PASSES times a plan (and the port
    did before the native split): timed once on the fixture, and held
    against the native split there."""
    n = len(cost)
    cost_l, halo_l = cost.tolist(), halo.tolist()
    safe_l = [True] * n if safe is None else np.asarray(safe).tolist()
    blist = [0]
    acc = halo_l[0]
    for x in range(n):
        w = cost_l[x]
        close = acc + w > target and safe_l[x]
        close |= (acc + w > 1.5 * target) and force_unsafe
        if close and x > blist[-1]:
            if len(blist) == num_lanes:
                return None
            blist.append(x)
            acc = halo_l[x]
        acc += w
    while len(blist) < num_lanes + 1:
        blist.append(n)
    return np.array(blist, np.int64)


class Scale:
    """The scale phases' shared state: the fixture, its two artifacts,
    the card line, and each phase's peak device memory (also used by the
    cnr-2000 phases that report their peaks: graph names the graph)."""

    def __init__(self, runs: PathRuns, smi: str, tmp: str,
                 graph: str = "synth-4M"):
        self.runs, self.smi, self.tmp, self.graph = runs, smi, tmp, graph
        self.kernels = {}

    def start(self):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.base = torch.cuda.memory_allocated()

    def emit(self, phase: str, dec=None, flat=None, **fields):
        """One phase line: its fields, the peak device memory since
        start() (and what was allocated then, earlier phases' included),
        the artifact's bytes on the device, the largest size of each
        int32-indexed layout as a share of 2^31, and the card."""
        torch.cuda.synchronize()
        extra = {"peak_device_bytes": torch.cuda.max_memory_allocated(),
                 "allocated_at_start_bytes": self.base, "card": self.smi}
        if dec is not None:
            t = dec.tables
            extra["artifact_device_bytes"] = (
                t.lut.numel() * t.lut.element_size()
                + t.stream.numel() * t.stream.element_size())
        if flat is not None:
            extra["flat_share_of_2_31"] = {k: v / 2 ** 31
                                           for k, v in flat.items()}
        emit(phase, graph=self.graph, **fields, **extra)


def _flat(*dicts) -> dict:
    """The largest recorded size of each layout over plan dicts."""
    out = {}
    for d in dicts:
        for k, v in (d or {}).get("flat_sizes", {}).items():
            out[k] = max(out.get(k, 0), v)
    return out


def scale_fixture(sc: Scale):
    """Phase 26: synth_web_graph(4,000,000, seed=7), passes 1-2 once and
    pass 3 twice (the serial native encode; 512 blocks encoded on the
    card), as store_layouts runs them; the encode kernel timed at the
    block store's plan, and held against its plain version on every lane
    of that plan at SCALE_PLAIN_CAP. Returns (adj, serial graph, block
    graph, block CompressionResult)."""
    from webgraph_ans_torch import ANSBvGraph
    from webgraph_ans_torch.ans.prelude import save_pointers, save_states
    from webgraph_ans_torch.bvgraph.store import (_build_models,
                                                  _encode_with_models)
    from webgraph_ans_torch.bvgraph.synth import synth_web_graph
    from webgraph_ans_torch.ops import encode_cuda, encode_torch

    sc.start()
    adj, gen_s = timed(lambda: synth_web_graph(SYNTH_NODES, seed=SYNTH_SEED))
    arcs = adj.num_arcs
    seconds = {}
    (model2, tables1, hist2), models_s = timed(lambda: _build_models(
        adj, 7, 3, 2, False, 12, None, seconds))

    def pass3(blocks, device):
        stages = {}
        res, sec = timed(lambda: _encode_with_models(
            adj, model2, tables1, hist2, 7, 3, 2, blocks, None, 1 << 22,
            device, stages))
        base = os.path.join(sc.tmp, f"synth_b{blocks}")
        res.prelude.save(base)
        save_states(base, res.states)
        save_pointers(base, res.pointers)
        words = len(res.prelude.stream)
        ans = os.path.getsize(base + ".ans")
        return res, {"seconds": sec, "stage_seconds": stages,
                     "stream_words": words, "ans_bytes": ans,
                     "bits_per_link": ans * 8 / arcs}

    res_s, serial = pass3(1, None)
    # the block store's encode plan, kept for the kernel's time
    plans, real_plan = [], encode_torch.encode_plan

    def keep_plan(*a, **kw):
        plans.append(real_plan(*a, **kw))
        return plans[-1]

    encode_torch.encode_plan = keep_plan
    try:
        (res_b, blocks), counts = sc.runs(
            "scale block store", lambda: pass3(SCALE_BLOCKS, DEVICE),
            ["encode_blocks"])
    finally:
        encode_torch.encode_plan = real_plan
    plan = plans[-1]
    kres = encode_cuda.encode_blocks(*encode_args(plan))
    t_enc = cuda_ms(lambda: encode_cuda.encode_blocks(*encode_args(plan)))
    L = plan.tstart.shape[0]
    sc.kernels["encode_blocks"] = {
        "lanes": L, "cap": plan.cap, "ms": t_enc,
        **encode_bound(plan, kres[3])}
    short = (*encode_args(plan)[:-1], SCALE_PLAIN_CAP)
    sc.kernels["encode_blocks"]["plain"] = hold_plain(
        encode_cuda.encode_blocks(*short),
        "webgraph_ans_torch.ops.encode_torch.encode_blocks_plain", short,
        {}, slice(0, L), SCALE_PLAIN_CAP, SCALE_PLAIN_CAP)
    del plans, plan, kres, short
    gs = ANSBvGraph(res_s.prelude, res_s.states, res_s.pointers)
    gb = ANSBvGraph(res_b.prelude, res_b.states, res_b.pointers)
    sc.emit("scale_fixture", source="bench.py:352-361",
            numpy=np.__version__, nodes=adj.num_nodes, arcs=arcs,
            generate_seconds=gen_s, passes_1_2_seconds=models_s,
            passes_1_2_stages=seconds, serial=serial,
            blocks={"blocks": SCALE_BLOCKS, **blocks, "launches": counts,
                    "encode_kernel": sc.kernels["encode_blocks"]})
    return adj, gs, gb, res_b


def scale_token_path(sc: Scale, adj, gs) -> int:
    """Phase 27: the token path at SCALE_LANES, cold (a fresh decoder) and
    warm by stage, list for list; the token kernel timed on its plan and
    held against its plain version on the lanes around the longest.
    Returns the graph's token count."""
    from webgraph_ans_torch import TorchGraphDecoder, reconstruct
    from webgraph_ans_torch.ops.decode_cuda import decode_blocks
    from webgraph_ans_torch.ops.decode_torch import fetch_block_tokens

    n, arcs, mi = adj.num_nodes, adj.num_arcs, gs.prelude.min_interval_length
    sc.start()

    def path():
        dec = TorchGraphDecoder(gs)
        off, succs = reconstruct(*dec.decode_tokens(SCALE_LANES), n, mi)
        cold_exact = (np.array_equal(off, adj.offsets)
                      and np.array_equal(succs, adj.succs))
        del off, succs
        return dec, cold_exact

    ((dec, cold_exact), cold_s), counts = sc.runs(
        "scale token path", lambda: timed(path), ["decode_blocks"])
    stages = {}
    (out, cnt, cap), stages["decode_raw"] = timed(
        lambda: dec.decode_raw(SCALE_LANES))
    (vals, comps), stages["fetch_unpack"] = timed(
        lambda: fetch_block_tokens(out, cnt, cap))
    (off, succs), stages["reconstruct"] = timed(
        lambda: reconstruct(vals, comps, n, mi))
    warm_exact = (np.array_equal(off, adj.offsets)
                  and np.array_equal(succs, adj.succs))
    del out, vals, comps, off, succs
    warm_s = sum(stages.values())
    pl = dec.plan(SCALE_LANES)
    args = decode_args(dec, pl, cap)
    kres = decode_blocks(*args)
    tokens = int(kres[1].sum())
    sc.kernels["decode_blocks"] = {
        "lanes": SCALE_LANES, "cap": cap,
        "ms": cuda_ms(lambda: decode_blocks(*args)),
        **decode_bound(dec, pl, cap, kres[1]),
        "plain": hold_decode(dec, pl, cap, kres)}
    del kres
    L = len(pl["starts_np"])
    sc.emit("scale_token_path", dec=dec, lanes=L, cap=cap,
            cold_seconds=cold_s, cold_ns_per_arc=cold_s * 1e9 / arcs,
            warm_seconds=warm_s, warm_ns_per_arc=warm_s * 1e9 / arcs,
            warm_stages=stages, exact=cold_exact and warm_exact,
            launches=counts, kernel=sc.kernels["decode_blocks"],
            token_layout_share_of_2_31=(cap + cap // 8) * L / 2 ** 31)
    if not (cold_exact and warm_exact):
        raise SystemExit("scale token path: lists differ from the input")
    return tokens


def hold_decode(dec, pl, cap, kres, emit_aux: bool = False):
    """decode_blocks' outputs kres on the plan pl against the plain
    version on the lanes around the one of most steps, at the same cap
    (pending, as hold_plain)."""
    sl = longest_slice(kres[1])
    args = (dec.tables, *(pl[k][sl] for k in ("states", "ptrs", "starts",
                                               "ends", "ring")),
            dec.window, dec.min_interval, cap)
    return hold_plain(
        kres, "webgraph_ans_torch.ops.decode_torch.decode_blocks_plain",
        args, {"emit_aux": emit_aux}, sl, cap, int(kres[1][sl].max()))


def emit_to_steady(sc: Scale, dec, adj, name: str, host: dict,
                   lanes: int = SCALE_LANES):
    """decode_to_adjacency_device at `lanes` until the plan is verified,
    then five steady calls, each checked list for list; the first call's
    last kernel launch (its plan, before the rebalance) timed alone.
    Returns (the per-call records, the steady records, the first call's
    kernel, the plan)."""
    from webgraph_ans_torch.ops import emit_cuda

    arcs = adj.num_arcs
    calls, pl, first = [], {}, {}
    raw = dec.decode_emit_raw

    def keep_first(*a, **kw):
        res = raw(*a, **kw)
        if not first:
            p = dec._plans[("emit", lanes)]
            first.update(
                args=emit_args(dec, p, res[3]), lanes=len(p["starts_np"]),
                empty_lanes=int(np.sum(p["starts_np"] >= p["ends_np"])),
                cap=res[3], T=p["T"])
        return res

    dec.decode_emit_raw = keep_first
    for i in range(6):
        for k in host:
            host[k] = [] if k == "caps" else 0.0
        (res3, sec), counts = sc.runs(f"{name} call {i}", lambda: timed(
            lambda: dec.decode_to_adjacency_device(lanes)), [])
        pl = dec._plans[("emit", lanes)]
        mc = pl.get("post_meta", {})
        calls.append({
            "seconds": sec, "caps": list(host["caps"]),
            "host_planner_seconds": {k: v for k, v in host.items()
                                     if k != "caps"},
            "lanes": len(pl["starts_np"]),
            "empty_lanes": int(np.sum(pl["starts_np"] >= pl["ends_np"])),
            "T": pl.get("T"),
            "dirty_nodes": (len(mc["order_np"]) if "order_np" in mc
                            else None),
            "verified": dec.emit_steady(lanes),
            "exact": adjacency_exact(res3, adj), "launches": counts})
        del res3
        if i == 0:
            fargs = first.pop("args")
            first["ms"] = cuda_ms(lambda: emit_cuda.decode_emit(
                *fargs, T=first["T"]))
            del fargs
        if dec.emit_steady(lanes):
            break
    # a layout with dirty nodes runs the fixup kernel once a steady call
    fixups = ["emit_fixup"] if pl["post_meta"]["fx_nodes"].shape[0] else []
    results, counts = sc.runs(f"{name} steady", lambda: [timed(
        lambda: dec.decode_to_adjacency_device(lanes))
        for _ in range(5)], ["decode_emit", *fixups])
    if fixups and counts["emit_fixup"] != len(results):
        raise SystemExit(f"{name}: {counts['emit_fixup']} fixup launches in "
                         f"{len(results)} steady calls")
    steady_exact = all(adjacency_exact(r, adj) for r, _ in results)
    steady_s = statistics.median(t for _, t in results)
    del results
    t_dev = cuda_ms(lambda: dec.decode_to_adjacency_device(lanes))
    steady = {"seconds": steady_s, "exact": steady_exact,
              "device_ms": t_dev,
              "device_ns_per_arc": t_dev["median"] * 1e6 / arcs,
              "launches": counts,
              **emit_cuda.launch_geometry(dec.window, pl["T"])}
    if not (all(c["exact"] for c in calls) and steady_exact
            and dec.emit_steady(lanes)):
        raise SystemExit(f"{name}: lists differ from the input, or the plan "
                         "never verified")
    return calls, steady, first, pl


def emit_kernel_scale(dec, pl, tokens: int, short: bool = False) -> dict:
    """decode_emit timed on a verified plan (mark_deg), with its bound,
    and held against its plain version (pending, as hold_plain): on the
    lanes around the one of most rows at the plan's cap, or (short) on
    every lane at SCALE_PLAIN_CAP."""
    from webgraph_ans_torch.ops.emit_cuda import decode_emit
    T = pl["T"]
    eargs = emit_args(dec, pl, pl["cap"])
    ek = decode_emit(*eargs, T=T, mark_deg=True)
    out = {"lanes": len(pl["starts_np"]), "cap": pl["cap"], "T": T,
           "ms": cuda_ms(lambda: decode_emit(*eargs, T=T, mark_deg=True)),
           **emit_bound(dec, pl, pl["cap"], ek[3], tokens)}
    if short:
        cap, sl = SCALE_PLAIN_CAP, slice(0, out["lanes"])
        sargs = emit_args(dec, pl, cap)
        ek, steps = decode_emit(*sargs, T=T, mark_deg=True), cap
    else:
        cap, sl = pl["cap"], longest_slice(ek[3])
        sargs = (dec.tables, pl["regs"][:, sl].contiguous(), pl["ptrs"][sl],
                 dec.window, dec.min_interval, cap)
        steps = int(ek[3][sl].max())
    out["plain"] = hold_plain(
        ek, "webgraph_ans_torch.ops.emit_torch.decode_emit_plain", sargs,
        {"T": T, "mark_deg": True}, sl, cap, steps)
    return out


def timing_hooks(dec, host: dict):
    """Adds the host seconds of the decoder's planner steps into host, and
    lists the caps its merged-emit launches ran at in host["caps"]."""
    for key in ("_emit_bounds", "_safe_boundaries", "_reference_chains"):
        fn = getattr(dec, key)
        host[key] = 0.0

        def run(*a, _fn=fn, _key=key, **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                host[_key] += time.perf_counter() - t0

        setattr(dec, key, run)
    raw = dec.decode_emit_raw
    host["caps"] = []

    def emit_raw(*a, **kw):
        res = raw(*a, **kw)
        host["caps"].append(res[3])
        return res

    dec.decode_emit_raw = emit_raw


def scale_emit(sc: Scale, adj, gs, tokens: int):
    """Phase 28: the merged emit at SCALE_LANES on the serial artifact,
    through the rebalance and refinement into the steady state, with the
    planner's host seconds a call; one pass of the split as the scalar
    Python loop against the native split on the last plan's inputs.
    Returns the decoder (random access reuses its verified plan)."""
    from webgraph_ans_torch import TorchGraphDecoder
    from webgraph_ans_torch.ops import graph_decode

    sc.start()
    dec = TorchGraphDecoder(gs)
    host = {}
    timing_hooks(dec, host)
    last, native_split = {}, graph_decode.emit_split

    def keep_args(*a):
        last["args"] = a
        return native_split(*a)

    graph_decode.emit_split = keep_args
    try:
        calls, steady, first, pl = emit_to_steady(sc, dec, adj,
                                                  "scale merged emit", host)
    finally:
        graph_decode.emit_split = native_split
    want, py_s = timed(lambda: scalar_split(*last["args"]))
    got, nat_s = timed(lambda: native_split(*last["args"]))
    split = {"nodes": adj.num_nodes, "python_one_pass_seconds": py_s,
             "native_one_pass_seconds": nat_s,
             "passes_per_plan": SPLIT_PASSES,
             "bounds_equal": got is not None and want is not None
             and np.array_equal(got, want)}
    sc.kernels["decode_emit"] = emit_kernel_scale(dec, pl, tokens)
    sc.kernels["decode_emit"]["first_call"] = first
    sc.emit("scale_merged_emit", dec=dec,
            flat=_flat(pl, dec._plans.get(2048)), calls=calls,
            steady=steady, split=split, kernel=sc.kernels["decode_emit"])
    if not split["bounds_equal"]:
        raise SystemExit("scale merged emit: the native split differs from "
                         "the scalar loop")
    return dec


def sort_path_runs(dec, adj, name: str, runs: PathRuns, reps: int = 4):
    """decode_to_csr_device at SCALE_LANES, cold then warm, each call
    checked list for list."""
    def calls():
        out = []
        for _ in range(reps):
            res, sec = timed(lambda: dec.decode_to_csr_device(SCALE_LANES))
            out.append({"seconds": sec, "exact": csr_exact(*res, adj)})
            del res
        return out

    got, counts = runs(name, calls, ["decode_blocks_aux"])
    if not all(c["exact"] for c in got):
        raise SystemExit(f"{name}: the CSR differs from the input graph")
    return {"cold_seconds": got[0]["seconds"],
            "warm_seconds": [c["seconds"] for c in got[1:]],
            "warm_ns_per_arc": statistics.median(
                c["seconds"] for c in got[1:]) * 1e9 / adj.num_arcs,
            "exact": True, "launches": counts}


def scale_sort_path(sc: Scale, adj, gs):
    """Phase 29: the sort path at SCALE_LANES on the serial artifact; the
    aux-mode kernel timed on its plan and held against its plain version
    on the lanes around the longest."""
    from webgraph_ans_torch import TorchGraphDecoder
    from webgraph_ans_torch.ops.decode_cuda import decode_blocks

    sc.start()
    dec = TorchGraphDecoder(gs)
    res = sort_path_runs(dec, adj, "scale sort path", sc.runs)
    pl = dec.plan(SCALE_LANES)
    out, _, acap = dec.decode_raw(SCALE_LANES, emit_aux=True)
    del out
    aargs = decode_args(dec, pl, acap)
    akres = decode_blocks(*aargs, emit_aux=True)
    sc.kernels["decode_blocks_aux"] = {
        "lanes": SCALE_LANES, "cap": acap,
        "ms": cuda_ms(lambda: decode_blocks(*aargs, emit_aux=True)),
        **decode_bound(dec, pl, acap, akres[1], aux=True),
        "plain": hold_decode(dec, pl, acap, akres, emit_aux=True)}
    del akres
    sc.emit("scale_sort_path", dec=dec, flat=_flat(pl, pl.get("recon_meta")),
            lanes=len(pl["starts_np"]), cap=acap, **res,
            kernel=sc.kernels["decode_blocks_aux"])

def scale_blocks(sc: Scale, adj, gb, res_b, tokens: int):
    """Phase 30: the 512-block artifact: the merged emit into its steady
    state (lanes split inside the encode blocks, every block start a lane
    bound, none crossed; the first call's kernel, on its stream-balanced
    lanes, timed beside the steady one), the sort path, and the native
    sequential reader."""
    from webgraph_ans_torch import TorchGraphDecoder
    from webgraph_ans_torch.bvgraph.sequential import ANSBvGraphSeq

    sc.start()
    dec = TorchGraphDecoder(gb)
    host = {}
    timing_hooks(dec, host)
    calls, steady, first, pl = emit_to_steady(sc, dec, adj,
                                              "scale blocks emit", host)
    layout = block_layout(dec, pl)
    split_inside = (layout["crossing_lanes"] == 0
                    and layout["halos_past_block"] == 0
                    and layout["block_starts_bound"] == SCALE_BLOCKS
                    and layout["used_lanes"] > SCALE_BLOCKS)
    sc.kernels["decode_emit_blocks"] = emit_kernel_scale(dec, pl, tokens)
    sc.kernels["decode_emit_blocks"]["first_call"] = first
    sdec = TorchGraphDecoder(gb)
    sort = sort_path_runs(sdec, adj, "scale blocks sort path", sc.runs,
                          reps=2)
    spl = sdec.plan(SCALE_LANES)
    flat = _flat(pl, dec._plans.get(2048), spl, spl.get("recon_meta"))
    del sdec, spl
    seq, seq_s = timed(lambda: ANSBvGraphSeq(res_b.prelude).decode_all())
    seq_exact = adjacency_equal(seq, adj)
    del seq
    sc.emit("scale_blocks", dec=dec, flat=flat, blocks=SCALE_BLOCKS,
            merged_emit={
                "calls": calls, "steady": steady, "layout": layout,
                "split_inside_blocks": split_inside,
                "kernel": sc.kernels["decode_emit_blocks"]},
            sort_path=sort,
            sequential={"seconds": seq_s, "exact": seq_exact})
    del dec
    if not (split_inside and seq_exact):
        raise SystemExit("scale blocks: the emit plan is not split inside "
                         "the blocks, or the sequential reader's lists "
                         "differ")


def scale_random_access(sc: Scale, adj, gs, edec, tokens: int):
    """Phase 31: random access with seeded uniform queries, as phase 18:
    the wave decode (10,000), the CSR server (build, then 1,000,000) and
    per-query merged-emit lanes (4,096, with their rounds), each batch
    list for list against the input graph; then phase 31b (tokens: the
    serial artifact's token count, for decode_emit's bound)."""
    from webgraph_ans_torch import (TorchCsrServer, TorchEmitRandomAccess,
                                    TorchGraphDecoder, TorchRandomAccess)

    n = adj.num_nodes
    rng = np.random.default_rng(2026)
    sc.start()
    ra = TorchRandomAccess(TorchGraphDecoder(gs))
    wave = []
    for _ in range(2):
        q = rng.integers(0, n, 10_000)
        (got, sec), counts = sc.runs("scale wave random access", lambda: timed(
            lambda: ra.successors_batch(q)), ["decode_blocks"])
        wave.append({"seconds": sec, "arcs": len(got.succs),
                     "ns_per_arc": sec * 1e9 / max(len(got.succs), 1),
                     "waves": ra.last_waves, "launches": counts,
                     "exact": adjacency_equal(got, lists_of(adj, q))})
    del ra
    (srv, build_s), counts = sc.runs("scale CSR server", lambda: timed(
        lambda: TorchCsrServer(TorchGraphDecoder(gs),
                               num_lanes=SCALE_LANES)),
        ["decode_blocks_aux"])
    q = rng.integers(0, n, 1_000_000)
    got = srv.successors_batch(q)
    csr = {"build_seconds": build_s, "build_launches": counts,
           "queries": len(q), "arcs": len(got.succs),
           "batch_seconds": [timed(lambda: srv.serve(q))[1]
                             for _ in range(3)],
           "exact": adjacency_equal(got, lists_of(adj, q))}
    del got
    era = TorchEmitRandomAccess(edec)
    emit_b = []
    for _ in range(2):
        q = rng.integers(0, n, 4096)
        (got, sec), counts = sc.runs("scale emit random access",
                                     lambda: timed(
                                         lambda: era.successors_batch(q)),
                                     ["decode_emit"])
        emit_b.append({"seconds": sec, "arcs": len(got.succs),
                       "rounds": era.last_rounds,
                       "unclean_to_wave": era.last_unclean,
                       "launches": counts,
                       "exact": adjacency_equal(got, lists_of(adj, q))})
    sc.emit("scale_random_access", dec=edec, wave_10000=wave,
            csr_server=csr, emit_4096=emit_b)
    if not (all(w["exact"] for w in wave) and csr["exact"]
            and all(b["exact"] for b in emit_b)):
        raise SystemExit("scale random access: a batch differs from the "
                         "input graph")
    del era
    # ---- 31b. the device-resident serving contract and the serve
    # protocol at synth-4M ----
    ondemand_phase(sc, gs, adj, srv, tokens)


def newest_split() -> dict:
    """The attributes of the newest `emit.split` stage: the last split
    the planner made (its rule, target, lane costs and the encode-block
    starts it forced as bounds, `block_starts`)."""
    from webgraph_ans_torch.utils import trace

    splits = [st.attrs for st in trace.stages() if st.name == "emit.split"]
    return dict(splits[-1]) if splits else {}


def block_layout(dec, pl) -> dict:
    """How a merged-emit plan sits on its artifact's encode blocks: the
    blocks (0 on a serial artifact), the lanes that hold a node and their
    number a block, the block starts that start a lane, the lanes that
    cross a block start and the halos that reach back past one (both 0
    on a sound plan)."""
    starts, ends = pl["starts_np"], pl["ends_np"]
    used = starts < ends
    a, b = starts[used], ends[used]
    bs = dec._encode_block_starts()
    out = {"encode_blocks": 0 if bs is None else len(bs),
           "used_lanes": int(used.sum())}
    if bs is None:
        return out
    floor = dec._block_floor(a)
    return {**out, "lanes_a_block": float(used.sum() / len(bs)),
            "block_starts_bound": int(np.isin(bs, a).sum()),
            "crossing_lanes": int((floor != dec._block_floor(b - 1)).sum()),
            "halos_past_block": int((pl["hstarts_np"][used] < floor).sum()),
            "halo_lanes": int((pl["hstarts_np"][used] < a).sum())}


def blocks_steady_phase(edec, bdec, adj, base_b: str, tmp: str) -> dict:
    """Phase 14b: the 512-block artifact's verified merged-emit plan at
    EMIT_LANES (phase 14 drove it there; the benchmark's
    cnr2000_blocks.decode): its lanes split inside the encode blocks,
    every block start a lane bound, no lane across one and no halo past
    one, at least 3 lanes holding a node a block; its steady decode timed
    in turns beside phase 9's serial one (cnr2000.decode's plan), each
    steady result list for list; and a second store of the artifact with
    the device model search, whose .ans bytes must equal the first's.
    Fails on any of these."""
    from webgraph_ans_torch import store

    epl = edec._plans[("emit", EMIT_LANES)]
    bpl = bdec._plans[("emit", EMIT_LANES)]
    layout = block_layout(bdec, bpl)
    split = newest_split()      # phase 14's refined split
    results = [bdec.decode_to_adjacency_device(EMIT_LANES)
               for _ in range(3)]
    exact = all(adjacency_exact(r, adj) for r in results)
    del results
    times = {"serial": [], "blocks": []}
    for name in ("serial", "blocks", "blocks", "serial"):
        dec = edec if name == "serial" else bdec
        times[name].append(cuda_ms(
            lambda: dec.decode_to_adjacency_device(EMIT_LANES), runs=10))
    ms = {k: statistics.median(t["median"] for t in v)
          for k, v in times.items()}
    again = os.path.join(tmp, "cnr_b512_again")
    store(CNR, again, encode_blocks=ENCODE_BLOCKS, use_tpu_model_search=True)
    with open(base_b + ".ans", "rb") as f1, open(again + ".ans", "rb") as f2:
        same_bytes = f1.read() == f2.read()
    mc = bpl["post_meta"]
    arcs = adj.num_arcs
    out = {"lanes": len(bpl["starts_np"]), "cap": bpl["cap"],
           "serial_cap": epl["cap"], "T": bpl["T"],
           "rows_max": int(bpl["rows_np"].max()),
           "rows_mean": float(bpl["rows_np"].mean()),
           "dirty_nodes": len(mc["order_np"]),
           "dirty_elements": int(mc["fx_srcs"].shape[0]),
           "fixup_rounds": mc["rounds"], **layout, "split": split,
           "steady_exact": exact, "steady_device_ms": times,
           "steady_ms": ms["blocks"], "serial_steady_ms": ms["serial"],
           "steady_ns_per_arc": ms["blocks"] * 1e6 / arcs,
           "serial_steady_ns_per_arc": ms["serial"] * 1e6 / arcs,
           "over_serial": ms["blocks"] / ms["serial"],
           "bits_per_link": os.path.getsize(base_b + ".ans") * 8 / arcs,
           "second_store_same_bytes": same_bytes,
           "serial_layout": block_layout(edec, epl)}
    emit("blocks_steady", graph="cnr-2000", blocks=ENCODE_BLOCKS, **out)
    out["fold"] = fold_phase("cnr-2000 512 blocks", bdec, bpl, hold=True)
    if not (exact and same_bytes and not layout["crossing_lanes"]
            and not layout["halos_past_block"]
            and layout["block_starts_bound"] == layout["encode_blocks"]
            and layout["lanes_a_block"] >= 3
            and split.get("block_starts") == layout["encode_blocks"]
            and out["serial_layout"]["encode_blocks"] == 0):
        raise SystemExit("block artifact's steady plan: a list differs, "
                         "a lane or halo crosses a block start, a block "
                         "start bounds no lane, fewer than 3 lanes a "
                         "block, or two stores differ")
    return out


def fixup_hold(dec, pl, plain_on_host: bool = False) -> dict:
    """The fixup of a verified merged-emit plan on the card: the
    emit_fixup kernel on a mark_deg decode's val channel, held bit for bit
    against its plain version (node by node; on host copies of its inputs
    with plain_on_host). Both patch val in place, so each call gets a
    fresh copy of it. Times the kernel's wrapper (zeroed flags and the
    launch, on fresh copies; CUDA events, median of TIMED_RUNS) beside the
    bound of the bytes the fixup needs: the node table, each element's
    source, its gathered value and its write, each read or written once
    (bound_ms), and per level of the dirty chains (`us_per_level`); the
    layout's rows that take the kernel's two-run step (`two_run_rows`,
    and their share of the dirty nodes). `hold_launches` counts the
    hold's own calls of the kernel, none of the main path."""
    from webgraph_ans_torch.ops import emit_cuda, fixup_cuda

    mc = pl["post_meta"]
    nodes, srcs = mc["fx_nodes"], mc["fx_srcs"]
    eargs = emit_args(dec, pl, pl["cap"])
    val = emit_cuda.decode_emit(*eargs, T=pl["T"], mark_deg=True)[0]

    def fresh(k):
        copies = iter([val.clone() for _ in range(k)])
        return lambda: fixup_cuda.emit_fixup(next(copies), nodes, srcs)

    launches = fixup_cuda.emit_fixup.launches
    kernel = fixup_cuda.emit_fixup(val.clone(), nodes, srcs)
    on = (lambda t: t.cpu()) if plain_on_host else (lambda t: t.clone())
    plain, plain_s = timed(lambda: fixup_cuda.emit_fixup_plain(
        on(val), on(nodes), on(srcs)))
    held = compare([on(kernel)], [plain])
    t_kernel = cuda_ms(fresh(TIMED_RUNS + 3))
    nd, E = nodes.shape[0], srcs.shape[0]
    degs = nodes[:, 1].cpu().numpy()
    need = nodes.numel() * 4 + E * 12
    return {"rounds": mc["rounds"], "dirty_nodes": nd, "elements": E,
            "two_run_rows": mc["two_run_rows"],
            "two_run_share": mc["two_run_rows"] / max(nd, 1),
            "us_per_level": t_kernel["median"] * 1e3 / max(mc["rounds"], 1),
            "parent_reads": int((srcs < 0).sum()),
            "deg_median": float(np.median(degs)), "deg_max": int(degs.max()),
            "hold_launches": fixup_cuda.emit_fixup.launches - launches,
            "ms": t_kernel, "plain_ms": plain_s * 1e3,
            "bytes": need, "bound_ms": need / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "plain": held}


def hc_safe_break_phase(adj, runs: PathRuns, smi: str, tmp: str) -> dict:
    """Phase 17b: cnr-2000 stored in the JAX bench's high-compression mode
    with safe breaks (store(..., 16, 2e9, 4, safe_break_interval=128),
    host passes), decoded by the merged emit at HC_LANES lanes into the
    verified steady state (the window-16 instance of decode_emit), every
    call list for list; fails if the sort path served (emit_broken) or
    decode_emit never launched. Prints the planner's safe set beside the
    one the chain roots give (converged_safe_nodes) and the passes those
    took, and the verified plan's cap, its longest and mean lane's rows
    (the lanes closed at the last safe node within the split's target);
    fails if the planner marks a node safe that a chain crosses, and
    returns decode_emit's time, bound and plain hold on the verified
    plan."""
    from webgraph_ans_torch import ANSBvGraph, TorchGraphDecoder, store
    from webgraph_ans_torch.ops import emit_cuda

    base = os.path.join(tmp, "cnr_hc_safe")
    res, store_s = timed(lambda: store(CNR, base, 16, 2_000_000_000, 4,
                                       safe_break_interval=HC_SAFE_BREAK))
    del res
    g = ANSBvGraph.load(base)
    arcs = adj.num_arcs
    sc = Scale(runs, smi, tmp, graph="cnr-2000 hc safe breaks")
    sc.start()
    dec = TorchGraphDecoder(g)
    host = {}
    timing_hooks(dec, host)
    calls, steady, first, pl = emit_to_steady(
        sc, dec, adj, "hc safe-break merged emit", host, lanes=HC_LANES)
    split = newest_split()
    parent, has_ref, counts, _ = dec._reference_parents()
    exact, deepest = converged_safe_nodes(parent, has_ref)
    used = pl["safe_np"]
    safe = {"passes_to_converge": deepest,
            "safe_nodes": int(used.sum()),
            "exact_safe_nodes": int(exact.sum()),
            "wrongly_safe": int((used & ~exact).sum()),
            "missed_safe": int((exact & ~used).sum())}
    del parent, has_ref
    tokens = int(counts.sum())
    kernel = emit_kernel_scale(dec, pl, tokens)
    kernel.update(emit_cuda.launch_geometry(dec.window, pl["T"]))
    kernel["first_call"] = first
    sc.emit("hc_safe_break_emit", dec=dec,
            flat=_flat(pl, dec._plans.get(2048)), window=16,
            max_ref_count=2_000_000_000, min_interval_length=4,
            safe_break_interval=HC_SAFE_BREAK, source="bench.py:293-340",
            store_seconds=store_s, stream_words=len(g.prelude.stream),
            bits_per_link=os.path.getsize(base + ".ans") * 8 / arcs,
            lanes=HC_LANES, cold_seconds=[c["seconds"] for c in calls],
            calls=calls, steady=steady,
            steady_ns_per_arc=steady["device_ms"]["median"] * 1e6 / arcs,
            T=pl["T"], cap=pl["cap"], rows_max=int(pl["rows_np"].max()),
            rows_mean=float(pl["rows_np"].mean()),
            empty_lanes=int(np.sum(pl["starts_np"] >= pl["ends_np"])),
            dirty_nodes=len(pl["post_meta"]["order_np"]),
            emit_broken=pl.get("emit_broken"), safe_boundaries=safe,
            split=split, kernel=kernel)
    if safe["wrongly_safe"] or split.get("block_starts") != 0:
        raise SystemExit("hc safe-break: the planner marked a node safe "
                         "that a reference chain crosses, or forced block "
                         "starts on a serial artifact")
    fixup = fixup_hold(dec, pl)
    sc.emit("hc_fixup_vs_plain", dec=dec, lanes=HC_LANES, **fixup)
    if not (fixup["plain"]["bit_equal"] and fixup["hold_launches"] > 0):
        raise SystemExit("hc safe-break: the fixup kernel differs from its "
                         "plain version")
    kernel["fixup"] = fixup
    kernel["fold"] = fold_phase("cnr-2000 hc safe breaks", dec, pl)
    return kernel


def hc_no_breaks_phase(adj, runs: PathRuns, smi: str, tmp: str,
                       sort_path_s: float) -> dict:
    """Phase 17c: cnr-2000 stored as the reference stores it at high
    compression (store(..., 16, 2e9, 4), no safe breaks: reference chains
    4,506 deep, the benchmark's cnr2000hcref), decoded by the merged emit
    at HC_LANES lanes into the verified steady state, every call list for
    list: lanes are cut inside the safe gaps longer than their target, and
    the fixup finishes the chains the cuts cross. Fails if the sort path
    served or the fixup kernel differs from its plain version (on host
    copies) on the verified layout. Prints the plan (cap, lanes, unsafe
    cuts, dirty nodes and elements, fixup rounds), decode_emit's and the
    fixup's times beside their bounds (decode_emit not held here: 17b
    holds the same instance), and the steady decode beside phase 16's warm
    sort path on the same artifact (sort_path_s)."""
    from webgraph_ans_torch import ANSBvGraph, TorchGraphDecoder, store
    from webgraph_ans_torch.ops import emit_cuda, graph_decode
    from webgraph_ans_torch.ops.emit_cuda import decode_emit

    base = os.path.join(tmp, "cnr_hc_no_breaks")
    res, store_s = timed(lambda: store(CNR, base, 16, 2_000_000_000, 4))
    del res
    g = ANSBvGraph.load(base)
    arcs = adj.num_arcs
    sc = Scale(runs, smi, tmp, graph="cnr-2000 hc no safe breaks")
    sc.start()
    dec = TorchGraphDecoder(g)
    host = {}
    timing_hooks(dec, host)
    calls, steady, first, pl = emit_to_steady(
        sc, dec, adj, "hc no-break merged emit", host, lanes=HC_LANES)
    split = newest_split()
    counts = dec._reference_parents()[2]
    T = pl["T"]
    eargs = emit_args(dec, pl, pl["cap"])
    ek = decode_emit(*eargs, T=T, mark_deg=True)
    kernel = {"lanes": len(pl["starts_np"]), "cap": pl["cap"], "T": T,
              "ms": cuda_ms(lambda: decode_emit(*eargs, T=T,
                                                mark_deg=True)),
              **emit_bound(dec, pl, pl["cap"], ek[3], int(counts.sum())),
              **emit_cuda.launch_geometry(dec.window, T)}
    del ek, eargs
    mc = pl["post_meta"]
    steady_ms = steady["device_ms"]["median"]
    sc.emit("hc_no_breaks_emit", dec=dec,
            flat=_flat(pl, dec._plans.get(2048)), window=16,
            max_ref_count=2_000_000_000, min_interval_length=4,
            source="webgraph-ans-rs script.py:24, README.md:141-165",
            store_seconds=store_s,
            ans_bytes=os.path.getsize(base + ".ans"),
            bits_per_link=os.path.getsize(base + ".ans") * 8 / arcs,
            lanes=HC_LANES, cold_seconds=[c["seconds"] for c in calls],
            calls=calls, steady=steady,
            steady_ns_per_arc=steady_ms * 1e6 / arcs,
            sort_path_warm_seconds=sort_path_s,
            sort_path_over_steady=sort_path_s * 1e3 / steady_ms,
            cap=pl["cap"], rows_max=int(pl["rows_np"].max()),
            rows_mean=float(pl["rows_np"].mean()),
            empty_lanes=int(np.sum(pl["starts_np"] >= pl["ends_np"])),
            unsafe_cuts=graph_decode.unsafe_cuts(pl["starts_np"],
                                                 pl["safe_np"]),
            dirty_nodes=len(mc["order_np"]),
            dirty_elements=int(mc["fx_srcs"].shape[0]),
            fixup_rounds=mc["rounds"], emit_broken=pl.get("emit_broken"),
            split=split, kernel=kernel, first_call=first)
    fixup = fixup_hold(dec, pl, plain_on_host=True)
    sc.emit("hc_no_breaks_fixup_vs_plain", dec=dec, lanes=HC_LANES,
            **fixup)
    if (pl.get("emit_broken") or split.get("block_starts") != 0
            or not (fixup["plain"]["bit_equal"]
                    and fixup["hold_launches"] > 0)):
        raise SystemExit("hc without safe breaks: the sort path served, its "
                         "split forced block starts, or the fixup kernel "
                         "differs from its plain version")
    kernel["fixup"] = fixup
    kernel["fold"] = fold_phase("cnr-2000 hc no safe breaks", dec, pl,
                                hold=True)
    return kernel


def converged_safe_nodes(parent, has_ref):
    """(the safe set from each node's chain root, the passes the root
    loop took): the ancestor minima resolved forward until no node
    changes, the slow form that graph_decode.safe_nodes replaces."""
    n = len(parent)
    am = np.arange(n, dtype=np.int64)
    passes = 0
    while True:
        upd = has_ref & (am[parent] < am)
        if not upd.any():
            break
        am = np.where(upd, am[parent], am)
        passes += 1
    sm = np.minimum.accumulate(am[::-1])[::-1]
    safe = np.ones(n, bool)
    safe[1:] = sm[1:] >= np.arange(1, n)
    return safe, passes


def ondemand_device(dec, adj, runs: PathRuns, name: str) -> dict:
    """The JAX bench's on-demand protocol (tools/bench_device.py:169-249)
    through TorchEmitRandomAccess.successors_batch_device on a fresh
    decoder: ONDEMAND_BATCH int32 queries a batch drawn on the card from
    a seeded generator; warm batches until the 2048-lane plan is verified
    and its CUDA graph recorded; then ONDEMAND_REPS reps, each drained by
    int(total) on the host clock, the first of them checked query for
    query against the input graph on the host; one more steady batch
    under torch.cuda.set_sync_debug_mode("error"), which raises on a host
    synchronisation."""
    from webgraph_ans_torch import TorchEmitRandomAccess

    n = adj.num_nodes
    era = TorchEmitRandomAccess(dec)
    lanes = era.FULL_DECODE_LANES
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(2026)

    def make_q():
        return torch.randint(0, n, (ONDEMAND_BATCH,), generator=gen,
                             device=DEVICE, dtype=torch.int32)

    def batch():
        t0 = time.perf_counter()
        q = make_q()
        outv, offs, total = era.successors_batch_device(q)
        arcs = int(total)        # drains the whole pipeline
        return q, outv, offs, arcs, time.perf_counter() - t0

    def steady():
        pl = dec._plans.get(("emit", lanes), {})
        # on the card the first steady call records the CUDA graph
        return dec.emit_steady(lanes) and ("graph" in pl
                                           or dec.device.type != "cuda")

    def warm_then_reps():
        warm = []
        while len(warm) < 2 or not steady():
            if len(warm) == 6:
                raise SystemExit(f"{name}: the plan never reached its "
                                 "steady state")
            warm.append(batch()[4])
        reps = [batch() for _ in range(ONDEMAND_REPS)]
        return warm, reps

    (warm, reps), counts = runs(f"{name} on-demand", warm_then_reps,
                                ["decode_emit"])
    q, outv, offs, total, _ = reps[0]          # the checked batch
    want = lists_of(adj, q.cpu().numpy())
    exact = (total <= outv.shape[0]
             and np.array_equal(offs.cpu().numpy().astype(np.int64),
                                want.offsets.astype(np.int64))
             and np.array_equal(outv[:total].cpu().numpy().astype(np.uint32),
                                want.succs))
    del q, outv, offs, want
    q = make_q()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = era.successors_batch_device(q)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    sync_free_total = int(got[2])
    del got
    secs = [r[4] for r in reps]
    arcs = [r[3] for r in reps]
    del reps
    pl = dec._plans[("emit", lanes)]
    sec = statistics.median(secs)
    return {"queries": ONDEMAND_BATCH, "lanes_requested": lanes,
            "lanes": len(pl["starts_np"]),
            "T": pl["T"], "cap": pl["cap"], "warm_seconds": warm,
            "rep_seconds": secs, "ms_per_batch": sec * 1e3,
            "arcs_per_rep": arcs,
            "ns_per_arc": sec * 1e9 / max(statistics.mean(arcs), 1),
            "out_cap": era._full_out_cap(ONDEMAND_BATCH),
            "checked_queries": ONDEMAND_BATCH, "checked_total": total,
            "exact": exact, "sync_debug_rep_total": sync_free_total,
            "launches": counts, "emit_broken": pl.get("emit_broken")}


def serve_device(srv, adj) -> dict:
    """The JAX bench's serve protocol (tools/bench_device.py:250-282) on a
    built TorchCsrServer: SERVE_BATCH queries drawn on the card a rep,
    one gather_rows at out_cap = 1.3 times the mean degree, drained by
    int(total); the first batch checked query for query against the input
    graph."""
    from webgraph_ans_torch.ops.random_torch import gather_rows
    from webgraph_ans_torch.ops.reconstruct_device import _quant

    n = adj.num_nodes
    out_cap = _quant(int(SERVE_BATCH * (adj.num_arcs / n) * 1.3))
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(2027)

    def rep():
        t0 = time.perf_counter()
        q = torch.randint(0, n, (SERVE_BATCH,), generator=gen,
                          device=DEVICE, dtype=torch.int32)
        out, out_off, total = gather_rows(srv.offsets, srv.succs, q,
                                          out_cap)
        tot = int(total)
        return q, out, out_off, tot, time.perf_counter() - t0

    q, out, out_off, tot, _ = rep()
    want = lists_of(adj, q.cpu().numpy())
    exact = (tot <= out_cap
             and np.array_equal(out_off.cpu().numpy().astype(np.int64),
                                want.offsets.astype(np.int64))
             and np.array_equal(out[:tot].cpu().numpy().astype(np.uint32),
                                want.succs))
    del q, out, out_off, want
    rep()
    reps = [rep()[3:] for _ in range(SERVE_REPS)]
    secs = [r[1] for r in reps]
    tots = [r[0] for r in reps]
    sec = statistics.median(secs)
    return {"queries": SERVE_BATCH, "out_cap": out_cap, "rep_seconds": secs,
            "ms_per_batch": sec * 1e3, "arcs_per_rep": tots,
            "ns_per_arc": sec * 1e9 / statistics.mean(tots),
            "fits_out_cap": max(tots) <= out_cap, "exact": exact}


def ondemand_phase(sc: Scale, g, adj, srv, tokens: int | None = None
                   ) -> None:
    """Phases 19b and 31b: the device-resident serving contract and the
    serve protocol on one graph, with the phase's peak device memory.
    Given the graph's token count (31b, where no earlier phase ran a plan
    of the contract's lane count), decode_emit is timed on the verified
    plan beside its bound and held against its plain version on every
    lane at SCALE_PLAIN_CAP (sc.kernels["decode_emit_ondemand"])."""
    from webgraph_ans_torch import TorchGraphDecoder

    sc.start()
    dec = TorchGraphDecoder(g)
    od = ondemand_device(dec, adj, sc.runs, f"{sc.graph} ondemand")
    kernel = None
    if tokens is not None:
        pl = dec._plans[("emit", od["lanes_requested"])]
        kernel = emit_kernel_scale(dec, pl, tokens, short=True)
        sc.kernels["decode_emit_ondemand"] = kernel
        del pl
    del dec
    serve = serve_device(srv, adj)
    sc.emit("ondemand_device", dec=srv.dec, ondemand=od, serve=serve,
            kernel=kernel)
    if not (od["exact"] and serve["exact"] and serve["fits_out_cap"]
            and not od["emit_broken"]):
        raise SystemExit(f"{sc.graph} ondemand: a batch differs from the "
                         "input graph, the serve batch overflowed, or the "
                         "merged emit fell back")


def scale_phases(runs: PathRuns, smi: str, tmp: str) -> dict:
    """Phases 26-31: every single-device path on the JAX bench's fixture.
    Returns each kernel's time and bound at the fixture's shapes."""
    sc = Scale(runs, smi, tmp)
    adj, gs, gb, res_b = scale_fixture(sc)
    tokens = scale_token_path(sc, adj, gs)
    edec = scale_emit(sc, adj, gs, tokens)
    scale_sort_path(sc, adj, gs)
    scale_blocks(sc, adj, gb, res_b, tokens)
    scale_random_access(sc, adj, gs, edec, tokens)
    return sc.kernels


# --parent DIR: a checkout (or `git archive`) of another commit whose
# decode_emit the fold phases time in turns with this checkout's
PARENT: str | None = None
_PARENT_EMIT = None


def parent_emit_kernel():
    """--parent's decode_emit, built from that checkout's csrc once (into
    BUILD_DIR/parent), as (run, ptxas report): run(eargs, T) launches it in
    mark_deg mode on emit_args' inputs and returns its outputs (six
    channels, or seven where that source already counts folded rows)."""
    global _PARENT_EMIT
    if _PARENT_EMIT is None:
        import ctypes
        from webgraph_ans_torch.ops import cuda_build
        src = os.path.join(os.path.abspath(PARENT), "webgraph_ans_torch",
                           "csrc", "decode_emit.cu")
        lib_path = os.path.join(cuda_build.BUILD_DIR, "parent",
                                "libdecode_emit.so")
        info = cuda_build.build(src, lib_path, force=True)
        lib = ctypes.CDLL(lib_path)
        with open(src) as f:
            outs = 7 if "void* fold" in f.read() else 6
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.wgt_decode_emit.argtypes = (
            [ctypes.POINTER(ctypes.c_longlong), vp, vp, ctypes.c_longlong,
             vp, vp] + [ci] * 6 + [vp] * (outs + 1))
        lib.wgt_decode_emit.restype = ci

        def run(eargs, T):
            tables, regs, ptrs, window, mi, cap = eargs
            L, dev, i32 = regs.shape[1], regs.device, torch.int32
            res = [torch.empty((cap, L), dtype=i32, device=dev),
                   torch.empty((cap, L), dtype=i32, device=dev),
                   torch.empty((cap // 8, L), dtype=i32, device=dev),
                   torch.empty(L, dtype=i32, device=dev),
                   torch.empty(L, dtype=torch.bool, device=dev),
                   torch.empty((6, L), dtype=i32, device=dev),
                   torch.empty(L, dtype=i32, device=dev)][:outs]
            err = lib.wgt_decode_emit(
                cuda_build.codec_params(tables.params), tables.lut.data_ptr(),
                tables.stream.data_ptr(),
                tables.stream.shape[0], regs.data_ptr(), ptrs.data_ptr(), L,
                window, mi, cap, T, 1, *(t.data_ptr() for t in res),
                torch.cuda.current_stream(dev).cuda_stream)
            if err != 0:
                raise SystemExit(f"--parent's decode_emit failed: {err}")
            return res

        _PARENT_EMIT = (run, ptxas_report(info["log"]))
    return _PARENT_EMIT


def fold_phase(name: str, dec, pl, hold: bool = False) -> dict:
    """The verified plan's steady decode_emit (mark_deg) by run folding:
    the rows it writes in the fold's loop, each lane's full steps (rows
    less folded rows), the lane with the most steps and the lanes within
    3% of it, beside the lane of most rows and the lanes within 4% of it.
    With hold, the kernel against its plain version on the
    SCALE_PLAIN_LANES lanes around the lane of most steps (pending, as
    hold_plain; the record's "plain"). With --parent, that checkout's
    kernel on the same inputs, bit for bit on every channel both write,
    timed in turns with this one (parent, this, this, parent, three
    times; CUDA-event medians of TIMED_RUNS). Emits one `fold` line and
    fails if the parent's outputs differ."""
    from webgraph_ans_torch.ops.emit_cuda import decode_emit
    T, cap = pl["T"], pl["cap"]
    eargs = emit_args(dec, pl, cap)
    ek = decode_emit(*eargs, T=T, mark_deg=True)
    rows, fold = ek[3].long().cpu(), ek[6].long().cpu()
    steps = rows - fold
    starts, ends = pl["starts_np"], pl["ends_np"]

    def lane_record(k):
        return {"lane": k, "nodes": [int(starts[k]), int(ends[k])],
                "rows": int(rows[k]), "fold_rows": int(fold[k]),
                "steps": int(steps[k])}

    out = {"graph": name, "lanes": len(starts), "cap": cap, "T": T,
           "rows_max": int(rows.max()),
           "rows_mean": float(rows.double().mean()),
           "fold_rows": int(fold.sum()),
           "fold_share": 100 * float(fold.sum()) / float(rows.sum()),
           "steps_max": int(steps.max()),
           "steps_mean": float(steps.double().mean()),
           "steps_max_lane": lane_record(int(torch.argmax(steps))),
           "lanes_within_3pct_of_steps_max":
               int((100 * steps >= 97 * steps.max()).sum()),
           "rows_max_lane": lane_record(int(torch.argmax(rows))),
           "lanes_within_4pct_of_rows_max":
               int((100 * rows >= 96 * rows.max()).sum()),
           "longest_rows": sorted(rows.tolist(), reverse=True)[:5]}
    if hold:
        sl = longest_slice(steps)
        sargs = (dec.tables, pl["regs"][:, sl].contiguous(), pl["ptrs"][sl],
                 dec.window, dec.min_interval, cap)
        out["plain"] = hold_plain(
            ek, "webgraph_ans_torch.ops.emit_torch.decode_emit_plain",
            sargs, {"T": T, "mark_deg": True}, sl, cap,
            int(rows[sl].max()))
    if PARENT:
        run, ptxas = parent_emit_kernel()
        pk = run(eargs, T)
        same = all(torch.equal(a, b) for a, b in zip(pk, ek))
        channels = len(pk)
        del pk
        times = {"parent": [], "change": []}
        for side in ("parent", "change", "change", "parent") * 3:
            fn = ((lambda: run(eargs, T)) if side == "parent" else
                  (lambda: decode_emit(*eargs, T=T, mark_deg=True)))
            times[side].append(cuda_ms(fn)["median"])
        ms = {k: statistics.median(v) for k, v in times.items()}
        out["vs_parent"] = {"root": PARENT, "bit_equal": same,
                            "channels": channels, "ms": times,
                            "median_ms": ms,
                            "change_over_parent": ms["change"] / ms["parent"],
                            "parent_ptxas": ptxas}
    emit("fold", **out)
    if PARENT and not out["vs_parent"]["bit_equal"]:
        raise SystemExit(f"{name}: decode_emit differs from --parent's")
    return out


def main() -> int:
    global HOLDS, PARENT
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout of another commit whose "
                    "decode_emit the fold phases time in turns with this "
                    "one's")
    args = ap.parse_args()
    PARENT = args.parent
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from webgraph_ans_torch import (ANSBvGraph, TorchGraphDecoder,
                                    reconstruct, store)
    from webgraph_ans_torch.bvgraph.graph import Adjacency, load_bvgraph
    from webgraph_ans_torch.bvgraph.sequential import ANSBvGraphSeq
    from webgraph_ans_torch.bvgraph.store import (compress_adjacency,
                                                  dump_tokens)
    from webgraph_ans_torch.bvgraph.synth import synth_web_graph
    from webgraph_ans_torch.ops import (cuda_build, decode_cuda, emit_cuda,
                                        encode_cuda, emit_post, fixup_cuda)
    from webgraph_ans_torch.ops.encode_torch import (encode_blocks_plain,
                                                     encode_plan)
    from webgraph_ans_torch.ops.decode_torch import (decode_blocks_plain,
                                                     fetch_block_tokens)
    from webgraph_ans_torch.ops.emit_torch import decode_emit_plain

    cuda = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(smi, flush=True)
    emit("device", name=kind, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, count=torch.cuda.device_count())

    # ---- 1. build the four kernels from the checkout's sources, at once
    t0 = time.perf_counter()
    built = cuda_build.build_many(
        [(decode_cuda.SOURCE, decode_cuda.LIB_PATH),
         (emit_cuda.SOURCE, emit_cuda.LIB_PATH),
         (encode_cuda.SOURCE, encode_cuda.LIB_PATH),
         (fixup_cuda.SOURCE, fixup_cuda.LIB_PATH)], force=True)
    reports = {name: ptxas_report(info["log"]) for name, info in
               zip(("decode_blocks", "decode_emit", "encode_blocks",
                    "emit_fixup"), built)}
    emit("build", seconds=time.perf_counter() - t0, kernels=[
        {"kernel": name, "seconds": info["seconds"], "ptxas": reports[name]}
        for name, info in zip(reports, built)])
    HOLDS = Holds()
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
        # per grammar variant (window 0, no intervals, the merged-emit
        # kernel's widest ring, a wider one, phase-sampled entry points) ----
        rng = np.random.default_rng(2026)
        lists = [sorted(rng.choice(2000, size=int(rng.integers(0, 24)),
                                   replace=False).tolist())
                 for _ in range(2000)]
        adj_small = Adjacency.from_lists(lists)
        small, small_decs = [], []
        for name, w, r, mi, step in SMALL_CONFIGS + BLOCKS_ONLY_CONFIGS:
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
                        _, _, _, rows, ok, *_ = emit_cuda.decode_emit(
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
        fixup_cuda.emit_fixup.launches = 0
        cold = []
        epl = {}
        for _ in range(4):
            res3, sec = timed(
                lambda: edec.decode_to_adjacency_device(EMIT_LANES))
            epl = edec._plans[("emit", EMIT_LANES)]
            cold.append({"seconds": sec, "ns_per_arc": sec * 1e9 / arcs,
                         "exact": adjacency_exact(res3, adj),
                         "verified": edec.emit_steady(EMIT_LANES)})
            if edec.emit_steady(EMIT_LANES):
                break
        cold_launches = {
            "decode_emit": emit_cuda.decode_emit.launches,
            "decode_blocks_aux": decode_cuda.decode_blocks.aux_launches,
            "decode_blocks": decode_cuda.decode_blocks.launches,
            "emit_fixup": fixup_cuda.emit_fixup.launches}
        decode_cuda.decode_blocks.launches = 0
        decode_cuda.decode_blocks.aux_launches = 0
        emit_cuda.decode_emit.launches = 0
        fixup_cuda.emit_fixup.launches = 0
        # the first steady call runs eagerly and captures the CUDA graph,
        # the later ones replay it; every result is checked once all five
        # calls have run, so a replay must not overwrite an earlier result
        steady, results = [], []
        for _ in range(5):
            res3, sec = timed(
                lambda: edec.decode_to_adjacency_device(EMIT_LANES))
            steady.append(sec)
            results.append(res3)
        steady_exact = all(adjacency_exact(r, adj) for r in results)
        del results
        steady_launches = {
            "decode_emit": emit_cuda.decode_emit.launches,
            "decode_blocks_aux": decode_cuda.decode_blocks.aux_launches,
            "decode_blocks": decode_cuda.decode_blocks.launches,
            "emit_fixup": fixup_cuda.emit_fixup.launches}
        mc = epl["post_meta"]
        split_w7 = newest_split()
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
        # the post-pass patches val in place: each call gets a fresh copy
        posts = iter([ek[0].clone() for _ in range(13)])
        t_post = cuda_ms(lambda: emit_post.post_steady(
            next(posts), ek[1], *(mc[k] for k in emit_post.STEADY_KEYS)),
            runs=10)
        del posts
        steady_s = statistics.median(steady)
        emit("emit_e2e", graph="cnr-2000", lanes=len(epl["starts_np"]),
             T=epl["T"], cap=epl["cap"],
             dirty_nodes=len(mc["order_np"]),
             fixup_rounds=mc["rounds"], cold=cold,
             steady_seconds=steady_s, steady_ns_per_arc=steady_s * 1e9 / arcs,
             steady_runs=steady, steady_exact=steady_exact,
             steady_device_ms=t_steady, steady_eager_seconds=eager_s,
             steady_eager_device_ms=t_eager, post_steady_ms=t_post,
             host_planner_seconds=host_s, launches=cold_launches,
             steady_launches=steady_launches, split=split_w7,
             emit_broken=epl.get("emit_broken"))
        if not (all(c["exact"] for c in cold) and steady_exact
                and edec.emit_steady(EMIT_LANES)
                and split_w7.get("block_starts") == 0):
            raise SystemExit("merged emit: end-to-end adjacency is not "
                             "exact, the plan never verified, or its split "
                             "forced block starts on a serial artifact")
        if (path_launches["decode_emit"] < 1
                or path_launches["decode_blocks_aux"] < 1
                or steady_launches["decode_emit"] != len(steady)
                or steady_launches["emit_fixup"] != len(steady)
                or cold_launches["emit_fixup"] > PLANNING_CALLS
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
            cold4.append({"seconds": sec,
                          "exact": adjacency_exact(res3, adj)})
            if edec4.emit_steady(WIDE_EMIT_LANES):
                break
        steady4 = [timed(lambda: edec4.decode_to_adjacency_device(
            WIDE_EMIT_LANES)) for _ in range(3)]
        exact4 = all(adjacency_exact(r, adj) for r, _ in steady4)
        t_steady4 = cuda_ms(
            lambda: edec4.decode_to_adjacency_device(WIDE_EMIT_LANES),
            runs=10)
        emit("emit_e2e_wide", graph="cnr-2000",
             lanes=len(epl4["starts_np"]), T=epl4["T"], cap=epl4["cap"],
             cold=cold4, verified=edec4.emit_steady(WIDE_EMIT_LANES),
             steady_seconds=statistics.median(t for _, t in steady4),
             steady_device_ms=t_steady4, steady_exact=exact4)
        if not (exact4 and all(c["exact"] for c in cold4)
                and edec4.emit_steady(WIDE_EMIT_LANES)):
            raise SystemExit(f"merged emit at {WIDE_EMIT_LANES} lanes: not "
                             "exact, or the plan never verified")
        del edec4, steady4

        # ---- 9b. the fixup kernel vs its plain version, on the verified
        # cnr-2000 plan ----
        fix_w7 = fixup_hold(edec, epl)
        emit("fixup_vs_plain", graph="cnr-2000", lanes=EMIT_LANES, **fix_w7)
        if not (fix_w7["plain"]["bit_equal"]
                and fix_w7["hold_launches"] > 0):
            raise SystemExit("cnr-2000: the fixup kernel differs from its "
                             "plain version")

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
        # ---- 10c. its rows by run folding (and --parent's kernel) ----
        fold_phase("cnr-2000", edec, epl)

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
                               "exact": adjacency_exact(res3, adj),
                               "verified": bdec.emit_steady(EMIT_LANES)})
            if bdec.emit_steady(EMIT_LANES):
                break
        res3, steady_b = timed(
            lambda: bdec.decode_to_adjacency_device(EMIT_LANES))
        emit_calls.append({"seconds": steady_b, "steady": True,
                           "exact": adjacency_exact(res3, adj)})
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
        # ---- 14b. its steady plan, split inside the encode blocks, beside
        # the serial one's ----
        blocks_fold = blocks_steady_phase(edec, bdec, adj, base_b,
                                          tmp)["fold"]

        # ---- 15-19. the sort path, its fallbacks and random access ----
        runs = PathRuns()
        hc_base = os.path.join(tmp, "cnr_hc")
        hc_sort_s = sort_path_phases(g, adj, edec, runs, hc_base)
        # ---- 17b. the JAX bench's hc mode with safe breaks: the merged
        # emit's window-16 instance at 1024 lanes ----
        hc_kernel = hc_safe_break_phase(adj, runs, smi, tmp)
        # ---- 17c. the reference's hc artifact, without safe breaks, on
        # the merged emit at 1024 lanes ----
        hcref_kernel = hc_no_breaks_phase(adj, runs, smi, tmp, hc_sort_s)
        ra_cmp = random_access_phases(g, adj, edec, runs, smi)

        # ---- 20-25. scale-out: shards on the card, ranks over gloo and
        # NCCL ----
        so_cmp = scale_out_phases(g, gb, adj, edec, runs, tmp, hc_base)
        del g, gb, adj, edec

        # ---- 26-31. every single-device path on the JAX bench's
        # 4M-node synthetic fixture ----
        scale = scale_phases(runs, smi, tmp)
        settle_holds({**scale, "decode_emit_hc": hc_kernel,
                      "decode_emit_blocks_cnr": blocks_fold,
                      "decode_emit_hcref": hcref_kernel["fold"]})

    if spills:
        raise SystemExit(f"kernel instances spill registers: {spills}")

    # ---- 32. the kernels line: launches summed over every path; each
    # kernel's time and bound at the scale phases' shapes beside; its
    # holds against the plain version at cnr-2000's and those shapes ----
    held = {k: v["plain"] for k, v in scale.items()}
    kernels = [{
        "name": "decode_blocks", "route": "cuda",
        "source": "webgraph_ans_torch/csrc/decode_blocks.cu",
        "replaces": "webgraph_ans_tpu/ops/decode_pallas.py:440",
        "launches": launches + runs.total["decode_blocks"],
        "bit_equal": (cmp_cnr["bit_equal"]
                      and ra_cmp["decode_blocks"]["bit_equal"]
                      and so_cmp["decode_blocks"]["bit_equal"]
                      and held["decode_blocks"]["bit_equal"]),
        "max_abs_err": max(cmp_cnr["max_abs_err"],
                           ra_cmp["decode_blocks"]["max_abs_err"],
                           so_cmp["decode_blocks"]["max_abs_err"],
                           held["decode_blocks"]["max_abs_err"]),
        "ms": t_k["median"],
        "plain_ms": plain_s * 1e3, "bound_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"], "library_ms": None,
        "lanes": LANES, "ms_32768_lanes": t_w["median"],
        "scale": scale["decode_blocks"],
    }, {
        "name": "decode_blocks_aux", "route": "cuda",
        "source": "webgraph_ans_torch/csrc/decode_blocks.cu",
        "replaces": "webgraph_ans_tpu/ops/decode_pallas.py:440",
        "launches": (path_launches["decode_blocks_aux"]
                     + runs.total["decode_blocks_aux"]),
        "bit_equal": (cmp_aux["bit_equal"]
                      and held["decode_blocks_aux"]["bit_equal"]),
        "max_abs_err": max(cmp_aux["max_abs_err"],
                           held["decode_blocks_aux"]["max_abs_err"]),
        "ms": t_aux["median"],
        "plain_ms": aplain_s * 1e3, "bound_ms": abound["bound_ms"],
        "bound_by": abound["bound_by"], "library_ms": None,
        "lanes": EMIT_LANES, "scale": scale["decode_blocks_aux"],
    }, {
        "name": "decode_emit", "route": "cuda",
        "source": "webgraph_ans_torch/csrc/decode_emit.cu",
        "replaces": "webgraph_ans_tpu/ops/emit_pallas.py:501",
        "launches": path_launches["decode_emit"] + runs.total["decode_emit"],
        "bit_equal": (cmp_emit["bit_equal"]
                      and ra_cmp["decode_emit"]["bit_equal"]
                      and so_cmp["decode_emit"]["bit_equal"]
                      and held["decode_emit"]["bit_equal"]
                      and held["decode_emit_blocks"]["bit_equal"]
                      and held["decode_emit_ondemand"]["bit_equal"]
                      and hc_kernel["plain"]["bit_equal"]
                      and blocks_fold["plain"]["bit_equal"]
                      and hcref_kernel["fold"]["plain"]["bit_equal"]),
        "max_abs_err": max(cmp_emit["max_abs_err"],
                           ra_cmp["decode_emit"]["max_abs_err"],
                           so_cmp["decode_emit"]["max_abs_err"],
                           held["decode_emit"]["max_abs_err"],
                           held["decode_emit_blocks"]["max_abs_err"],
                           held["decode_emit_ondemand"]["max_abs_err"],
                           hc_kernel["plain"]["max_abs_err"],
                           blocks_fold["plain"]["max_abs_err"],
                           hcref_kernel["fold"]["plain"]["max_abs_err"]),
        "ms": t_emit["median"],
        "plain_ms": eplain_s * 1e3, "bound_ms": ebound["bound_ms"],
        "bound_by": ebound["bound_by"], "library_ms": None,
        "lanes": len(epl["starts_np"]), **geometry,
        "scale": {"serial": scale["decode_emit"],
                  "blocks": scale["decode_emit_blocks"],
                  "ondemand_2048": scale["decode_emit_ondemand"]},
        "hc_safe_break_w16": {k: hc_kernel[k] for k in (
            "lanes", "cap", "T", "ms", "bound_ms", "bound_by",
            "lanes_per_block", "smem_bytes")},
    }, {
        "name": "encode_blocks", "route": "cuda",
        "source": "webgraph_ans_torch/csrc/encode_blocks.cu",
        "replaces": "webgraph_ans_tpu/ops/encode_pallas.py:291",
        "launches": enc_launches + runs.total["encode_blocks"],
        "bit_equal": (cmp_enc["bit_equal"]
                      and held["encode_blocks"]["bit_equal"]),
        "max_abs_err": max(cmp_enc["max_abs_err"],
                           held["encode_blocks"]["max_abs_err"]),
        "ms": t_enc["median"],
        "plain_ms": enc_plain_s * 1e3, "bound_ms": enc_bound["bound_ms"],
        "bound_by": enc_bound["bound_by"], "library_ms": None,
        "lanes": cplan.tstart.shape[0], **enc_geometry,
        "scale": scale["encode_blocks"],
    }, {
        "name": "emit_fixup", "route": "cuda",
        "source": "webgraph_ans_torch/csrc/emit_fixup.cu",
        "replaces": None,
        "launches": path_launches["emit_fixup"] + runs.total["emit_fixup"],
        "bit_equal": (fix_w7["plain"]["bit_equal"]
                      and hc_kernel["fixup"]["plain"]["bit_equal"]
                      and hcref_kernel["fixup"]["plain"]["bit_equal"]),
        "max_abs_err": max(fix_w7["plain"]["max_abs_err"],
                           hc_kernel["fixup"]["plain"]["max_abs_err"],
                           hcref_kernel["fixup"]["plain"]["max_abs_err"]),
        "ms": fix_w7["ms"]["median"], "plain_ms": fix_w7["plain_ms"],
        "bound_ms": fix_w7["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "lanes": EMIT_LANES,
        "hc_safe_break_w16": {k: hc_kernel["fixup"][k] for k in (
            "rounds", "dirty_nodes", "ms", "bound_ms")},
        "hc_no_breaks_w16": {k: hcref_kernel["fixup"][k] for k in (
            "rounds", "dirty_nodes", "elements", "ms", "bound_ms")},
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        if HOLDS is not None:
            HOLDS.close()
    sys.exit(rc)
