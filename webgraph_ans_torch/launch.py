"""Multi-process launch: one command per process of a torch.distributed
group, each decoding its node-range shard.

    python -m webgraph_ans_torch.launch BASENAME \\
        --coordinator HOST0:PORT --num-processes P --process-id r \\
        [--backend nccl|gloo] [--device cuda:0|cpu] \\
        [--lanes-per-host 4096] [--reps 3] [--gather OUT.npz]

Every process loads the same artifacts (a shared filesystem or a copy),
joins the process group (init method tcp://HOST0:PORT), decodes its shard
with the lane-parallel kernel on its device and prints one JSON report
of its decode throughput, with its stages (MultihostGraphDecoder.stats)
and the kernels' launches in this process. With --gather, the shards are
moved over the collectives (an ordered all_gather of padded shards, rank
order = node order) and process 0 writes the full CSR (offsets u64, succs
u32) to OUT.npz.

The device defaults to cuda:<rank % local GPU count> with NCCL, one
rank to a GPU. --device cpu runs the kernels' plain versions over gloo.
NCCL refuses two ranks on one GPU, so ranks that share a card (--device
cuda:0 with several local ranks) use gloo, and each report says
shared_device.

Dry run on one machine: spawns N local processes of this module, the
coordinator on localhost, and ends them all when one fails:

    python -m webgraph_ans_torch.launch BASENAME --local-dryrun 4 \\
        --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

_PKG_PARENT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_device(args):
    """This rank's device: --device, else its own CUDA device (raises
    without CUDA)."""
    import torch

    if args.device is not None:
        return torch.device(args.device)
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu")
    return torch.device("cuda", args.process_id % torch.cuda.device_count())


def _backend(args, device) -> str | None:
    """--backend, else NCCL for a CUDA device and gloo for the host when
    there is a group to make (several processes or a named backend)."""
    if args.backend is not None:
        return args.backend
    if args.num_processes == 1:
        return None
    return "nccl" if device.type == "cuda" else "gloo"


def _gather(lo: int, hi: int, offsets, succs, out_path: str) -> dict:
    """Ordered gather of every shard to process 0 over the collectives:
    each shard padded to the largest, one all_gather each of the sizes,
    the successors and the offsets; rank order is node order. Process 0
    writes the CSR to out_path."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from .parallel.multihost import collective_device

    dev = collective_device()
    P, rank = dist.get_world_size(), dist.get_rank()
    arcs = len(succs)

    def all_gather(t):
        parts = [torch.empty_like(t) for _ in range(P)]
        dist.all_gather(parts, t)
        return torch.stack(parts).cpu().numpy()

    dist.barrier()          # the gather's seconds exclude waiting for ranks
    t0 = time.perf_counter()
    counts = all_gather(torch.tensor([arcs, hi - lo], dtype=torch.int64,
                                     device=dev))
    amax, nmax = int(counts[:, 0].max()), int(counts[:, 1].max())
    pad_s = np.zeros(amax, np.uint32)
    pad_s[:arcs] = succs
    pad_o = np.zeros(nmax + 1, np.int64)
    pad_o[:hi - lo + 1] = np.asarray(offsets, np.int64)
    all_s = all_gather(torch.from_numpy(pad_s.view(np.int32)).to(dev))
    all_o = all_gather(torch.from_numpy(pad_o).to(dev))
    seconds = time.perf_counter() - t0
    if rank != 0:
        return {}
    parts, offs, base = [], [np.zeros(1, np.int64)], 0
    for h in range(P):
        a, nn = int(counts[h, 0]), int(counts[h, 1])
        parts.append(all_s[h, :a].view(np.uint32))
        offs.append(all_o[h, 1:nn + 1] + base)
        base += a
    np.savez(out_path, offsets=np.concatenate(offs).astype(np.uint64),
             succs=np.concatenate(parts))
    return {"gathered": out_path, "total_arcs": int(base),
            "gather_seconds": seconds}


def _run(args) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from .bvgraph.random_access import ANSBvGraph
    from .ops.decode_cuda import decode_blocks
    from .ops.emit_cuda import decode_emit
    from .parallel.multihost import (DEFAULT_TIMEOUT, MultihostGraphDecoder,
                                     init_distributed)

    device = _rank_device(args)
    backend = _backend(args, device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    coordinator = args.coordinator
    if backend is not None and coordinator is None:
        if args.num_processes > 1:
            raise SystemExit("--coordinator HOST:PORT is needed for "
                             "several processes")
        coordinator = f"127.0.0.1:{_free_port()}"
    grouped = init_distributed(
        backend, f"tcp://{coordinator}" if coordinator else None,
        args.num_processes, args.process_id, DEFAULT_TIMEOUT)
    try:
        shared = False
        if grouped:
            # ranks on one host that name the same device share it
            where = [None] * dist.get_world_size()
            dist.all_gather_object(where, (socket.gethostname(),
                                           str(device)))
            shared = where.count(where[dist.get_rank()]) > 1
        g = ANSBvGraph.load(args.basename)
        mh = MultihostGraphDecoder(g, lanes_per_host=args.lanes_per_host,
                                   device=device)
        lo, hi, offsets, succs = mh.decode_shard()   # warm (plans, builds)
        ts = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            lo, hi, offsets, succs = mh.decode_shard()
            ts.append(time.perf_counter() - t0)
        sec = float(np.median(ts)) if ts else float("nan")
        arcs = int(len(succs))
        print(json.dumps({
            "process": mh.h, "num_processes": mh.num_hosts,
            "nodes": [int(lo), int(hi)], "arcs": arcs,
            "sec_per_rep": sec, "ns_per_arc": sec / max(arcs, 1) * 1e9,
            "device": str(device), "backend": backend,
            "shared_device": shared, "stats": mh.stats,
            "launches": {"decode_blocks": decode_blocks.launches,
                         "decode_emit": decode_emit.launches},
        }), flush=True)
        if args.gather:
            if not grouped:
                raise SystemExit("--gather needs a process group (several "
                                 "processes or --backend)")
            line = _gather(lo, hi, offsets, succs, args.gather)
            if line:
                print(json.dumps(line), flush=True)
    finally:
        if grouped:
            dist.destroy_process_group()


def _stop(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + 10
    for p in procs:
        try:
            p.wait(max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def _local_dryrun(args) -> int:
    """Spawns args.local_dryrun processes of this module on this machine
    and waits for them as long as a collective may wait
    (multihost.DEFAULT_TIMEOUT). On the first nonzero exit (or past that
    wait) it ends the other processes and returns nonzero:
    a dead rank would otherwise leave the others blocked in a collective.
    Without --device each rank takes its own GPU (NCCL); with one device
    named, every rank runs on it, over gloo when they share a card."""
    import torch

    from .parallel.multihost import DEFAULT_TIMEOUT

    n = args.local_dryrun
    device, backend = args.device, args.backend
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("CUDA is not available; pass --device cpu")
        if n > torch.cuda.device_count():
            raise SystemExit(
                f"{n} ranks and {torch.cuda.device_count()} GPUs: NCCL needs "
                "one GPU a rank; name one device (--device cuda:0) to run "
                "every rank on it over gloo")
    elif backend is None:
        backend = "gloo"
    if backend == "nccl" and device is not None and n > 1 \
            and not device.startswith("cpu"):
        raise SystemExit("NCCL refuses several ranks on one GPU; use "
                         "--backend gloo")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_PKG_PARENT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                         if p])
    coord = f"127.0.0.1:{_free_port()}"
    procs = []
    try:
        for pid in range(n):
            cmd = [sys.executable, "-m", "webgraph_ans_torch.launch",
                   args.basename, "--coordinator", coord,
                   "--num-processes", str(n), "--process-id", str(pid),
                   "--lanes-per-host", str(args.lanes_per_host),
                   "--reps", str(args.reps)]
            if device is not None:
                cmd += ["--device", device]
            if backend is not None:
                cmd += ["--backend", backend]
            if args.gather:
                # the gather is a collective: every process passes the
                # flag, only process 0 writes the file
                cmd += ["--gather", args.gather]
            procs.append(subprocess.Popen(cmd, env=env))
        wait = DEFAULT_TIMEOUT.total_seconds()
        deadline = time.monotonic() + wait
        while True:
            rcs = [p.poll() for p in procs]
            failed = [rc for rc in rcs if rc not in (None, 0)]
            if failed:
                print(f"launch: a rank exited with {failed[0]}; ending the "
                      "others", file=sys.stderr, flush=True)
                return failed[0]
            if all(rc == 0 for rc in rcs):
                return 0
            if time.monotonic() > deadline:
                print(f"launch: ranks still running after {wait} s; "
                      "ending them", file=sys.stderr, flush=True)
                return 124
            time.sleep(0.05)
    finally:
        _stop(procs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m webgraph_ans_torch.launch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("basename")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 (the tcp:// init method)")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="default: nccl on CUDA devices, gloo on the host")
    ap.add_argument("--device", default=None,
                    help="cuda:N or cpu (default: cuda:<rank %% GPUs>)")
    ap.add_argument("--lanes-per-host", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--gather", default=None,
                    help="npz path: ordered-gather the CSR to process 0")
    ap.add_argument("--local-dryrun", type=int, default=0, metavar="N",
                    help="spawn N local processes of this module")
    args = ap.parse_args(argv)
    if args.local_dryrun:
        return _local_dryrun(args)
    _run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
