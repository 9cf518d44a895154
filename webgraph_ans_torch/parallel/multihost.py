"""Scale-out over processes (torch.distributed): node-range shards, one a
process, each decoded with the lane-parallel kernel on the process's
device and reconstructed there; only the final statistics and gathers
use collectives (the PyTorch form of webgraph_ans_tpu/parallel/
multihost.py, with torch.distributed in place of jax.distributed).

The phase table makes node ranges independent, so process r of P owns
nodes [r*n/P, (r+1)*n/P), loads the shared artifacts and decodes its
range; the nodes before its range that its lists copy from (the
reference closure) are decoded as contiguous ranges that at least double
until they close. Collectives take tensors where the backend wants them:
on the CUDA device for NCCL, on the host for gloo.

Degenerates to one process (the whole graph) without a process group.
"""

from __future__ import annotations

import datetime
import time

import numpy as np
import torch
import torch.distributed as dist

from ..bvgraph.random_access import ANSBvGraph
from ..ops.graph_decode import TorchGraphDecoder
from ..ops.reconstruct_torch import reconstruct

DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def init_distributed(backend: str | None = None,
                     init_method: str | None = None,
                     world_size: int | None = None, rank: int | None = None,
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> bool:
    """torch.distributed.init_process_group with a finite timeout; a
    no-op for one process without a backend. The backend defaults to NCCL
    where CUDA is available, gloo elsewhere. Returns whether a process
    group was made."""
    if backend is None and world_size in (None, 1):
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size or 1, rank=rank or 0,
                            timeout=timeout)
    return True


def collective_device() -> torch.device:
    """Where the process group's collectives take their tensors: the
    current CUDA device for NCCL, the host for gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


class MultihostGraphDecoder:
    """Decodes this process's node-range shard of an ANSBvGraph.

    Every process loads the same basename (a shared filesystem or a
    copy); the node range follows the process group's rank and size, or
    is the whole graph without a process group. decode_shard() returns the
    local CSR shard with its global node range (the results stay sharded);
    total_arcs() shows the collective path. `device` is the decoder's
    (CUDA by default; "cpu" runs the kernels' plain versions)."""

    def __init__(self, graph: ANSBvGraph, lanes_per_host: int = 4096,
                 device=None):
        self.g = graph
        self.dec = TorchGraphDecoder(graph, device=device)
        if _grouped():
            self.h, self.num_hosts = dist.get_rank(), dist.get_world_size()
        else:
            self.h, self.num_hosts = 0, 1
        n = graph.num_nodes
        self.node_lo = (self.h * n) // self.num_hosts
        self.node_hi = ((self.h + 1) * n) // self.num_hosts
        self.lanes = lanes_per_host
        # the last decode_shard's closure ranges and host-clock seconds
        self.stats: dict = {}

    def _decode_range_tokens(self, lo: int, hi: int):
        """Lane-parallel token decode of nodes [lo, hi) on the decoder's
        device, through its range plan (TorchGraphDecoder.plan): lane
        bounds honour encode-block starts (a lane never crosses an rANS
        state reset), and on phase-sampled artifacts lo must be an entry
        point (ValueError otherwise)."""
        if hi <= lo:
            return np.zeros(0, np.uint32), np.zeros(0, np.uint8)
        L = min(self.lanes, hi - lo)
        return self.dec.decode_tokens(L, lo=lo, hi=hi)

    def _closure_before(self, lo: int):
        """Token streams of the reference closure preceding the shard:
        nodes in [lo-window, lo) may be copied from by the shard, and they
        may reference further back. Decoded as CONTIGUOUS node ranges:
        when a reference escapes the current range the range at least
        doubles, so deep chains close in O(log span) ranged decodes.
        Returns (base, vals, comps): the token streams of [base, lo).
        Raises ValueError when a reference points below node 0 (a corrupt
        REFERENCE_OFFSET); otherwise every pass lowers base to a parent
        node at or above 0, so the loop ends."""
        d = self.dec
        base = max(lo - max(d.window, 1), 0)
        ranges = self.stats.setdefault("closure_ranges", [])
        while True:
            ranges.append((base, lo))
            vals, comps = self._decode_range_tokens(base, lo)
            # every node opens with an OUTDEGREE (component 0) token;
            # REFERENCE_OFFSET (component 1) tokens with a value > 0 copy
            # from node_of - value
            node_of = base + np.cumsum(comps == 0) - 1
            m = (comps == 1) & (vals > 0)
            if not m.any():
                return base, vals, comps
            parents = node_of[m] - vals[m].astype(np.int64)
            k = int(np.argmin(parents))
            min_parent = int(parents[k])
            if min_parent >= base:
                return base, vals, comps
            if min_parent < 0:
                raise ValueError(
                    f"node {int(node_of[m][k])} has REFERENCE_OFFSET "
                    f"{int(vals[m][k])}, which points below node 0: the "
                    "artifact is corrupt")
            base = max(min(min_parent, lo - 2 * (lo - base)), 0)

    def decode_shard(self):
        """Token-decodes and reconstructs the local node range. Returns
        (node_lo, node_hi, offsets u64, succs u32) for nodes
        [node_lo, node_hi); stats records the closure's ranges and the
        seconds of each stage."""
        d = self.dec
        lo, hi = self.node_lo, self.node_hi
        self.stats = {}
        if hi <= lo:
            return lo, hi, np.zeros(1, np.uint64), np.zeros(0, np.uint32)
        t0 = time.perf_counter()
        vals, comps = self._decode_range_tokens(lo, hi)
        t1 = time.perf_counter()
        self.stats["shard_tokens_s"] = t1 - t0
        if lo == 0:
            offsets, succs = reconstruct(vals, comps, hi - lo,
                                         d.min_interval, device=d.device)
            self.stats["reconstruct_s"] = time.perf_counter() - t1
            return lo, hi, offsets, succs
        base, pre_vals, pre_comps = self._closure_before(lo)
        t2 = time.perf_counter()
        self.stats["closure_s"] = t2 - t1
        ids = np.arange(base, hi, dtype=np.int64)
        vals = np.concatenate([pre_vals.astype(vals.dtype), vals])
        comps = np.concatenate([pre_comps.astype(comps.dtype), comps])
        offsets, succs = reconstruct(vals, comps, len(ids), d.min_interval,
                                     node_ids=ids, device=d.device)
        self.stats["reconstruct_s"] = time.perf_counter() - t2
        first = lo - base
        off0 = int(offsets[first])
        return lo, hi, (offsets[first:] - off0).astype(np.uint64), \
            succs[off0:]

    def total_arcs(self) -> int:
        """The arcs of every shard: an all_reduce over the process group,
        the local count without one."""
        _, _, _, succs = self.decode_shard()
        if self.num_hosts == 1 or not _grouped():
            return len(succs)
        t = torch.tensor([len(succs)], dtype=torch.int64,
                         device=collective_device())
        dist.all_reduce(t)
        return int(t.item())
