"""The system under test, webgraph_ans_torch, as the benchmark drives it,
and the data cache that keeps each configuration's reference lists and
stored artifact inside the checkout.

The cache lives in `<benchmark>/.cache/<config>/`, at fixed paths. Each
entry carries the digest of what made it: the reference lists the
configuration's graph and the reference's sources, the artifact the
graph, the store's parameters and every source file of the port. So
only a checkout's first run of a configuration generates, reads and
stores; an entry made by other code is made again.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os

import numpy as np
import torch

from .reference import lists as ref_lists

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
PORT = "webgraph_ans_torch"
PORT_SOURCES = ("**/*.py", "**/*.cu", "**/*.cuh", "**/*.cpp", "**/*.hpp",
                "native/Makefile")


def _digest(parts, files) -> str:
    h = hashlib.sha256(json.dumps(parts, sort_keys=True).encode())
    for path in sorted(files):
        h.update(os.path.relpath(path, ROOT).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def _sources(directory: str, patterns) -> list[str]:
    out = set()
    for pat in patterns:
        out.update(p for p in glob.glob(os.path.join(directory, pat),
                                        recursive=True)
                   if os.sep + "build" + os.sep not in p)
    return sorted(out)


class Cache:
    """One configuration's entries in the data cache, in `directory`."""

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(self.dir, exist_ok=True)

    def path(self, name: str) -> str:
        return os.path.join(self.dir, name)

    def meta(self, entry: str) -> dict | None:
        try:
            with open(self.path(entry + ".json")) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def seal(self, entry: str, meta: dict):
        """Marks an entry complete: its meta is written last."""
        tmp = self.path(f"{entry}.json.{os.getpid()}.tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, self.path(entry + ".json"))

    def save_array(self, name: str, arr: np.ndarray):
        tmp = self.path(f"{name}.{os.getpid()}.tmp.npy")
        np.save(tmp, arr)
        os.replace(tmp, self.path(name + ".npy"))


def reference_digest(cfg: dict) -> str:
    return _digest({"graph": cfg["graph"]},
                   _sources(os.path.join(BENCH_DIR, "reference"), ["*.py"]))


def _check_size(cfg: dict, nodes: int, arcs: int):
    """The lists the plain side read have the configuration's size."""
    if (nodes, arcs) != (cfg["nodes"], cfg["arcs"]):
        raise ValueError(
            f"configuration {cfg['name']}: the plain side read {nodes} nodes "
            f"and {arcs} arcs, the configuration states {cfg['nodes']} and "
            f"{cfg['arcs']}")


def reference_lists(cfg: dict, cache: Cache, load: bool = True):
    """The configuration's lists from the plain side, made once a checkout
    and kept: (offsets int64, succs int32), or None with load=False when
    the cache already holds them. The meta (`nodes`, `arcs`) is
    `cache.meta("reference")`. Raises ValueError when the lists' size is
    not the configuration's `nodes` and `arcs`."""
    key = reference_digest(cfg)
    meta = cache.meta("reference")
    if meta is not None and meta.get("key") == key:
        _check_size(cfg, meta["nodes"], meta["arcs"])
        if not load:
            return None
        return (np.load(cache.path("ref_offsets.npy")),
                np.load(cache.path("ref_succs.npy")))
    offsets, succs = ref_lists.graph_lists(cfg["graph"], BENCH_DIR)
    _check_size(cfg, len(offsets) - 1, len(succs))
    cache.save_array("ref_offsets", offsets)
    cache.save_array("ref_succs", succs)
    cache.seal("reference", {"key": key, "nodes": len(offsets) - 1,
                             "arcs": len(succs)})
    return offsets, succs


def artifact(cfg: dict, cache: Cache) -> str:
    """The basename of the artifact the port's store writes for the
    configuration (`.ans`, `.pointers`, `.states`), stored once a
    checkout: a BVGraph file through the port's own reader (`store`),
    a generated graph from the reference's lists (`compress_adjacency`),
    with the configuration's `store` parameters."""
    key = _digest({"graph": cfg["graph"], "store": cfg["store"]},
                  _sources(os.path.join(ROOT, PORT), PORT_SOURCES))
    base = cache.path("artifact")
    meta = cache.meta("artifact")
    if meta is not None and meta.get("key") == key:
        return base
    from webgraph_ans_torch.ans.prelude import save_pointers, save_states
    from webgraph_ans_torch.bvgraph.graph import Adjacency
    from webgraph_ans_torch.bvgraph.store import compress_adjacency, store
    graph, params = cfg["graph"], cfg["store"]
    tmp = cache.path(f"artifact.{os.getpid()}.tmp")
    if graph["kind"] == "bvgraph":
        store(os.path.join(BENCH_DIR, graph["basename"]), tmp, **params)
    else:
        offsets, succs = reference_lists(cfg, cache)
        res = compress_adjacency(
            Adjacency(offsets.astype(np.uint64), succs.astype(np.uint32)),
            **params)
        res.prelude.save(tmp)
        save_states(tmp, res.states)
        save_pointers(tmp, res.pointers)
    for ext in (".ans", ".pointers", ".states"):
        os.replace(tmp + ext, base + ext)
    cache.seal("artifact", {"key": key})
    return base


class PortSystem:
    """The port's entry points on one stored artifact: the full decode
    (`TorchGraphDecoder.decode_to_adjacency_device`) and batch random
    access (`TorchEmitRandomAccess.successors_batch`)."""

    def __init__(self, cfg: dict, base: str, device: str = "cuda"):
        from webgraph_ans_torch import ANSBvGraph, TorchGraphDecoder
        self.graph = ANSBvGraph.load(base)
        self.dec = TorchGraphDecoder(self.graph, device=device)
        self.device = self.dec.device
        self.lanes = int(cfg["decode_lanes"])
        self._ra = None

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def decode(self):
        """(succs2d [cap, L], starts_flat [n], degs [n]) on the device:
        node x's k-th successor is succs2d.flatten()[starts_flat[x] +
        k * L]."""
        return self.dec.decode_to_adjacency_device(self.lanes)

    @property
    def ra(self):
        if self._ra is None:
            from webgraph_ans_torch import TorchEmitRandomAccess
            self._ra = TorchEmitRandomAccess(self.dec)
        return self._ra

    def query(self, q: np.ndarray):
        """(offsets [len(q) + 1], succs) on the host: query i's list is
        succs[offsets[i]:offsets[i + 1]]."""
        adj = self.ra.successors_batch(q)
        return adj.offsets, adj.succs

    def query_record(self) -> dict:
        """The port's own record of the last batch: its rounds (each with
        its host seconds) and the queries sent to the wave decode."""
        ra = self.ra
        return {"rounds": [dict(r) for r in ra.last_rounds],
                "unclean": int(ra.last_unclean),
                "wave_seconds": float(ra.last_wave_seconds)}

    def counters(self) -> dict:
        """The kernels' launch counts; none off the card, where the port
        runs its plain PyTorch versions and counts nothing."""
        if self.device.type != "cuda":
            return {}
        from webgraph_ans_torch.ops import decode_cuda, emit_cuda
        return {"decode_emit": emit_cuda.decode_emit.launches,
                "decode_blocks": decode_cuda.decode_blocks.launches,
                "decode_blocks_aux": decode_cuda.decode_blocks.aux_launches}

    def close(self):
        self._ra = None
        self.dec = None
        self.graph = None
