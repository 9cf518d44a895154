"""The one general traffic generator. A traffic mix is a data file of
parameters (`traffic/<mix>.json`); its `entry` names the entry point it
drives, and the rest are the mix's sizes:

- `"entry": "decode"`: back-to-back full decodes of the stored graph,
  closed loop, one client. `warmup_calls` untimed decodes first (the
  cold plan calls until the steady state); in the window, the seed
  draws `checked` decodes among the indices of `check_range` (one
  parity, so no two are adjacent) whose lists are compared in full
  besides the last one's. Before each of those, the previous decode's
  successors are overwritten, so that a decode that hands back an
  earlier answer cannot pass.
- `"entry": "query"`: batches of `batch` query nodes, closed loop, one
  client; `distribution` "uniform" over all nodes. `warmup_batches`
  batches from `warmup_seed` first. Every batch of the window is
  compared.

Either runs at least `min_calls` calls (default 1) in its window. A key
that the entry does not read, or a value it does not implement, raises.

The seed draws only what the window sends and checks; the warm-up is the
same work in every run.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .reference import lists as ref_lists


def make_driver(mix: dict, system, nodes: int, seed: int, spans):
    entry = mix.get("entry")
    drivers = {d.entry: d for d in (DecodeDriver, QueryDriver)}
    if entry not in drivers:
        raise ValueError(f"unknown traffic entry {entry!r}")
    unread = sorted(set(mix) - drivers[entry].keys - {"entry", "min_calls"})
    if unread:
        raise ValueError(f"traffic keys {unread} are not read by the "
                         f"{entry!r} entry")
    return drivers[entry](mix, system, nodes, seed, spans)


class DecodeDriver:
    entry = "decode"
    keys = {"warmup_calls", "checked", "check_range"}

    def __init__(self, mix, system, nodes, seed, spans):
        self.mix, self.sys, self.spans = mix, system, spans
        rng = np.random.default_rng(seed)
        lo, hi = mix["check_range"]
        k = int(mix["checked"])
        cand = np.arange(lo + int(rng.integers(2)), hi, 2)
        if len(cand) < k:
            cand = np.arange(lo, hi, 2)
        self.picks = set(int(i) for i in rng.choice(
            cand, size=k, replace=False))
        self.kept: dict[int, tuple] = {}
        self.min_calls = int(mix.get("min_calls", 1))

    def warmup(self):
        for i in range(int(self.mix["warmup_calls"])):
            with self.spans("cold_decode", index=i):
                self.sys.decode()
                self.sys.sync()

    def measure(self, seconds: float) -> dict:
        prev, i = None, 0
        t0 = time.perf_counter()
        end = t0 + seconds
        while True:
            if i in self.picks and prev is not None:
                prev[0].fill_(-1)
            with self.spans("decode", index=i):
                out = self.sys.decode()
                self.sys.sync()
            if i in self.picks:
                self.kept[i] = out
            prev, i = out, i + 1
            if time.perf_counter() >= end and i >= self.min_calls:
                break
        t1 = time.perf_counter()
        self.kept[i - 1] = out
        return {"seconds": t1 - t0, "count": i}

    def traced(self, seconds: float) -> int:
        """Decodes, as in the window, for `seconds`: the traced window."""
        i, end = 0, time.perf_counter() + seconds
        while i == 0 or time.perf_counter() < end:
            with self.spans("decode", traced=True):
                self.sys.decode()
                self.sys.sync()
            i += 1
        return i

    @staticmethod
    def path_checks(counts: dict, calls: int) -> dict:
        """The window's decodes ran the merged-emit kernel, as the cell
        names it: a decode that fell back to the sort path launches none.
        Only where the system counts the kernel's launches (on the card)."""
        if "decode_emit" not in counts:
            return {}
        return {"emit_launches_per_decode": {
            "value": counts["decode_emit"] / max(calls, 1), "min": 1}}

    def check(self, ref_offsets, ref_succs) -> dict:
        """Every kept decode against the reference's lists, on the
        decode's device."""
        dev = self.sys.device
        n = len(ref_offsets) - 1
        ro = torch.from_numpy(ref_offsets).to(dev)
        rs = torch.from_numpy(ref_succs).to(dev)
        nodes = torch.arange(n, device=dev)
        wrong, failed = 0, 0
        for _, (succs2d, starts, degs) in sorted(self.kept.items()):
            if starts.numel() != n or degs.numel() != n or succs2d.dim() != 2:
                w = n
            else:
                w = ref_lists.count_wrong(ro, rs, nodes, starts, degs,
                                          succs2d.shape[1], succs2d)
            wrong += w
            failed += w > 0
        return {"wrong": wrong, "answers": len(self.kept),
                "lists": n * len(self.kept), "failed": failed}

    def release(self):
        self.kept.clear()


class QueryDriver:
    entry = "query"
    keys = {"batch", "distribution", "warmup_seed", "warmup_batches"}

    def __init__(self, mix, system, nodes, seed, spans):
        self.mix, self.sys, self.nodes, self.spans = mix, system, nodes, spans
        self.seed = seed
        self.batch = int(mix["batch"])
        self.kept: list[tuple] = []
        self.min_calls = int(mix.get("min_calls", 1))
        self.records: list[dict] = []
        dist = mix.get("distribution", "uniform")
        if dist != "uniform":
            raise ValueError(f"unknown query distribution {dist!r}")

    def draw(self, rng) -> np.ndarray:
        return rng.integers(0, self.nodes, self.batch, dtype=np.int64)

    def _batch(self, q, **attrs):
        with self.spans("batch", **attrs) as sid:
            t = time.perf_counter()
            ans = self.sys.query(q)
            lat = time.perf_counter() - t
        rec = self.sys.query_record()
        for r in rec["rounds"]:
            self.spans.add("round", r.get("seconds", 0.0), parent=sid,
                           lanes=r.get("lanes"), cap=r.get("cap"))
        if rec["unclean"]:
            self.spans.add("wave_decode", rec["wave_seconds"], parent=sid,
                           queries=rec["unclean"])
        return ans, lat, rec

    def warmup(self):
        rng = np.random.default_rng(int(self.mix["warmup_seed"]))
        for i in range(int(self.mix["warmup_batches"])):
            self._batch(self.draw(rng), warmup=True)

    def measure(self, seconds: float) -> dict:
        rng = np.random.default_rng(self.seed)
        t0 = time.perf_counter()
        end = t0 + seconds
        while True:
            q = self.draw(rng)
            ans, lat, rec = self._batch(q)
            self.kept.append((q, ans))
            self.records.append({
                "latency": lat, "arcs": int(len(ans[1])),
                "rounds": len(rec["rounds"]), "unclean": rec["unclean"],
                "unique": int(len(np.unique(q)))})
            if (time.perf_counter() >= end
                    and len(self.kept) >= self.min_calls):
                break
        return {"seconds": time.perf_counter() - t0,
                "count": len(self.kept)}

    def traced(self, seconds: float) -> int:
        rng = np.random.default_rng([self.seed, 1])
        i, end = 0, time.perf_counter() + seconds
        while i == 0 or time.perf_counter() < end:
            self._batch(self.draw(rng), traced=True)
            i += 1
        return i

    def path_checks(self, counts: dict, calls: int) -> dict:
        """Every batch of the window ran per-query lanes, as the cell
        names it: a batch that the full-decode plan served records no
        round."""
        return {"full_decode_batches": {
            "value": sum(r["rounds"] == 0 for r in self.records), "max": 0}}

    def check(self, ref_offsets, ref_succs) -> dict:
        """Every batch of the window against the reference's lists, in
        query order, repeats included."""
        wrong = failed = lists = 0
        ro = torch.from_numpy(ref_offsets)
        rs = torch.from_numpy(ref_succs)
        for q, (offs, vals) in self.kept:
            offs = np.asarray(offs).astype(np.int64)
            if offs.shape != (len(q) + 1,):
                w = len(q)
            else:
                w = ref_lists.count_wrong(
                    ro, rs, torch.from_numpy(q), torch.from_numpy(offs[:-1]),
                    torch.from_numpy(np.diff(offs)), 1,
                    torch.from_numpy(np.asarray(vals).astype(np.int64)))
            wrong += w
            failed += w > 0
            lists += len(q)
        return {"wrong": wrong, "answers": len(self.kept), "lists": lists,
                "failed": failed}

    def release(self):
        self.kept.clear()
