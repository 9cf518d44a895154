"""The control of the comparison that decides `correct`: the plain side's
own lists put in the program's place, one bit of precision below what
the configuration guarantees (lossless lists: every node id exact). Each
successor loses its lowest bit, the nearest lossy step from exact ids.
The control has to come out as not correct.

    python3 benchmark/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...]

runs the cell's traffic and comparison through the control, on the card
and at the cell's own size, once a seed in one process, and prints each
run's numbers compared, one JSON line a seed. The benchmark's own runs
never run it.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness, system  # noqa: E402
from benchmark.reference import lists as ref_lists  # noqa: E402


class ControlSystem:
    """Answers from the reference's lists with each id's lowest bit
    cleared: the full decode in the port's one-lane layout
    (succs2d [arcs, 1], starts_flat = offsets[:-1], degs), a query batch
    as (offsets, succs) on the host."""

    def __init__(self, cfg: dict, base: str, device: str = "cuda"):
        offsets, succs = system.reference_lists(
            cfg, system.Cache(os.path.dirname(base)))
        self.offsets = offsets
        self.succs = succs & ~np.int32(1)
        self.device = torch.device(device)
        self._flat = torch.from_numpy(self.succs).to(self.device)
        self._starts = torch.from_numpy(offsets[:-1].astype(np.int32)).to(
            self.device)
        self._degs = torch.from_numpy(np.diff(offsets).astype(np.int32)).to(
            self.device)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def decode(self):
        return (self._flat.clone().reshape(-1, 1), self._starts,
                self._degs.clone())

    def query(self, q):
        return ref_lists.lists_of(self.offsets, self.succs, q)

    @staticmethod
    def query_record() -> dict:
        return {"rounds": [], "unclean": 0, "wave_seconds": 0.0}

    @staticmethod
    def counters() -> dict:
        return {}

    def close(self):
        self._flat = self._starts = self._degs = None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        res = harness.run(args.workload, seed, args.seconds, False,
                          t0=time.perf_counter(), device=args.device,
                          make_system=ControlSystem)
        print(json.dumps({"control": args.workload, "seed": seed,
                          "correct": res["correct"],
                          "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
