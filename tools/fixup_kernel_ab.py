"""Times the dirty-chain fixup kernel (csrc/emit_fixup.cu) of several
checkouts, or of variants of one checkout's kernel constants, on one card,
on the verified merged-emit layouts of cnr-2000 at three store settings:
window 7 (2048 lanes), the high-compression store with safe breaks every
128 nodes and the one without (both at 1024 lanes).

    python tools/fixup_kernel_ab.py [--out FILE] SPEC [SPEC ...]

SPEC is ROOT or ROOT@NAME=VALUE[,NAME=VALUE...], as for
tools/decode_kernel_ab.py: ROOT holds a webgraph_ans_torch package (a
checkout, or an archive of one), and each NAME=VALUE rewrites `constexpr
int NAME = ...;` in a copy of its csrc. Give a SPEC more than once, in
turns (A B B A), to compare versions on one card.

This checkout stores the three artifacts once. Every SPEC's fixup kernel
is built at once (one nvcc each), then each SPEC runs in a process of its
own with ROOT's package: it plans each artifact into its verified steady
state (ROOT's planner and node layout), decodes its val channel once in
mark_deg mode, and times the fixup on fresh copies of it (CUDA events,
median of 20: chip_smoke.cuda_ms), with the time per level of the dirty
chains. Each result is held bit for bit against emit_fixup_plain on host
copies, and must equal the first SPEC's. Prints one JSON line per run,
with the build's -Xptxas -v report and the card as nvidia-smi names it,
and writes them all to FILE.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from decode_kernel_ab import digest, parse_spec, stage_sources  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# name: (store arguments after the input and output, lanes)
LAYOUTS = {"w7": ((), 2048),
           "hc": ((16, 2_000_000_000, 4), 1024),
           "hcref": ((16, 2_000_000_000, 4), 1024)}
SAFE_BREAKS = {"hc": 128}


def make_artifacts(tmp: str) -> dict:
    """The three stores of cnr-2000, under tmp; their base paths."""
    sys.path.insert(0, REPO)
    from webgraph_ans_torch import store
    cnr = os.path.join(REPO, "tests", "data", "cnr-2000", "cnr-2000")
    bases = {}
    for name, (args, _) in LAYOUTS.items():
        bases[name] = os.path.join(tmp, name)
        kw = ({"safe_break_interval": SAFE_BREAKS[name]}
              if name in SAFE_BREAKS else {})
        store(cnr, bases[name], *args, **kw)
    return bases


def worker(root: str, vdir: str, bases_json: str) -> None:
    """Times ROOT's fixup on vdir's build; prints one JSON line."""
    sys.path.insert(0, REPO)
    sys.path.insert(0, root)
    from chip_smoke import cuda_ms, emit_args
    from webgraph_ans_torch import ANSBvGraph, TorchGraphDecoder
    from webgraph_ans_torch.ops import emit_cuda, fixup_cuda
    fixup_cuda.SOURCE = os.path.join(vdir, "csrc", "emit_fixup.cu")
    fixup_cuda.LIB_PATH = os.path.join(vdir, "libemit_fixup.so")
    bases = json.loads(bases_json)
    out = {"digests": {}, "layouts": {}}
    for name, (_, lanes) in LAYOUTS.items():
        dec = TorchGraphDecoder(ANSBvGraph.load(bases[name]))
        for _ in range(8):
            dec.decode_to_adjacency_device(lanes)
            if dec.emit_steady(lanes):
                break
        else:
            raise SystemExit(f"{name}: the merged-emit plan never verified")
        pl = dec._plans[("emit", lanes)]
        mc = pl["post_meta"]
        nodes, srcs = mc["fx_nodes"], mc["fx_srcs"]
        val = emit_cuda.decode_emit(*emit_args(dec, pl, pl["cap"]),
                                    T=pl["T"], mark_deg=True)[0]
        got = fixup_cuda.emit_fixup(val.clone(), nodes, srcs)
        plain = fixup_cuda.emit_fixup_plain(val.cpu(), nodes.cpu(),
                                            srcs.cpu())
        copies = iter([val.clone() for _ in range(23)])
        ms = cuda_ms(lambda: fixup_cuda.emit_fixup(next(copies), nodes,
                                                   srcs))
        out["digests"][name] = digest([got])
        out["layouts"][name] = {
            "ms": ms, "us_per_level": ms["median"] * 1e3 / mc["rounds"],
            "rounds": mc["rounds"], "dirty_nodes": nodes.shape[0],
            "elements": srcs.shape[0], "columns": nodes.shape[1],
            "two_run_rows": mc.get("two_run_rows"),
            "plain_bit_equal": bool(torch.equal(got.cpu(), plain))}
        del dec, pl, mc, val, got, plain
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("specs", nargs="*")
    ap.add_argument("--out")
    ap.add_argument("--worker", nargs=3, metavar=("ROOT", "VDIR", "BASES"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(*args.worker)
        return 0
    if not torch.cuda.is_available():
        print("fixup_kernel_ab: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from chip_smoke import nvidia_smi_line, ptxas_report
    from webgraph_ans_torch.ops import cuda_build
    lines = []

    def emit(obj):
        print(json.dumps(obj), flush=True)
        lines.append(obj)

    emit({"device": torch.cuda.get_device_name(0),
          "nvidia_smi": nvidia_smi_line()})
    tmp = tempfile.mkdtemp(prefix="fixup_ab_")
    try:
        distinct = list(dict.fromkeys(args.specs))
        vdirs = {}
        for i, spec in enumerate(distinct):
            vdirs[spec] = os.path.join(tmp, f"v{i}")
            stage_sources(*parse_spec(spec), vdirs[spec])
        built = cuda_build.build_many(
            [(os.path.join(vdirs[s], "csrc", "emit_fixup.cu"),
              os.path.join(vdirs[s], "libemit_fixup.so")) for s in distinct],
            force=True)
        for spec, b in zip(distinct, built):
            emit({"spec": spec, "ptxas": ptxas_report(b["log"])})
        bases = json.dumps(make_artifacts(tmp))
        first = None
        for spec in args.specs:
            root, _ = parse_spec(spec)
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker", root,
                 vdirs[spec], bases], capture_output=True, text=True)
            if res.returncode != 0:
                raise SystemExit(f"{spec} failed:\n{res.stderr[-4000:]}")
            run = json.loads(res.stdout.strip().splitlines()[-1])
            first = first or run["digests"]
            run["bit_equal_to_first"] = run["digests"] == first
            emit({"spec": spec, **run})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as f:
                f.writelines(json.dumps(x) + "\n" for x in lines)
    held = all(x.get("bit_equal_to_first", True)
               and all(v["plain_bit_equal"]
                       for v in x.get("layouts", {}).values())
               for x in lines)
    if not held:
        print("fixup_kernel_ab: an output differs", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
