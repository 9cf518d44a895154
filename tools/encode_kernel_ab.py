"""Times the encode kernel of several checkouts, or of variants of one
checkout's kernel constants, on one card, on the main path's input: the
cnr-2000 plan at 512 encode blocks (the block store's).

    python tools/encode_kernel_ab.py [--out FILE] SPEC [SPEC ...]

SPEC is ROOT or ROOT@NAME=VALUE[,NAME=VALUE...], as in
tools/decode_kernel_ab.py: ROOT holds a webgraph_ans_torch package (a
checkout, or an archive of one), and each NAME=VALUE rewrites `constexpr
int NAME = ...;` in a copy of ROOT's csrc before it is built (e.g.
kLanesPerBlock or kDepth of csrc/encode_blocks.cu, kThreads of an older
one). Give a SPEC more than once, in turns (A B B A), to compare versions
on one card.

The plan comes from this checkout: cnr-2000 compressed on the host, its
tokens and model, encode_plan at 512 blocks. Every SPEC's encode_blocks.cu
is built at once (one nvcc each), then each SPEC runs in a process of its
own, with ROOT's wrapper and its own build. Its outputs must equal the
first SPEC's bit for bit; its times are CUDA-event medians of 20 runs
(chip_smoke.cuda_ms) of the launch alone (`encode_cuda._launch`, without
the wrapper's component check), with ns per step (ms / cap), and, where
the wrapper splits the call (`records`, `lanes`), each launch's own time
and the launch shape. Prints one JSON line per run, with the build's
-Xptxas -v report and the card as nvidia-smi names it, and writes them all
to FILE.
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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
from decode_kernel_ab import digest, parse_spec, stage_sources  # noqa: E402

BLOCKS = 512


def make_plan(path: str) -> dict:
    """The block store's encode input on cnr-2000, saved for the workers."""
    sys.path.insert(0, REPO)
    from webgraph_ans_torch.bvgraph.graph import load_bvgraph
    from webgraph_ans_torch.bvgraph.store import (compress_adjacency,
                                                  dump_tokens)
    from webgraph_ans_torch.ops.encode_torch import encode_plan
    adj, _ = load_bvgraph(os.path.join(REPO, "tests", "data", "cnr-2000",
                                       "cnr-2000"))
    res = compress_adjacency(adj, 7, 3, 2)
    vals, comps = dump_tokens(adj, 7, 3, 2, res.est_tables)
    plan = encode_plan(res.prelude.model, vals, comps, BLOCKS, device="cpu")
    torch.save({"params": plan.params, "tab": plan.tab,
                "tokens": plan.tokens, "tstart": plan.tstart,
                "tend": plan.tend, "cap": plan.cap}, path)
    return {"lanes": int(plan.tstart.shape[0]), "cap": plan.cap,
            "tokens": int(plan.tokens.shape[0]),
            "max_folds": plan.params[9]}


def worker(root: str, vdir: str, plan_path: str) -> None:
    """Times ROOT's wrapper on vdir's build; prints one JSON line."""
    sys.path.insert(0, REPO)
    sys.path.insert(0, root)
    from chip_smoke import cuda_ms
    from webgraph_ans_torch.ops import encode_cuda
    encode_cuda.SOURCE = os.path.join(vdir, "csrc", "encode_blocks.cu")
    encode_cuda.LIB_PATH = os.path.join(vdir, "libencode_blocks.so")
    P = torch.load(plan_path, weights_only=False)
    cuda = torch.device("cuda")
    params, cap = tuple(P["params"]), P["cap"]
    tab, tokens, tstart, tend = (P[k].to(cuda) for k in ("tab", "tokens",
                                                         "tstart", "tend"))
    args = (params, tab, tokens, tstart, tend, cap)
    out = {"digest": digest(encode_cuda._launch(*args))}
    t = cuda_ms(lambda: encode_cuda._launch(*args))
    out["ms"] = {"encode_blocks": t}
    out["ns_per_step"] = t["median"] * 1e6 / cap
    if hasattr(encode_cuda, "records"):
        emit = torch.empty_like(encode_cuda._launch(*args)[0])
        rec = encode_cuda.records(params, tab, tokens, emit, cap)
        out["ms"]["records"] = cuda_ms(
            lambda: encode_cuda.records(params, tab, tokens, emit, cap))
        out["ms"]["lanes"] = cuda_ms(lambda: encode_cuda.lanes(
            rec, emit, tstart, tend, cap, params[9]))
        out["geometry"] = encode_cuda.launch_geometry(
            tstart.shape[0], tokens.shape[0], cap, params[9])
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("specs", nargs="*")
    ap.add_argument("--out")
    ap.add_argument("--worker", nargs=3, metavar=("ROOT", "VDIR", "PLAN"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(*args.worker)
        return 0
    if not torch.cuda.is_available():
        print("encode_kernel_ab: CUDA is not available", file=sys.stderr)
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
    tmp = tempfile.mkdtemp(prefix="ab_")
    try:
        distinct = list(dict.fromkeys(args.specs))
        vdirs = {}
        for i, spec in enumerate(distinct):
            vdirs[spec] = os.path.join(tmp, f"v{i}")
            stage_sources(*parse_spec(spec), vdirs[spec])
        built = cuda_build.build_many(
            [(os.path.join(vdirs[s], "csrc", "encode_blocks.cu"),
              os.path.join(vdirs[s], "libencode_blocks.so"))
             for s in distinct], force=True)
        for spec, info in zip(distinct, built):
            emit({"spec": spec, "ptxas": ptxas_report(info["log"])})
        plan_path = os.path.join(tmp, "plan.pt")
        emit({"plan": make_plan(plan_path)})
        first = None
        for spec in args.specs:
            root, _ = parse_spec(spec)
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker", root,
                 vdirs[spec], plan_path], capture_output=True, text=True)
            if res.returncode != 0:
                raise SystemExit(f"{spec} failed:\n{res.stderr[-4000:]}")
            run = json.loads(res.stdout.strip().splitlines()[-1])
            first = first or run["digest"]
            run["bit_equal_to_first"] = run["digest"] == first
            emit({"spec": spec, **run})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as f:
                f.writelines(json.dumps(x) + "\n" for x in lines)
    if not all(x.get("bit_equal_to_first", True) for x in lines):
        print("encode_kernel_ab: the specs' outputs differ", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
