"""Times the decode kernels of several checkouts, or of variants of one
checkout's kernel constants, on one card, at the main path's shapes on
cnr-2000: decode_blocks in token mode (4096 lanes) and in aux mode (2048
lanes), and decode_emit in mark_deg mode on the verified 2048-lane plan.

    python tools/decode_kernel_ab.py [--out FILE] SPEC [SPEC ...]

SPEC is ROOT or ROOT@NAME=VALUE[,NAME=VALUE...]. ROOT is a directory that
holds a webgraph_ans_torch package (a checkout, or an archive of one).
Each NAME=VALUE rewrites `constexpr int NAME = ...;` in a copy of ROOT's
csrc before it is built, to sweep a compile-time constant such as
decode_emit.cu's kLanesPerBlock. Give a SPEC more than once, in turns
(A B B A), to compare versions on one card.

The plans come from this checkout: the store of cnr-2000, the token plan
at 4096 lanes, the aux decode at 2048 lanes and the merged-emit plan at
2048 lanes, driven until it is verified. Every SPEC's kernels are built
at once (one nvcc per source), then each SPEC runs in a process of its
own, with ROOT's wrappers and its own build, on those plans. Its outputs
(decode_emit's first six channels) must equal the first SPEC's bit for
bit; its times are CUDA-event medians of 20 runs (chip_smoke.cuda_ms).
Prints one JSON line per run, with the build's -Xptxas -v report and the
card as nvidia-smi names it, and writes them all to FILE.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("decode_blocks", "decode_emit")
TOKEN_LANES, EMIT_LANES = 4096, 2048


def parse_spec(spec: str):
    root, _, rest = spec.partition("@")
    consts = dict(kv.split("=", 1) for kv in rest.split(",")) if rest else {}
    return os.path.abspath(root), consts


def stage_sources(root: str, consts: dict, vdir: str) -> None:
    """ROOT's csrc copied into vdir/csrc, with each constant rewritten."""
    src = os.path.join(root, "webgraph_ans_torch", "csrc")
    dst = os.path.join(vdir, "csrc")
    shutil.copytree(src, dst)
    hits = dict.fromkeys(consts, 0)
    for name in os.listdir(dst):
        path = os.path.join(dst, name)
        text = open(path).read()
        for key, value in consts.items():
            text, n = re.subn(rf"(constexpr int {key} = )[^;]+;",
                              rf"\g<1>{value};", text)
            hits[key] += n
        open(path, "w").write(text)
    missing = [k for k, n in hits.items() if n == 0]
    if missing:
        raise SystemExit(f"{root}: no constant named {missing} in csrc")


def make_plans(path: str) -> dict:
    """The main path's kernel inputs on cnr-2000, saved for the workers."""
    sys.path.insert(0, REPO)
    from webgraph_ans_torch import ANSBvGraph, TorchGraphDecoder, store
    cnr = os.path.join(REPO, "tests", "data", "cnr-2000", "cnr-2000")
    base = os.path.join(os.path.dirname(path), "cnr")
    store(cnr, base)
    g = ANSBvGraph.load(base)
    dec = TorchGraphDecoder(g)
    pl = dec.plan(TOKEN_LANES)
    _, _, cap = dec.decode_raw(TOKEN_LANES)
    apl = dec.plan(EMIT_LANES)
    _, _, acap = dec.decode_raw(EMIT_LANES, emit_aux=True)
    edec = TorchGraphDecoder(g)
    for _ in range(6):
        edec.decode_to_adjacency_device(EMIT_LANES)
        epl = edec._plans[("emit", EMIT_LANES)]
        if edec.emit_steady(EMIT_LANES):
            break
    else:
        raise SystemExit("the merged-emit plan never verified")

    def lanes(p, c):
        return {k: p[k].cpu() for k in ("states", "ptrs", "starts", "ends",
                                        "ring")} | {"cap": c}

    plans = {"lut": dec.tables.lut.cpu(), "stream": dec.tables.stream.cpu(),
             "params": dec.tables.params, "window": dec.window,
             "min_interval": dec.min_interval, "token": lanes(pl, cap),
             "aux": lanes(apl, acap),
             "emit": {"regs": epl["regs"].cpu(), "ptrs": epl["ptrs"].cpu(),
                      "cap": epl["cap"], "T": epl["T"]}}
    torch.save(plans, path)
    return {"token_cap": cap, "aux_cap": acap, "emit_cap": epl["cap"],
            "T": epl["T"]}


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def worker(root: str, vdir: str, plan_path: str) -> None:
    """Times ROOT's wrappers on vdir's build; prints one JSON line."""
    sys.path.insert(0, REPO)
    sys.path.insert(0, root)
    from chip_smoke import cuda_ms
    from webgraph_ans_torch.ops import decode_cuda, emit_cuda
    from webgraph_ans_torch.ops.decode_torch import DecoderTables
    for mod, name in ((decode_cuda, "decode_blocks"),
                      (emit_cuda, "decode_emit")):
        mod.SOURCE = os.path.join(vdir, "csrc", f"{name}.cu")
        mod.LIB_PATH = os.path.join(vdir, f"lib{name}.so")
    P = torch.load(plan_path, weights_only=False)
    cuda = torch.device("cuda")
    tables = DecoderTables(lut=P["lut"].to(cuda), stream=P["stream"].to(cuda),
                           params=tuple(P["params"]))
    W, mi = P["window"], P["min_interval"]

    def lane_args(p):
        return (tables, *(p[k].to(cuda) for k in ("states", "ptrs", "starts",
                                                  "ends", "ring")),
                W, mi, p["cap"])

    targs, aargs = lane_args(P["token"]), lane_args(P["aux"])
    e = P["emit"]
    eargs = (tables, e["regs"].to(cuda), e["ptrs"].to(cuda), W, mi, e["cap"])
    runs = {
        "decode_blocks": lambda: decode_cuda.decode_blocks(*targs),
        "decode_blocks_aux": lambda: decode_cuda.decode_blocks(
            *aargs, emit_aux=True),
        "decode_emit": lambda: emit_cuda.decode_emit(*eargs, T=e["T"],
                                                     mark_deg=True),
    }
    # the first six channels: the seventh, decode_emit's folded rows, is
    # missing where a checkout's kernel does not count them
    out = {"digests": {k: digest(fn()[:6]) for k, fn in runs.items()},
           "ms": {k: cuda_ms(fn) for k, fn in runs.items()}}
    if hasattr(emit_cuda, "launch_geometry"):
        out["emit_geometry"] = emit_cuda.launch_geometry(W, e["T"])
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("specs", nargs="*")
    ap.add_argument("--out")
    ap.add_argument("--worker", nargs=3, metavar=("ROOT", "VDIR", "PLANS"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(*args.worker)
        return 0
    if not torch.cuda.is_available():
        print("decode_kernel_ab: CUDA is not available", file=sys.stderr)
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
        vdirs, pairs = {}, []
        for i, spec in enumerate(distinct):
            vdirs[spec] = os.path.join(tmp, f"v{i}")
            stage_sources(*parse_spec(spec), vdirs[spec])
            pairs += [(os.path.join(vdirs[spec], "csrc", f"{k}.cu"),
                       os.path.join(vdirs[spec], f"lib{k}.so"))
                      for k in KERNELS]
        built = cuda_build.build_many(pairs, force=True)
        for i, spec in enumerate(distinct):
            emit({"spec": spec, "ptxas": {
                k: ptxas_report(built[2 * i + j]["log"])
                for j, k in enumerate(KERNELS)}})
        plan_path = os.path.join(tmp, "plans.pt")
        emit({"plans": make_plans(plan_path)})
        first = None
        for spec in args.specs:
            root, _ = parse_spec(spec)
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker", root,
                 vdirs[spec], plan_path], capture_output=True, text=True)
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
    if not all(x.get("bit_equal_to_first", True) for x in lines):
        print("decode_kernel_ab: the specs' outputs differ", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
