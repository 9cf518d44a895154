"""The benchmark of webgraph_ans_torch on NVIDIA GPUs: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. Prints, as the last line of standard
output, one JSON object (`correct`, `attempted`, `failed`, `metrics`,
`device`; traced: `breakdown`; `checks` last) and, as the last lines of
standard error, each number compared beside its limit. Exits with 2,
printing no result, without CUDA or with fewer cards than the cell asks
for, and with 3 when the process loaded JAX or the JAX package.
"""

import os
import time

T0 = time.perf_counter()

# One process with one host thread for the math libraries: host-paced
# calls then vary less with the neighbours on the machine's cores.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    cell = harness.find(harness.load_spec()["workloads"], args.workload,
                        "workload")
    if not torch.cuda.is_available():
        print("bench: CUDA is not available", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"bench: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    try:
        result = harness.run(args.workload, args.seed, args.seconds,
                             bool(args.trace), t0=T0)
    except harness.ForbiddenModules as e:
        print(f"bench: the process loaded {e}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    harness.print_checks(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
