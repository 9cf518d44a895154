"""bvcomp-torch CLI: recompress a BVGraph into .ans/.pointers/.states
(reference: src/bin/bvcomp.rs:10-42 and the webgraph CompressArgs flag
schema it flattens — window -w, max ref count -c, min interval length -l).

Also exposes decode/bench subcommands the reference keeps in examples/
(bench_random_access.rs, bench_seq_access.rs). The subcommands and flags
are those of the JAX package's `bvcomp`; the device stages
(--encode-blocks N > 1, --tpu-model-search, bench-seq --gpu) run on CUDA
unless --device names another device.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time


def _add_compress_args(p):
    p.add_argument("basename", help="input BVGraph basename (.graph/.properties)")
    p.add_argument("new_basename", help="output basename for .ans/.pointers/.states")
    p.add_argument("-w", "--compression-window", type=int, default=7,
                   help="reference search window (default 7)")
    p.add_argument("-c", "--max-ref-count", type=int, default=3,
                   help="maximum length of reference chains (default 3)")
    p.add_argument("-l", "--min-interval-length", type=int, default=4,
                   help="minimum interval length (default 4; 0 disables intervals)")
    p.add_argument("--tpu-model-search", action="store_true",
                   help="run the (fidelity, radix) model grid search on the "
                        "device")
    p.add_argument("--max-frame-log2", type=int, default=12,
                   help="cap ANS frame sizes at 2^k (16 = reference-exact; "
                        "smaller = faster device decode, usually smaller "
                        "files)")
    p.add_argument("--encode-blocks", type=int, default=1,
                   help="lane-parallel rANS encode with this many "
                        "independent blocks on the device (1 = serial)")
    p.add_argument("--phase-step", type=int, default=1,
                   help="store phases for every k-th node only: .states/"
                        ".pointers shrink ~k x, random access decodes up "
                        "to k-1 extra lists per query")
    p.add_argument("--spill-path", default=None,
                   help="run pass 3 out-of-core: spill the token buffer "
                        "to this file in varint chunks (RAM stays "
                        "O(--spill-chunk-tokens); serial encoder only)")
    p.add_argument("--spill-chunk-tokens", type=int, default=1 << 22,
                   help="tokens per in-RAM spill chunk (default 4M)")
    p.add_argument("--safe-break", type=int, default=0, metavar="K",
                   help="forbid references reaching past every K-th "
                        "node (+ element-aware early breaks in dense "
                        "regions): bounds copy chains so hc artifacts "
                        "stay lane-splittable for the parallel decoder "
                        "(~+1-2%% size; this framework's format "
                        "extension, default off)")
    p.add_argument("--streaming", action="store_true",
                   help="never materialize the input adjacency: every "
                        "pass re-walks the mmap'd .graph through BvComp "
                        "(RAM O(window + histograms + phases); combine "
                        "with --spill-path for O(window + chunk) pass 3)")
    _add_device_arg(p)


def _add_device_arg(p):
    p.add_argument("--device", default=None,
                   help="device of the device stages (default cuda; cpu "
                        "runs their plain PyTorch versions)")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="bvcomp-torch", description=__doc__)
    sub = parser.add_subparsers(dest="cmd")

    pc = sub.add_parser("compress", help="recompress a BVGraph with ANS")
    _add_compress_args(pc)

    pb = sub.add_parser("bench-random", help="random-access decode benchmark")
    pb.add_argument("basename", help="ANS basename (.ans/.pointers/.states)")
    pb.add_argument("-n", "--queries", type=int, default=10_000_000)
    pb.add_argument("-s", "--seed", type=int, default=0)

    ps = sub.add_parser("bench-seq", help="sequential decode benchmark")
    ps.add_argument("basename", help="ANS basename (.ans)")
    ps.add_argument("--gpu", "--tpu", dest="gpu", action="store_true",
                    help="use the device decode path (token decode + "
                         "reconstruction)")
    ps.add_argument("--lanes", type=int, default=512)
    _add_device_arg(ps)

    # default subcommand = compress (positional style of the reference CLI)
    args_list = list(sys.argv[1:] if argv is None else argv)
    if args_list and args_list[0] not in ("compress", "bench-random", "bench-seq",
                                          "-h", "--help"):
        args_list.insert(0, "compress")
    args = parser.parse_args(args_list)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(levelname)s %(message)s")

    if args.cmd == "compress":
        from .bvgraph.store import store

        t0 = time.time()
        res = store(args.basename, args.new_basename,
                    args.compression_window, args.max_ref_count,
                    args.min_interval_length,
                    use_tpu_model_search=args.tpu_model_search,
                    max_frame_log2=args.max_frame_log2,
                    encode_blocks=args.encode_blocks,
                    phase_step=args.phase_step,
                    spill_path=args.spill_path,
                    spill_chunk_tokens=args.spill_chunk_tokens,
                    streaming=args.streaming,
                    safe_break_interval=args.safe_break,
                    device=args.device)
        print(json.dumps({
            "seconds": round(time.time() - t0, 3),
            "stage_seconds": {k: round(v, 3) for k, v in res.seconds.items()},
            "nodes": res.prelude.num_nodes,
            "arcs": res.prelude.num_arcs,
            "stream_u16": len(res.prelude.stream),
            "per_component": res.report,
        }, indent=2))
        return 0

    if args.cmd == "bench-random":
        from .bvgraph.random_access import ANSBvGraph

        g = ANSBvGraph.load(args.basename)
        t0 = time.time()
        arcs = g.bench_random(args.queries, args.seed)
        dt = time.time() - t0
        print(json.dumps({"queries": args.queries, "arcs": arcs,
                          "seconds": round(dt, 3),
                          "ns_per_arc": round(dt / max(arcs, 1) * 1e9, 2)}))
        return 0

    if args.cmd == "bench-seq":
        from .bvgraph.random_access import ANSBvGraph
        from .bvgraph.sequential import ANSBvGraphSeq

        if args.gpu:
            from .ops.graph_decode import TorchGraphDecoder
            from .ops.reconstruct_torch import reconstruct

            g = ANSBvGraph.load(args.basename)
            dec = TorchGraphDecoder(g, device=args.device)
            dec.decode_tokens(num_lanes=args.lanes)  # warmup: builds, caps
            t0 = time.time()
            vals, comps = dec.decode_tokens(num_lanes=args.lanes)
            _, succs = reconstruct(vals, comps, g.num_nodes,
                                   g.prelude.min_interval_length,
                                   device=dec.device)
            dt = time.time() - t0
            arcs = len(succs)
        else:
            g = ANSBvGraphSeq.load(args.basename)
            t0 = time.time()
            adj = g.decode_all()
            dt = time.time() - t0
            arcs = adj.num_arcs
        print(json.dumps({"arcs": arcs, "seconds": round(dt, 3),
                          "ns_per_arc": round(dt / max(arcs, 1) * 1e9, 2)}))
        return 0

    parser.print_help()
    return 1


if __name__ == "__main__":
    sys.exit(main())
