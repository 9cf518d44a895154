"""Self-contained entry points on tiny shapes, with no graph fixture and no
C++ build: the compressed input is synthesized by the pure-Python encoder
(ans/pyencoder.py).

entry()               -> (fn, example_args): one token-decode step of the
                         lane-parallel rANS decoder (decode_blocks) over a
                         real compressed stream, on one device.
dryrun_multichip(n)   -> one full sharded step over n device entries: the
                         ring seeds and the token decode with the lanes
                         split over the devices (tables and stream copied
                         to each), the model histogram split the same way
                         and summed, checked against the graph's
                         outdegrees, and the merged-emit decode with its
                         lanes split, checked list by list.

Both run on CUDA unless given device="cpu" (the kernels' plain versions).
On one card dryrun_multichip(n) runs its n shards on that card.
"""

from __future__ import annotations

import numpy as np
import torch

WINDOW, MIN_INTERVAL = 7, 2


def _tiny_graph(num_nodes: int = 64, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    lists = []
    for _ in range(num_nodes):
        d = int(rng.integers(0, 6))
        lists.append(sorted(rng.choice(num_nodes, size=d,
                                       replace=False).tolist()) if d else [])
    return lists


def _encoded(num_nodes: int):
    """(lists, model, stream, states, pointers, final state, decode LUT,
    codec parameters) of a tiny no-reference graph."""
    from .ans.pyencoder import encode_graph_py
    from .ops.decode_torch import build_decoder_tables_np

    lists = _tiny_graph(num_nodes)
    model, stream, states, pointers, final = encode_graph_py(
        lists, WINDOW, MIN_INTERVAL)
    return (lists, model, stream, states, pointers, final,
            *build_decoder_tables_np(model))


def _lane_bounds(n: int, lanes: int):
    starts = (np.arange(lanes) * n) // lanes
    ends = (np.arange(1, lanes + 1) * n) // lanes
    return starts, ends


def entry(device=None):
    """(fn, example_args): fn(*example_args) runs decode_blocks on 8 lanes
    of a 64-node graph and returns (out, counts)."""
    from .ops.decode_cuda import decode_blocks
    from .ops.decode_torch import (resolve_device, round_cap,
                                   tables_from_numpy)

    dev = resolve_device(device)
    lists, _, stream, states, pointers, _, lut, params = _encoded(64)
    tables = tables_from_numpy(lut, stream, params, dev)
    n, lanes, W = len(lists), 8, WINDOW
    starts, ends = _lane_bounds(n, lanes)
    ring = np.zeros((lanes, W + 1), np.int32)
    for lane in range(lanes):
        for node in range(max(0, starts[lane] - W), starts[lane]):
            ring[lane, node % (W + 1)] = len(lists[node])
    cap = round_cap(params, 64)

    def fn(states_a, ptrs_a, starts_a, ends_a, ring_a):
        out, counts, _ = decode_blocks(tables, states_a, ptrs_a,
                                       starts_a, ends_a, ring_a, W,
                                       MIN_INTERVAL, cap)
        return out, counts

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a).astype(dtype)).to(dev)

    example_args = (t(states[starts], np.int64), t(pointers[starts], np.int64),
                    t(starts, np.int32), t(ends, np.int32), t(ring, np.int32))
    return fn, example_args


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One sharded decode, histogram and merged-emit step over n_devices
    device entries (all on `device` when one is named; without one, the
    CUDA devices, or n_devices shards on cuda:0 when fewer cards exist).
    Raises when a step's result is wrong; returns its counts."""
    from .ans.prelude import Prelude
    from .bvgraph.random_access import ANSBvGraph
    from .ops.decode_torch import (fetch_block_tokens, round_cap,
                                   tables_from_numpy)
    from .ops.graph_decode import TorchGraphDecoder
    from .parallel.sharded import (make_devices, replicate_tables,
                                   sharded_decode_blocks,
                                   sharded_emit_adjacency, sharded_histogram,
                                   sharded_seed_rings)

    if device is None and torch.cuda.is_available() \
            and torch.cuda.device_count() < n_devices:
        device = "cuda:0"
    devices = make_devices(n_devices, device)
    d0 = devices[0]
    (lists, model, stream, states, pointers, final, lut,
     params) = _encoded(16 * n_devices)
    tables = replicate_tables(tables_from_numpy(lut, stream, params, d0),
                              devices)
    n, W = len(lists), WINDOW
    starts, ends = _lane_bounds(n, 2 * n_devices)

    def t(a, dtype=np.int64):
        return torch.from_numpy(np.ascontiguousarray(a).astype(dtype)).to(d0)

    # ring seeds: the window of outdegrees before each block, the lanes
    # split over the devices
    pre = np.clip(starts[:, None] - W + np.arange(W)[None, :], 0, n - 1)
    ring = sharded_seed_rings(devices, tables, t(states[pre]),
                              t(pointers[pre]), t(starts, np.int32), W)

    # the sharded token decode: the grammar FSM over data-parallel lanes
    cap = round_cap(params, 96)
    out, counts, ok = sharded_decode_blocks(
        devices, tables, t(states[starts]), t(pointers[starts]),
        t(starts, np.int32), t(ends, np.int32), ring, W, MIN_INTERVAL, cap)
    if not bool(ok.all()):
        raise RuntimeError("dry-run decode overflowed its cap")

    # the model's histogram, its stream split over the devices, summed
    fv, fc = fetch_block_tokens(out, counts, cap)
    hist = sharded_histogram(devices, torch.from_numpy(fv.astype(np.int64)),
                             torch.from_numpy(fc.astype(np.int64)), 64)
    arcs = sum(map(len, lists))
    got_arcs = int(hist[0].cpu() @ torch.arange(64))
    if got_arcs != arcs or len(fv) < n:
        raise RuntimeError(f"dry-run histogram: outdegrees sum to "
                           f"{got_arcs}, the graph has {arcs} arcs")

    # the merged-emit path with its lanes split over the same devices,
    # its channels gathered into the single-device layout and post-passed
    prelude = Prelude(model=model, stream=np.asarray(stream, np.uint16),
                      state=int(final), num_nodes=n, num_arcs=arcs,
                      compression_window=W, min_interval_length=MIN_INTERVAL)
    g = ANSBvGraph(prelude, np.asarray(states, np.uint32)[::-1],
                   np.asarray(pointers, np.uint64)[::-1])
    dec = TorchGraphDecoder(g, device=d0)
    s2d, st, dg = sharded_emit_adjacency(devices, dec,
                                         num_lanes=2 * n_devices)
    F = s2d.reshape(-1).cpu().numpy()
    G = s2d.shape[1]
    st = st.cpu().numpy().astype(np.int64)
    dg = dg.cpu().numpy().astype(np.int64)
    for x, want in enumerate(lists):
        got = F[st[x] + np.arange(dg[x]) * G].astype(np.int64).tolist()
        if got != list(want):
            raise RuntimeError(f"dry-run sharded emit: node {x} decodes to "
                               f"{got}, not {want}")
    return {"devices": [str(d) for d in devices], "nodes": n, "arcs": arcs,
            "tokens": int(counts.sum()), "lanes": len(starts),
            "emit_lanes": G}
