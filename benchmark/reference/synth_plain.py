"""A synthetic web graph with the locality features of a crawl, frozen
here so that the graph a configuration names cannot change with the
program: a copy of the port's `synth_web_graph` that returns plain
arrays. No cell runs it: it makes the small graphs of the benchmark's
own CPU tests, which drive the whole harness; a cell's configuration
names a published graph.

Everything is vectorized numpy off a seeded Generator, so (n, seed)
gives the same graph under one numpy version. numpy's samplers have
changed between versions: at (4_000_000, seed=7) numpy 2.3.5 draws
57,985,434 arcs and numpy 2.0.2 57,966,608.

Structure: power-law outdegrees (Zipf); locality (most arcs point near
their source); similarity (nodes in blocks of 8 share a pool of
targets, which drives references and copy blocks); runs of consecutive
targets (intervals); a Zipf-distributed count of private residuals.
"""

from __future__ import annotations

import numpy as np


def synth_web_graph(num_nodes: int, seed: int = 0, block: int = 8,
                    pool_size: int = 18, take_prob: float = 0.55,
                    run_prob: float = 0.35, run_len: int = 6,
                    private: int = 1):
    """(offsets int64 [n + 1], succs int32 [arcs]) of a web-like graph
    with ~num_nodes * (pool_size * take_prob + run_prob * run_len +
    private) arcs (duplicates removed).

    Structure: nodes come in `block`-sized groups sharing a target pool
    (each node samples a subset -> copy blocks + window references),
    plus a run of consecutive targets (-> intervals) and a few global
    Zipf-gap targets (-> residuals)."""
    n = int(num_nodes)
    rng = np.random.default_rng(seed)
    nblocks = -(-n // block)

    # Shared per-block pools: ascending targets anchored near the block,
    # gaps Zipf-distributed (power-law residual gaps when not copied).
    gaps = rng.zipf(1.25, size=(nblocks, pool_size)).astype(np.int64)
    np.clip(gaps, 1, n // 4, out=gaps)
    anchors = (np.arange(nblocks, dtype=np.int64) * block)[:, None]
    pools = anchors - (block * 4) + np.cumsum(gaps, axis=1)
    np.clip(pools, 0, n - 1, out=pools)

    # Each node takes a random subset of its block's pool.
    take = rng.random((n, pool_size)) < take_prob
    pool_per_node = np.broadcast_to(
        pools.repeat(block, axis=0)[:n], (n, pool_size))
    src_pool = np.repeat(np.arange(n, dtype=np.int64), take.sum(axis=1))
    tgt_pool = pool_per_node[take]

    # Interval runs: consecutive targets starting just past the node.
    has_run = rng.random(n) < run_prob
    lens = rng.integers(4, run_len + 4, size=n)
    lens = np.where(has_run, lens, 0)
    run_start = (np.arange(n, dtype=np.int64) + 1 +
                 rng.integers(0, 16, size=n)) % n
    src_run = np.repeat(np.arange(n, dtype=np.int64), lens)
    offs = np.concatenate([np.zeros(1, np.int64), np.cumsum(lens)])
    t = np.arange(offs[-1], dtype=np.int64) - offs[:-1].repeat(lens)
    tgt_run = np.minimum(run_start.repeat(lens) + t, n - 1)

    # Private residuals: signed Zipf gaps around the source, with a
    # Zipf-distributed per-node count so outdegrees are heavy-tailed.
    npriv = np.minimum(rng.zipf(2.0, size=n) * private, 400)
    src_priv = np.repeat(np.arange(n, dtype=np.int64), npriv)
    k = len(src_priv)
    pg = rng.zipf(1.35, size=k).astype(np.int64)
    sign = np.where(rng.random(k) < 0.5, -1, 1)
    tgt_priv = (src_priv + sign * pg) % n

    src = np.concatenate([src_pool, src_run, src_priv])
    tgt = np.concatenate([tgt_pool, tgt_run, tgt_priv])

    # (src, tgt) packed into one sortable i64 key: one radix-ish sort +
    # unique beats a 2-key lexsort ~4x at the 50M-arc scale. The unique is
    # a mask of adjacent duplicates, not np.unique, which is two orders
    # of magnitude slower on 67M keys under numpy 2.3.5.
    key = np.sort(src * n + tgt)
    keep = np.ones(len(key), bool)
    keep[1:] = key[1:] != key[:-1]
    key = key[keep]
    src = key // n
    tgt = key % n

    deg = np.bincount(src, minlength=n)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=offsets[1:])
    return offsets, tgt.astype(np.int32)
