"""The port's merged-emit pipeline, TorchGraphDecoder.
decode_to_adjacency_device, on the CPU (plain versions of the kernels):
its planner against the JAX package's on the same artifacts, its native
lane split against the planner's scalar loop, its int32 layout guard, and
the whole path against the input graph, through the verified steady state.

Artifacts are written by the JAX package and read by both packages'
loaders. The JAX planner runs as its own
CPU tests run it (XLA token decode, WGT_PALLAS=0). Everything is integer
and compared exactly (tolerance 0).
"""

import dataclasses
import logging
import re

import numpy as np
import pytest
import torch

from webgraph_ans_tpu.ans.prelude import save_pointers, save_states
from webgraph_ans_tpu.bvgraph.graph import Adjacency
from webgraph_ans_tpu.bvgraph.random_access import ANSBvGraph as JaxGraph
from webgraph_ans_tpu.bvgraph.store import compress_adjacency
from webgraph_ans_tpu.bvgraph.synth import synth_web_graph
from webgraph_ans_tpu.ops.graph_decode import TpuGraphDecoder
from webgraph_ans_torch.bvgraph.random_access import ANSBvGraph as TorchGraph
from webgraph_ans_torch.ops import (emit_cuda, emit_post, emit_torch,
                                    graph_decode, reconstruct_device)
from webgraph_ans_torch.ops.cuda_build import KernelError
from webgraph_ans_torch.ops.graph_decode import TorchGraphDecoder
from webgraph_ans_torch.utils import trace
import jax_native_build

# the JAX package's native library, built once before any test loads it
jax_native_build.ensure()

LANES = 8


def _rand_lists(n, seed, dmax):
    rng = np.random.default_rng(seed)
    return [sorted(rng.choice(n, size=int(rng.integers(0, dmax)),
                              replace=False).tolist()) for _ in range(n)]


def _save(base, res, step):
    prelude, states, pointers = res.prelude, res.states, res.pointers
    if step > 1:
        prelude = dataclasses.replace(prelude, phase_step=step)
        n = prelude.num_nodes
        rev_idx = (n - 1 - np.arange(0, n, step))[::-1]
        states, pointers = states[rev_idx], pointers[rev_idx]
    prelude.save(base)
    save_states(base, np.ascontiguousarray(states))
    save_pointers(base, np.ascontiguousarray(pointers))


# name -> (adjacency maker, compress args, compress kwargs, phase_step)
ARTIFACTS = {
    "serial": (lambda: synth_web_graph(400, seed=21), (7, 3, 2), {}, 1),
    "sampled4": (lambda: synth_web_graph(400, seed=7), (7, 3, 2), {}, 4),
    # block-encoded and phase-sampled: lane entries and ring seeds go
    # through the native random access that enters at block starts
    "blocks4_sampled3": (
        lambda: Adjacency.from_lists(_rand_lists(180, 17, 11)), (7, 3, 2),
        dict(encode_blocks=4), 3),
    "w16_safe": (lambda: synth_web_graph(300, seed=13),
                 (16, 2_000_000_000, 4), dict(safe_break_interval=32), 1),
}
PIPELINE = ("serial", "sampled4", "blocks4_sampled3")


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_emit_pipeline")
    made = {}
    for name, (make, args, kw, step) in ARTIFACTS.items():
        adj = make()
        base = str(root / name)
        _save(base, compress_adjacency(adj, *args, **kw), step)
        made[name] = (adj, base)
    return made


@pytest.fixture()
def xla_decoder(monkeypatch):
    monkeypatch.setenv("WGT_PALLAS", "0")


def _summary_jax(jdec):
    pl = jdec._emit_plan(LANES)
    regs = emit_torch.regs_from_jax(np.asarray(pl["init"]),
                                    len(pl["starts_np"]))
    return pl, regs


def _check_plans(jdec, tdec, drop_empty=False):
    """Same lane bounds, halo starts, ring depth, step cap and register
    file (but the pointer row, which the port keeps apart). drop_empty:
    the port's plan is the JAX plan without its empty lanes."""
    jpl, jregs = _summary_jax(jdec)
    tpl = tdec._emit_plan(LANES)
    keep_l = (jpl["starts_np"] < jpl["ends_np"] if drop_empty
              else np.ones(len(jpl["starts_np"]), bool))
    jregs = jregs[:, torch.from_numpy(keep_l)]
    np.testing.assert_array_equal(tpl["starts_np"], jpl["starts_np"][keep_l])
    np.testing.assert_array_equal(tpl["ends_np"], jpl["ends_np"][keep_l])
    np.testing.assert_array_equal(tpl["hstarts_np"],
                                  jregs[emit_torch.D_X].numpy())
    assert tpl["T"] == jpl["T"] and tpl["cap"] == jpl["cap"]
    keep = torch.ones(jregs.shape[0], dtype=torch.bool)
    keep[emit_torch.D_PTR] = False
    np.testing.assert_array_equal(tpl["regs"][keep].numpy(),
                                  jregs[keep].numpy())


def _replan(dec, keys, **state):
    pl = dec._plans[("emit", LANES)]
    for k in keys:
        pl.pop(k, None)
    pl.update(state)


def _plan_lists(adj, tdec):
    """The port's lists decoded on its current emit plan, against the
    input graph."""
    val, xch, nib, _ = tdec.decode_emit_raw(LANES)
    pl = tdec._emit_plan(LANES)
    lens = pl["ends_np"] - pl["starts_np"]
    lane_of = np.repeat(np.arange(len(lens), dtype=np.int32), lens)
    _assert_lists(adj, *emit_post.postprocess(val, xch, nib, lane_of,
                                              pl["starts_np"],
                                              adj.num_nodes)[:3])


@pytest.mark.parametrize("name", list(ARTIFACTS))
def test_emit_planner_matches_jax(artifacts, name, xla_decoder):
    """First plan, the plan rebalanced on known degrees and safe
    boundaries, and the plan refined on per-node work: equal in both
    packages, as are the safe boundaries themselves.

    On the block-encoded artifact the rebalanced and refined plans are
    compared through the lists: there every encode-block start bounds a
    lane and no lane crosses one; the port splits inside the blocks (one
    bisected target over all of them, each start a forced bound), while
    the JAX planner bisects and snaps its bounds to the block starts, one
    lane a block. So the port's plan is checked for those properties
    (_check_block_plan), and its lists are the input graph's.

    On the window-16 artifact too: past window 12 every cut is at a safe
    node, and the port closes each lane at the last safe node that keeps
    it within the bisected target (emit_split_last), where the JAX
    planner's greedy split lets a lane run past its target to the next
    safe node. So the port's rebalanced and refined plans differ from the
    JAX plans: their longest lane costs no more than the JAX plan's, no
    lane is empty, every bound is a safe node, and the lists are the
    input graph's."""
    adj, base = artifacts[name]
    blocks = ARTIFACTS[name][2].get("encode_blocks", 1) > 1
    jdec = TpuGraphDecoder(JaxGraph.load(base))
    tdec = TorchGraphDecoder(TorchGraph.load(base), device="cpu")
    _check_plans(jdec, tdec)

    safe = jdec._safe_boundaries()
    np.testing.assert_array_equal(tdec._safe_boundaries(), safe)
    degs = np.diff(adj.offsets.astype(np.int64)).astype(np.int32)
    _replan(jdec, ("init", "slab", "cap", "bounds"), degs_np=degs,
            safe_np=safe)
    _replan(tdec, ("regs", "cap", "bounds"), degs_np=degs,
            safe_np=safe.copy())
    offs = np.concatenate([[0], np.cumsum(degs, dtype=np.int64)])
    _compare_rebalanced(jdec, tdec, adj, blocks, safe,
                        np.diff(offs + 2.0 * np.arange(len(offs))))

    work = degs.astype(np.float64) + 2.5 + (np.arange(len(degs)) % 3)
    _replan(jdec, ("init", "slab", "cap", "bounds"), node_work=work)
    _replan(tdec, ("regs", "cap", "bounds"), node_work=work.copy())
    _compare_rebalanced(jdec, tdec, adj, blocks, safe,
                        np.diff(np.concatenate([[0.0], np.cumsum(work)])))


def _compare_rebalanced(jdec, tdec, adj, blocks, safe, cost):
    """A rebalanced plan of both packages: equal; on block artifacts
    through the lists, with the port's plan split inside the blocks
    (_check_block_plan); or past window 12 through the lists, with the
    port's longest lane (in the split's cost) no longer than the JAX
    plan's, no empty lane and every bound safe."""
    if blocks:
        _check_block_plan(tdec, tdec._emit_plan(LANES), LANES)
        _plan_lists(adj, tdec)
        return
    if tdec.window <= 12:
        _check_plans(jdec, tdec)
        return
    jpl, _ = _summary_jax(jdec)
    tpl = tdec._emit_plan(LANES)
    n = adj.num_nodes
    halo = np.zeros(n + 1)
    got = graph_decode.lane_costs(
        cost, halo, np.append(tpl["starts_np"], tpl["ends_np"][-1]))
    want = graph_decode.lane_costs(
        cost, halo, np.append(jpl["starts_np"], jpl["ends_np"][-1]))
    assert got.max() <= want.max()
    assert (tpl["starts_np"] < tpl["ends_np"]).all()
    np.testing.assert_array_equal(tpl["starts_np"][1:], tpl["ends_np"][:-1])
    inner = tpl["starts_np"][1:]
    assert safe[inner].all() and tpl["starts_np"][0] == 0
    assert tpl["ends_np"][-1] == n
    _plan_lists(adj, tdec)


def _split_spec(cost, halo, safe, num_lanes, force_unsafe, target):
    """The planner's split as the JAX package writes it
    (webgraph_ans_tpu/ops/graph_decode.py, _emit_bounds), a scalar loop
    over the nodes in Python floats: the specification of emit_split."""
    n = len(cost)
    cost_l, halo_l = cost.tolist(), halo.tolist()
    safe_l = [True] * n if safe is None else np.asarray(safe).tolist()
    blist = [0]
    acc = halo_l[0]
    for x in range(n):
        w = cost_l[x]
        close = acc + w > target and safe_l[x]
        close |= (acc + w > 1.5 * target) and force_unsafe
        if close and x > blist[-1]:
            if len(blist) == num_lanes:
                return None
            blist.append(x)
            acc = halo_l[x]
        acc += w
    while len(blist) < num_lanes + 1:
        blist.append(n)
    return np.array(blist, np.int64)


def _split_case(seed, refined, masked, halo_on):
    """Planner inputs of a seeded 600-node graph: integer costs (elements
    + 2 a node) or fractional ones (each of 40 spans' extra rows spread
    over its nodes); a safe mask with long unsafe stretches, or none; the
    halo sums of a window-7 halo, or zeros."""
    rng = np.random.default_rng(seed)
    n = 600
    degs = np.minimum(rng.zipf(1.6, n), 400).astype(np.int64)
    degs[rng.random(n) < 0.1] = 0
    offs = np.concatenate([[0], np.cumsum(degs)])
    if refined:
        nw = degs.astype(np.float64)
        cuts = np.unique(np.concatenate([[0, n], rng.integers(0, n, 40)]))
        for a, b in zip(cuts[:-1], cuts[1:]):
            # a span's extra rows over its nodes
            nw[a:b] += float(rng.integers(0, 7 * (b - a) + 1)) / (b - a)
        work = np.concatenate([[0.0], np.cumsum(nw)])
    else:
        work = offs + 2.0 * np.arange(n + 1)
    Hsp = 28 if halo_on else 0
    halo = (offs - offs[np.maximum(np.arange(n + 1) - Hsp, 0)]) \
        .astype(np.float64)
    safe = None
    if masked:
        safe = rng.random(n) < 0.4
        for a in rng.integers(0, n - 60, 4):
            safe[a:a + 60] = False
    return np.diff(work), halo, safe, work, degs


@pytest.mark.parametrize("force_unsafe", [False, True])
@pytest.mark.parametrize("halo_on", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("refined", [False, True])
def test_emit_split_matches_scalar_loop(refined, masked, halo_on,
                                        force_unsafe):
    """The native split gives the scalar loop's bounds, bound for bound,
    or refuses where it refuses: at every target of the planner's own
    bisection, at integer targets (ties with integer cost sums), and at
    lane counts from 1 to more than the nodes."""
    seed = 8 * refined + 4 * masked + 2 * halo_on + force_unsafe
    cost, halo, safe, work, degs = _split_case(seed, refined, masked,
                                               halo_on)
    n = len(cost)
    for lanes in (1, 2, 7, 64, n, n + 9):
        lo = float(work[-1]) / lanes
        hi = lo * 8 + float(np.max(degs) + halo.max()) + 4096
        targets = [0.0, 1.0, float(work[-1]), 1e300]
        for _ in range(40):
            mid = (lo + hi) / 2
            targets.append(mid)
            if _split_spec(cost, halo, safe, lanes, force_unsafe,
                           mid) is None:
                lo = mid
            else:
                hi = mid
        targets += [hi, float(np.floor(hi)), float(np.ceil(hi)),
                    float(np.floor(2 * hi / 3))]
        for t in targets:
            want = _split_spec(cost, halo, safe, lanes, force_unsafe, t)
            got = graph_decode.emit_split(cost, halo, safe, lanes,
                                          force_unsafe, t)
            if want is None:
                assert got is None, (lanes, t)
            else:
                assert got is not None, (lanes, t)
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"{lanes} {t}")


def _cuts(safe, n):
    """The nodes a lane may start at (0 and the safe nodes) and end at
    (the safe nodes and n), in order: 0, the safe nodes past 0, n."""
    inner = (np.arange(1, n) if safe is None
             else np.flatnonzero(np.asarray(safe)[1:]) + 1)
    return np.concatenate([[0], inner, [n]]).astype(np.int64)


def _sums(cost, halo):
    """sum(a, b): a lane [a, b)'s sum in emit_split_last's arithmetic."""
    P = np.concatenate([[0.0], np.cumsum(cost)])
    return lambda a, b: halo[a] + (P[b] - P[a])


def _fewest_lanes(cost, halo, safe, target):
    """The fewest lanes of any split at safe nodes whose every lane sum is
    within target (inf where none is), over every pair of cuts."""
    cuts, lane = _cuts(safe, len(cost)), _sums(cost, halo)
    dp = np.full(len(cuts), np.inf)
    dp[0] = 0
    for j in range(1, len(cuts)):
        fit = lane(cuts[:j], cuts[j]) <= target
        if fit.any():
            dp[j] = dp[:j][fit].min() + 1
    return dp[-1]


def _min_max(cost, halo, safe, lanes):
    """The least longest lane of any split at safe nodes into at most
    `lanes` lanes: dynamic programming over every pair of cuts."""
    cuts, lane = _cuts(safe, len(cost)), _sums(cost, halo)
    best = np.full(len(cuts), np.inf)
    best[0] = 0.0
    least = np.inf
    for _ in range(lanes):
        nxt = np.full(len(cuts), np.inf)
        for j in range(1, len(cuts)):
            nxt[j] = np.maximum(best[:j], lane(cuts[:j], cuts[j])).min()
        best = nxt
        least = min(least, best[-1])
    return least


def _bisected(split, cost, halo, degs, lanes):
    """The planner's bisection of a split's target (its lo and hi)."""
    lo = float(np.sum(cost)) / lanes
    hi = lo * 8 + float(np.max(degs) + halo.max()) + 4096
    return graph_decode.min_max_split(split, lo, hi)


SPLIT_CASES = [(r, m, h) for r in (False, True) for m in (False, True)
               for h in (False, True)]


@pytest.mark.parametrize("refined,masked,halo_on", SPLIT_CASES)
def test_emit_split_last_closes_at_the_last_safe_node(refined, masked,
                                                      halo_on):
    """At every target of its own bisection, at integer targets and at
    lane counts from 1 to more than the nodes: each lane of
    emit_split_last stays within the target and ends at the last safe
    node (or n) that keeps it there, the next cut would pass it, unused
    lanes are empty at n; and it refuses exactly where no split at safe
    nodes into that many lanes keeps every lane within the target."""
    seed = 8 * refined + 4 * masked + 2 * halo_on
    cost, halo, safe, work, degs = _split_case(seed, refined, masked,
                                               halo_on)
    n = len(cost)
    cuts, lane = _cuts(safe, n), _sums(cost, halo)
    fewest = {}
    for lanes in (1, 2, 7, 64, n, n + 9):
        targets = [0.0, 1.0, float(work[-1]), 1e300]
        lo = float(work[-1]) / lanes
        hi = lo * 8 + float(np.max(degs) + halo.max()) + 4096
        for _ in range(40):
            mid = (lo + hi) / 2
            targets.append(mid)
            if graph_decode.emit_split_last(cost, halo, safe, lanes,
                                            mid) is None:
                lo = mid
            else:
                hi = mid
        targets += [hi, float(np.floor(hi)), float(np.ceil(hi)),
                    float(np.floor(2 * hi / 3))]
        for t in targets:
            got = graph_decode.emit_split_last(cost, halo, safe, lanes, t)
            if t not in fewest:
                fewest[t] = _fewest_lanes(cost, halo, safe, t)
            assert (got is None) == (fewest[t] > lanes), (lanes, t)
            if got is None:
                continue
            assert len(got) == lanes + 1 and got[0] == 0
            assert (np.diff(got) >= 0).all() and got[-1] == n
            used = np.flatnonzero(got[1:] > got[:-1])
            assert (got[used[-1] + 1:] == n).all()
            for li in used:
                a, b = got[li], got[li + 1]
                assert b in cuts and lane(a, b) <= t, (lanes, t, li)
                if b < n:
                    nxt = cuts[np.searchsorted(cuts, b, side="right")]
                    assert lane(a, nxt) > t, (lanes, t, li)


@pytest.mark.parametrize("refined,masked,halo_on", SPLIT_CASES)
def test_emit_split_last_bisected_is_min_max(refined, masked, halo_on):
    """After the planner's bisection, emit_split_last's longest lane is
    the least longest lane of any split at safe nodes (dynamic
    programming over the cuts of the first 40 and 60 nodes, 1 to 6
    lanes), to 1e-9 relative."""
    seed = 8 * refined + 4 * masked + 2 * halo_on
    cost, halo, safe, _, degs = _split_case(seed, refined, masked, halo_on)
    for m in (40, 60):
        c, h = cost[:m], halo[:m + 1]
        sf = None if safe is None else safe[:m]
        for lanes in range(1, 7):
            _, bounds = _bisected(
                lambda t: graph_decode.emit_split_last(c, h, sf, lanes, t),
                c, h, degs, lanes)
            got = graph_decode.lane_costs(c, h, bounds).max()
            want = _min_max(c, h, sf, lanes)
            assert got == pytest.approx(want, rel=1e-9), (m, lanes)


@pytest.mark.parametrize("refined,masked,halo_on", SPLIT_CASES)
def test_emit_split_last_no_longer_than_greedy(refined, masked, halo_on):
    """Bisected as the planner bisects each, emit_split_last's longest
    lane is never longer than the greedy emit_split's (cuts at safe nodes
    only) at its own bisected target, and never passes its target."""
    seed = 8 * refined + 4 * masked + 2 * halo_on
    cost, halo, safe, _, degs = _split_case(seed, refined, masked, halo_on)
    for lanes in (1, 2, 7, 16, 64):
        t_last, last = _bisected(
            lambda t: graph_decode.emit_split_last(cost, halo, safe, lanes,
                                                   t),
            cost, halo, degs, lanes)
        _, greedy = _bisected(
            lambda t: graph_decode.emit_split(cost, halo, safe, lanes, False,
                                              t),
            cost, halo, degs, lanes)
        got = graph_decode.lane_costs(cost, halo, last).max()
        assert got <= t_last
        assert got <= graph_decode.lane_costs(cost, halo, greedy).max()


def test_min_max_split_doubles_past_a_long_safe_gap():
    """With no safe node past node 0 the one lane must hold every node,
    past the planner's hi: the bisection doubles hi until the split gives
    bounds, and converges on that lane's sum."""
    cost, halo, _, work, degs = _split_case(0, False, False, False)
    n, lanes = len(cost), 64
    safe = np.zeros(n, bool)
    safe[0] = True
    lo = float(work[-1]) / lanes
    assert lo * 8 + float(np.max(degs) + halo.max()) + 4096 < work[-1]
    target, bounds = _bisected(
        lambda t: graph_decode.emit_split_last(cost, halo, safe, lanes, t),
        cost, halo, degs, lanes)
    assert bounds[0] == 0 and (bounds[1:] == n).all()
    assert target == pytest.approx(float(work[-1]), rel=1e-9)


@pytest.mark.parametrize("rule", ["greedy", "last_safe"])
@pytest.mark.parametrize("masked", [False, True])
def test_forced_split_is_each_block_split_alone(rule, masked):
    """With forced nodes (encode-block starts) the native split's bounds
    are, at every target the bisection tries, those of each block split
    alone at that target, with every forced node a bound; it refuses
    where the blocks' lanes together pass the lane count; and with no
    node forced it gives the bounds of the split without the argument,
    bound for bound."""
    cost, halo, safe, work, degs = _split_case(17 + masked, False, masked,
                                               True)
    n = len(cost)
    starts = np.array([0, 90, 91, 240, 420, 599])
    forced = np.zeros(n, bool)
    forced[starts] = True
    edges = np.append(starts, n)

    def split(t, lanes, forced=None, lo=0, hi=n):
        args = (cost[lo:hi], halo[lo:hi + 1],
                None if safe is None else safe[lo:hi], lanes)
        kw = {} if forced is None else dict(forced=forced)
        if rule == "greedy":
            return graph_decode.emit_split(*args, True, t, **kw)
        return graph_decode.emit_split_last(*args, t, **kw)

    for lanes in (len(starts), 12, 40):
        lo = float(work[-1]) / lanes
        hi = lo * 8 + float(np.max(degs) + halo.max()) + 4096
        targets = [lo * (1 + k / 8) for k in range(40)] + [hi, 1e300]
        for t in targets:
            got = split(t, lanes, forced)
            alone = [split(t, b - a, None, a, b) for a, b in
                     zip(edges[:-1], edges[1:])]
            if any(x is None for x in alone):
                assert got is None, (lanes, t)
                continue
            want = np.unique(np.concatenate(
                [a + x for a, x in zip(edges[:-1], alone)]))
            if len(want) - 1 > lanes:
                assert got is None, (lanes, t)
                continue
            assert got is not None, (lanes, t)
            np.testing.assert_array_equal(np.unique(got), want)
            np.testing.assert_array_equal(
                split(t, lanes, np.zeros(n, bool)), split(t, lanes))


def _check_block_plan(dec, pl, num_lanes):
    """A plan of a block-parallel artifact: contiguous lanes over every
    node, every encode-block start a lane's start, no lane across one,
    every lane's start an entry point (a sampled node or a block start),
    its halo start no further back than its block's start, and the lanes
    that hold a node within num_lanes (or one a block, where the blocks
    are more). Returns (block starts, used starts, used ends)."""
    bs = dec._encode_block_starts()
    starts, ends = pl["starts_np"], pl["ends_np"]
    np.testing.assert_array_equal(starts[1:], ends[:-1])
    assert starts[0] == 0 and ends[-1] == dec.num_nodes
    used = starts < ends
    a, b = starts[used], ends[used]
    assert np.isin(bs, a).all()
    np.testing.assert_array_equal(dec._block_floor(a), dec._block_floor(b - 1))
    assert np.isin(a, dec._entries()[0]).all()
    assert used.sum() <= max(num_lanes, len(bs))
    if "hstarts_np" in pl:
        h = pl["hstarts_np"][used]
        np.testing.assert_array_equal(
            h, np.maximum(a - dec._halo(pl), dec._block_floor(a)))
    return bs, a, b


def _lanes_a_block(bs, a, n):
    """The lanes that start in each encode block."""
    return np.diff(np.searchsorted(a, np.append(bs, n)))


def _block_costs(dec, pl, bs):
    """Each encode block's cost in the last split's model: its observed
    node work (the refinement's), or elements + 2 a node."""
    nw = pl.get("node_work")
    if nw is None:
        nw = pl["degs_np"] + 2.0
    P = np.concatenate([[0.0], np.cumsum(nw)])
    edges = np.append(bs, dec.num_nodes)
    return P[edges[1:]] - P[edges[:-1]]


def _split_stages(mark):
    return [s for s in trace.stages()
            if s.id > mark and s.name == "emit.split"]


def test_block_plan_one_lane_per_block(artifacts, xla_decoder):
    """On the block-encoded, phase-sampled artifact the rebalanced and
    refined plans split inside the encode blocks, at LANES and at
    4 * LANES: every block start bounds a lane, no lane crosses one, every
    lane starts at an entry point, a block longer than 1.5 x the split's
    target holds more than one lane (some block does at both lane
    counts), and every call's lists equal the JAX package's
    decode_to_adjacency_device (one lane a block)."""
    adj, base = artifacts["blocks4_sampled3"]
    g = TorchGraph.load(base)
    want = adj.to_lists()
    for lanes in (LANES, 4 * LANES):
        jax_lists = emit_post.to_host_lists(*(
            torch.from_numpy(np.array(a)) for a in TpuGraphDecoder(
                JaxGraph.load(base)).decode_to_adjacency_device(lanes)),
            adj.num_nodes)
        assert [x.tolist() for x in jax_lists] == want
        dec = TorchGraphDecoder(g, device="cpu")
        mark = max((s.id for s in trace.stages()), default=0)
        for i in range(4):
            got = emit_post.to_host_lists(
                *dec.decode_to_adjacency_device(lanes), adj.num_nodes)
            assert [x.tolist() for x in got] == want
            pl = dec._plans[("emit", lanes)]
            if i:       # rebalanced, refined, steady
                bs, a, _ = _check_block_plan(dec, pl, lanes)
        assert dec.emit_steady(lanes) and "node_work" in pl
        split = _split_stages(mark)[-1]
        assert split.attrs["block_starts"] == len(bs) == 4
        many = _block_costs(dec, pl, bs) > 1.5 * split.attrs["target"]
        per_block = _lanes_a_block(bs, a, adj.num_nodes)
        assert many.any() and (per_block[many] > 1).all()
        assert pl["ptrs"].shape[0] == pl["regs"].shape[1] == len(
            pl["starts_np"])


# block-parallel artifacts with per-node phases, every node an entry:
# name -> (nodes, seed, encode blocks, compress args, compress kwargs)
BLOCK_ARTIFACTS = {
    "blocks4": (400, 29, 4, (7, 3, 2), {}),
    "blocks8": (400, 31, 8, (7, 3, 2), {}),
    # past window 12: the last-safe split, each block start forced
    "w16_blocks4": (400, 37, 4, (16, 2_000_000_000, 4),
                    dict(safe_break_interval=32)),
}
BLOCK_LANES = 16


@pytest.fixture(scope="module")
def block_artifacts(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_emit_blocks")
    made = {}
    for name, (n, seed, blocks, args, kw) in BLOCK_ARTIFACTS.items():
        adj = synth_web_graph(n, seed=seed)
        base = str(root / name)
        _save(base, compress_adjacency(adj, *args, encode_blocks=blocks,
                                       **kw), 1)
        made[name] = (adj, base)
    return made


def _to_steady(adj, dec, lanes):
    """Drives the merged emit into its verified steady state, each call's
    lists checked against the input graph; returns the plan."""
    for _ in range(4):
        _assert_lists(adj, *dec.decode_to_adjacency_device(lanes))
        if dec.emit_steady(lanes):
            break
    assert dec.emit_steady(lanes)
    _assert_lists(adj, *dec.decode_to_adjacency_device(lanes))
    return dec._plans[("emit", lanes)]


@pytest.mark.parametrize("name", list(BLOCK_ARTIFACTS))
def test_block_plan_splits_inside_blocks(block_artifacts, name,
                                         xla_decoder):
    """A block-parallel artifact with per-node phases, driven into the
    steady state: every call's lists are the input graph's and the JAX
    package's; the steady plan uses every lane, starts one at each block
    start and crosses none, gives each block lanes by its steps (a block
    longer than 1.5 x the target holds more than one), and records the
    forced starts on its splits and the blocks on plan.verify."""
    adj, base = block_artifacts[name]
    blocks = BLOCK_ARTIFACTS[name][2]
    rule = "last_safe" if BLOCK_ARTIFACTS[name][3][0] > 12 else "greedy"
    jax_lists = emit_post.to_host_lists(*(
        torch.from_numpy(np.array(a)) for a in TpuGraphDecoder(
            JaxGraph.load(base)).decode_to_adjacency_device(BLOCK_LANES)),
        adj.num_nodes)
    assert [x.tolist() for x in jax_lists] == adj.to_lists()
    dec = TorchGraphDecoder(TorchGraph.load(base), device="cpu")
    mark = max((s.id for s in trace.stages()), default=0)
    pl = _to_steady(adj, dec, BLOCK_LANES)
    bs, a, _ = _check_block_plan(dec, pl, BLOCK_LANES)
    assert len(bs) == blocks and len(pl["starts_np"]) == BLOCK_LANES
    splits = _split_stages(mark)
    assert [s.attrs["block_starts"] for s in splits] == [blocks, blocks]
    assert [s.attrs["rule"] for s in splits] == [rule, rule]
    many = _block_costs(dec, pl, bs) > 1.5 * splits[-1].attrs["target"]
    per_block = _lanes_a_block(bs, a, adj.num_nodes)
    assert many.any() and (per_block[many] > 1).all()
    assert per_block.sum() > blocks
    (verify,) = [s for s in trace.stages()
                 if s.id > mark and s.name == "plan.verify"]
    assert verify.attrs["encode_blocks"] == blocks
    assert verify.attrs["lanes"] == BLOCK_LANES


@pytest.mark.parametrize("name", ["blocks4", "blocks8"])
def test_block_halo_stops_at_the_block_start(block_artifacts, name,
                                             monkeypatch):
    """Where the safe boundaries are unknown every lane re-decodes a
    4 * window halo, on a block-parallel artifact each clipped at its
    block's start (the rANS state resets there): the steady plan's lanes
    that start inside a block reach back 4 * window nodes or to the
    block's start, those at a block start not at all; the first call's
    stream-balanced lanes have none. Lanes planted 3 nodes past each block
    start reach back to it alone. Every call's lists are the input
    graph's."""
    adj, base = block_artifacts[name]
    n, lanes = adj.num_nodes, 2 * BLOCK_LANES

    def unknown():
        raise RuntimeError("no safe boundaries")

    dec = TorchGraphDecoder(TorchGraph.load(base), device="cpu")
    monkeypatch.setattr(dec, "_safe_boundaries", unknown)
    _assert_lists(adj, *dec.decode_to_adjacency_device(lanes))
    first = dict(dec._plans[("emit", lanes)])
    np.testing.assert_array_equal(first["hstarts_np"], first["starts_np"])
    pl = _to_steady(adj, dec, lanes)
    assert pl["safe_np"] is None and dec._halo(pl) == 4 * dec.window
    bs, a, _ = _check_block_plan(dec, pl, lanes)
    h = pl["hstarts_np"][pl["starts_np"] < pl["ends_np"]]
    inside = ~np.isin(a, bs)
    assert inside.any() and (h[inside] < a[inside]).all()

    # lanes 3 and 40 nodes past each block start: the first clipped to it
    dec = TorchGraphDecoder(TorchGraph.load(base), device="cpu")
    bs = dec._encode_block_starts()
    starts = np.unique(np.concatenate([bs, bs + 3, bs + 40]))
    starts = starts[starts < n]
    pl = dec._plans.setdefault(("emit", len(starts)), {})
    pl.update(degs_np=np.diff(adj.offsets.astype(np.int64)), safe_np=None,
              bounds=(starts, np.append(starts[1:], n)))
    val, xch, nib, _ = dec.decode_emit_raw(len(starts))
    pl = dec._emit_plan(len(starts))
    _check_block_plan(dec, pl, len(starts))
    hs = pl["hstarts_np"]
    np.testing.assert_array_equal(hs[np.isin(starts, bs + 3)],
                                  bs[bs + 3 < n])
    far = np.isin(starts, bs + 40)
    np.testing.assert_array_equal(hs[far], starts[far] - 4 * dec.window)
    lens = pl["ends_np"] - pl["starts_np"]
    lane_of = np.repeat(np.arange(len(lens), dtype=np.int32), lens)
    _assert_lists(adj, *emit_post.postprocess(val, xch, nib, lane_of,
                                              pl["starts_np"], n)[:3])


def _guarded_call(dec, layout):
    """(the call that plans `layout` on a fresh decoder, the dict where it
    records the layout's size after the call)."""
    if layout.startswith("aux"):
        return (lambda: dec.decode_to_csr_device(LANES),
                lambda: dec.plan(LANES)["flat_sizes"])
    if layout.startswith("merged"):
        return (lambda: dec.decode_to_adjacency_device(LANES),
                lambda: dec._plans[("emit", LANES)]["flat_sizes"])
    out, _, cap = dec.decode_raw(LANES, emit_aux=True)
    mc = {}
    return (lambda: reconstruct_device.reconstruct_device(
        out, dec.num_nodes, dec.num_arcs, cap, mc),
        lambda: mc["flat_sizes"])


@pytest.mark.parametrize("layout", [
    "aux-mode decode [3cap + cap//8, L]", "merged-emit [cap, L]",
    "merged-emit marker rows [cap << 6]",
    "sort-path element space [2 Epad + Ccap]"])
def test_layout_guard_names_the_layout(artifacts, layout, monkeypatch):
    """Each layout addressed by int32 flat indices records its size where
    it is planned, and raises ValueError naming itself, instead of
    wrapping, once the limit is not above that size."""
    _, base = artifacts["serial"]
    call, sizes = _guarded_call(
        TorchGraphDecoder(TorchGraph.load(base), device="cpu"), layout)
    call()
    size = sizes()[layout]
    assert 0 < size < reconstruct_device.FLAT_LIMIT
    limit = size
    if "marker rows" in layout:
        # a limit the [cap, L] channels stay under
        limit = sizes()["merged-emit [cap, L]"] + 1
        assert limit <= size
    call, _ = _guarded_call(
        TorchGraphDecoder(TorchGraph.load(base), device="cpu"), layout)
    monkeypatch.setattr(reconstruct_device, "FLAT_LIMIT", limit)
    with pytest.raises(ValueError, match=re.escape(layout)):
        call()


def test_layout_guard_propagates_from_safe_boundaries(artifacts,
                                                      monkeypatch):
    """The first call's safe boundaries decode the graph once in aux mode
    at 2048 lanes. Past the int32 limit that decode's ValueError, naming
    the aux layout, leaves decode_to_adjacency_device: it is not taken
    for a failed safe-boundary computation (the halo fallback)."""
    _, base = artifacts["serial"]
    aux = "aux-mode decode [3cap + cap//8, L]"
    dec = TorchGraphDecoder(TorchGraph.load(base), device="cpu")
    dec.decode_to_adjacency_device(LANES)
    assert dec._plans[("emit", LANES)].get("safe_np") is not None
    size = dec.plan(2048)["flat_sizes"][aux]
    # a limit the first call's merged-emit layouts stay under
    assert max(dec._plans[("emit", LANES)]["flat_sizes"].values()) < size
    monkeypatch.setattr(reconstruct_device, "FLAT_LIMIT", size)
    dec = TorchGraphDecoder(TorchGraph.load(base), device="cpu")
    with pytest.raises(ValueError, match=re.escape(aux)):
        dec.decode_to_adjacency_device(LANES)
    assert "safe_np" not in dec._plans[("emit", LANES)]


def _assert_lists(adj, s2d, st, dg):
    offs = adj.offsets.astype(np.int64)
    np.testing.assert_array_equal(dg.numpy(), np.diff(offs))
    lists = emit_post.to_host_lists(s2d, st, dg, adj.num_nodes)
    for x in range(adj.num_nodes):
        np.testing.assert_array_equal(lists[x].astype(np.uint32),
                                      adj.succs[offs[x]:offs[x + 1]],
                                      err_msg=f"node {x}")


class _NoHostSync:
    """Makes every tensor-to-host read raise while active, except inside
    the functions `lifted` wraps: the kernels' plain versions, which the
    CPU runs in the kernels' place."""

    NAMES = ("item", "tolist", "numpy", "cpu", "__bool__", "__int__",
             "__float__")

    def __enter__(self):
        self.saved = {k: getattr(torch.Tensor, k) for k in self.NAMES}

        def refuse(*args, **kw):
            raise AssertionError("host synchronisation in the steady state")

        for k in self.NAMES:
            setattr(torch.Tensor, k, refuse)
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            setattr(torch.Tensor, k, v)

    def lifted(self, fn, calls: list, note):
        """fn with the guard lifted while it runs; each call first appends
        note(*args, **kw) to calls."""
        def run(*args, **kw):
            calls.append(note(*args, **kw))
            self.__exit__()
            try:
                return fn(*args, **kw)
            finally:
                self.__enter__()
        return run


def _spy_kernels(monkeypatch, guard):
    """decode_emit and the steady fixup, each run with the guard lifted:
    (the mark_deg of each decode_emit call, the val device of each fixup
    call)."""
    calls, fixups = [], []
    monkeypatch.setattr(graph_decode, "decode_emit", guard.lifted(
        graph_decode.decode_emit, calls, lambda *a, **kw: kw.get("mark_deg")))
    monkeypatch.setattr(emit_post, "emit_fixup", guard.lifted(
        emit_post.emit_fixup, fixups, lambda val, *a: val.device.type))
    return calls, fixups


@pytest.mark.parametrize("name", PIPELINE)
def test_pipeline_reaches_steady_state(artifacts, name, monkeypatch):
    """First call, rebalance, refinement: exact lists on every call; then
    the verified steady state runs decode_emit (mark_deg) and the cached
    post-pass only, with no host synchronisation outside the kernel's
    plain versions (decode_emit's, and the fixup's where the layout has
    dirty nodes), and gives the input lists again."""
    adj, base = artifacts[name]
    dec = TorchGraphDecoder(TorchGraph.load(base), device="cpu")
    pl = None
    for _ in range(3):
        _assert_lists(adj, *dec.decode_to_adjacency_device(LANES))
        pl = dec._plans[("emit", LANES)]
        if dec.emit_steady(LANES):
            break
    assert dec.emit_steady(LANES), "plan never reached the verified state"
    assert "node_work" in pl and "safe_np" in pl

    guard = _NoHostSync()
    calls, fixups = _spy_kernels(monkeypatch, guard)

    def no_token_decode(*args, **kw):
        raise AssertionError("token decode in the steady state")

    monkeypatch.setattr(graph_decode, "decode_blocks", no_token_decode)
    with guard:
        out = dec.decode_to_adjacency_device(LANES)
    assert calls == [True]
    assert fixups == (["cpu"] if pl["post_meta"]["fx_nodes"].shape[0]
                      else [])
    _assert_lists(adj, *out)


@pytest.mark.parametrize("name,rule", [("w16_safe", "last_safe"),
                                       ("serial", "greedy")])
def test_split_rule_follows_the_window(artifacts, name, rule):
    """A window-16 safe-break artifact and a window-7 one, driven into
    the steady state: every call's lists are the input graph's; each of
    the plan's splits records its rule ("last_safe" past window 12,
    "greedy" up to it) and its longest and mean lane cost, the last-safe
    split's longest lane within its target; plan.verify records the
    longest and the mean lane's rows of its decode."""
    adj, base = artifacts[name]
    dec = TorchGraphDecoder(TorchGraph.load(base), device="cpu")
    mark = max((s.id for s in trace.stages()), default=0)
    for _ in range(3):
        _assert_lists(adj, *dec.decode_to_adjacency_device(LANES))
        if dec.emit_steady(LANES):
            break
    assert dec.emit_steady(LANES)
    _assert_lists(adj, *dec.decode_to_adjacency_device(LANES))
    stages = [s for s in trace.stages() if s.id > mark]
    splits = [s for s in stages if s.name == "emit.split"]
    assert [s.attrs["model"] for s in splits] == ["elements", "rows"]
    for s in splits:
        assert s.attrs["rule"] == rule
        assert s.attrs["block_starts"] == 0
        assert 0 < s.attrs["mean_cost"] <= s.attrs["max_cost"]
        if rule == "last_safe":
            assert s.attrs["max_cost"] <= s.attrs["target"]
    pl = dec._plans[("emit", LANES)]
    (verify,) = [s for s in stages if s.name == "plan.verify"]
    assert verify.attrs["encode_blocks"] == 0
    assert verify.attrs["rows_max"] == int(pl["rows_np"].max())
    assert verify.attrs["rows_mean"] == float(pl["rows_np"].mean())
    assert verify.attrs["rows_max"] >= verify.attrs["rows_mean"] > 0


NODE_ROWS_CASES = {
    # two lanes [0, 3) and [3, 5), marker rows 1, 4, 9 and 2, 3, rows
    # used 12 and 7; a lane's first node takes the rows before its marker
    "two lanes": ([1, 4, 9, 2, 3], [0, 3], [3, 5], [12, 7],
                  [4, 5, 3, 3, 4]),
    # an empty lane between them is skipped
    "empty lane": ([0, 2, 0], [0, 2, 2], [2, 2, 3], [5, 0, 6],
                   [2, 3, 6]),
}


@pytest.mark.parametrize("case", list(NODE_ROWS_CASES))
def test_node_rows_spreads_each_lane_by_its_markers(case):
    mrow, starts, ends, rows, want = NODE_ROWS_CASES[case]
    got = graph_decode.node_rows(np.array(mrow), np.array(starts),
                                 np.array(ends), np.array(rows))
    np.testing.assert_array_equal(got, np.array(want, np.float64))


def _spread_loop(degs, starts, ends, rows):
    """The even spread as the JAX planner's refinement writes it, lane by
    lane."""
    degs = np.asarray(degs, np.float64)
    offs = np.concatenate([[0], np.cumsum(degs)])
    nw = degs.copy()
    for li in range(len(starts)):
        a, b = int(starts[li]), int(ends[li])
        if b > a:
            extra = max(rows[li] - (offs[b] - offs[a]), 0.0)
            nw[a:b] += extra / (b - a)
    return nw


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_spread_rows_matches_the_lane_loop(seed):
    """spread_rows gives the JAX refinement's even spread bit for bit:
    contiguous lanes, empty lanes at n and inside the split, lanes whose
    rows fall short of their elements (no share)."""
    rng = np.random.default_rng(seed)
    n = 500
    degs = np.minimum(rng.zipf(1.6, n), 300).astype(np.int32)
    cuts = np.sort(np.concatenate([[0, n, n], rng.integers(0, n, 30)]))
    starts, ends = cuts[:-1], cuts[1:]
    offs = np.concatenate([[0], np.cumsum(degs, dtype=np.int64)])
    rows = (offs[ends] - offs[starts]
            + rng.integers(-5, 9 * (ends - starts) + 1)).astype(np.int32)
    rows[ends <= starts] = 0
    np.testing.assert_array_equal(
        graph_decode.spread_rows(degs, starts, ends, rows),
        _spread_loop(degs, starts, ends, rows))


@pytest.mark.parametrize("name", list(ARTIFACTS))
def test_refined_node_rows_sum_to_the_lanes_rows(artifacts, monkeypatch,
                                                 name):
    """The refinement prices nodes by the split's rule: on last_safe plans
    each node's rows from the marker rows of the split's decode
    (node_rows), on greedy ones each lane's rows spread evenly over its
    nodes (spread_rows). Either way no node is negative and each lane's
    nodes sum to its observed rows."""
    adj, base = artifacts[name]
    seen = []

    def keep(fn):
        def run(*args):
            nw = fn(*args)
            seen.append((fn.__name__, *(np.copy(x) for x in args[1:]), nw))
            return nw
        return run

    for fn in (graph_decode.node_rows, graph_decode.spread_rows):
        monkeypatch.setattr(graph_decode, fn.__name__, keep(fn))
    dec = TorchGraphDecoder(TorchGraph.load(base), device="cpu")
    for _ in range(2):
        _assert_lists(adj, *dec.decode_to_adjacency_device(LANES))
    assert dec.emit_steady(LANES)
    (fn, starts, ends, rows, nw), = seen
    assert fn == {"last_safe": "node_rows",
                  "greedy": "spread_rows"}[dec._split_rule()]
    assert (nw >= 0).all() and len(nw) == adj.num_nodes
    P = np.concatenate([[0.0], np.cumsum(nw)])
    np.testing.assert_allclose(P[ends] - P[starts],
                               np.where(ends > starts, rows, 0),
                               rtol=1e-12, atol=1e-9)
    np.testing.assert_array_equal(dec._plans[("emit", LANES)]["node_work"],
                                  nw)


def test_emit_steady_follows_the_plan(artifacts, tmp_path, caplog):
    """emit_steady is False until the plan is verified (the first call,
    then the split, refinement and verification of the second) and True
    after it; a plan sent to the sort path is never steady: a window-20
    artifact, or a verified plan marked broken."""
    adj, base = artifacts["serial"]
    dec = TorchGraphDecoder(TorchGraph.load(base), device="cpu")
    seen = [dec.emit_steady(LANES)]
    for _ in range(3):
        _assert_lists(adj, *dec.decode_to_adjacency_device(LANES))
        seen.append(dec.emit_steady(LANES))
    assert seen == [False, False, True, True]
    pl = dec._plans[("emit", LANES)]
    assert pl["verified"] and not pl.get("emit_broken")
    assert not dec.emit_steady(2 * LANES)
    pl["emit_broken"] = "marked broken"
    assert not dec.emit_steady(LANES)

    lists = _rand_lists(60, 3, 6)
    w20 = str(tmp_path / "w20")
    _save(w20, compress_adjacency(Adjacency.from_lists(lists), 20, 3, 2), 1)
    dec = TorchGraphDecoder(TorchGraph.load(w20), device="cpu")
    with caplog.at_level(logging.WARNING, logger=graph_decode.__name__):
        for _ in range(3):
            got = emit_post.to_host_lists(
                *dec.decode_to_adjacency_device(LANES), 60)
            assert [x.tolist() for x in got] == lists
            assert not dec.emit_steady(LANES)
    assert dec._plans[("emit", LANES)]["emit_broken"] == "window 20 > 16"


def test_random_access_enters_at_block_start(artifacts):
    """The native random access of the block-encoded, phase-sampled
    artifact: nodes 92, 136 and 137 lie past an encode-block start that
    falls between them and their sampled node."""
    adj, base = artifacts["blocks4_sampled3"]
    g = TorchGraph.load(base)
    assert list(g.prelude.blocks[0]) == [0, 48, 92, 136]
    lists = adj.to_lists()
    for ef in (True, False):
        got = TorchGraph.load(base, ef_pointers=ef).successors_batch(
            np.array([92, 136, 137], np.uint64)).to_lists()
        assert got == [lists[92], lists[136], lists[137]]


def test_window_over_16_raises(tmp_path, xla_decoder, caplog):
    """The merged-emit kernel serves windows up to 16 and refuses a wider
    one; decode_to_adjacency_device then falls back to the sort path, as
    the reference does, and returns the JAX package's lists."""
    lists = _rand_lists(60, 3, 6)
    base = str(tmp_path / "w20")
    _save(base, compress_adjacency(Adjacency.from_lists(lists), 20, 3, 2), 1)
    dec = TorchGraphDecoder(TorchGraph.load(base), device="cpu")
    with pytest.raises(ValueError, match="window"):
        emit_cuda._launch(dec.tables, torch.zeros((1, 1), dtype=torch.int32),
                          torch.zeros(1, dtype=torch.int64), 20, 2, 8, 8,
                          False)
    with caplog.at_level(logging.WARNING, logger=graph_decode.__name__):
        got = emit_post.to_host_lists(*dec.decode_to_adjacency_device(LANES),
                                      60)
    assert "window 20 > 16" in caplog.text
    jax_lists = emit_post.to_host_lists(*(torch.from_numpy(np.array(a))
                                          for a in TpuGraphDecoder(
        JaxGraph.load(base)).decode_to_adjacency_device(LANES)), 60)
    assert [x.tolist() for x in got] == [x.tolist() for x in jax_lists] \
        == lists


def test_postpass_error_propagates(artifacts, monkeypatch, caplog):
    """A post-pass RuntimeError falls back to the sort path (the lists
    stay exact and the plan stays there), while a kernel's launch error
    still propagates."""
    adj, base = artifacts["serial"]
    dec = TorchGraphDecoder(TorchGraph.load(base), device="cpu")
    real = emit_post.postprocess

    def broken(*args, **kw):
        raise RuntimeError("post-pass failure")

    monkeypatch.setattr(emit_post, "postprocess", broken)
    with caplog.at_level(logging.WARNING, logger=graph_decode.__name__):
        _assert_lists(adj, *dec.decode_to_adjacency_device(LANES))
    assert "post-pass failure" in dec._plans[("emit", LANES)]["emit_broken"]
    assert "sort-path reconstruction" in caplog.text
    monkeypatch.setattr(emit_post, "postprocess", real)
    _assert_lists(adj, *dec.decode_to_adjacency_device(LANES))

    def launch_error(*args, **kw):
        raise KernelError("decode_emit kernel launch (window 7, T 512) "
                          "failed: invalid argument")

    dec = TorchGraphDecoder(TorchGraph.load(base), device="cpu")
    monkeypatch.setattr(graph_decode, "decode_emit", launch_error)
    with pytest.raises(KernelError, match="launch"):
        dec.decode_to_adjacency_device(LANES)
    assert not dec._plans[("emit", LANES)].get("emit_broken")


def test_default_device_needs_cuda(artifacts, monkeypatch):
    _, base = artifacts["serial"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchGraphDecoder(TorchGraph.load(base)).decode_to_adjacency_device()


def _converged_safe(parent, has_ref):
    """(the safe set from each node's chain root, the passes the root loop
    took): ancestor minima resolved forward until no node changes, the
    loop that graph_decode.safe_nodes replaces, as the test's oracle."""
    n = len(parent)
    am = np.arange(n, dtype=np.int64)
    passes = 0
    while True:
        upd = has_ref & (am[parent] < am)
        if not upd.any():
            break
        am = np.where(upd, am[parent], am)
        passes += 1
    sm = np.minimum.accumulate(am[::-1])[::-1]
    safe = np.ones(n, bool)
    safe[1:] = sm[1:] >= np.arange(1, n)
    return safe, passes


def _forest(seed):
    """A seeded reference forest of 3,000 nodes: each node copies one of
    the 16 before it (most often the one just before) or none, with a
    root forced every 700 nodes, so that chains run past 64 deep."""
    rng = np.random.default_rng(seed)
    n = 3000
    x = np.arange(n)
    back = np.where(rng.random(n) < 0.9, 1, rng.integers(1, 17, n))
    parent = np.maximum(x - back, 0)
    has_ref = (rng.random(n) < 0.985) & (x > 0) & (x % 700 != 0)
    return parent, has_ref


SAFE_CASES = {
    # one chain 99 deep (node x copies x - 1): node 0 alone is safe
    "chain99": (np.maximum(np.arange(100) - 1, 0), np.arange(100) > 0,
                np.arange(100) == 0, 99),
    # a root every 10 nodes: every root is safe
    "rooted": (np.maximum(np.arange(100) - 1, 0), np.arange(100) % 10 > 0,
               np.arange(100) % 10 == 0, 9),
    **{f"forest{seed}": (*_forest(seed), None, None) for seed in range(3)},
}


@pytest.mark.parametrize("case", list(SAFE_CASES))
def test_safe_nodes_reports_unconverged_passes(case):
    """The one-pass safe set (a suffix minimum of the reference parents)
    is the converged root loop's, bit for bit, also where that loop needs
    more than the 64 passes the JAX planner runs: on a chain 99 deep, on
    chains with a root every 10 nodes, and on seeded forests whose chains
    pass 64 deep."""
    parent, has_ref, want, want_passes = SAFE_CASES[case]
    exact, passes = _converged_safe(parent, has_ref)
    if want is None:
        assert passes > 64
    else:
        assert passes == want_passes
        np.testing.assert_array_equal(exact, want)
    safe = graph_decode.safe_nodes(parent, has_ref)
    assert safe.dtype == bool
    np.testing.assert_array_equal(safe, exact)