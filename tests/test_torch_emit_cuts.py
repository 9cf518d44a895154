"""The merged emit on window-16 artifacts without safe breaks, whose
reference chains run past a lane's target: the planner cuts inside such a
safe gap (emit_split_last with the chains' crossings), the chains it cuts
leave their nodes dirty, and the post-pass's fixup resolves them at any
depth. Plain PyTorch on the CPU, against the input lists and the JAX
package's sort path (its XLA decoder, WGT_PALLAS=0). Plans whose safe
gaps all fit a mean lane keep the bounds of the split at safe nodes
alone. Everything is integer and compared exactly (tolerance 0)."""

import numpy as np
import pytest

from webgraph_ans_tpu.bvgraph.graph import Adjacency
from webgraph_ans_tpu.bvgraph.random_access import ANSBvGraph as JaxGraph
from webgraph_ans_tpu.bvgraph.store import compress_adjacency
from webgraph_ans_tpu.bvgraph.synth import synth_web_graph
from webgraph_ans_tpu.ops.graph_decode import TpuGraphDecoder
from webgraph_ans_torch.bvgraph.random_access import ANSBvGraph as TorchGraph
from webgraph_ans_torch.ops import emit_post, graph_decode
from webgraph_ans_torch.ops.graph_decode import TorchGraphDecoder
from webgraph_ans_torch.utils import trace
import jax_native_build

# the JAX package's native library, built once before any test loads it
jax_native_build.ensure()

HC = (16, 2_000_000_000, 4)


def _random(n, seed, dmax):
    rng = np.random.default_rng(seed)
    return [sorted(rng.choice(n, size=int(rng.integers(0, dmax)),
                              replace=False).tolist()) for _ in range(n)]


def _chain(n, d):
    """n equal lists: every node copies the one before, a chain n - 1
    deep under unbounded reference counts."""
    return [list(range(0, 3 * d, 3))] * n


# name -> (lists, lanes): the sort-path tests' window-16 artifact without
# safe breaks (a 30-node chain), and a 600-node chain between random
# nodes, one safe gap longer than any lane's target at 8 and 16 lanes
CHAIN600 = _random(100, 5, 8) + _chain(600, 4) + _random(100, 6, 8)
CASES = {"w16_no_breaks": (_random(100, 4, 8) + _chain(30, 4), 8),
         "chain600_8": (CHAIN600, 8), "chain600_16": (CHAIN600, 16)}


@pytest.fixture(scope="module")
def results():
    made = {}
    for name, (lists, _) in CASES.items():
        made[name] = compress_adjacency(Adjacency.from_lists(lists), *HC)
    return made


@pytest.fixture()
def xla_decoder(monkeypatch):
    monkeypatch.setenv("WGT_PALLAS", "0")


def _torch_dec(res):
    return TorchGraphDecoder(TorchGraph(res.prelude, res.states,
                                        res.pointers), device="cpu")


@pytest.mark.parametrize("name", list(CASES))
def test_break_free_chains_reach_the_steady_merged_emit(results, name,
                                                        xla_decoder):
    """Five calls, through the plan into its steady state, each returning
    the input lists, which are the JAX package's; nothing falls back to
    the sort path. On the 600-node chain, whose safe gap passes
    CUT_GAP_LANES mean lanes, every split's target is shorter than that
    gap, the verified plan cuts inside it (unsafe_cuts) with no empty
    lane, and the fixup finishes a dirty chain past the 192 rounds the
    post-pass once took."""
    lists, lanes = CASES[name]
    res = results[name]
    dec = _torch_dec(res)
    mark = max((s.id for s in trace.stages()), default=0)
    for _ in range(5):
        got = emit_post.to_host_lists(*dec.decode_to_adjacency_device(lanes),
                                      len(lists))
        assert [x.tolist() for x in got] == lists
    pl = dec._plans[("emit", lanes)]
    assert dec.emit_steady(lanes) and not pl.get("emit_broken")
    stages = [s for s in trace.stages() if s.id > mark]
    assert not [s for s in stages if s.name == "plan.fallback"]
    (verify,) = [s for s in stages if s.name == "plan.verify"]
    cut = pl["cross_np"] is not None
    assert cut == name.startswith("chain600")
    if cut:
        cost = np.asarray(pl["node_work"])
        gap = graph_decode.safe_gaps(cost, pl["safe_np"]).max()
        splits = [s for s in stages if s.name == "emit.split"]
        assert all(s.attrs["target"] < gap for s in splits)
        assert verify.attrs["unsafe_cuts"] > 0
        assert verify.attrs["empty_lanes"] == 0
        assert verify.attrs["dirty_elements"] > verify.attrs["dirty_nodes"]
        assert 0 < verify.attrs["two_run_rows"] <= verify.attrs["dirty_nodes"]
        assert verify.attrs["fixup_rounds"] > 192
    off, succs, E = TpuGraphDecoder(JaxGraph(
        res.prelude, res.states, res.pointers)).decode_to_csr_device(
            num_lanes=lanes)
    off, succs = np.asarray(off), np.asarray(succs)
    assert [succs[off[x]:off[x + 1]].tolist()
            for x in range(len(lists))] == lists


def _gap_case(seed: int, gap_nodes: int):
    """Split inputs of a seeded 600-node graph (elements + 2 a node, no
    halo) whose references cross at most 4 bounds a node; safe nodes at
    random, but for four unsafe stretches of gap_nodes nodes."""
    rng = np.random.default_rng(seed)
    n = 600
    degs = np.minimum(rng.zipf(1.6, n), 60).astype(np.int64)
    cost = degs + 2.0
    safe = rng.random(n) < 0.4
    safe[0] = True
    for a in rng.integers(1, n - gap_nodes, 4):
        safe[a:a + gap_nodes] = False
    cross = np.where(safe, 0, rng.integers(1, 5, n)).astype(np.int32)
    return cost, np.zeros(n + 1), safe, cross, degs


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("lanes", [4, 16, 64])
def test_split_cuts_inside_gaps_longer_than_the_target(seed, lanes):
    """At every target of the planner's bisection: no lane passes the
    target; a bound away from a safe node lies in a safe gap longer than
    the target, fills its lane to CUT_FILL of the target (but where the
    next node alone passes it) and is crossed by the fewest chains of the
    unsafe bounds after the lane's last safe node that do; where every gap
    fits the target the bounds are those of the split at safe nodes
    alone. Bisected, the longest lane is no longer than that split's."""
    cost, halo, safe, cross, degs = _gap_case(seed, 120)
    gap = graph_decode.safe_gaps(cost, safe)
    P = np.concatenate([[0.0], np.cumsum(cost)])
    n = len(cost)
    lo = float(P[-1]) / lanes
    hi = lo * 8 + float(degs.max()) + 4096
    targets = []
    for _ in range(40):
        mid = (lo + hi) / 2
        targets.append(mid)
        if graph_decode.emit_split_last(cost, halo, safe, lanes, mid,
                                        cross=cross, gap=gap) is None:
            lo = mid
        else:
            hi = mid
    fill = graph_decode.CUT_FILL
    for t in targets + [hi]:
        got = graph_decode.emit_split_last(cost, halo, safe, lanes, t,
                                           cross=cross, gap=gap)
        if gap.max() <= t:
            plain = graph_decode.emit_split_last(cost, halo, safe, lanes, t)
            assert (got is None) == (plain is None)
            if got is not None:
                np.testing.assert_array_equal(got, plain)
        if got is None:
            continue
        for a, b in zip(got[:-1], got[1:]):
            if b <= a:
                continue
            assert P[b] - P[a] <= t
            if b == n or safe[b]:
                continue
            assert gap[b] > t
            last = max([a] + [x for x in range(a + 1, b) if safe[x]])
            cand = [x for x in range(last + 1, n)
                    if P[x] - P[a] <= t and P[x] - P[a] >= fill * t]
            if P[b + 1] - P[a] <= t or not cand:
                continue
            assert b in cand
            assert cross[b] == min(cross[x] for x in cand)
    _, bounds = graph_decode.min_max_split(
        lambda t: graph_decode.emit_split_last(cost, halo, safe, lanes, t,
                                               cross=cross, gap=gap),
        float(P[-1]) / lanes, float(P[-1]) / lanes * 8 + degs.max() + 4096)
    _, plain = graph_decode.min_max_split(
        lambda t: graph_decode.emit_split_last(cost, halo, safe, lanes, t),
        float(P[-1]) / lanes, float(P[-1]) / lanes * 8 + degs.max() + 4096)
    assert (graph_decode.lane_costs(cost, halo, bounds).max()
            <= graph_decode.lane_costs(cost, halo, plain).max())


@pytest.mark.parametrize("lanes", [2, 4, 8, 16])
def test_safe_break_plans_keep_their_bounds(lanes):
    """A window-16 artifact with safe breaks every 32 nodes, whose longest
    safe gap stays within CUT_GAP_LANES mean lanes (1.9 of them at 16
    lanes): no lane is cut inside a gap. The first call moves every
    stream-balanced start back to its safe node, and the rebalanced and
    refined plans are the bisected split at safe nodes alone, bound for
    bound."""
    adj = synth_web_graph(300, seed=13)
    res = compress_adjacency(adj, *HC, safe_break_interval=32)
    dec = _torch_dec(res)
    starts, _ = dec._block_bounds(lanes)
    first, _ = dec._emit_bounds(lanes)
    pl = dec._plans[("emit", lanes)]
    safe, n = pl["safe_np"], dec.num_nodes
    degs = np.diff(adj.offsets.astype(np.int64))
    gap = graph_decode.safe_gaps(degs + 2.0, safe).max()
    assert gap <= dec.CUT_GAP_LANES * (degs + 2.0).sum() / lanes
    assert pl["cross_np"] is None
    sn = np.flatnonzero(safe)
    old = np.unique(sn[np.searchsorted(sn, starts, side="right") - 1])
    np.testing.assert_array_equal(
        first, np.concatenate([old, np.full(len(starts) - len(old), n)]))
    for work in (degs + 2.0, degs + 2.5 + np.arange(n) % 3):
        for k in ("bounds", "regs", "cap"):
            pl.pop(k, None)
        pl.update(degs_np=degs, node_work=work)
        got, _ = dec._emit_bounds(lanes)
        # the planner's costs: the steps between prefix sums
        P = np.concatenate([[0.0], np.cumsum(work)])
        cost, halo = np.diff(P), np.zeros(n + 1)
        _, want = graph_decode.min_max_split(
            lambda t: graph_decode.emit_split_last(cost, halo, safe, lanes,
                                                   t),
            float(P[-1]) / lanes, float(P[-1]) / lanes * 8 + degs.max()
            + 4096)
        np.testing.assert_array_equal(got, want[:-1])


@pytest.mark.parametrize("seed", [0, 1])
def test_chain_crossings_count_the_links_a_bound_cuts(seed):
    """chain_crossings: at each x, the nodes y >= x with a reference whose
    parent is below x (counted one by one); safe_nodes is where it is 0;
    unsafe_cuts counts the distinct inner bounds where it is not."""
    rng = np.random.default_rng(seed)
    n = 400
    ids = np.arange(n)
    has_ref = rng.random(n) < 0.6
    has_ref[0] = False
    parent = np.where(has_ref, ids - rng.integers(1, 40, n), ids)
    parent = np.maximum(parent, 0)
    has_ref &= parent < ids
    cross = graph_decode.chain_crossings(parent, has_ref)
    want = [int(np.sum(has_ref[x:] & (parent[x:] < x))) for x in range(n)]
    np.testing.assert_array_equal(cross, want)
    safe = graph_decode.safe_nodes(parent, has_ref)
    np.testing.assert_array_equal(safe, cross == 0)
    bounds = np.array([0, 5, 5, 17, 90, 90, 233, n])
    inner = np.unique(bounds[(bounds > 0) & (bounds < n)])
    assert graph_decode.unsafe_cuts(bounds, safe) == int((~safe[inner]).sum())
    assert graph_decode.unsafe_cuts(bounds, None) == 0
