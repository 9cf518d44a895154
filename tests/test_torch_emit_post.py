"""The port's merged-emit post-pass (ops/emit_post.py) against the JAX
package's on the same channels: the contract channels that
tools/proto_merged_emit.emit_channels simulates, as the JAX package's own
test_emit_post.py uses them (3000 nodes with dirty nodes; 800 nodes with
every 7th list empty), and the same 3000 nodes at window 16 with unbounded
references, whose dirty chains run dozens of fixup rounds deep. Every
call's fixup is the fixup kernel's plain version (ops/fixup_cuda.py) over
the node layout, held on each to the JAX package's rounds (its
post_steady). Everything is integer and compared exactly (tolerance 0)."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from webgraph_ans_tpu.bvgraph.graph import Adjacency
from webgraph_ans_tpu.bvgraph.synth import synth_web_graph
from webgraph_ans_tpu.ops import emit_post as jpost
from webgraph_ans_tpu.ops.reconstruct_device import _quant as jquant
from webgraph_ans_torch.ops import emit_post as tpost
from webgraph_ans_torch.ops import fixup_cuda
from webgraph_ans_torch.ops import reconstruct_device as trecon
from webgraph_ans_torch.utils import trace
import jax_native_build

# the JAX package's native library, built once before any test loads it
jax_native_build.ensure()

# the JAX post_steady's cached-layout arguments, in order: the marker
# layout and the per-slot arrays of its round-by-round fixup
JAX_STEADY_KEYS = ("lane_of_d", "mrow_d", "kind_d", "starts_flat_d",
                   "fx_rowf", "fx_valid", "fx_ispl", "fx_pd", "fx_elmask",
                   "fx_srcF", "fx_srcC", "fx_sortn", "fx_dst", "fx_destF",
                   "fx_offs", "Dall")
STEADY_KEYS = tpost.STEADY_KEYS


def _with_empty_nodes(base: Adjacency, every: int = 7) -> Adjacency:
    offs = base.offsets.astype(np.int64)
    keep = np.ones(len(base.succs), bool)
    new_offs = [0]
    for x in range(base.num_nodes):
        a, b = offs[x], offs[x + 1]
        if x % every == 3:
            keep[a:b] = False
            new_offs.append(new_offs[-1])
        else:
            new_offs.append(new_offs[-1] + (b - a))
    return Adjacency(np.array(new_offs, np.uint64), base.succs[keep])


def _t(a) -> torch.Tensor:
    """A fresh int32 tensor of a's bit patterns (the steady fixup patches
    its val in place, so no test shares the fixtures' memory)."""
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(a)).view(np.int32)).clone()


@pytest.fixture(scope="module")
def channels():
    from proto_merged_emit import emit_channels

    made = {}
    adj = synth_web_graph(3000, seed=3)
    made["dirty_3000"] = (adj, emit_channels(adj, L=8, T=256))
    adj = _with_empty_nodes(synth_web_graph(800, seed=9))
    made["empty_800"] = (adj, emit_channels(adj, L=4, T=256))
    adj = synth_web_graph(3000, seed=3)
    made["deep_3000"] = (adj, emit_channels(adj, W=16, MR=2_000_000_000,
                                            MI=4, L=8, T=256))
    return made


@pytest.fixture(scope="module")
def both(channels):
    """Each fixture through both post-passes, with their meta caches."""
    out = {}
    for name, (adj, (val, xch, nib, lane_of, bounds, _)) in channels.items():
        n = adj.num_nodes
        mcj, mct = {}, {}
        rj = jpost.postprocess(jnp.asarray(val), jnp.asarray(xch),
                               jnp.asarray(nib), lane_of, bounds, n,
                               meta_cache=mcj)
        rt = tpost.postprocess(_t(val), _t(xch), _t(nib), lane_of, bounds, n,
                               meta_cache=mct)
        out[name] = (rj, rt, mcj, mct)
    return out


NAMES = ("dirty_3000", "empty_800", "deep_3000")


def test_fixture_exercises_dirty_nodes(channels):
    assert len(channels["dirty_3000"][1][5]) > 0


def test_deep_fixture_runs_many_rounds(both):
    """The window-16 fixture's dirty chains take at least 8 rounds."""
    assert both["deep_3000"][3]["rounds"] >= 8


@pytest.mark.parametrize("name", NAMES)
def test_postprocess_matches_jax(both, name):
    (sj, stj, dj, _), (st, stt, dt, tt), _, _ = both[name]
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(stt.numpy(), np.asarray(stj))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    assert bool(tt["ok"])


@pytest.mark.parametrize("name", NAMES)
def test_node_tables_match_jax(both, name):
    (_, _, _, tj), (_, _, _, tt), _, _ = both[name]
    for key in ("start_el", "deg", "kind", "ref", "cause", "span", "rank_at",
                "mrow"):
        np.testing.assert_array_equal(tt[key].numpy(), np.asarray(tj[key]),
                                      err_msg=key)


@pytest.mark.parametrize("name", NAMES)
def test_postprocess_gives_input_lists(channels, both, name):
    adj = channels[name][0]
    st, stt, dt, _ = both[name][1]
    offs = adj.offsets.astype(np.int64)
    np.testing.assert_array_equal(dt.numpy(), np.diff(offs))
    lists = tpost.to_host_lists(st, stt, dt, adj.num_nodes)
    for x in range(adj.num_nodes):
        np.testing.assert_array_equal(lists[x].astype(np.uint32),
                                      adj.succs[offs[x]:offs[x + 1]],
                                      err_msg=f"node {x}")


@pytest.mark.parametrize("name", NAMES)
def test_dense_csr_matches_jax(channels, both, name):
    adj = channels[name][0]
    (sj, stj, dj, _), (st, stt, dt, _), _, _ = both[name]
    E = jquant(int(adj.num_arcs))
    assert trecon._quant(int(adj.num_arcs)) == E
    oj, cj = jpost.to_dense_csr(sj, stj, dj, E)
    ot, ct = tpost.to_dense_csr(st, stt, dt, E)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(ct.numpy()[:adj.num_arcs].astype(np.uint32),
                                  adj.succs)
    np.testing.assert_array_equal(ot.numpy()[:adj.num_nodes + 1],
                                  adj.offsets.astype(np.int64))


@pytest.mark.parametrize("name", NAMES)
def test_post_steady_matches_jax(channels, both, name):
    """The cached-layout steady state, on the same channels, equals the
    JAX package's, and its adjacency the first call's. (Its degrees come
    from xch, which carries outdegrees only from a mark_deg kernel run;
    these channels carry node ids there.)"""
    _, (val, xch, _, _, _, _) = channels[name]
    _, rt, mcj, mct = both[name]
    assert set(STEADY_KEYS) <= set(mct)
    sj = jpost.post_steady(jnp.asarray(val), jnp.asarray(xch),
                           *(mcj[k] for k in JAX_STEADY_KEYS))
    st = tpost.post_steady(_t(val), _t(xch), *(mct[k] for k in STEADY_KEYS))
    for a, b in zip(sj, st):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for b, first in zip(st[:2], rt[:2]):
        np.testing.assert_array_equal(b.numpy(), first.numpy())


@pytest.mark.parametrize("name", NAMES)
def test_fixup_kernel_plain_matches_rounds(channels, both, name):
    """The fixup kernel's plain version, node by node over the cached node
    layout, gives the channel of the JAX package's rounds (its
    post_steady: a gather, a sort and a scatter a chain level)."""
    _, (val, xch, _, _, _, _) = channels[name]
    _, _, mcj, mct = both[name]
    sj = jpost.post_steady(jnp.asarray(val), jnp.asarray(xch),
                           *(mcj[k] for k in JAX_STEADY_KEYS))[0]
    got = fixup_cuda.emit_fixup_plain(_t(val), mct["fx_nodes"],
                                      mct["fx_srcs"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(sj))


def test_post_steady_on_cpu_takes_the_plain_path(channels, both):
    """CPU tensors run the plain version: no kernel is built, loaded or
    counted (the module imports without nvcc or a card); a device other
    than cpu or cuda is refused."""
    _, (val, xch, _, _, _, _) = channels["deep_3000"]
    mct = both["deep_3000"][3]
    launches = fixup_cuda.emit_fixup.launches
    counted = trace.counters().get("fixup_kernel_launches", 0)
    tpost.post_steady(_t(val), _t(xch), *(mct[k] for k in STEADY_KEYS))
    fixup_cuda.emit_fixup(_t(val), mct["fx_nodes"], mct["fx_srcs"])
    assert fixup_cuda.emit_fixup.launches == launches
    assert trace.counters().get("fixup_kernel_launches", 0) == counted
    assert fixup_cuda._lib is None
    with pytest.raises(ValueError, match="cuda or cpu"):
        fixup_cuda.emit_fixup(torch.empty((8, 2), dtype=torch.int32,
                                          device="meta"),
                              mct["fx_nodes"], mct["fx_srcs"])


@pytest.mark.parametrize("name", NAMES)
def test_second_postprocess_uses_cache(channels, both, name):
    """A second postprocess with the filled meta cache reuses its node
    layout (no new one is built) and gives the same result."""
    adj, (val, xch, nib, lane_of, bounds, _) = channels[name]
    rt, mct = both[name][1], both[name][3]
    nodes = mct["fx_nodes"]
    again = tpost.postprocess(_t(val), _t(xch), _t(nib), lane_of, bounds,
                              adj.num_nodes, meta_cache=mct)
    assert mct["fx_nodes"] is nodes
    for a, b in zip(again[:3], rt[:3]):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def clean_channels():
    """300 nodes in one lane with a 4096-row ring: every copy source is
    still in the ring, so no node is dirty."""
    from proto_merged_emit import emit_channels

    adj = synth_web_graph(300, seed=5)
    return adj, emit_channels(adj, L=1, T=4096)


@pytest.mark.parametrize("name", ["dirty_3000", "deep_3000", "clean_300"])
def test_first_postprocess_runs_the_fixup_once(channels, clean_channels,
                                               name, monkeypatch):
    """A plan's first postprocess finishes its dirty nodes through
    emit_fixup over the node layout it has just built: one call, over
    every dirty node, where nodes are dirty; none where none is. The lists
    are the input's either way."""
    adj, (val, xch, nib, lane_of, bounds, dirty) = (
        clean_channels if name == "clean_300" else channels[name])
    assert bool(dirty) == (name != "clean_300")
    real, calls = tpost.emit_fixup, []

    def spy(v, nodes, srcs):
        calls.append(nodes.shape[0])
        return real(v, nodes, srcs)

    monkeypatch.setattr(tpost, "emit_fixup", spy)
    mc = {}
    out = tpost.postprocess(_t(val), _t(xch), _t(nib), lane_of, bounds,
                            adj.num_nodes, meta_cache=mc)
    assert calls == ([len(dirty)] if dirty else [])
    assert len(mc["order_np"]) == len(dirty)
    offs = adj.offsets.astype(np.int64)
    lists = tpost.to_host_lists(*out[:3], adj.num_nodes)
    for x in range(adj.num_nodes):
        np.testing.assert_array_equal(lists[x].astype(np.uint32),
                                      adj.succs[offs[x]:offs[x + 1]],
                                      err_msg=f"node {x}")


def test_unpack_nib_matches_jax(channels):
    _, (_, _, nib, _, _, _) = channels["dirty_3000"]
    S = nib.shape[0] * 8
    np.testing.assert_array_equal(
        trecon.unpack_nibbles(_t(nib), S).numpy(),
        np.asarray(jpost.unpack_nib(jnp.asarray(nib), S)))


def test_dirty_chains_at_any_depth():
    """_dirty_chains on a parent array 10,000 deep: one dirty chain of
    10,000 nodes, each referencing the node before, among seeded nodes
    that reference up to 50 back and are dirty, clean or empty at random.
    Its depths are the one-pass recurrence in node order (dirty: 1 + the
    parent's depth, clean 0), its rounds their maximum, and its order the
    dirty nodes by (depth, node); no bound on the depth."""
    rng = np.random.default_rng(11)
    n = 12_000
    ids = np.arange(n)
    ref = np.minimum(rng.integers(0, 50, n), ids).astype(np.int32)
    kind = rng.integers(0, 3, n).astype(np.int32)
    chain = np.arange(1_000, 11_000)
    ref[chain] = 1
    ref[chain[0]] = 0
    kind[chain] = 1
    mc = {}
    tpost._dirty_chains(mc, {"kind": torch.from_numpy(kind),
                             "ref": torch.from_numpy(ref)}, n)
    want = np.zeros(n, np.int64)
    for x in range(n):
        if kind[x] == 1:
            want[x] = 1 + (want[x - ref[x]] if ref[x] > 0 else 0)
    np.testing.assert_array_equal(mc["ddep"], want)
    assert mc["rounds"] == want.max() >= 10_000
    dirty = np.flatnonzero(kind == 1)
    order = sorted(dirty.tolist(), key=lambda x: (want[x], x))
    np.testing.assert_array_equal(mc["order_np"], order)
    np.testing.assert_array_equal(mc["parent"], np.maximum(ids - ref, 0))


def test_fixup_plain_resolves_a_path_5000_deep():
    """emit_fixup_plain on a layout whose one path runs 5,000 levels deep
    (each node copying from the row before), with one-node paths that wait
    on rows of it: every row's list is the one resolved level by level."""
    from deep_layout import deep_path_layout, resolved

    val, nodes, srcs, lists = deep_path_layout(5_000)
    want = resolved(val, nodes, lists)
    got = fixup_cuda.emit_fixup_plain(val.clone(), nodes, srcs)
    assert torch.equal(got, want)


def _check_two_run_form(path_nodes, path_srcs, nodes, srcs, rows):
    """The two-run form of a path layout: the same rows; each row's
    sources, ~j first in ascending j, then the others in their order;
    column 5 the row's copies where it takes the kernel's two-run step (at
    most 64 elements that read a parent or copy nothing), else -1; `rows`
    those rows."""
    pn, ps = np.asarray(path_nodes, np.int64), np.asarray(path_srcs)
    nodes, srcs = np.asarray(nodes, np.int64), np.asarray(srcs)
    np.testing.assert_array_equal(nodes[:, :5], pn[:, :5])
    taking = 0
    for q, (e, d, _, link, _) in enumerate(pn[:, :5].tolist()):
        before = ps[e:e + d]
        j = ~before[before < 0]
        np.testing.assert_array_equal(
            srcs[e:e + d], np.concatenate([~np.sort(j), before[before >= 0]]),
            err_msg=f"row {q}")
        takes = d <= 64 and (link != -1 or len(j) == 0)
        assert nodes[q, 5] == (len(j) if takes else -1), q
        taking += takes
    assert rows == taking


def _plain(val, nodes, srcs):
    return fixup_cuda.emit_fixup_plain(
        val.clone(), torch.from_numpy(np.ascontiguousarray(nodes, np.int32)),
        torch.from_numpy(np.ascontiguousarray(srcs, np.int32)))


@pytest.mark.parametrize("name", ["dirty_3000", "deep_3000"])
def test_node_layout_takes_the_two_run_form(channels, name, monkeypatch):
    """The node layout a plan's first postprocess caches is its path
    layout in the two-run form, with the count of two-run rows beside it;
    the plain fixup gives the same val on both."""
    adj, (val, xch, nib, lane_of, bounds, _) = channels[name]
    real, seen = tpost.two_run_layout, []

    def spy(nodes, srcs):
        seen.append((nodes, srcs))
        return real(nodes, srcs)

    monkeypatch.setattr(tpost, "two_run_layout", spy)
    mc = {}
    tpost.postprocess(_t(val), _t(xch), _t(nib), lane_of, bounds,
                      adj.num_nodes, meta_cache=mc)
    (path_nodes, path_srcs), = seen
    nodes, srcs = mc["fx_nodes"].numpy(), mc["fx_srcs"].numpy()
    _check_two_run_form(path_nodes, path_srcs, nodes, srcs,
                        mc["two_run_rows"])
    assert 0 < mc["two_run_rows"] <= len(nodes)
    mixed = (nodes[:, 5] > 0) & (nodes[:, 5] < nodes[:, 1])
    assert mixed.any()   # rows that merge copies with known values
    np.testing.assert_array_equal(_plain(_t(val), nodes, srcs).numpy(),
                                  _plain(_t(val), path_nodes,
                                         path_srcs).numpy())


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_two_run_form_of_seeded_chains(seed):
    """_node_layout on seeded dirty chains whose placeholders come out of
    order, among holes, with ties (tests/deep_layout.py seeded_chains):
    its two-run form, and the same val from the plain fixup on both."""
    from deep_layout import seeded_chains

    args, val = seeded_chains(seed)
    path_nodes, path_srcs = tpost._node_layout(*args)
    nodes, srcs, rows = tpost.two_run_layout(path_nodes, path_srcs)
    _check_two_run_form(path_nodes, path_srcs, nodes, srcs, rows)
    assert (nodes[:, 5] == -1).any() and rows > 0
    want = _plain(val, path_nodes, path_srcs)
    assert torch.equal(_plain(val, nodes, srcs), want)
    assert not torch.equal(want, val)


def test_two_run_form_of_a_path_5000_deep():
    """The path 5,000 levels deep in the two-run form: every row takes the
    two-run step, those of the long path and the one-node paths that read
    its rows; the plain fixup resolves it level by level."""
    from deep_layout import deep_path_layout, resolved

    val, path_nodes, path_srcs, lists = deep_path_layout(5_000)
    nodes, srcs, rows = tpost.two_run_layout(path_nodes, path_srcs)
    _check_two_run_form(path_nodes, path_srcs, nodes, srcs, rows)
    assert rows == len(nodes) == 5_020
    assert torch.equal(_plain(val, nodes, srcs),
                       resolved(val, path_nodes, lists))
