"""The port's merged-emit post-pass (ops/emit_post.py) against the JAX
package's on the same channels: the contract channels that
tools/proto_merged_emit.emit_channels simulates, as the JAX package's own
test_emit_post.py uses them (3000 nodes with dirty nodes; 800 nodes with
every 7th list empty). Everything is integer and compared exactly
(tolerance 0)."""

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
from webgraph_ans_torch.ops import reconstruct_device as trecon
import jax_native_build

# the JAX package's native library, built once before any test loads it
jax_native_build.ensure()

# the JAX post_steady takes the same cached-layout arguments in this order
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
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)).view(np.int32))


@pytest.fixture(scope="module")
def channels():
    from proto_merged_emit import emit_channels

    made = {}
    adj = synth_web_graph(3000, seed=3)
    made["dirty_3000"] = (adj, emit_channels(adj, L=8, T=256))
    adj = _with_empty_nodes(synth_web_graph(800, seed=9))
    made["empty_800"] = (adj, emit_channels(adj, L=4, T=256))
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


NAMES = ("dirty_3000", "empty_800")


def test_fixture_exercises_dirty_nodes(channels):
    assert len(channels["dirty_3000"][1][5]) > 0


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
                           *(mcj[k] for k in STEADY_KEYS))
    st = tpost.post_steady(_t(val), _t(xch), *(mct[k] for k in STEADY_KEYS))
    for a, b in zip(sj, st):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for b, first in zip(st[:2], rt[:2]):
        np.testing.assert_array_equal(b.numpy(), first.numpy())


@pytest.mark.parametrize("name", NAMES)
def test_second_postprocess_uses_cache(channels, both, name):
    """A second postprocess with the filled meta cache takes the fused
    path and gives the same result."""
    adj, (val, xch, nib, lane_of, bounds, _) = channels[name]
    rt, mct = both[name][1], both[name][3]
    again = tpost.postprocess(_t(val), _t(xch), _t(nib), lane_of, bounds,
                              adj.num_nodes, meta_cache=mct)
    for a, b in zip(again[:3], rt[:3]):
        assert torch.equal(a, b)


def test_unpack_nib_matches_jax(channels):
    _, (_, _, nib, _, _, _) = channels["dirty_3000"]
    S = nib.shape[0] * 8
    np.testing.assert_array_equal(
        trecon.unpack_nibbles(_t(nib), S).numpy(),
        np.asarray(jpost.unpack_nib(jnp.asarray(nib), S)))
