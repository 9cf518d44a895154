"""The port's node-range shard decoder (webgraph_ans_torch/parallel/
multihost.py) against the JAX package's MultihostGraphDecoder, in one
process, on the graphs of tests/test_multihost.py: the whole-graph
shard, forced mid-graph shards (the reference closure before the shard),
and the sequence of node ranges the closure decodes on a deep-chain
artifact. Also the closure's error on a corrupt REFERENCE_OFFSET, which
the reference loops on forever (so it is not run there). Tolerance 0."""

import numpy as np
import pytest

from webgraph_ans_tpu.bvgraph.graph import Adjacency
from webgraph_ans_tpu.bvgraph.random_access import ANSBvGraph as JaxGraph
from webgraph_ans_tpu.bvgraph.store import compress_adjacency
from webgraph_ans_tpu.parallel.multihost import (
    MultihostGraphDecoder as JaxMultihost)
from webgraph_ans_torch.ans.prelude import Prelude
from webgraph_ans_torch.ans.pyencoder import (PyANSEncoder, simple_model_for,
                                              tokens_no_reference)
from webgraph_ans_torch.bvgraph.random_access import ANSBvGraph
from webgraph_ans_torch.parallel.multihost import (MultihostGraphDecoder,
                                                   init_distributed)

import jax_native_build

# the JAX package's native library, built once before any test loads it
jax_native_build.ensure()


def _lists(n, seed, dmax):
    rng = np.random.default_rng(seed)
    return [sorted(rng.choice(n, size=int(rng.integers(0, dmax)),
                              replace=False).tolist()) for _ in range(n)]


def _deep_chain():
    """test_shard_closure_deep_chain's graph: 600 near-identical lists,
    every node copying from its predecessor."""
    rng = np.random.default_rng(5)
    base = sorted(rng.choice(5000, size=24, replace=False).tolist())
    return [sorted(set(base) | {5000 + i}) for i in range(600)]


GRAPHS = {
    # name: (lists, compress args, lanes per host, forced shards)
    "std_500": (lambda: _lists(500, 77, 14), ((7, 3, 2), {}), 16,
                [(200, 400), (0, 137), (499, 500)]),
    "blocks8_300": (lambda: _lists(300, 99, 10),
                    ((7, 3, 2), dict(encode_blocks=8)), 3,
                    [(100, 250), (37, 300)]),
    # its mid-graph shard: test_deep_chain_closure_ranges_match_jax
    "deep_chain_600": (_deep_chain, ((16, 2_000_000_000, 4), {}), 8, []),
}


def _pair(name):
    make, (args, kw), lanes, shards = GRAPHS[name]
    lists = make()
    res = compress_adjacency(Adjacency.from_lists(lists), *args, **kw)
    jmh = JaxMultihost(JaxGraph(res.prelude, res.states, res.pointers),
                       lanes_per_host=lanes)
    tmh = MultihostGraphDecoder(ANSBvGraph(res.prelude, res.states,
                                           res.pointers),
                                lanes_per_host=lanes, device="cpu")
    return lists, jmh, tmh, shards


def _record(mh):
    calls = []
    orig = mh._decode_range_tokens
    mh._decode_range_tokens = lambda lo, hi: (calls.append((lo, hi)),
                                              orig(lo, hi))[1]
    return calls


@pytest.mark.parametrize("name", list(GRAPHS))
def test_shards_match_jax(name):
    """The whole-graph shard of one process, then forced mid-graph shards:
    the port's (lo, hi, offsets, succs) equal the JAX package's, and the
    ranges each decodes (the shard, then the closure's) are the same."""
    lists, jmh, tmh, shards = _pair(name)
    assert (tmh.node_lo, tmh.node_hi) == (0, len(lists))
    assert tmh.total_arcs() == jmh.total_arcs() == sum(map(len, lists))
    for lo, hi in [(0, len(lists))] + shards:
        jmh.node_lo, jmh.node_hi = tmh.node_lo, tmh.node_hi = lo, hi
        jcalls, tcalls = _record(jmh), _record(tmh)
        j, t = jmh.decode_shard(), tmh.decode_shard()
        assert t[:2] == j[:2] == (lo, hi)
        assert t[2].dtype == np.uint64 and t[3].dtype == np.uint32
        np.testing.assert_array_equal(t[2], j[2])
        np.testing.assert_array_equal(t[3], j[3])
        assert Adjacency(t[2], t[3]).to_lists() == lists[lo:hi]
        assert tcalls == jcalls
        assert tmh.stats.get("closure_ranges", []) == tcalls[1:]
        del jmh._decode_range_tokens, tmh._decode_range_tokens


def test_deep_chain_closure_ranges_match_jax():
    """The closure before node 500 on the deep-chain artifact doubles its
    range until the chain closes: the same (lo, hi) sequence as the JAX
    package's, in at most 12 ranged decodes."""
    lists, jmh, tmh, _ = _pair("deep_chain_600")
    jmh.node_lo, jmh.node_hi = tmh.node_lo, tmh.node_hi = 500, 600
    jcalls, tcalls = _record(jmh), _record(tmh)
    jmh.decode_shard()
    _, _, off, succs = tmh.decode_shard()
    assert Adjacency(off, succs).to_lists() == lists[500:600]
    assert tcalls == jcalls
    closure = [c for c in tcalls if c[1] == 500]
    assert 1 <= len(closure) <= 12 and closure[-1][0] < 100, closure


def _corrupt_graph():
    """A 12-node graph encoded by the pure-Python encoder with node 2's
    REFERENCE_OFFSET set to 5 (a copy from node -3) and a block count of
    0: the token stream decodes, but its reference points below node 0."""
    lists = _lists(12, 4, 5)
    lists[2] = [0, 7, 9]
    toks = tokens_no_reference(lists, 7, 2)
    starts = [i for i, (c, _) in enumerate(toks) if c == 0]
    at = starts[2] + 1
    assert toks[at] == (1, 0)
    toks[at:at + 1] = [(1, 5), (2, 0)]
    model = simple_model_for(toks)
    enc = PyANSEncoder(model)
    states, pointers = [], []
    for comp, val in reversed(toks):
        enc.encode(val, comp)
        if comp == 0:
            states.append(enc.state)
            pointers.append(len(enc.stream))
    p = Prelude(model=model, stream=np.array(enc.stream, np.uint16),
                state=enc.state, num_nodes=len(lists),
                num_arcs=sum(map(len, lists)), compression_window=7,
                min_interval_length=2)
    return ANSBvGraph(p, np.array(states, np.uint32),
                      np.array(pointers, np.uint64))


def test_closure_raises_on_reference_below_node_zero():
    """The reference's closure never ends on this artifact (its range
    stays at node 0 while the parent stays below it); the port's raises
    ValueError naming the node and the offset."""
    mh = MultihostGraphDecoder(_corrupt_graph(), lanes_per_host=4,
                               device="cpu")
    vals, comps = mh._decode_range_tokens(0, 12)
    assert comps[:6].tolist()[:1] == [0] and 5 in vals[comps == 1].tolist()
    mh.node_lo, mh.node_hi = 3, 12
    with pytest.raises(ValueError, match="node 2 has REFERENCE_OFFSET 5"):
        mh.decode_shard()
    with pytest.raises(ValueError, match="below node 0"):
        mh._closure_before(9)


def test_sampled_artifact_shard_start_must_be_an_entry():
    """Phase-sampled artifacts (every 4th node has a phase): a shard that
    starts off an entry point raises the reference's ValueError; one that
    starts on an entry point decodes its lists (its closure, at window 8,
    starts on the entry point 92)."""
    import dataclasses

    lists = _lists(200, 8, 8)
    res = compress_adjacency(Adjacency.from_lists(lists), 8, 3, 2)
    prelude = dataclasses.replace(res.prelude, phase_step=4)
    rev = (199 - np.arange(0, 200, 4))[::-1]
    states, ptrs = res.states[rev], res.pointers[rev]
    tmh = MultihostGraphDecoder(ANSBvGraph(prelude, states, ptrs), 8,
                                device="cpu")
    jmh = JaxMultihost(JaxGraph(prelude, states, ptrs), 8)
    for mh in (tmh, jmh):
        with pytest.raises(ValueError, match="not a valid entry point"):
            mh._decode_range_tokens(101, 200)
    # the reference indexes its per-node phase arrays by node id here
    # (an IndexError on the sampled arrays), so only the port decodes
    tmh.node_lo, tmh.node_hi = 100, 200
    _, _, off, succs = tmh.decode_shard()
    assert Adjacency(off, succs).to_lists() == lists[100:200]


def test_init_distributed_is_a_noop_for_one_process():
    import torch.distributed as dist

    assert init_distributed() is False
    assert init_distributed(world_size=1) is False
    assert not dist.is_initialized()
