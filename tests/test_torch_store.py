"""The PyTorch port's host layers (its own copy of the native runtime,
model search, prelude and store) write the same bytes as the JAX package,
and its loader reads JAX-written artifacts identically."""

import dataclasses

import numpy as np
import pytest

import webgraph_ans_tpu.ans.prelude as jprelude
import webgraph_ans_tpu.bvgraph.store as jstore
import webgraph_ans_torch.ans.prelude as tprelude
import webgraph_ans_torch.bvgraph.store as tstore
from webgraph_ans_tpu.bvgraph.graph import Adjacency as JaxAdjacency
from webgraph_ans_tpu.bvgraph.random_access import ANSBvGraph as JaxGraph
from webgraph_ans_torch.bvgraph.graph import Adjacency as TorchAdjacency
from webgraph_ans_torch.bvgraph.graph import load_bvgraph
from webgraph_ans_torch.bvgraph.random_access import ANSBvGraph as TorchGraph
import jax_native_build

# the JAX package's native library, built once before any test loads it
jax_native_build.ensure()

CNR = "tests/data/cnr-2000/cnr-2000"
EXTS = (".ans", ".states", ".pointers")


def _lists(n, seed, dmax):
    rng = np.random.default_rng(seed)
    return [sorted(rng.choice(n, size=int(rng.integers(0, dmax)),
                              replace=False).tolist()) for _ in range(n)]


def _write(prelude_mod, res, base, step=1):
    prelude, states, pointers = res.prelude, res.states, res.pointers
    if step > 1:
        prelude = dataclasses.replace(prelude, phase_step=step)
        n = prelude.num_nodes
        rev_idx = (n - 1 - np.arange(0, n, step))[::-1]
        states, pointers = states[rev_idx], pointers[rev_idx]
    prelude.save(base)
    prelude_mod.save_states(base, np.ascontiguousarray(states))
    prelude_mod.save_pointers(base, np.ascontiguousarray(pointers))


def _same_bytes(a, b):
    for ext in EXTS:
        with open(a + ext, "rb") as fa, open(b + ext, "rb") as fb:
            assert fa.read() == fb.read(), ext


# (n, seed, dmax, window, max_ref, min_interval, phase_step)
SMALL = {
    "serial": (200, 3, 12, 7, 3, 2, 1),
    "window0_no_intervals": (150, 4, 10, 0, 0, 0, 1),
    "deep_refs_sampled": (160, 9, 10, 16, 2_000_000_000, 4, 3),
}


@pytest.mark.parametrize("name", list(SMALL))
def test_store_bytes_match_jax_small(tmp_path, name):
    n, seed, dmax, w, r, mi, step = SMALL[name]
    lists = _lists(n, seed, dmax)
    jres = jstore.compress_adjacency(JaxAdjacency.from_lists(lists), w, r, mi)
    tres = tstore.compress_adjacency(TorchAdjacency.from_lists(lists), w, r,
                                     mi)
    _write(jprelude, jres, str(tmp_path / "jax"), step)
    _write(tprelude, tres, str(tmp_path / "torch"), step)
    _same_bytes(str(tmp_path / "jax"), str(tmp_path / "torch"))


def test_store_bytes_match_jax_cnr2000(tmp_path):
    jstore.store(CNR, str(tmp_path / "jax"))
    tstore.store(CNR, str(tmp_path / "torch"))
    _same_bytes(str(tmp_path / "jax"), str(tmp_path / "torch"))


@pytest.mark.parametrize("encode_blocks,step", [(1, 1), (4, 1), (4, 3)])
def test_loader_reads_jax_artifacts(tmp_path, encode_blocks, step):
    """Serial, block-encoded (written by the JAX device encoder) and
    phase-sampled artifacts."""
    lists = _lists(180, 17, 11)
    res = jstore.compress_adjacency(JaxAdjacency.from_lists(lists), 7, 3, 2,
                                    encode_blocks=encode_blocks)
    base = str(tmp_path / "g")
    _write(jprelude, res, base, step)
    jg, tg = JaxGraph.load(base), TorchGraph.load(base)
    np.testing.assert_array_equal(tg.states, jg.states)
    np.testing.assert_array_equal(tg.pointers, jg.pointers)
    np.testing.assert_array_equal(tg.prelude.stream, jg.prelude.stream)
    assert (tg.prelude.to_bytes() == jg.prelude.to_bytes())
    assert tg.prelude.phase_step == step
    assert (tg.prelude.blocks is None) == (encode_blocks == 1)
    q = np.arange(len(lists), dtype=np.uint64)
    got = tg.successors_batch(q).to_lists()
    assert got == lists
    if encode_blocks == 1 or step == 1:
        # block-encoded and phase-sampled artifacts are held against the
        # input graph only (ROADMAP §3: the reference's random access
        # there skip-decodes across encode-block starts)
        assert got == jg.successors_batch(q).to_lists()


def test_port_load_bvgraph_matches_input():
    adj, props = load_bvgraph(CNR)
    assert adj.num_nodes == props.nodes == 325557
    assert adj.num_arcs == props.arcs == 3216152
