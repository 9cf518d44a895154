"""PyTorch port's successor reconstruction vs the JAX package on the same
tokens, and the port's end-to-end decode (TorchGraphDecoder +
reconstruct, plain PyTorch on the CPU) vs the input graph. Integer
outputs, compared exactly (tolerance 0)."""

import dataclasses

import numpy as np
import pytest

from webgraph_ans_tpu.bvgraph.graph import Adjacency
from webgraph_ans_tpu.bvgraph.random_access import ANSBvGraph as JaxGraph
from webgraph_ans_tpu.bvgraph.store import compress_adjacency
from webgraph_ans_tpu.ops.graph_decode import TpuGraphDecoder
from webgraph_ans_tpu.ops.reconstruct_jax import reconstruct as jax_reconstruct
from webgraph_ans_torch import ANSBvGraph as TorchGraph
from webgraph_ans_torch import TorchGraphDecoder, reconstruct, store
from webgraph_ans_torch.bvgraph.graph import load_bvgraph
import jax_native_build

# the JAX package's native library, built once before any test loads it
jax_native_build.ensure()

CNR = "tests/data/cnr-2000/cnr-2000"


def _structured():
    lists = []
    for i in range(64):
        if i % 4 in (0, 1):
            lists.append(list(range(0, 32)))
        elif i % 4 == 2:
            lists.append([j for j in range(0, 32) if j % 3 != 0])
        else:
            lists.append([1, 5, 50, 63])
    return lists


def _random(n, seed, dmax):
    rng = np.random.default_rng(seed)
    return [sorted(rng.choice(n, size=int(rng.integers(0, dmax)),
                              replace=False).tolist()) for _ in range(n)]


# The graphs of tests/test_tpu_reconstruct.py:
# name -> (lists, window, max_ref, min_interval, lanes)
GRAPHS = {
    "dummy": ([[2, 3], [5], [], [], [0], []], 7, 3, 2, 2),
    "structured": (_structured(), 7, 3, 4, 8),
    "window_zero": ([[1, 2], [0, 2], [0, 1], [3]], 0, 0, 2, 2),
    "no_intervals": ([[1, 2, 3, 4], [1, 2, 3, 4], [0, 4], []], 7, 3, 0, 2),
    "random": (_random(300, 23, 15), 7, 3, 2, 16),
    "deep_ref_chains": ([sorted({1, 3, 5, 7, 9} | {i % 11})
                         for i in range(40)], 7, 10, 2, 4),
}


def _graphs(name):
    lists, w, r, mi, lanes = GRAPHS[name]
    res = compress_adjacency(Adjacency.from_lists(lists), w, r, mi)
    return lists, mi, lanes, res


@pytest.mark.parametrize("name", list(GRAPHS))
def test_reconstruct_matches_jax(name, monkeypatch):
    monkeypatch.setenv("WGT_PALLAS", "0")
    lists, mi, lanes, res = _graphs(name)
    g = JaxGraph(res.prelude, res.states, res.pointers)
    vals, comps = TpuGraphDecoder(g).decode_tokens(num_lanes=lanes)
    off_j, succs_j = jax_reconstruct(vals, comps, len(lists), mi)
    off_t, succs_t = reconstruct(vals, comps, len(lists), mi, device="cpu")
    np.testing.assert_array_equal(off_t, off_j)
    np.testing.assert_array_equal(succs_t, succs_j)
    assert off_t.dtype == np.uint64 and succs_t.dtype == np.uint32


@pytest.mark.parametrize("name", list(GRAPHS))
def test_e2e_torch_decode_matches_input(name):
    lists, mi, lanes, res = _graphs(name)
    g = TorchGraph(res.prelude, res.states, res.pointers)
    vals, comps = TorchGraphDecoder(g, device="cpu").decode_tokens(lanes)
    offsets, succs = reconstruct(vals, comps, g.num_nodes, mi, device="cpu")
    assert Adjacency(offsets, succs).to_lists() == lists


@pytest.mark.parametrize("encode_blocks,step", [(4, 1), (1, 4)])
def test_e2e_torch_decode_block_and_sampled(encode_blocks, step):
    lists = _random(250, 21, 12)
    res = compress_adjacency(Adjacency.from_lists(lists), 7, 3, 2,
                             encode_blocks=encode_blocks)
    prelude, states, pointers = res.prelude, res.states, res.pointers
    if step > 1:
        prelude = dataclasses.replace(prelude, phase_step=step)
        rev_idx = (len(lists) - 1 - np.arange(0, len(lists), step))[::-1]
        states, pointers = states[rev_idx], pointers[rev_idx]
    g = TorchGraph(prelude, np.ascontiguousarray(states),
                   np.ascontiguousarray(pointers))
    vals, comps = TorchGraphDecoder(g, device="cpu").decode_tokens(16)
    offsets, succs = reconstruct(vals, comps, g.num_nodes, 2, device="cpu")
    assert Adjacency(offsets, succs).to_lists() == lists


@pytest.mark.slow
def test_e2e_torch_decode_cnr2000(tmp_path):
    """The README drive through the port, on the CPU: store, load,
    decode at 4096 lanes, reconstruct, compare with the BVGraph input."""
    store(CNR, str(tmp_path / "cnr"))
    g = TorchGraph.load(str(tmp_path / "cnr"))
    vals, comps = TorchGraphDecoder(g, device="cpu").decode_tokens(4096)
    offsets, succs = reconstruct(vals, comps, g.num_nodes,
                                 g.prelude.min_interval_length, device="cpu")
    adj, _ = load_bvgraph(CNR)
    np.testing.assert_array_equal(offsets, adj.offsets)
    np.testing.assert_array_equal(succs, adj.succs)
