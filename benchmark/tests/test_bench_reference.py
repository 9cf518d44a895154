"""The frozen plain reader and generator give the port's lists (the only
test of the benchmark that imports the port beside them)."""

import os

import numpy as np
import pytest

from benchmark import system
from benchmark.reference import bvgraph_plain, lists, synth_plain

CNR = os.path.join(system.BENCH_DIR, "data", "cnr-2000", "cnr-2000")


def test_plain_bvgraph_reader_matches_the_ports_reader():
    from webgraph_ans_torch.bvgraph.graph import load_bvgraph
    offsets, succs = bvgraph_plain.read_bvgraph(CNR)
    adj, _ = load_bvgraph(CNR)
    assert np.array_equal(offsets, adj.offsets.astype(np.int64))
    assert np.array_equal(succs, adj.succs.astype(np.int32))


@pytest.mark.parametrize("nodes,seed", [(1, 0), (1000, 1), (20000, 7)])
def test_frozen_generator_matches_the_ports(nodes, seed):
    from webgraph_ans_torch.bvgraph.synth import synth_web_graph
    offsets, succs = synth_plain.synth_web_graph(nodes, seed=seed)
    adj = synth_web_graph(nodes, seed=seed)
    assert np.array_equal(offsets, adj.offsets.astype(np.int64))
    assert np.array_equal(succs, adj.succs.astype(np.int32))


def test_graph_lists_by_kind():
    o, s = lists.graph_lists({"kind": "synth", "nodes": 50, "seed": 3},
                             system.BENCH_DIR)
    assert len(o) == 51 and o[-1] == len(s)
    with pytest.raises(ValueError, match="unknown graph kind"):
        lists.graph_lists({"kind": "nope"}, system.BENCH_DIR)


def test_reference_lists_of_another_size_fail(tmp_path):
    from conftest import TINY
    cfg = dict(TINY, arcs=TINY["arcs"] + 1)
    with pytest.raises(ValueError, match="configuration states"):
        system.reference_lists(cfg, system.Cache(str(tmp_path)))
    # and from the cache, once the lists are kept
    system.reference_lists(TINY, system.Cache(str(tmp_path)))
    with pytest.raises(ValueError, match="configuration states"):
        system.reference_lists(cfg, system.Cache(str(tmp_path)), load=False)
