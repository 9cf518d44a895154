"""The port's device model search (ops/model_torch.py, run here on the CPU)
must select the identical model to the host builder and to the JAX
package's device search (same frames, params and scaled frequencies), on
the cases of tests/test_model_jax.py."""

import numpy as np
import pytest

from webgraph_ans_tpu.ans.model import build_model
from webgraph_ans_tpu.bvgraph import estimators
from webgraph_ans_tpu.bvgraph.graph import Adjacency
from webgraph_ans_tpu.bvgraph.store import _run_histogram_pass
from webgraph_ans_tpu.ops.model_jax import build_model_jax
from webgraph_ans_torch.ops.model_torch import build_model_torch

from conftest import zipf_symbols
import jax_native_build

# the JAX package's native library, built once before any test loads it
jax_native_build.ensure()


def _hist_from_sequences(seqs):
    hists = []
    for comp in range(9):
        if comp in seqs and len(seqs[comp]):
            s, c = np.unique(np.asarray(seqs[comp], np.uint64),
                             return_counts=True)
            hists.append((s.astype(np.uint64), c.astype(np.uint64)))
        else:
            hists.append((np.zeros(0, np.uint64), np.zeros(0, np.uint64)))
    return hists


def _assert_models_equal(a, b):
    for i, (ca, cb) in enumerate(zip(a.components, b.components)):
        assert (ca.log_m, ca.radix, ca.fidelity) == \
            (cb.log_m, cb.radix, cb.fidelity), f"component {i} params differ"
        assert ca.freqs.dtype == cb.freqs.dtype
        np.testing.assert_array_equal(ca.freqs, cb.freqs,
                                      err_msg=f"component {i} freqs differ")


def _check(hists, max_frame_log2=16):
    got = build_model_torch(hists, max_frame_log2, device="cpu")
    _assert_models_equal(build_model(hists, max_frame_log2), got)
    _assert_models_equal(build_model_jax(hists, max_frame_log2), got)


def _graph_hists(adj):
    return _run_histogram_pass(adj, 7, 3, 2, estimators.LOG2,
                               estimators.empty_tables())


CASES = {
    "zipf": lambda: _hist_from_sequences(
        {c: zipf_symbols(20000, 1.2 + 0.1 * c, seed=c, max_val=1 << 26)
         for c in range(9)}),
    "sparse_components": lambda: _hist_from_sequences(
        {0: np.array([5, 5, 5, 7], np.uint64),
         8: zipf_symbols(5000, 1.5, seed=1)}),
    "single_symbol": lambda: _hist_from_sequences(
        {0: np.full(100, 3, np.uint64), 4: np.array([1], np.uint64)}),
    "graph_histograms": lambda: _graph_hists(
        Adjacency.from_lists([[2, 3], [5], [], [], [0], []])),
}


@pytest.mark.parametrize("max_frame_log2", [16, 12])
@pytest.mark.parametrize("case", list(CASES))
def test_model_torch_matches(case, max_frame_log2):
    _check(CASES[case](), max_frame_log2)


def test_model_torch_empty_histograms():
    """No symbols at all: every component is the empty model."""
    empty = (np.zeros(0, np.uint64), np.zeros(0, np.uint64))
    got = build_model_torch([empty] * 9, 12, device="cpu")
    _assert_models_equal(build_model([empty] * 9, 12), got)


@pytest.mark.slow
def test_model_torch_cnr2000(cnr2000):
    adj, _ = cnr2000
    hists = _graph_hists(adj)
    for mfl in (16, 12):
        _check(hists, mfl)
