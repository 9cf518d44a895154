"""The port's host codec modules against the JAX package's copies: the raw
symbol codec over the native library (ans/codec.py), the pure-Python
reference codec (ans/reference_codec.py), the pure-Python graph encoder
(ans/pyencoder.py) and the reference payload size (ans/refsize.py), on
the inputs of tests/test_codec_roundtrip.py, tests/test_pyencoder.py and
tests/test_pipeline.py. Tolerance 0: streams, states and pointers are
byte-equal."""

import numpy as np
import pytest

import webgraph_ans_tpu.ans.codec as jcodec
import webgraph_ans_tpu.ans.pyencoder as jpyenc
import webgraph_ans_tpu.ans.reference_codec as jref
import webgraph_ans_tpu.ans.refsize as jrefsize
import webgraph_ans_torch.ans.codec as tcodec
import webgraph_ans_torch.ans.pyencoder as tpyenc
import webgraph_ans_torch.ans.reference_codec as tref
import webgraph_ans_torch.ans.refsize as trefsize
from webgraph_ans_torch.ans.prelude import Prelude
from webgraph_ans_torch.bvgraph.graph import Adjacency
from webgraph_ans_torch.bvgraph.sequential import ANSBvGraphSeq
from webgraph_ans_torch.bvgraph.store import compress_adjacency

import jax_native_build
from conftest import zipf_symbols

# the JAX package's native library, built once before any test loads it
jax_native_build.ensure()


def _interleave(seqs):
    """Round-robin interleave of per-component sequences (the order of
    tests/test_codec_roundtrip.py's roundtrip)."""
    values, comps = [], []
    iters = {c: list(map(int, v)) for c, v in seqs.items()}
    longest = max(len(v) for v in iters.values())
    for idx in range(longest):
        for c in sorted(iters):
            if idx < len(iters[c]):
                values.append(iters[c][idx])
                comps.append(c)
    return np.array(values, np.uint64), np.array(comps, np.uint8)


def _shuffled(seqs, seed):
    """Components in a seeded random order (three_shuffled_components,
    frame1_component_interleave_roundtrip)."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(
        np.concatenate([np.full(len(v), c) for c, v in seqs.items()]))
    picks = {c: 0 for c in seqs}
    vals = np.empty(len(order), np.uint64)
    for i, c in enumerate(order.tolist()):
        vals[i] = seqs[c][picks[c]]
        picks[c] += 1
    return vals, order.astype(np.uint8)


def _case(name):
    rng = np.random.default_rng(3)
    if name == "dummy":
        seqs = {0: np.array([1, 1, 1, 2, 2, 2, 3, 3, 4, 5], np.uint64)}
    elif name == "folding":
        seqs = {0: np.array([1000, 1000, 2000], np.uint64)}
    elif name == "large_symbols":
        seqs = {0: np.array([1, (1 << 40) + 3, 17, 1 << 47, 2, 5],
                            np.uint64)}
    elif name.startswith("zipf"):
        seqs = {0: zipf_symbols(1_000_000, float(name[4:]), seed=0)}
    elif name == "interleaved":
        seqs = {0: zipf_symbols(20_000, 1.3, seed=1),
                8: zipf_symbols(20_000, 1.7, seed=2)}
    elif name == "three_shuffled":
        seqs = {0: zipf_symbols(30_000, 1.2, seed=4),
                4: rng.integers(1, 8, size=30_000).astype(np.uint64),
                8: zipf_symbols(30_000, 2.0, seed=5)}
        return seqs, *_shuffled(seqs, 3)
    elif name == "frame1":
        rng = np.random.default_rng(77)
        seqs = {1: rng.integers(0, 8, 500).astype(np.uint64),
                4: np.zeros(300, np.uint64),
                7: rng.zipf(1.8, 400).astype(np.uint64) % (1 << 20),
                8: rng.zipf(1.5, 800).astype(np.uint64) % (1 << 16)}
        return seqs, *_shuffled(seqs, 77)
    return seqs, *_interleave(seqs)


def _models_equal(a, b):
    assert len(a.components) == len(b.components) == 9
    for ca, cb in zip(a.components, b.components):
        np.testing.assert_array_equal(ca.freqs, cb.freqs)
        assert (ca.log_m, ca.radix, ca.fidelity, ca.folding_threshold,
                ca.folding_offset) == (cb.log_m, cb.radix, cb.fidelity,
                                       cb.folding_threshold, cb.folding_offset)


CASES = ["dummy", "folding", "large_symbols", "zipf1.2", "zipf1.5",
         "zipf2.0", "interleaved", "three_shuffled", "frame1"]


@pytest.mark.parametrize("name", CASES)
def test_raw_codec_matches_jax(name):
    """model_from_sequences, encode_raw and decode_raw give the JAX
    package's model, stream, phases and symbols."""
    seqs, values, comps = _case(name)
    tmodel = tcodec.model_from_sequences(seqs)
    jmodel = jcodec.model_from_sequences(seqs)
    _models_equal(tmodel, jmodel)
    t = tcodec.encode_raw(tmodel, values, comps)
    j = jcodec.encode_raw(jmodel, values, comps)
    assert t.stream.dtype == np.uint16 and t.states.dtype == np.uint32
    np.testing.assert_array_equal(t.stream, j.stream)
    np.testing.assert_array_equal(t.states, j.states)
    np.testing.assert_array_equal(t.pointers, j.pointers)
    assert t.final_state == j.final_state
    back = tcodec.decode_raw(tmodel, t.stream, t.final_state, comps[::-1])
    np.testing.assert_array_equal(
        back, jcodec.decode_raw(jmodel, j.stream, j.final_state,
                                comps[::-1]))
    np.testing.assert_array_equal(back[::-1], values)


def test_reference_codec_matches_jax_and_native():
    """The pure-Python executable spec (test_native_matches_python_spec's
    inputs): the port's encoder and decoder give the JAX package's stream,
    state and symbols, which equal the native codec's."""
    seqs = {0: zipf_symbols(3000, 1.4, seed=9),
            8: zipf_symbols(3000, 1.8, seed=10)}
    model = tcodec.model_from_sequences(seqs)
    values = np.concatenate([seqs[0], seqs[8]])
    comps = np.concatenate([np.zeros(3000, np.uint8),
                            np.full(3000, 8, np.uint8)])
    native = tcodec.encode_raw(model, values, comps)
    tenc, jenc = tref.PyANSEncoder(model), jref.PyANSEncoder(model)
    for v, c in zip(values.tolist(), comps.tolist()):
        tenc.encode(int(v), int(c))
        jenc.encode(int(v), int(c))
    assert tenc.state == jenc.state == native.final_state
    np.testing.assert_array_equal(np.array(tenc.stream, np.uint16),
                                  np.array(jenc.stream, np.uint16))
    np.testing.assert_array_equal(np.array(tenc.stream, np.uint16),
                                  native.stream)
    tdec = tref.PyANSDecoder(model, native.stream, native.final_state)
    jdec = jref.PyANSDecoder(model, native.stream, native.final_state)
    rev = comps[::-1].tolist()
    got = [tdec.decode(int(c)) for c in rev]
    assert got == [jdec.decode(int(c)) for c in rev]
    np.testing.assert_array_equal(np.array(got[::-1], np.uint64), values)


def test_pyencoder_matches_jax_and_native():
    """test_pyencoder_matches_native's inputs through both packages'
    pure-Python encoders and the port's native codec."""
    rng = np.random.default_rng(5)
    comps = rng.integers(0, 9, size=2000).astype(np.uint8)
    vals = zipf_symbols(2000, 1.4, seed=8, max_val=1 << 24)
    model = tcodec.model_from_sequences({c: vals[comps == c]
                                         for c in range(9)})
    native = tcodec.encode_raw(model, vals, comps)
    tenc, jenc = tpyenc.PyANSEncoder(model), jpyenc.PyANSEncoder(model)
    for v, c in zip(vals.tolist(), comps.tolist()):
        tenc.encode(int(v), int(c))
        jenc.encode(int(v), int(c))
    assert tenc.state == jenc.state == native.final_state
    np.testing.assert_array_equal(np.array(tenc.stream, np.uint16),
                                  np.array(jenc.stream, np.uint16))
    np.testing.assert_array_equal(np.array(tenc.stream, np.uint16),
                                  native.stream)


@pytest.mark.parametrize("window,min_interval", [(7, 2), (0, 2), (7, 0)])
def test_encode_graph_py_matches_jax(window, min_interval):
    """encode_graph_py (test_encode_graph_py_decodable's 80-node graph):
    the port's model, stream, phases and final state equal the JAX
    package's, and the port's sequential reader decodes the lists."""
    rng = np.random.default_rng(2)
    lists = [sorted(rng.choice(80, size=int(rng.integers(0, 6)),
                               replace=False).tolist()) for _ in range(80)]
    tmodel, tstream, tstates, tptrs, tfinal = tpyenc.encode_graph_py(
        lists, window, min_interval)
    jmodel, jstream, jstates, jptrs, jfinal = jpyenc.encode_graph_py(
        lists, window, min_interval)
    _models_equal(tmodel, jmodel)
    np.testing.assert_array_equal(tstream, jstream)
    np.testing.assert_array_equal(tstates, jstates)
    np.testing.assert_array_equal(tptrs, jptrs)
    assert tfinal == jfinal
    p = Prelude(model=tmodel, stream=tstream, state=tfinal,
                num_nodes=len(lists), num_arcs=sum(map(len, lists)),
                compression_window=window, min_interval_length=min_interval)
    assert ANSBvGraphSeq(p).decode_all().to_lists() == lists


@pytest.mark.parametrize("max_frame_log2", [12, 16])
def test_refsize_matches_jax(max_frame_log2):
    """reference_ans_payload_bytes on the cnr-2000 model of the port's
    store (tests/test_pipeline.py's size parity) and on the models of the
    codec cases: equal to the JAX package's, and the port's prelude is no
    larger than the reference payload."""
    from webgraph_ans_torch.bvgraph.graph import load_bvgraph
    from conftest import CNR

    adj, _ = load_bvgraph(CNR)
    res = compress_adjacency(adj, 7, 3, 2, max_frame_log2=max_frame_log2)
    n = len(res.prelude.stream)
    ref16 = compress_adjacency(adj, 7, 3, 2, max_frame_log2=16) \
        if max_frame_log2 != 16 else res
    ref_bytes = trefsize.reference_ans_payload_bytes(
        ref16.prelude.model, len(ref16.prelude.stream))
    assert ref_bytes == jrefsize.reference_ans_payload_bytes(
        ref16.prelude.model, len(ref16.prelude.stream))
    assert (trefsize.reference_ans_payload_bytes(res.prelude.model, n)
            == jrefsize.reference_ans_payload_bytes(res.prelude.model, n))
    assert res.prelude.serialized_size() <= ref_bytes
    for name in CASES:
        model = tcodec.model_from_sequences(_case(name)[0])
        assert (trefsize.reference_ans_payload_bytes(model, 1234)
                == jrefsize.reference_ans_payload_bytes(model, 1234))
