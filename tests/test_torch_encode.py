"""The port's lane-parallel encoder (ops/encode_torch.py, the plain version
of the CUDA kernel in ops/encode_cuda.py) against the JAX package's, on the
CPU: tables, plan, the kernel's raw outputs against encode_blocks_pallas
in interpret mode (as tests/test_pallas_kernels.py runs it) and against
the XLA twin, the host stream assembly, and the store's block-encoded
artifacts byte for byte. Everything is integer and compared exactly
(tolerance 0).
"""

import numpy as np
import pytest
import torch

import webgraph_ans_tpu.ans.prelude as jprelude
import webgraph_ans_tpu.bvgraph.store as jstore
from webgraph_ans_tpu.bvgraph.graph import Adjacency as JaxAdjacency
from webgraph_ans_tpu.bvgraph.graph import load_bvgraph
from webgraph_ans_tpu.ops import encode_jax
import webgraph_ans_torch.ans.prelude as tprelude
import webgraph_ans_torch.bvgraph.store as tstore
from webgraph_ans_torch.bvgraph.graph import Adjacency
from webgraph_ans_torch.bvgraph.random_access import ANSBvGraph
from webgraph_ans_torch.bvgraph.sequential import ANSBvGraphSeq
from webgraph_ans_torch.ops import encode_cuda, encode_torch, emit_post
from webgraph_ans_torch.ops.graph_decode import TorchGraphDecoder
from webgraph_ans_torch.ops.reconstruct_torch import reconstruct
import jax_native_build

# the JAX package's native library, built once before any test loads it
jax_native_build.ensure()

CNR = "tests/data/cnr-2000/cnr-2000"
EXTS = (".ans", ".states", ".pointers")
EDGE_GRAPHS = {"one_empty": [[]], "three_empty": [[], [], []],
               "tiny": [[1], [], [0, 2]]}


def _lists(n, seed, dmax):
    rng = np.random.default_rng(seed)
    return [sorted(rng.choice(n, size=int(rng.integers(0, dmax)),
                              replace=False).tolist()) for _ in range(n)]


def _tokens(lists, w=7, r=3, mi=2):
    adj = JaxAdjacency.from_lists(lists)
    res = jstore.compress_adjacency(adj, w, r, mi)
    vals, comps = jstore.dump_tokens(adj, w, r, mi, res.est_tables)
    return res, vals, comps


@pytest.fixture(scope="module")
def small():
    """The 120-node graph of test_pallas_kernels.py: serial result, tokens."""
    return _tokens(_lists(120, 5, 9))


@pytest.fixture(scope="module")
def cnr_prefix():
    """cnr-2000's model and its token stream cut at a node start near
    30,000 tokens: the model's fold-threshold exponent passes 31
    (test_pallas_kernels.py:69-102)."""
    adj, _ = load_bvgraph(CNR)
    res = jstore.compress_adjacency(adj, 7, 3, 2)
    vals, comps = jstore.dump_tokens(adj, 7, 3, 2, res.est_tables)
    K = int(np.nonzero(comps[:30000] == 0)[0][-1])
    return res, vals[:K], comps[:K]


def _cases(small, cnr_prefix):
    return {"small_1": (small, 1), "small_8": (small, 8),
            "small_32": (small, 32), "cnr_prefix_8": (cnr_prefix, 8)}


@pytest.fixture(scope="module")
def pallas_refs(small, cnr_prefix):
    """encode_blocks_pallas(interpret=True) outputs, once per case: each
    interpret run traces for seconds."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WGT_PALLAS", "interpret")
        for name, ((res, vals, comps), nb) in _cases(small,
                                                     cnr_prefix).items():
            plan = encode_jax.encode_plan(res.prelude.model, vals, comps, nb)
            (params, tables, tokens, tstart_d, tend_d, cap, tstart, tend,
             _nodes, tab_np) = plan
            raw = encode_jax.encode_blocks_auto(
                params, tables, tokens, tstart_d, tend_d, cap, tstart, tend,
                tab_np)
            out[name] = (plan, [np.asarray(a) for a in raw])
    return out


def _port_raw(res, vals, comps, nb):
    plan = encode_torch.encode_plan(res.prelude.model, vals, comps, nb,
                                    device="cpu")
    raw = encode_cuda.encode_blocks(plan.params, plan.tab, plan.tokens,
                                    plan.tstart, plan.tend, plan.cap)
    return plan, [a.numpy() if a.dtype == torch.bool
                  else a.numpy().view(np.uint32) for a in raw]


def test_tables_match_jax(small, cnr_prefix):
    """From the JAX package's model objects and from the port's own
    models (the port's store on the same graphs)."""
    for res, lists in ((small[0], _lists(120, 5, 9)),
                       (cnr_prefix[0], None)):
        _, params_j, tab_j = encode_jax.build_encoder_tables(
            res.prelude.model)
        tab_t, params_t, tab_np = encode_torch.build_encoder_tables(
            res.prelude.model, "cpu")
        assert params_t == params_j
        np.testing.assert_array_equal(tab_np, tab_j)
        np.testing.assert_array_equal(tab_t.numpy().view(np.uint32), tab_j)
        if lists is None:
            adj, _ = load_bvgraph(CNR)
            port = tstore.compress_adjacency(Adjacency(adj.offsets,
                                                       adj.succs), 7, 3, 2)
        else:
            port = tstore.compress_adjacency(Adjacency.from_lists(lists),
                                             7, 3, 2)
        tab_p, params_p = encode_torch.build_encoder_tables_np(
            port.prelude.model)
        assert params_p == params_j
        np.testing.assert_array_equal(tab_p, tab_j)
    assert params_j[9] == 7      # cnr-2000 folds up to 7 times


@pytest.mark.parametrize("case", ["small_1", "small_8", "small_32",
                                  "cnr_prefix_8"])
def test_plan_matches_jax(small, cnr_prefix, pallas_refs, case):
    (res, vals, comps), nb = _cases(small, cnr_prefix)[case]
    jplan = pallas_refs[case][0]
    tplan = encode_torch.encode_plan(res.prelude.model, vals, comps, nb,
                                     device="cpu")
    assert tplan.params == jplan[0] and tplan.cap == jplan[5]
    np.testing.assert_array_equal(tplan.tokens.numpy().view(np.uint32),
                                  np.asarray(jplan[2]))
    np.testing.assert_array_equal(tplan.tstart.numpy(), np.asarray(jplan[3]))
    np.testing.assert_array_equal(tplan.tend.numpy(), np.asarray(jplan[4]))
    np.testing.assert_array_equal(tplan.tstart_np, jplan[6])
    np.testing.assert_array_equal(tplan.tend_np, jplan[7])
    np.testing.assert_array_equal(tplan.block_nodes, jplan[8])
    np.testing.assert_array_equal(tplan.tab_np, jplan[9])


@pytest.mark.parametrize("case", ["small_1", "small_8", "small_32",
                                  "cnr_prefix_8"])
def test_raw_outputs_match_pallas_interpret(small, cnr_prefix, pallas_refs,
                                            case):
    """Every output tensor of the plain version equals the Pallas kernel's
    for the real lanes, every row up to cap."""
    (res, vals, comps), nb = _cases(small, cnr_prefix)[case]
    _, ref = pallas_refs[case]
    _, got = _port_raw(res, vals, comps, nb)
    assert len(got) == len(ref) == 5
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_array_equal(g, r)
    assert got[4].all()


@pytest.mark.parametrize("case", ["small_1", "small_8", "cnr_prefix_8"])
def test_raw_outputs_match_xla_twin(small, cnr_prefix, case):
    """The XLA twin stops at the longest lane; rows below it are equal."""
    (res, vals, comps), nb = _cases(small, cnr_prefix)[case]
    plan, got = _port_raw(res, vals, comps, nb)
    params, tables, tokens, tstart_d, tend_d, cap = encode_jax.encode_plan(
        res.prelude.model, vals, comps, nb)[:6]
    ref = [np.asarray(a) for a in encode_jax.encode_blocks(
        params, tables, tokens, tstart_d, tend_d, cap)]
    rows = int((plan.tend_np - plan.tstart_np).max())
    EP = encode_torch._emit_pairs(params[9])
    np.testing.assert_array_equal(got[0][:rows * EP], ref[0][:rows * EP])
    np.testing.assert_array_equal(got[0][cap * EP:cap * EP + rows],
                                  ref[0][cap * EP:cap * EP + rows])
    np.testing.assert_array_equal(got[1][:rows], ref[1][:rows])
    for g, r in zip(got[2:], ref[2:]):
        np.testing.assert_array_equal(g, r)


def _assert_encoded_equal(a, b):
    for x, y in zip(a[:3], b[:3]):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert a[3] == b[3]
    for x, y in zip(a[4], b[4]):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("case", ["small_1", "small_8", "small_32",
                                  "cnr_prefix_8"])
def test_lane_encode_tokens_matches_jax(small, cnr_prefix, case):
    """Stream, states, pointers, final state and block table."""
    (res, vals, comps), nb = _cases(small, cnr_prefix)[case]
    _assert_encoded_equal(
        encode_torch.lane_encode_tokens(res.prelude.model, vals, comps, nb,
                                        device="cpu"),
        encode_jax.lane_encode_tokens(res.prelude.model, vals, comps, nb))


def test_single_block_equals_serial_native(small):
    res, vals, comps = small
    stream, states, ptrs, fstate, _ = encode_torch.lane_encode_tokens(
        res.prelude.model, vals, comps, num_blocks=1, device="cpu")
    np.testing.assert_array_equal(stream, res.prelude.stream)
    np.testing.assert_array_equal(states, res.states)
    np.testing.assert_array_equal(ptrs, res.pointers)
    assert fstate == res.prelude.state


def test_plan_rejects_wide_values(small):
    res, vals, comps = small
    vals = vals.copy()
    vals[3] = 1 << 31
    with pytest.raises(ValueError, match="uint31"):
        encode_torch.encode_plan(res.prelude.model, vals, comps, 4,
                                 device="cpu")


def _write(prelude_mod, res, base):
    res.prelude.save(base)
    prelude_mod.save_states(base, np.ascontiguousarray(res.states))
    prelude_mod.save_pointers(base, np.ascontiguousarray(res.pointers))


def _same_bytes(a, b):
    for ext in EXTS:
        with open(a + ext, "rb") as fa, open(b + ext, "rb") as fb:
            assert fa.read() == fb.read(), ext


# name -> (lists, window, max_ref, min_interval)
GRAPHS = {
    "w7_r3_i2": (lambda: _lists(400, 9, 15), 7, 3, 2),
    "window0": (lambda: _lists(300, 4, 12), 0, 0, 2),
    "no_intervals": (lambda: _lists(300, 6, 12), 7, 3, 0),
    **{k: (lambda v=v: v, 7, 3, 2) for k, v in EDGE_GRAPHS.items()},
}


@pytest.mark.parametrize("search", [False, True], ids=["host", "device"])
@pytest.mark.parametrize("blocks", [4, 32])
@pytest.mark.parametrize("graph", list(GRAPHS))
def test_store_bytes_match_jax(tmp_path, graph, blocks, search):
    """.ans, .states and .pointers of the port's block-encoded store equal
    the JAX package's for the same flags (device stages on the CPU)."""
    make, w, r, mi = GRAPHS[graph]
    lists = make()
    jres = jstore.compress_adjacency(JaxAdjacency.from_lists(lists), w, r,
                                     mi, use_tpu_model_search=search,
                                     encode_blocks=blocks)
    tres = tstore.compress_adjacency(Adjacency.from_lists(lists), w, r, mi,
                                     use_tpu_model_search=search,
                                     encode_blocks=blocks, device="cpu")
    assert tres.prelude.blocks is not None
    _write(jprelude, jres, str(tmp_path / "jax"))
    _write(tprelude, tres, str(tmp_path / "torch"))
    _same_bytes(str(tmp_path / "jax"), str(tmp_path / "torch"))
    if search:
        assert tres.seconds["model_search"] > 0


@pytest.fixture(scope="module")
def block_artifact(tmp_path_factory):
    """A block-encoded artifact written by the port's store (device stages
    on the CPU), and its input lists."""
    lists = _lists(400, 9, 15)
    base = str(tmp_path_factory.mktemp("blocks") / "g")
    res = tstore.compress_adjacency(Adjacency.from_lists(lists), 7, 3, 2,
                                    encode_blocks=32,
                                    use_tpu_model_search=True, device="cpu")
    serial = tstore.compress_adjacency(Adjacency.from_lists(lists), 7, 3, 2)
    # about two words of overhead per block at most
    assert len(res.prelude.stream) <= len(serial.prelude.stream) + 2 * 32
    _write(tprelude, res, base)
    return lists, base


def test_block_artifact_token_drive(block_artifact):
    lists, base = block_artifact
    g = ANSBvGraph.load(base)
    vals, comps = TorchGraphDecoder(g, device="cpu").decode_tokens(8)
    off, succs = reconstruct(vals, comps, g.num_nodes, 2, device="cpu")
    assert Adjacency(off, succs).to_lists() == lists


def test_block_artifact_merged_emit(block_artifact):
    lists, base = block_artifact
    dec = TorchGraphDecoder(ANSBvGraph.load(base), device="cpu")
    for _ in range(3):
        s2d, st, dg = dec.decode_to_adjacency_device(8)
        got = emit_post.to_host_lists(s2d, st, dg, len(lists))
        assert [x.tolist() for x in got] == lists
        if dec.emit_steady(8):
            break
    assert dec.emit_steady(8)


def test_block_artifact_sequential_and_random(block_artifact):
    lists, base = block_artifact
    seq = ANSBvGraphSeq.load(base)
    assert seq.decode_all().to_lists() == lists
    chunks = [lst for _, a in seq.iter_chunks(max_nodes=37)
              for lst in a.to_lists()]
    assert chunks == lists
    q = np.arange(len(lists), dtype=np.uint64)
    assert ANSBvGraph.load(base).successors_batch(q).to_lists() == lists
