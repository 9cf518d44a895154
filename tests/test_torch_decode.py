"""PyTorch port's token decode (plain PyTorch version of the CUDA kernel,
planner, ring seeds) vs the JAX package on the same artifacts.

Artifacts are written by the JAX package and read by both packages'
loaders. The JAX side runs as its own CPU tests run it: the XLA decoder
(WGT_PALLAS=0), or the Pallas kernel in interpret mode. Everything is
integer, so every comparison is exact (tolerance 0).
"""

import dataclasses

import numpy as np
import pytest
import torch

from webgraph_ans_tpu.ans.prelude import save_pointers, save_states
from webgraph_ans_tpu.bvgraph.graph import Adjacency
from webgraph_ans_tpu.bvgraph.random_access import ANSBvGraph as JaxGraph
from webgraph_ans_tpu.bvgraph.store import compress_adjacency
from webgraph_ans_tpu.ops import decode_jax
from webgraph_ans_tpu.ops import reconstruct_device as jax_recon
from webgraph_ans_tpu.ops.graph_decode import TpuGraphDecoder
from webgraph_ans_torch.bvgraph.random_access import ANSBvGraph as TorchGraph
from webgraph_ans_torch.ops import decode_torch
from webgraph_ans_torch.ops import reconstruct_device as torch_recon
from webgraph_ans_torch.ops.graph_decode import TorchGraphDecoder

def _rand_adj(n=120, seed=5, dmax=9):
    rng = np.random.default_rng(seed)
    lists = [sorted(rng.choice(n, size=int(rng.integers(0, dmax)),
                               replace=False).tolist()) for _ in range(n)]
    return Adjacency.from_lists(lists)


def _save(base, res, step=1):
    """Writes a CompressionResult the way store(phase_step=step) does."""
    prelude, states, pointers = res.prelude, res.states, res.pointers
    if step > 1:
        prelude = dataclasses.replace(prelude, phase_step=step)
        n = prelude.num_nodes
        rev_idx = (n - 1 - np.arange(0, n, step))[::-1]
        states, pointers = states[rev_idx], pointers[rev_idx]
    prelude.save(base)
    save_states(base, np.ascontiguousarray(states))
    save_pointers(base, np.ascontiguousarray(pointers))


# name -> (graph, compress args, compress kwargs, phase_step, lanes)
ARTIFACTS = {
    "serial": (dict(n=120, seed=5), (7, 3, 2), {}, 1, 8),
    "blocks4": (dict(n=150, seed=11), (7, 3, 2), dict(encode_blocks=4), 1, 8),
    "sampled4": (dict(n=250, seed=21, dmax=12), (7, 3, 2), {}, 4, 16),
    "window0": (dict(n=120, seed=7), (0, 0, 2), {}, 1, 8),
}


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_decode")
    made = {}
    for name, (gkw, args, kw, step, lanes) in ARTIFACTS.items():
        adj = _rand_adj(**gkw)
        base = str(root / name)
        _save(base, compress_adjacency(adj, *args, **kw), step)
        made[name] = (adj, base, lanes)
    return made


@pytest.fixture()
def xla_decoder(monkeypatch):
    monkeypatch.setenv("WGT_PALLAS", "0")


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("name", list(ARTIFACTS))
def test_decoder_tables_match_jax(artifacts, name):
    _, base, _ = artifacts[name]
    prelude = JaxGraph.load(base).prelude
    lut_j, _, params_j = decode_jax.build_decoder_tables_np(prelude.model,
                                                            prelude.stream)
    lut_t, params_t = decode_torch.build_decoder_tables_np(
        TorchGraph.load(base).prelude.model)
    np.testing.assert_array_equal(lut_t, lut_j)
    assert list(params_t) == list(params_j)


@pytest.mark.parametrize("name", list(ARTIFACTS))
def test_plan_and_seed_rings_match_jax(artifacts, name, xla_decoder):
    _, base, lanes = artifacts[name]
    jpl = TpuGraphDecoder(JaxGraph.load(base)).plan(lanes)
    tpl = TorchGraphDecoder(TorchGraph.load(base), device="cpu").plan(lanes)
    np.testing.assert_array_equal(tpl["starts_np"], jpl["starts_np"])
    np.testing.assert_array_equal(tpl["ends_np"], jpl["ends_np"])
    np.testing.assert_array_equal(tpl["ring"].numpy(), np.asarray(jpl["ring"]))
    assert tpl["cap"] == jpl["cap"]


@pytest.mark.parametrize("name", list(ARTIFACTS))
def test_raw_decode_matches_xla(artifacts, name, xla_decoder):
    """decode_blocks_plain's raw (out, counts, ok) equal decode_jax's
    decode_blocks on the same lane plan and cap."""
    _, base, lanes = artifacts[name]
    out_j, counts_j, cap = TpuGraphDecoder(JaxGraph.load(base)).decode_raw(
        lanes)
    dec = TorchGraphDecoder(TorchGraph.load(base), device="cpu")
    pl = dec.plan(lanes)
    out_t, counts_t, ok_t = decode_torch.decode_blocks_plain(
        dec.tables, pl["states"], pl["ptrs"], pl["starts"], pl["ends"],
        pl["ring"], dec.window, dec.min_interval, cap)
    np.testing.assert_array_equal(_u32(out_t), np.asarray(out_j))
    np.testing.assert_array_equal(counts_t.numpy(), np.asarray(counts_j))
    assert bool(ok_t.all())


def test_raw_decode_matches_pallas_interpret(artifacts, monkeypatch):
    """Same, against the TPU kernel itself (decode_blocks_pallas in
    interpret mode), at the size of test_pallas_kernels' decode case."""
    monkeypatch.setenv("WGT_PALLAS", "interpret")
    _, base, lanes = artifacts["blocks4"]
    jdec = TpuGraphDecoder(JaxGraph.load(base))
    assert jdec._use_pallas(lanes)
    out_p, counts_p, cap = jdec.decode_raw(lanes)
    dec = TorchGraphDecoder(TorchGraph.load(base), device="cpu")
    out_t, counts_t, cap_t = dec.decode_raw(lanes, cap=cap)
    assert cap_t == cap
    np.testing.assert_array_equal(_u32(out_t), np.asarray(out_p))
    np.testing.assert_array_equal(counts_t.numpy(), np.asarray(counts_p))


@pytest.mark.parametrize("name", list(ARTIFACTS))
def test_decode_tokens_match_jax(artifacts, name, xla_decoder):
    adj, base, lanes = artifacts[name]
    vals_j, comps_j = TpuGraphDecoder(JaxGraph.load(base)).decode_tokens(
        lanes)
    dec = TorchGraphDecoder(TorchGraph.load(base), device="cpu")
    vals_t, comps_t = dec.decode_tokens(lanes)
    np.testing.assert_array_equal(vals_t, vals_j)
    np.testing.assert_array_equal(comps_t, comps_j)
    assert int((comps_t == 0).sum()) == adj.num_nodes


def test_decode_cap_overflow_doubles(artifacts):
    """A cap too small for some lane reports ok=False there; decode_raw
    doubles the cap until every lane fits."""
    _, base, lanes = artifacts["serial"]
    dec = TorchGraphDecoder(TorchGraph.load(base), device="cpu")
    pl = dec.plan(lanes)
    _, counts, ok = decode_torch.decode_blocks_plain(
        dec.tables, pl["states"], pl["ptrs"], pl["starts"], pl["ends"],
        pl["ring"], dec.window, dec.min_interval, 8)
    assert not bool(ok.all()) and int(counts.max()) == 8
    out, counts, cap = dec.decode_raw(lanes, cap=8)
    assert cap > 8 and int(counts.max()) <= cap


def test_tighten_cap(artifacts):
    """tighten_cap shrinks the plan's cap to the quantum covering the
    observed counts; the decode stays the same."""
    _, base, lanes = artifacts["sampled4"]
    dec = TorchGraphDecoder(TorchGraph.load(base), device="cpu")
    before = dec.decode_tokens(lanes)
    loose = dec.plan(lanes)["cap"]
    _, counts, _ = dec.decode_raw(lanes)
    tight = dec.tighten_cap(lanes)
    assert tight == decode_torch.round_cap(dec.params, int(counts.max()))
    assert tight <= loose and dec.plan(lanes)["cap"] == tight
    after = dec.decode_tokens(lanes)
    np.testing.assert_array_equal(after[0], before[0])
    np.testing.assert_array_equal(after[1], before[1])


def test_cnr_model_lanes_match_xla(tmp_path, cnr2000, xla_decoder):
    """The cnr-2000 model quasi-unfolds up to 7 times (max_folds * widest
    radix = 49 >= 32: a decoder that shifted by the model-wide bound would
    hit an undefined u32 shift on a GPU; per slot folds*radix stays at 14).
    Lanes of the 4096-lane plan, decoded by both packages, must agree."""
    adj, _ = cnr2000
    base = str(tmp_path / "cnr")
    _save(base, compress_adjacency(adj, 7, 3, 2))
    jdec = TpuGraphDecoder(JaxGraph.load(base))
    dec = TorchGraphDecoder(TorchGraph.load(base), device="cpu")
    params = dec.params
    assert params[10] * max(p[3] for p in params[:9]) >= 32, \
        "model no longer folds past 32 bits"

    L = 4096
    jpl, tpl = jdec.plan(L), dec.plan(L)
    np.testing.assert_array_equal(tpl["ring"].numpy(), np.asarray(jpl["ring"]))
    lanes = np.sort(np.random.default_rng(3).choice(L, 24, replace=False))
    idx = torch.from_numpy(lanes)
    cap = tpl["cap"]
    starts, ends = tpl["starts_np"][lanes], tpl["ends_np"][lanes]
    ptrs = tpl["ptrs"][idx]
    out_j, counts_j, ok_j = decode_jax.decode_blocks(
        jdec.params, jdec.tables, np.asarray(tpl["states"][idx]).astype(
            np.uint32), ptrs.numpy().astype(np.int32), starts, ends,
        np.asarray(jpl["ring"])[lanes], dec.window, dec.min_interval, cap)
    out_t, counts_t, ok_t = decode_torch.decode_blocks_plain(
        dec.tables, tpl["states"][idx], ptrs, tpl["starts"][idx],
        tpl["ends"][idx], tpl["ring"][idx], dec.window, dec.min_interval,
        cap)
    np.testing.assert_array_equal(_u32(out_t), np.asarray(out_j))
    np.testing.assert_array_equal(counts_t.numpy(), np.asarray(counts_j))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    assert int(counts_t.sum()) > 0


@pytest.mark.parametrize("name", list(ARTIFACTS))
def test_raw_decode_aux_matches_xla(artifacts, name, xla_decoder):
    """Aux mode (emit_aux=True): the [3cap + cap/8, L] rows, the token
    counts and the aux cap of decode_blocks_plain equal decode_jax's."""
    _, base, lanes = artifacts[name]
    out_j, counts_j, cap = TpuGraphDecoder(JaxGraph.load(base)).decode_raw(
        lanes, emit_aux=True)
    dec = TorchGraphDecoder(TorchGraph.load(base), device="cpu")
    out_t, counts_t, cap_t = dec.decode_raw(lanes, emit_aux=True)
    assert cap_t == cap and out_t.shape[0] == 3 * cap + cap // 8
    np.testing.assert_array_equal(_u32(out_t), np.asarray(out_j))
    np.testing.assert_array_equal(counts_t.numpy(), np.asarray(counts_j))


def test_raw_decode_aux_matches_pallas_interpret(artifacts, monkeypatch):
    """Aux mode against the TPU kernel itself (decode_blocks_pallas,
    emit_aux=True, interpret mode)."""
    monkeypatch.setenv("WGT_PALLAS", "interpret")
    _, base, lanes = artifacts["sampled4"]
    jdec = TpuGraphDecoder(JaxGraph.load(base))
    assert jdec._use_pallas(lanes)
    out_p, counts_p, cap = jdec.decode_raw(lanes, emit_aux=True)
    dec = TorchGraphDecoder(TorchGraph.load(base), device="cpu")
    out_t, counts_t, _ = dec.decode_raw(lanes, cap=cap, emit_aux=True)
    np.testing.assert_array_equal(_u32(out_t), np.asarray(out_p))
    np.testing.assert_array_equal(counts_t.numpy(), np.asarray(counts_p))


@pytest.mark.parametrize("name", list(ARTIFACTS))
def test_parse_stats_matches_jax(artifacts, name, xla_decoder):
    """The port's parse_stats gives the same outdegrees, parents and
    reference depths as reconstruct_device.parse_stats on the same aux
    decode."""
    adj, base, lanes = artifacts[name]
    out_j, _, cap = TpuGraphDecoder(JaxGraph.load(base)).decode_raw(
        lanes, emit_aux=True)
    n = adj.num_nodes
    st_j = jax_recon.parse_stats(out_j, n, cap, depth_iters=0)
    st_t = torch_recon.parse_stats(torch.from_numpy(
        np.array(out_j).view(np.int32)), n, cap)
    np.testing.assert_array_equal(st_t["d"].numpy(), np.asarray(st_j["d"]))
    np.testing.assert_array_equal(st_t["parent"].numpy(),
                                  np.asarray(st_j["parent"]))
    np.testing.assert_array_equal(st_t["depth"].numpy(),
                                  np.asarray(st_j["depth"]))
    np.testing.assert_array_equal(st_t["d"].numpy(),
                                  np.diff(adj.offsets.astype(np.int64)))


def test_tighten_cap_aux(artifacts):
    """tighten_cap(emit_aux=True) shrinks the aux cap to the quantum
    covering tokens plus one summary step per node, apart from the token
    cap."""
    _, base, lanes = artifacts["serial"]
    dec = TorchGraphDecoder(TorchGraph.load(base), device="cpu")
    out, counts, cap = dec.decode_raw(lanes, emit_aux=True)
    pl = dec.plan(lanes)
    tight = dec.tighten_cap(lanes, emit_aux=True)
    steps = counts.numpy() + (pl["ends_np"] - pl["starts_np"])
    assert tight == decode_torch.round_cap(dec.params, int(steps.max()))
    assert tight <= cap and pl["cap_aux"] == tight
    out2, _, cap2 = dec.decode_raw(lanes, emit_aux=True)
    assert cap2 == tight
    codes = torch_recon.unpack_nibbles(out2[3 * cap2:], cap2)
    assert int((codes == decode_torch.NIB_SUM).sum()) == dec.num_nodes
    np.testing.assert_array_equal(out2[:cap2].numpy(), out[:cap2].numpy())
