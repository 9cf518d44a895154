"""The port's merged-emit pipeline, TorchGraphDecoder.
decode_to_adjacency_device, on the CPU (plain versions of the kernels):
its planner against the JAX package's on the same artifacts, and the
whole path against the input graph, through the verified steady state.

Artifacts are written by the JAX package and read by both packages'
loaders. The JAX planner runs as its own
CPU tests run it (XLA token decode, WGT_PALLAS=0). Everything is integer
and compared exactly (tolerance 0).
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch

from webgraph_ans_tpu.ans.prelude import save_pointers, save_states
from webgraph_ans_tpu.bvgraph.graph import Adjacency
from webgraph_ans_tpu.bvgraph.random_access import ANSBvGraph as JaxGraph
from webgraph_ans_tpu.bvgraph.store import compress_adjacency
from webgraph_ans_tpu.bvgraph.synth import synth_web_graph
from webgraph_ans_tpu.ops.graph_decode import TpuGraphDecoder
from webgraph_ans_torch.bvgraph.random_access import ANSBvGraph as TorchGraph
from webgraph_ans_torch.ops import emit_cuda, emit_post, emit_torch, graph_decode
from webgraph_ans_torch.ops.cuda_build import KernelError
from webgraph_ans_torch.ops.graph_decode import TorchGraphDecoder
import jax_native_build

# the JAX package's native library, built once before any test loads it
jax_native_build.ensure()

LANES = 8


def _rand_lists(n, seed, dmax):
    rng = np.random.default_rng(seed)
    return [sorted(rng.choice(n, size=int(rng.integers(0, dmax)),
                              replace=False).tolist()) for _ in range(n)]


def _save(base, res, step):
    prelude, states, pointers = res.prelude, res.states, res.pointers
    if step > 1:
        prelude = dataclasses.replace(prelude, phase_step=step)
        n = prelude.num_nodes
        rev_idx = (n - 1 - np.arange(0, n, step))[::-1]
        states, pointers = states[rev_idx], pointers[rev_idx]
    prelude.save(base)
    save_states(base, np.ascontiguousarray(states))
    save_pointers(base, np.ascontiguousarray(pointers))


# name -> (adjacency maker, compress args, compress kwargs, phase_step)
ARTIFACTS = {
    "serial": (lambda: synth_web_graph(400, seed=21), (7, 3, 2), {}, 1),
    "sampled4": (lambda: synth_web_graph(400, seed=7), (7, 3, 2), {}, 4),
    # block-encoded and phase-sampled: lane entries and ring seeds go
    # through the native random access that enters at block starts
    "blocks4_sampled3": (
        lambda: Adjacency.from_lists(_rand_lists(180, 17, 11)), (7, 3, 2),
        dict(encode_blocks=4), 3),
    "w16_safe": (lambda: synth_web_graph(300, seed=13),
                 (16, 2_000_000_000, 4), dict(safe_break_interval=32), 1),
}
PIPELINE = ("serial", "sampled4", "blocks4_sampled3")


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_emit_pipeline")
    made = {}
    for name, (make, args, kw, step) in ARTIFACTS.items():
        adj = make()
        base = str(root / name)
        _save(base, compress_adjacency(adj, *args, **kw), step)
        made[name] = (adj, base)
    return made


@pytest.fixture()
def xla_decoder(monkeypatch):
    monkeypatch.setenv("WGT_PALLAS", "0")


def _summary_jax(jdec):
    pl = jdec._emit_plan(LANES)
    regs = emit_torch.regs_from_jax(np.asarray(pl["init"]),
                                    len(pl["starts_np"]))
    return pl, regs


def _check_plans(jdec, tdec):
    """Same lane bounds, halo starts, ring depth, step cap and register
    file (but the pointer row, which the port keeps apart)."""
    jpl, jregs = _summary_jax(jdec)
    tpl = tdec._emit_plan(LANES)
    np.testing.assert_array_equal(tpl["starts_np"], jpl["starts_np"])
    np.testing.assert_array_equal(tpl["ends_np"], jpl["ends_np"])
    np.testing.assert_array_equal(tpl["hstarts_np"],
                                  jregs[emit_torch.D_X].numpy())
    assert tpl["T"] == jpl["T"] and tpl["cap"] == jpl["cap"]
    keep = torch.ones(jregs.shape[0], dtype=torch.bool)
    keep[emit_torch.D_PTR] = False
    np.testing.assert_array_equal(tpl["regs"][keep].numpy(),
                                  jregs[keep].numpy())


def _replan(dec, keys, **state):
    pl = dec._plans[("emit", LANES)]
    for k in keys:
        pl.pop(k, None)
    pl.update(state)


@pytest.mark.parametrize("name", list(ARTIFACTS))
def test_emit_planner_matches_jax(artifacts, name, xla_decoder):
    """First plan, the plan rebalanced on known degrees and safe
    boundaries, and the plan refined on per-node work: equal in both
    packages, as are the safe boundaries themselves."""
    adj, base = artifacts[name]
    jdec = TpuGraphDecoder(JaxGraph.load(base))
    tdec = TorchGraphDecoder(TorchGraph.load(base), device="cpu")
    _check_plans(jdec, tdec)

    safe = jdec._safe_boundaries()
    np.testing.assert_array_equal(tdec._safe_boundaries(), safe)
    degs = np.diff(adj.offsets.astype(np.int64)).astype(np.int32)
    _replan(jdec, ("init", "slab", "cap", "bounds"), degs_np=degs,
            safe_np=safe)
    _replan(tdec, ("regs", "cap", "bounds"), degs_np=degs,
            safe_np=safe.copy())
    _check_plans(jdec, tdec)

    work = degs.astype(np.float64) + 2.5 + (np.arange(len(degs)) % 3)
    _replan(jdec, ("init", "slab", "cap", "bounds"), node_work=work)
    _replan(tdec, ("regs", "cap", "bounds"), node_work=work.copy())
    _check_plans(jdec, tdec)


def _assert_lists(adj, s2d, st, dg):
    offs = adj.offsets.astype(np.int64)
    np.testing.assert_array_equal(dg.numpy(), np.diff(offs))
    lists = emit_post.to_host_lists(s2d, st, dg, adj.num_nodes)
    for x in range(adj.num_nodes):
        np.testing.assert_array_equal(lists[x].astype(np.uint32),
                                      adj.succs[offs[x]:offs[x + 1]],
                                      err_msg=f"node {x}")


class _NoHostSync:
    """Makes every tensor-to-host read raise while active."""

    NAMES = ("item", "tolist", "numpy", "cpu", "__bool__", "__int__",
             "__float__")

    def __enter__(self):
        self.saved = {k: getattr(torch.Tensor, k) for k in self.NAMES}

        def refuse(*args, **kw):
            raise AssertionError("host synchronisation in the steady state")

        for k in self.NAMES:
            setattr(torch.Tensor, k, refuse)
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            setattr(torch.Tensor, k, v)


@pytest.mark.parametrize("name", PIPELINE)
def test_pipeline_reaches_steady_state(artifacts, name, monkeypatch):
    """First call, rebalance, refinement: exact lists on every call; then
    the verified steady state runs decode_emit (mark_deg) and the cached
    post-pass only, with no host synchronisation outside the kernel's
    plain version, and gives the input lists again."""
    adj, base = artifacts[name]
    dec = TorchGraphDecoder(TorchGraph.load(base), device="cpu")
    pl = None
    for _ in range(3):
        _assert_lists(adj, *dec.decode_to_adjacency_device(LANES))
        pl = dec._plans[("emit", LANES)]
        if pl.get("verified") and "fx_offs" in pl.get("post_meta", {}):
            break
    assert pl.get("verified"), "plan never reached the verified state"
    assert "node_work" in pl and "safe_np" in pl

    real = graph_decode.decode_emit
    calls = []
    guard = _NoHostSync()

    def spy(*args, **kw):
        calls.append(kw.get("mark_deg"))
        guard.__exit__()
        try:
            return real(*args, **kw)
        finally:
            guard.__enter__()

    def no_token_decode(*args, **kw):
        raise AssertionError("token decode in the steady state")

    monkeypatch.setattr(graph_decode, "decode_emit", spy)
    monkeypatch.setattr(graph_decode, "decode_blocks", no_token_decode)
    with guard:
        out = dec.decode_to_adjacency_device(LANES)
    assert calls == [True]
    _assert_lists(adj, *out)


def test_random_access_enters_at_block_start(artifacts):
    """The native random access of the block-encoded, phase-sampled
    artifact: nodes 92, 136 and 137 lie past an encode-block start that
    falls between them and their sampled node."""
    adj, base = artifacts["blocks4_sampled3"]
    g = TorchGraph.load(base)
    assert list(g.prelude.blocks[0]) == [0, 48, 92, 136]
    lists = adj.to_lists()
    for ef in (True, False):
        got = TorchGraph.load(base, ef_pointers=ef).successors_batch(
            np.array([92, 136, 137], np.uint64)).to_lists()
        assert got == [lists[92], lists[136], lists[137]]


def test_window_over_16_raises(tmp_path, xla_decoder, caplog):
    """The merged-emit kernel serves windows up to 16 and refuses a wider
    one; decode_to_adjacency_device then falls back to the sort path, as
    the reference does, and returns the JAX package's lists."""
    lists = _rand_lists(60, 3, 6)
    base = str(tmp_path / "w20")
    _save(base, compress_adjacency(Adjacency.from_lists(lists), 20, 3, 2), 1)
    dec = TorchGraphDecoder(TorchGraph.load(base), device="cpu")
    with pytest.raises(ValueError, match="window"):
        emit_cuda._launch(dec.tables, torch.zeros((1, 1), dtype=torch.int32),
                          torch.zeros(1, dtype=torch.int64), 20, 2, 8, 8,
                          False)
    with caplog.at_level(logging.WARNING, logger=graph_decode.__name__):
        got = emit_post.to_host_lists(*dec.decode_to_adjacency_device(LANES),
                                      60)
    assert "window 20 > 16" in caplog.text
    jax_lists = emit_post.to_host_lists(*(torch.from_numpy(np.array(a))
                                          for a in TpuGraphDecoder(
        JaxGraph.load(base)).decode_to_adjacency_device(LANES)), 60)
    assert [x.tolist() for x in got] == [x.tolist() for x in jax_lists] \
        == lists


def test_postpass_error_propagates(artifacts, monkeypatch, caplog):
    """A post-pass RuntimeError falls back to the sort path (the lists
    stay exact and the plan stays there), while a kernel's launch error
    still propagates."""
    adj, base = artifacts["serial"]
    dec = TorchGraphDecoder(TorchGraph.load(base), device="cpu")
    real = emit_post.postprocess

    def broken(*args, **kw):
        raise RuntimeError("post-pass failure")

    monkeypatch.setattr(emit_post, "postprocess", broken)
    with caplog.at_level(logging.WARNING, logger=graph_decode.__name__):
        _assert_lists(adj, *dec.decode_to_adjacency_device(LANES))
    assert "post-pass failure" in dec._plans[("emit", LANES)]["emit_broken"]
    assert "sort-path reconstruction" in caplog.text
    monkeypatch.setattr(emit_post, "postprocess", real)
    _assert_lists(adj, *dec.decode_to_adjacency_device(LANES))

    def launch_error(*args, **kw):
        raise KernelError("decode_emit kernel launch (window 7, T 512) "
                          "failed: invalid argument")

    dec = TorchGraphDecoder(TorchGraph.load(base), device="cpu")
    monkeypatch.setattr(graph_decode, "decode_emit", launch_error)
    with pytest.raises(KernelError, match="launch"):
        dec.decode_to_adjacency_device(LANES)
    assert not dec._plans[("emit", LANES)].get("emit_broken")


def test_default_device_needs_cuda(artifacts, monkeypatch):
    _, base = artifacts["serial"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchGraphDecoder(TorchGraph.load(base)).decode_to_adjacency_device()
