"""The port's single-process scale-out (webgraph_ans_torch/parallel/
sharded.py) against the JAX package's mesh version, on the graphs of
tests/test_parallel.py: the sharded token decode over ["cpu"] * n (the
lane groups each run the plain version of the kernel) against
ShardedGraphDecoder on the 8-device CPU mesh, the sharded histogram, and
the sharded merged emit against the JAX package's (Pallas in interpret
mode) and against the port's own single-device decode. Tolerance 0."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from webgraph_ans_tpu.bvgraph.graph import Adjacency as JaxAdjacency
from webgraph_ans_tpu.bvgraph.random_access import ANSBvGraph as JaxGraph
from webgraph_ans_tpu.bvgraph.store import compress_adjacency, dump_tokens
from webgraph_ans_tpu.parallel import sharded as jsharded
from webgraph_ans_torch.bvgraph.random_access import ANSBvGraph
from webgraph_ans_torch.ops.graph_decode import TorchGraphDecoder
from webgraph_ans_torch.ops.reconstruct_torch import reconstruct
from webgraph_ans_torch.parallel import sharded

import jax_native_build

# the JAX package's native library, built once before any test loads it
jax_native_build.ensure()


def _lists(n, seed, dmax):
    rng = np.random.default_rng(seed)
    return [sorted(rng.choice(n, size=int(rng.integers(0, dmax)),
                              replace=False).tolist()) for _ in range(n)]


def _graphs(res):
    return (JaxGraph(res.prelude, res.states, res.pointers),
            ANSBvGraph(res.prelude, res.states, res.pointers))


@pytest.mark.parametrize("case", ["serial_400", "blocks8_300"])
def test_sharded_decode_matches_jax(case):
    """test_sharded_decode_matches_serial (400 nodes, 8 devices) and
    test_sharded_decode_block_encoded_file (300 nodes, 8 encode blocks,
    4 devices: the block starts add lanes, padded back to a multiple of
    the devices): the port's tokens equal the JAX mesh decoder's, and
    reconstruct to the lists."""
    if case == "serial_400":
        lists, ndev, kw = _lists(400, 31, 14), 8, {}
    else:
        lists, ndev, kw = _lists(300, 13, 10), 4, dict(encode_blocks=8)
    adj = JaxAdjacency.from_lists(lists)
    res = compress_adjacency(adj, 7, 3, 2, **kw)
    jg, tg = _graphs(res)
    jv, jc = jsharded.ShardedGraphDecoder(
        jg, jsharded.make_mesh(ndev)).decode_tokens(lanes_per_device=4)
    dec = sharded.ShardedGraphDecoder(tg, ["cpu"] * ndev)
    tv, tc = dec.decode_tokens(lanes_per_device=4)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tc, jc)
    if not kw:
        want_v, want_c = dump_tokens(adj, 7, 3, 2, res.est_tables)
        np.testing.assert_array_equal(tv.astype(np.uint64), want_v)
        np.testing.assert_array_equal(tc.astype(np.uint8), want_c)
    L = len(dec.single.plan(4 * ndev, pad_to=ndev)["starts_np"])
    assert L % ndev == 0
    off, succs = reconstruct(tv, tc, len(lists), 2, device="cpu")
    assert JaxAdjacency(off, succs).to_lists() == lists


def test_sharded_decode_pads_empty_lanes_and_regrows():
    """The padded lanes are empty and never touch the stream, and a cap
    too small for every lane grows on the lanes that did not finish (each
    on its own device) up to the cap of the single-device decode."""
    lists = _lists(300, 13, 10)
    res = compress_adjacency(JaxAdjacency.from_lists(lists), 7, 3, 2,
                             encode_blocks=8)
    tg = _graphs(res)[1]
    dec = sharded.ShardedGraphDecoder(tg, ["cpu"] * 3)
    pl = dec.single.plan(6, pad_to=3)
    starts, ends = pl["starts_np"], pl["ends_np"]
    empty = starts == ends
    assert len(starts) % 3 == 0 and empty.any()
    assert (pl["ptrs"].numpy()[empty] == 0).all()
    out, counts, cap = dec.decode_raw(lanes_per_device=2, cap=8)
    # unpadded, the same bounds are the 8 block starts
    single = TorchGraphDecoder(tg, device="cpu")
    sout, scounts, scap = single.decode_raw(6, cap=8)
    assert cap == scap > 8
    assert torch.equal(counts[torch.from_numpy(~empty)], scounts)
    assert torch.equal(out[:, torch.from_numpy(~empty)], sout)
    assert (counts.numpy()[empty] == 0).all()
    v, c = dec.decode_tokens(lanes_per_device=2, cap=8)
    sv, sc = single.decode_tokens(64)
    np.testing.assert_array_equal(v, sv)
    np.testing.assert_array_equal(c, sc)


def test_sharded_histogram_matches_jax():
    """test_sharded_histogram's inputs: equal to the JAX mesh histogram
    and to np.add.at, with symbols past the top bin clipped into it."""
    rng = np.random.default_rng(5)
    sym = rng.integers(0, 50, size=8 * 1000).astype(np.int32)
    comp = rng.integers(0, 9, size=8 * 1000).astype(np.int32)
    got = sharded.sharded_histogram(["cpu"] * 8, torch.from_numpy(sym),
                                    torch.from_numpy(comp), 64)
    want = np.asarray(jsharded.sharded_histogram(
        jsharded.make_mesh(), jnp.asarray(sym), jnp.asarray(comp), 64))
    np.testing.assert_array_equal(got.numpy(), want)
    ref = np.zeros((9, 64), np.int64)
    np.add.at(ref, (comp, sym), 1)
    np.testing.assert_array_equal(got.numpy(), ref)
    clipped = sharded.sharded_histogram(["cpu"] * 3, sym + 40, comp, 64)
    np.testing.assert_array_equal(
        clipped.numpy(), np.asarray(jsharded.sharded_histogram(
            jsharded.make_mesh(), jnp.asarray(sym + 40), jnp.asarray(comp),
            64)))


def test_sharded_seed_rings_match_single_device():
    lists = _lists(400, 31, 14)
    res = compress_adjacency(JaxAdjacency.from_lists(lists), 7, 3, 2)
    dec = TorchGraphDecoder(_graphs(res)[1], device="cpu")
    pl = dec.plan(16)
    devs = ["cpu"] * 4
    starts = pl["starts_np"].astype(np.int64)
    pre = np.clip(starts[:, None] - 7 + np.arange(7)[None, :], 0, 399)
    ring = sharded.sharded_seed_rings(
        devs, sharded.replicate_tables(dec.tables, devs),
        torch.from_numpy(dec.states_np[pre].astype(np.int64)),
        torch.from_numpy(dec.pointers[pre]), pl["starts"], 7)
    assert torch.equal(ring, pl["ring"])


def _adjacency_lists(s2d, st, dg):
    F = s2d.reshape(-1).numpy()
    G = s2d.shape[1]
    st, dg = st.numpy().astype(np.int64), dg.numpy().astype(np.int64)
    return [F[st[x] + np.arange(dg[x]) * G].astype(np.int64).tolist()
            for x in range(len(dg))]


def test_sharded_emit_matches_jax_and_single_device(monkeypatch):
    """test_sharded_emit_adjacency_bit_exact's 700-node synth graph at 16
    lanes: the port's sharded merged emit over ["cpu"] * 2 gives, node by
    node, the JAX package's sharded lists (Pallas in interpret mode), and
    bit for bit what the port's single-device decode_to_adjacency_device
    returns on the same plan."""
    monkeypatch.setenv("WGT_PALLAS", "interpret")
    from webgraph_ans_tpu.bvgraph.synth import synth_web_graph
    from webgraph_ans_tpu.ops.graph_decode import TpuGraphDecoder

    adj = synth_web_graph(700, seed=13)
    res = compress_adjacency(adj)
    jg, tg = _graphs(res)
    js2d, jst, jdg = jsharded.sharded_emit_adjacency(
        jsharded.make_mesh(), TpuGraphDecoder(jg), num_lanes=16,
        interpret=True)
    jF = np.asarray(js2d).reshape(-1)
    jG = np.asarray(js2d).shape[1]
    jst, jdg = np.asarray(jst).astype(np.int64), np.asarray(jdg)
    jlists = [jF[jst[x] + np.arange(jdg[x]) * jG].astype(np.int64).tolist()
              for x in range(adj.num_nodes)]

    got = sharded.sharded_emit_adjacency(
        ["cpu"] * 2, TorchGraphDecoder(tg, device="cpu"), num_lanes=16)
    single = TorchGraphDecoder(tg, device="cpu").decode_to_adjacency_device(
        16)
    for a, b in zip(got, single):
        assert a.dtype == b.dtype and torch.equal(a, b)
    lists = _adjacency_lists(*got)
    assert lists == jlists
    offs = adj.offsets.astype(np.int64)
    assert lists == [adj.succs[offs[x]:offs[x + 1]].tolist()
                     for x in range(adj.num_nodes)]


def test_sharded_emit_regrows_and_raises_where_single_falls_back(
        monkeypatch):
    """A cap too small for the lanes grows on the lanes that did not
    finish, on their own device, to the single-device path's result; a
    window past 16 raises EmitPlanUnsupported where the single-device path
    falls back to the sort path."""
    from webgraph_ans_torch.bvgraph.synth import synth_web_graph
    from webgraph_ans_torch.bvgraph.store import (
        compress_adjacency as tcompress)
    from webgraph_ans_torch.ops.graph_decode import EmitPlanUnsupported

    adj = synth_web_graph(60, seed=5)
    res = tcompress(adj)
    g = ANSBvGraph(res.prelude, res.states, res.pointers)
    dec = TorchGraphDecoder(g, device="cpu")
    dec._emit_plan(6)["cap"] = 400      # a lane needs more rows
    launches, kernel = [], sharded.decode_emit

    def recorded(tables, regs, ptrs, window, min_interval, cap, **kw):
        launches.append((regs.shape[1], cap))
        return kernel(tables, regs, ptrs, window, min_interval, cap, **kw)

    monkeypatch.setattr(sharded, "decode_emit", recorded)
    got = sharded.sharded_emit_adjacency(["cpu"] * 2, dec, num_lanes=6)
    # both groups of 3 lanes at 400, the unfinished lanes alone at 800,
    # then both groups at 800
    assert launches[:2] == [(3, 400)] * 2 and launches[-2:] == [(3, 800)] * 2
    assert [c for _, c in launches[2:-2]] == [800] * (len(launches) - 4)
    assert sum(n for n, _ in launches[2:-2]) < 6
    want = TorchGraphDecoder(g, device="cpu")
    want._emit_plan(6)["cap"] = 400
    for a, b in zip(got, want.decode_to_adjacency_device(6)):
        assert torch.equal(a, b)
    offs = adj.offsets.astype(np.int64)
    assert _adjacency_lists(*got) == [adj.succs[offs[x]:offs[x + 1]].tolist()
                                      for x in range(adj.num_nodes)]

    wide = tcompress(adj, 20, 3, 2)
    wg = ANSBvGraph(wide.prelude, wide.states, wide.pointers)
    with pytest.raises(EmitPlanUnsupported, match="window 20"):
        sharded.sharded_emit_adjacency(
            ["cpu"] * 2, TorchGraphDecoder(wg, device="cpu"), num_lanes=4)


def test_sharded_emit_on_a_verified_plan_is_the_steady_call():
    """Once the single-device path has verified its plan, the sharded
    merged emit runs the steady state (mark_deg launches, the cached
    layout's post-pass): bit for bit the single-device steady call."""
    from webgraph_ans_torch.bvgraph.synth import synth_web_graph
    from webgraph_ans_torch.bvgraph.store import (
        compress_adjacency as tcompress)

    adj = synth_web_graph(60, seed=9)
    res = tcompress(adj)
    dec = TorchGraphDecoder(ANSBvGraph(res.prelude, res.states,
                                       res.pointers), device="cpu")
    for _ in range(4):
        dec.decode_to_adjacency_device(4)
        if dec.emit_steady(4):
            break
    assert dec.emit_steady(4)
    got = sharded.sharded_emit_adjacency(["cpu"] * 2, dec, num_lanes=4)
    for a, b in zip(got, dec.decode_to_adjacency_device(4)):
        assert torch.equal(a, b)
    offs = adj.offsets.astype(np.int64)
    assert _adjacency_lists(*got) == [adj.succs[offs[x]:offs[x + 1]].tolist()
                                      for x in range(adj.num_nodes)]


def test_sharded_emit_alone_reaches_the_verified_plan():
    """Driven only through the sharded merged emit, a fresh plan goes
    through the single-device path's refinement to its verified steady
    state, and every call is bit for bit the single-device call's."""
    from webgraph_ans_torch.bvgraph.synth import synth_web_graph
    from webgraph_ans_torch.bvgraph.store import (
        compress_adjacency as tcompress)

    adj = synth_web_graph(80, seed=3)
    res = tcompress(adj)
    g = ANSBvGraph(res.prelude, res.states, res.pointers)
    dec = TorchGraphDecoder(g, device="cpu")
    single = TorchGraphDecoder(g, device="cpu")
    for _ in range(4):
        got = sharded.sharded_emit_adjacency(["cpu"] * 3, dec, num_lanes=6)
        for a, b in zip(got, single.decode_to_adjacency_device(6)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    pl = dec._plans[("emit", 6)]
    assert dec.emit_steady(6)
    assert "rows_np" in pl and "node_work" in pl
    offs = adj.offsets.astype(np.int64)
    assert _adjacency_lists(*got) == [adj.succs[offs[x]:offs[x + 1]].tolist()
                                      for x in range(adj.num_nodes)]
    with pytest.raises(ValueError, match="decoder's device"):
        sharded.sharded_emit_adjacency(["meta"], dec, num_lanes=6)


def test_make_devices():
    assert sharded.make_devices(3, "cpu") == [torch.device("cpu")] * 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            sharded.make_devices(2)


def test_dryrun_entry_matches_jax():
    """dryrun.entry() decodes the same tiny pure-Python-encoded graph as
    the JAX package's __graft_entry__.entry(), to the same output."""
    import __graft_entry__
    from webgraph_ans_torch import dryrun

    jfn, jargs = __graft_entry__.entry()
    jout, jcounts = jfn(*jargs)
    fn, args = dryrun.entry(device="cpu")
    out, counts = fn(*args)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    # the port holds the u32 output words as int32 bit patterns
    np.testing.assert_array_equal(out.numpy().view(np.uint32),
                                  np.asarray(jout).astype(np.uint32))


def test_dryrun_multichip_on_four_host_shards():
    """dryrun_multichip(4) over ["cpu"] * 4: the sharded ring seeds, token
    decode, histogram (its outdegrees sum to the arcs) and merged emit
    (checked list by list inside)."""
    from webgraph_ans_torch import dryrun

    got = dryrun.dryrun_multichip(4, device="cpu")
    assert got["devices"] == ["cpu"] * 4 and got["nodes"] == 64
    assert got["lanes"] == 8 and got["tokens"] >= 64
