"""The merged-emit kernel's plain PyTorch version (ops/emit_torch.py) and
its dispatching wrapper (ops/emit_cuda.py) against the TPU kernel
decode_emit_pallas run in interpret mode, fed the same register file.

Small artifacts at 8 lanes, each run in both mark_deg modes, one of them
at a small ring depth. This file holds a serial window-7 artifact with a
node that overflows the interval queue and a window-0 one (row codes 3, 8
and 9); test_torch_emit_dirty.py holds the phase-sampled and window-16
ones (row codes 7, 8 and 9). Every channel is integer and compared
exactly (tolerance 0). One Pallas interpret run costs about 15 s of
tracing, so each artifact runs it twice.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from webgraph_ans_tpu.ans.prelude import save_pointers, save_states
from webgraph_ans_tpu.bvgraph.graph import Adjacency
from webgraph_ans_tpu.bvgraph.random_access import ANSBvGraph as JaxGraph
from webgraph_ans_tpu.bvgraph.store import compress_adjacency
from webgraph_ans_tpu.bvgraph.synth import synth_web_graph
from webgraph_ans_tpu.ops.emit_pallas import decode_emit_pallas
from webgraph_ans_tpu.ops.graph_decode import TpuGraphDecoder
from webgraph_ans_torch.bvgraph.random_access import ANSBvGraph as TorchGraph
from webgraph_ans_torch.ops import cuda_build, emit_cuda, emit_torch
from webgraph_ans_torch.ops.graph_decode import TorchGraphDecoder
import jax_native_build

# the JAX package's native library, built once before any test loads it
jax_native_build.ensure()

LANES = 8
CHANNELS = ("val", "xch", "nib", "rows_used", "ok", "diag")


def _graph(n, seed, overflow_node=None):
    lists = synth_web_graph(n, seed=seed).to_lists()
    if overflow_node is not None:
        # no reference and 20 interval runs (0,1, 3,4, ...): more runs than
        # the interval queue holds before the node's meta is sent
        lists[overflow_node] = [v for k in range(20) for v in (3 * k, 3 * k + 1)]
    return Adjacency.from_lists(lists)


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


# name -> (graph kwargs, compress args, compress kwargs, phase_step,
#          ring depth of the mark_deg run)
ARTIFACTS = {
    "serial_w7": (dict(n=300, seed=21, overflow_node=150), (7, 3, 2), {}, 1,
                  32),
    "window0": (dict(n=200, seed=5), (0, 0, 2), {}, 1, 512),
    "no_intervals_sampled": (dict(n=240, seed=8), (7, 3, 0), {}, 3, 64),
    "w16_safe": (dict(n=200, seed=13), (16, 2_000_000_000, 4),
                 dict(safe_break_interval=32), 1, 32),
}
HERE = ("serial_w7", "window0")


def cases(names):
    """(artifact, T, mark_deg): T = 512 without mark_deg, the artifact's
    own ring depth with it."""
    return [c for name in names
            for c in ((name, 512, False), (name, ARTIFACTS[name][4], True))]


class _Runs:
    """Both packages' outputs per (artifact, T, mark_deg), computed once:
    the JAX emit plan's register file goes to decode_emit_pallas
    (interpret) and, through regs_from_jax, to decode_emit_plain."""

    def __init__(self, root):
        self.root = root
        self.plans = {}
        self.caps = {}
        self.out = {}

    def plan(self, name):
        if name not in self.plans:
            gkw, args, kw, step, _ = ARTIFACTS[name]
            base = str(self.root / name)
            _save(base, compress_adjacency(_graph(**gkw), *args, **kw), step)
            jdec = TpuGraphDecoder(JaxGraph.load(base))
            pl = jdec._emit_plan(LANES)
            tdec = TorchGraphDecoder(TorchGraph.load(base), device="cpu")
            regs = emit_torch.regs_from_jax(np.asarray(pl["init"]), LANES)
            starts = regs[emit_torch.D_X].numpy().astype(np.int64)
            ends = starts + regs[emit_torch.D_LEFT].numpy()
            if tdec.phase_step == 1:
                ptrs = tdec.pointers[np.minimum(starts, tdec.num_nodes - 1)]
            else:
                ptrs = tdec._entry_lookup(starts)[1]
            ptrs = torch.from_numpy(np.where(starts < ends, ptrs, 0))
            self.plans[name] = (jdec, pl, tdec, regs, ptrs)
        return self.plans[name]

    def get(self, name, T, mark_deg):
        key = (name, T, mark_deg)
        if key not in self.out:
            jdec, pl, tdec, regs, ptrs = self.plan(name)
            args = (tdec.tables, regs, ptrs, tdec.window, tdec.min_interval)
            if name not in self.caps:
                # a tight cap keeps the interpret run short; the last rows
                # still cover finished lanes (code 0xF, frozen values)
                rows = emit_torch.decode_emit_plain(*args, pl["cap"])[3]
                self.caps[name] = (int(rows.max()) // 8 + 3) * 8
            cap = self.caps[name]
            got = emit_torch.decode_emit_plain(*args, cap, T, mark_deg)
            want = decode_emit_pallas(
                jdec.params, pl["lut"], pl["slab"], pl["init"], jdec.window,
                jdec.min_interval, cap, T=T, interpret=True,
                mark_deg=mark_deg)
            want = [np.asarray(w)[..., :LANES] for w in want]
            self.out[key] = (want, got)
        return self.out[key]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _Runs(tmp_path_factory.mktemp("torch_emit"))


def _codes(nib: np.ndarray) -> np.ndarray:
    words = nib.astype(np.uint32)
    return ((words[:, None, :] >> (4 * np.arange(8, dtype=np.uint32))[
        None, :, None]) & 0xF).reshape(-1)


def check_case(runs, name, T, mark_deg):
    want, got = runs.get(name, T, mark_deg)
    for ch, w, g in zip(CHANNELS, want, got):
        g = g.numpy()
        if w.dtype == np.uint32:
            g = g.view(np.uint32)
        np.testing.assert_array_equal(g, w, err_msg=ch)
    assert bool(got[4].all()), "a lane did not finish inside the cap"


def codes_seen(runs, names) -> set:
    """Row codes the plain version wrote in the cases of `names`."""
    seen = set()
    for name, T, mark_deg in cases(names):
        got = runs.get(name, T, mark_deg)[1]
        seen |= {int(c) for c in np.unique(_codes(got[2].numpy().view(
            np.uint32)))}
    return seen


@pytest.mark.parametrize("name,T,mark_deg", cases(HERE))
def test_emit_plain_matches_pallas(runs, name, T, mark_deg):
    check_case(runs, name, T, mark_deg)


def test_fixtures_hit_dirty_codes(runs):
    """Queue overflow (3), tainted parents (8) and ring overflow (9)."""
    assert {3, 8, 9} <= codes_seen(runs, HERE)


@pytest.mark.parametrize("name", HERE)
def test_mark_deg_changes_only_xch(runs, name):
    """With mark_deg the marker rows carry outdegrees in xch; every other
    channel equals the run without it."""
    jdec, pl, tdec, regs, ptrs = runs.plan(name)
    args = (tdec.tables, regs, ptrs, tdec.window, tdec.min_interval, 256, 64)
    plain = emit_torch.decode_emit_plain(*args)
    marked = emit_torch.decode_emit_plain(*args, mark_deg=True)
    for i in (0, 2, 3, 4, 5):
        assert torch.equal(plain[i], marked[i]), CHANNELS[i]
    assert not torch.equal(plain[1], marked[1])


@pytest.mark.parametrize("name", HERE)
def test_emit_init_regs_match_jax(runs, name):
    """emit_init_regs on the JAX plan's lane ranges and ring seeds builds
    the register file regs_from_jax reads (the pointer row apart: the
    port keeps absolute pointers outside the register file)."""
    _, pl, tdec, regs, _ = runs.plan(name)
    x = regs[emit_torch.D_X].numpy().astype(np.int64)
    ends = x + regs[emit_torch.D_LEFT].numpy()
    R = tdec.window + 1
    degring = emit_torch._layout(tdec.window)[0]
    ring = regs[degring:degring + R].t().contiguous()
    states = regs[emit_torch.D_STATE].numpy().view(np.uint32).astype(np.int64)
    mine = emit_torch.emit_init_regs(
        states, x, ends, ring, tdec.window,
        real_starts=regs[emit_torch.E_RSTART].numpy())
    keep = torch.ones(mine.shape[0], dtype=torch.bool)
    keep[emit_torch.D_PTR] = False
    np.testing.assert_array_equal(mine[keep].numpy(), regs[keep].numpy())


def test_wrapper_dispatch(runs):
    """CPU tensors run the plain version (no kernel launch); tensors on
    any device but cuda or cpu raise."""
    _, pl, tdec, regs, ptrs = runs.plan("window0")
    before = emit_cuda.decode_emit.launches
    args = (tdec.tables, regs, ptrs, tdec.window, tdec.min_interval, 64)
    got = emit_cuda.decode_emit(*args, T=64)
    want = emit_torch.decode_emit_plain(*args, T=64)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert emit_cuda.decode_emit.launches == before
    meta = regs.to("meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        emit_cuda.decode_emit(tdec.tables, meta, ptrs.to("meta"),
                              tdec.window, tdec.min_interval, 64)


def test_plain_rejects_bad_shapes(runs):
    _, _, tdec, regs, ptrs = runs.plan("window0")
    args = (tdec.tables, regs, ptrs, tdec.window, tdec.min_interval)
    with pytest.raises(ValueError, match="multiple of 8"):
        emit_torch.decode_emit_plain(*args, 60)
    with pytest.raises(ValueError, match="power of two"):
        emit_torch.decode_emit_plain(*args, 64, T=48)
    with pytest.raises(ValueError, match="rows"):
        emit_torch.decode_emit_plain(tdec.tables, regs[1:], ptrs,
                                     tdec.window, tdec.min_interval, 64)


def test_emit_kernel_build_command(monkeypatch, tmp_path):
    """The kernel builds with nvcc for sm_90a beside the token kernel
    (nvcc itself is stubbed: it exists only where the card is)."""
    calls = []

    class FakeNvcc:
        returncode = 0

        def __init__(self, cmd, **kw):
            calls.append(cmd)
            open(cmd[cmd.index("-o") + 1], "wb").close()

        def communicate(self):
            return "ptxas info", None

    lib = str(tmp_path / "build" / "libdecode_emit.so")
    monkeypatch.setattr(emit_cuda, "LIB_PATH", lib)
    monkeypatch.setattr(cuda_build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(cuda_build.subprocess, "Popen", FakeNvcc)
    info = emit_cuda.build()
    assert info["path"] == lib and os.path.exists(lib)
    cmd = calls[0]
    assert cmd[0] == "nvcc" and "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[-1] == emit_cuda.SOURCE and cuda_build.CSRC_DIR in cmd
    assert emit_cuda.build()["seconds"] == 0.0 and len(calls) == 1
