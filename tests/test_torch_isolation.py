"""The PyTorch port stands alone: it imports neither jax nor the JAX
package, its entry points (the device stages of the store among them) run
on CUDA unless told otherwise, and its kernel wrappers dispatch on the
tensor's device only and build for sm_90a."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from webgraph_ans_torch import ANSBvGraph, TorchGraphDecoder, reconstruct
from webgraph_ans_torch.bvgraph.graph import Adjacency
from webgraph_ans_torch.bvgraph.store import compress_adjacency
from webgraph_ans_torch.ops import cuda_build, decode_cuda, encode_cuda
from webgraph_ans_torch.ops.encode_torch import encode_plan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ISOLATED = r"""
import importlib, pkgutil, sys
import numpy as np
import webgraph_ans_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in mods:
    importlib.import_module(name)
from webgraph_ans_torch import ANSBvGraph, TorchGraphDecoder, reconstruct
from webgraph_ans_torch.bvgraph.graph import Adjacency
from webgraph_ans_torch.bvgraph.store import compress_adjacency
rng = np.random.default_rng(2)
lists = [sorted(rng.choice(60, size=int(rng.integers(0, 8)), replace=False).tolist())
         for _ in range(60)]
res = compress_adjacency(Adjacency.from_lists(lists), 7, 3, 2)
g = ANSBvGraph(res.prelude, res.states, res.pointers)
vals, comps = TorchGraphDecoder(g, device="cpu").decode_tokens(4)
off, succs = reconstruct(vals, comps, g.num_nodes, 2, device="cpu")
assert Adjacency(off, succs).to_lists() == lists
res = compress_adjacency(Adjacency.from_lists(lists), 7, 3, 2, encode_blocks=4,
                         use_tpu_model_search=True, device="cpu")
from webgraph_ans_torch.bvgraph.sequential import ANSBvGraphSeq
assert ANSBvGraphSeq(res.prelude).decode_all().to_lists() == lists
import webgraph_ans_torch.cli
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "webgraph_ans_tpu"))
print(len(mods), "modules;", "leaked:", bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", _ISOLATED], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "leaked: []" in res.stdout


def _small_graph():
    lists = [[1, 2], [0, 2], [0, 1, 5], [3], [], [0, 4]]
    res = compress_adjacency(Adjacency.from_lists(lists), 7, 3, 2)
    return ANSBvGraph(res.prelude, res.states, res.pointers), lists


def test_entry_points_need_cuda_or_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g, lists = _small_graph()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchGraphDecoder(g)
    vals, comps = TorchGraphDecoder(g, device="cpu").decode_tokens(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        reconstruct(vals, comps, g.num_nodes, 2)
    off, succs = reconstruct(vals, comps, g.num_nodes, 2, device="cpu")
    assert Adjacency(off, succs).to_lists() == lists


def test_kernel_wrapper_dispatches_on_device_only():
    """CPU tensors take the plain version without touching the kernel or
    its launch count; a tensor on another device raises."""
    g, _ = _small_graph()
    dec = TorchGraphDecoder(g, device="cpu")
    pl = dec.plan(2)
    before = decode_cuda.decode_blocks.launches
    out, counts, ok = decode_cuda.decode_blocks(
        dec.tables, pl["states"], pl["ptrs"], pl["starts"], pl["ends"],
        pl["ring"], dec.window, dec.min_interval, pl["cap"])
    assert bool(ok.all()) and decode_cuda.decode_blocks.launches == before
    meta = pl["states"].to("meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        decode_cuda.decode_blocks(dec.tables, meta, meta, meta, meta, meta,
                                  dec.window, dec.min_interval, pl["cap"])


def test_kernel_build_command(monkeypatch, tmp_path):
    """The kernel builds with nvcc for sm_90a into the build directory
    (nvcc itself is stubbed: it exists only where the card is)."""
    calls = []

    class FakeNvcc:
        returncode = 0

        def __init__(self, cmd, **kw):
            calls.append(cmd)
            open(cmd[cmd.index("-o") + 1], "wb").close()

        def communicate(self):
            return "ptxas info", None

    lib = str(tmp_path / "build" / "libdecode_blocks.so")
    monkeypatch.setattr(decode_cuda, "LIB_PATH", lib)
    monkeypatch.setattr(cuda_build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(cuda_build.subprocess, "Popen", FakeNvcc)
    info = decode_cuda.build()
    assert info["path"] == lib and os.path.exists(lib)
    cmd = calls[0]
    assert cmd[0] == "nvcc" and "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[-1] == decode_cuda.SOURCE and "-shared" in cmd
    assert decode_cuda.build()["seconds"] == 0.0 and len(calls) == 1


@pytest.mark.parametrize("flags", [dict(encode_blocks=4),
                                   dict(use_tpu_model_search=True)],
                         ids=["encode_blocks", "model_search"])
def test_store_device_stages_need_cuda_or_explicit_cpu(monkeypatch, flags):
    """A device stage of the store raises without CUDA unless given
    device="cpu"; the serial host store needs no device at all."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lists = [[1, 2], [0, 2], [0, 1, 5], [3], [], [0, 4]]
    adj = Adjacency.from_lists(lists)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compress_adjacency(adj, 7, 3, 2, **flags)
    host = compress_adjacency(adj, 7, 3, 2)
    res = compress_adjacency(adj, 7, 3, 2, device="cpu", **flags)
    g = ANSBvGraph(res.prelude, res.states, res.pointers)
    assert g.successors_batch(np.arange(6, dtype=np.uint64)).to_lists() \
        == lists
    if "use_tpu_model_search" in flags:
        assert res.prelude.to_bytes() == host.prelude.to_bytes()


def test_encode_wrapper_dispatches_on_device_only():
    """CPU tensors take the plain version without touching the kernel or
    its launch count; a tensor on another device raises."""
    g, _ = _small_graph()
    vals = np.array([3, 1, 0, 2, 0, 5, 1], np.uint64)
    comps = np.array([0, 7, 0, 7, 0, 0, 8], np.uint8)
    plan = encode_plan(g.prelude.model, vals, comps, 2, device="cpu")
    before = encode_cuda.encode_blocks.launches
    out = encode_cuda.encode_blocks(plan.params, plan.tab, plan.tokens,
                                    plan.tstart, plan.tend, plan.cap)
    assert bool(out[4].all()) and encode_cuda.encode_blocks.launches == before
    meta = plan.tokens.to("meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        encode_cuda.encode_blocks(plan.params, plan.tab, meta, plan.tstart,
                                  plan.tend, plan.cap)
    # a component id past the 9 components is refused before any launch
    for bad in (9, -1):
        tokens = plan.tokens.clone()
        tokens[3, 1] = bad
        with pytest.raises(ValueError, match="components must be 0..8"):
            encode_cuda.encode_blocks(plan.params, plan.tab, tokens,
                                      plan.tstart, plan.tend, plan.cap)
    assert encode_cuda.encode_blocks.launches == before


def test_encode_kernel_build_command(monkeypatch, tmp_path):
    """The encode kernel builds with nvcc for sm_90a, from its own source,
    into the build directory (nvcc stubbed as in test_kernel_build_command)."""
    calls = []

    class FakeNvcc:
        returncode = 0

        def __init__(self, cmd, **kw):
            calls.append(cmd)
            open(cmd[cmd.index("-o") + 1], "wb").close()

        def communicate(self):
            return "ptxas info", None

    lib = str(tmp_path / "build" / "libencode_blocks.so")
    monkeypatch.setattr(encode_cuda, "LIB_PATH", lib)
    monkeypatch.setattr(cuda_build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(cuda_build.subprocess, "Popen", FakeNvcc)
    info = encode_cuda.build()
    assert info["path"] == lib and os.path.exists(lib)
    cmd = calls[0]
    assert cmd[0] == "nvcc" and "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[-1] == encode_cuda.SOURCE and "-shared" in cmd
    assert cmd[-1].endswith("csrc/encode_blocks.cu")
