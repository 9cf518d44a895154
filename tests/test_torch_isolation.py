"""The PyTorch port stands alone: it imports neither jax nor the JAX
package, its entry points run on CUDA unless told otherwise, and its kernel
wrapper dispatches on the tensor's device only."""

import os
import subprocess
import sys

import pytest
import torch

from webgraph_ans_torch import ANSBvGraph, TorchGraphDecoder, reconstruct
from webgraph_ans_torch.bvgraph.graph import Adjacency
from webgraph_ans_torch.bvgraph.store import compress_adjacency
from webgraph_ans_torch.ops import decode_cuda

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

    def fake_run(cmd, **kw):
        calls.append(cmd)
        open(cmd[cmd.index("-o") + 1], "wb").close()
        return subprocess.CompletedProcess(cmd, 0, "", "ptxas info")

    lib = str(tmp_path / "build" / "libdecode_blocks.so")
    monkeypatch.setattr(decode_cuda, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(decode_cuda, "LIB_PATH", lib)
    monkeypatch.setattr(decode_cuda, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(decode_cuda.subprocess, "run", fake_run)
    info = decode_cuda.build()
    assert info["path"] == lib and os.path.exists(lib)
    cmd = calls[0]
    assert cmd[0] == "nvcc" and "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[-1] == decode_cuda.SOURCE and "-shared" in cmd
    assert decode_cuda.build()["seconds"] == 0.0 and len(calls) == 1
