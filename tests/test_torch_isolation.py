"""The PyTorch port stands alone: it imports neither jax nor the JAX
package (nor does its launcher's process), its entry points (the device stages of the store among them) run
on CUDA unless told otherwise, and its kernel wrappers dispatch on the
tensor's device only and build for sm_90a."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from webgraph_ans_torch import (ANSBvGraph, TorchCsrServer,
                                TorchEmitRandomAccess, TorchGraphDecoder,
                                TorchRandomAccess, reconstruct)
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
dec = TorchGraphDecoder(g, device="cpu")
off, succs, E = dec.decode_to_csr_device(4)
assert Adjacency(off.numpy().astype(np.uint64),
                 succs[:E].numpy().astype(np.uint32)).to_lists() == lists
from webgraph_ans_torch import TorchCsrServer, TorchRandomAccess
q = [5, 0, 5, 59]
assert TorchRandomAccess(dec).successors_batch(q).to_lists() \
    == [lists[x] for x in q]
assert TorchCsrServer(dec, 4).successors_batch(q).to_lists() \
    == [lists[x] for x in q]
res = compress_adjacency(Adjacency.from_lists(lists), 7, 3, 2, encode_blocks=4,
                         use_tpu_model_search=True, device="cpu")
from webgraph_ans_torch.bvgraph.sequential import ANSBvGraphSeq
assert ANSBvGraphSeq(res.prelude).decode_all().to_lists() == lists
from webgraph_ans_torch import (MultihostGraphDecoder, ShardedGraphDecoder,
                                dryrun)
v2, c2 = ShardedGraphDecoder(g, ["cpu"] * 2).decode_tokens(2)
assert np.array_equal(v2, vals) and np.array_equal(c2, comps)
lo, hi, off, succs = MultihostGraphDecoder(g, 4, device="cpu").decode_shard()
assert (lo, hi) == (0, 60) and Adjacency(off, succs).to_lists() == lists
dryrun.dryrun_multichip(2, device="cpu")
from webgraph_ans_torch.ans import codec, pyencoder, reference_codec, refsize
model, stream, states, ptrs, final = pyencoder.encode_graph_py(lists)
assert refsize.reference_ans_payload_bytes(model, len(stream)) > 0
enc = codec.encode_raw(model, np.array([3, 1]), np.array([0, 0]))
assert codec.decode_raw(model, enc.stream, enc.final_state,
                        np.array([0, 0])).tolist() == [1, 3]
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


_LAUNCH_ISOLATED = r"""
import sys
from webgraph_ans_torch import launch
rc = launch.main(sys.argv[1:])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "webgraph_ans_tpu"))
print("leaked:", bad)
sys.exit(rc or (1 if bad else 0))
"""


def test_launcher_imports_no_jax(tmp_path):
    """The launcher in a process of its own, one rank in a gloo group of
    one, with the ordered gather: its lists are the graph's, and neither
    jax nor the JAX package was imported."""
    from webgraph_ans_torch.ans.prelude import save_pointers, save_states

    lists = [[1, 2], [0, 2], [0, 1, 5], [3], [], [0, 4]]
    res = compress_adjacency(Adjacency.from_lists(lists), 7, 3, 2)
    base, out = str(tmp_path / "g"), str(tmp_path / "csr.npz")
    res.prelude.save(base)
    save_states(base, res.states)
    save_pointers(base, res.pointers)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    run = subprocess.run(
        [sys.executable, "-c", _LAUNCH_ISOLATED, base, "--num-processes",
         "1", "--backend", "gloo", "--device", "cpu", "--reps", "1",
         "--lanes-per-host", "2", "--gather", out],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "leaked: []" in run.stdout and '"backend": "gloo"' in run.stdout
    z = np.load(out)
    assert Adjacency(z["offsets"], z["succs"]).to_lists() == lists


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


def test_sort_path_and_random_access_need_cuda_or_explicit_cpu(
        monkeypatch):
    """The sort path and the three random-access classes run on their
    decoder's device: without CUDA, only a decoder made with device="cpu"
    serves them."""
    g, lists = _small_graph()
    dec = TorchGraphDecoder(g, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchGraphDecoder(g).decode_to_csr_device(2)
    off, succs, E = dec.decode_to_csr_device(2)
    assert off.device.type == "cpu" == succs.device.type
    assert Adjacency(off.numpy().astype(np.uint64),
                     succs[:E].numpy().astype(np.uint32)).to_lists() == lists
    q = [2, 5, 2]
    for cls in (TorchRandomAccess, TorchCsrServer, TorchEmitRandomAccess):
        assert cls(dec).successors_batch(q).to_lists() == [lists[x]
                                                           for x in q]


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
