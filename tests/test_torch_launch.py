"""The port's launcher (python -m webgraph_ans_torch.launch) in real
processes over gloo on the host: two ranks on the 400-node graphs of
tests/multihost_worker.py (std and hc) and on the 900-node synth graph of
tests/test_launch.py, with the ordered gather checked against the
adjacency and each rank's shard against the JAX package's
MultihostGraphDecoder on the same node range (run in the test process);
and a rank made to fail, after which the launcher ends the other rank
and returns nonzero. Every launch runs under a subprocess timeout of
120 s."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from webgraph_ans_tpu.bvgraph.random_access import ANSBvGraph as JaxGraph
from webgraph_ans_tpu.parallel.multihost import (
    MultihostGraphDecoder as JaxMultihost)
from webgraph_ans_torch import launch
from webgraph_ans_torch.ans.prelude import save_pointers, save_states
from webgraph_ans_torch.bvgraph.graph import Adjacency
from webgraph_ans_torch.bvgraph.store import compress_adjacency
from webgraph_ans_torch.bvgraph.synth import synth_web_graph

import jax_native_build

# the JAX package's native library, built once before any test loads it
jax_native_build.ensure()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120


def _save(res, base, step=1):
    prelude, states, pointers = res.prelude, res.states, res.pointers
    if step > 1:
        import dataclasses

        prelude = dataclasses.replace(prelude, phase_step=step)
        n = prelude.num_nodes
        rev = (n - 1 - np.arange(0, n, step))[::-1]
        states, pointers = states[rev], pointers[rev]
    prelude.save(base)
    save_states(base, states)
    save_pointers(base, pointers)


def _launch(base, *flags, timeout=TIMEOUT):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "-m", "webgraph_ans_torch.launch", base, *flags],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)


def _reports(stdout):
    lines = [json.loads(x) for x in stdout.splitlines() if x.startswith("{")]
    return ([r for r in lines if "process" in r],
            [r for r in lines if "gathered" in r])


def _worker_graph(mode):
    """tests/multihost_worker.py's 400-node graph and its compression."""
    rng = np.random.default_rng(424)
    lists = [sorted(rng.choice(400, size=int(rng.integers(0, 12)),
                               replace=False).tolist()) for _ in range(400)]
    adj = Adjacency.from_lists(lists)
    if mode == "hc":
        return adj, compress_adjacency(adj, 16, 2_000_000_000, 4,
                                       safe_break_interval=64)
    return adj, compress_adjacency(adj, 7, 3, 2)


def _check_gather(path, adj):
    z = np.load(path)
    assert z["offsets"].dtype == np.uint64 and z["succs"].dtype == np.uint32
    np.testing.assert_array_equal(z["succs"], adj.succs)
    np.testing.assert_array_equal(z["offsets"].astype(np.int64),
                                  adj.offsets.astype(np.int64))
    return z


@pytest.mark.parametrize("mode", ["std", "hc"])
def test_two_gloo_ranks_match_jax_shards(tmp_path, mode):
    """Two ranks over gloo: their node ranges are contiguous, disjoint and
    cover the graph, the gathered CSR equals the adjacency, and each
    rank's shard equals the JAX package's shard decoder on that range
    (hc: the ranks start mid-window, so rank 1 resolves the reference
    closure before its shard)."""
    adj, res = _worker_graph(mode)
    base, out = str(tmp_path / "g"), str(tmp_path / "csr.npz")
    _save(res, base)
    run = _launch(base, "--local-dryrun", "2", "--device", "cpu",
                  "--reps", "1", "--lanes-per-host", "8", "--gather", out)
    assert run.returncode == 0, run.stderr[-3000:]
    reports, gathered = _reports(run.stdout)
    reports.sort(key=lambda r: r["process"])
    assert [r["process"] for r in reports] == [0, 1]
    assert all(r["num_processes"] == 2 and r["backend"] == "gloo"
               and r["device"] == "cpu" for r in reports)
    assert reports[0]["nodes"][0] == 0 and reports[1]["nodes"][1] == 400
    assert reports[0]["nodes"][1] == reports[1]["nodes"][0]
    assert sum(r["arcs"] for r in reports) == adj.num_arcs
    assert gathered == [dict(gathered[0], total_arcs=adj.num_arcs)]
    z = _check_gather(out, adj)
    offs = z["offsets"].astype(np.int64)
    jmh = JaxMultihost(JaxGraph(res.prelude, res.states, res.pointers),
                       lanes_per_host=8)
    for r in reports:
        lo, hi = r["nodes"]
        jmh.node_lo, jmh.node_hi = lo, hi
        _, _, joff, jsuccs = jmh.decode_shard()
        np.testing.assert_array_equal(
            offs[lo:hi + 1] - offs[lo], joff.astype(np.int64))
        np.testing.assert_array_equal(z["succs"][offs[lo]:offs[hi]], jsuccs)
    if mode == "hc":
        assert reports[1]["stats"]["closure_ranges"]


def test_launch_local_dryrun_gather(tmp_path):
    """tests/test_launch.py's 900-node synth graph: the ordered gather of
    two ranks equals the adjacency."""
    adj = synth_web_graph(900, seed=17)
    base, out = str(tmp_path / "g"), str(tmp_path / "gathered.npz")
    _save(compress_adjacency(adj), base)
    run = _launch(base, "--local-dryrun", "2", "--device", "cpu", "--reps",
                  "1", "--gather", out, "--lanes-per-host", "8")
    assert run.returncode == 0, run.stderr[-3000:]
    reports, _ = _reports(run.stdout)
    assert sorted(r["process"] for r in reports) == [0, 1]
    assert sum(r["arcs"] for r in reports) == adj.num_arcs
    _check_gather(out, adj)


def _running_with(text):
    """Processes whose command line holds `text`."""
    found = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        if text in cmd:
            found.append((int(pid), cmd))
    return found


def test_failed_rank_ends_the_launch(tmp_path):
    """Rank 1's shard starts off an entry point of a phase-sampled
    artifact, so it raises, while rank 0 decodes and waits in the gather:
    the launcher ends rank 0 and returns nonzero well inside its timeout,
    and no rank is left running."""
    lists = [sorted(np.random.default_rng(x).choice(
        300, size=x % 7, replace=False).tolist()) for x in range(301)]
    base, out = str(tmp_path / "sampled"), str(tmp_path / "csr.npz")
    _save(compress_adjacency(Adjacency.from_lists(lists), 7, 3, 2), base,
          step=7)
    run = _launch(base, "--local-dryrun", "2", "--device", "cpu", "--reps",
                  "1", "--gather", out)
    assert run.returncode not in (0, 124), run.stderr[-3000:]
    assert "not a valid entry point" in run.stderr
    assert "ending the others" in run.stderr
    assert not os.path.exists(out)
    assert _running_with(base) == []


def test_launcher_refuses_nccl_on_a_shared_gpu_and_missing_cuda(
        monkeypatch, tmp_path):
    import torch

    with pytest.raises(SystemExit, match="NCCL refuses"):
        launch.main([str(tmp_path / "g"), "--local-dryrun", "2", "--device",
                     "cuda:0", "--backend", "nccl"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        launch.main([str(tmp_path / "g"), "--local-dryrun", "2"])
    with pytest.raises(SystemExit, match="CUDA is not available"):
        launch.main([str(tmp_path / "g")])
