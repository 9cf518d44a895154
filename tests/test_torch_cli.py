"""The port's CLI (webgraph_ans_torch.cli, `bvcomp-torch`): the JAX
package's command lines work, compress hands every flag and the device to
the port's store, and bench-seq decodes block-encoded artifacts."""

import json

import numpy as np
import pytest

import webgraph_ans_torch.bvgraph.store as tstore
from webgraph_ans_torch import cli
from webgraph_ans_torch.ans.prelude import save_pointers, save_states
from webgraph_ans_torch.bvgraph.graph import Adjacency, load_bvgraph
from webgraph_ans_torch.bvgraph.sequential import ANSBvGraphSeq

CNR = "tests/data/cnr-2000/cnr-2000"


class _Stub:
    """Records store()'s arguments and returns a minimal result."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args, **kw):
        self.calls.append((args, kw))

        class P:
            num_nodes, num_arcs, stream = 3, 2, np.zeros(5, np.uint16)

        class R:
            prelude, report, seconds = P, [], {"encode": 0.5}
        return R


@pytest.mark.parametrize("subcommand", [True, False],
                         ids=["compress", "positional"])
def test_compress_passes_flags(monkeypatch, capsys, subcommand):
    stub = _Stub()
    monkeypatch.setattr(tstore, "store", stub)
    argv = ["in", "out", "-w", "5", "-c", "2", "-l", "0",
            "--tpu-model-search", "--max-frame-log2", "14",
            "--encode-blocks", "512", "--phase-step", "4",
            "--safe-break", "64", "--device", "cpu"]
    assert cli.main((["compress"] if subcommand else []) + argv) == 0
    (args, kw), = stub.calls
    assert args == ("in", "out", 5, 2, 0)
    assert kw == dict(use_tpu_model_search=True, max_frame_log2=14,
                      encode_blocks=512, phase_step=4, spill_path=None,
                      spill_chunk_tokens=1 << 22, streaming=False,
                      safe_break_interval=64, device="cpu")
    out = json.loads(capsys.readouterr().out)
    assert out["stream_u16"] == 5 and out["stage_seconds"] == {"encode": 0.5}


def test_compress_defaults(monkeypatch, capsys):
    """The JAX package's defaults; the device stays unset (CUDA when a
    device stage runs)."""
    stub = _Stub()
    monkeypatch.setattr(tstore, "store", stub)
    assert cli.main(["in", "out"]) == 0
    (args, kw), = stub.calls
    assert args == ("in", "out", 7, 3, 4)
    assert kw["encode_blocks"] == 1 and not kw["use_tpu_model_search"]
    assert kw["device"] is None and kw["max_frame_log2"] == 12
    capsys.readouterr()


def test_bench_seq_on_block_artifact(tmp_path, capsys):
    """bench-seq on a block-encoded artifact of the port's store, on the
    host and on the device path (--gpu, and the JAX package's --tpu
    spelling), each decoding every arc."""
    rng = np.random.default_rng(3)
    lists = [sorted(rng.choice(300, size=int(rng.integers(0, 12)),
                               replace=False).tolist()) for _ in range(300)]
    res = tstore.compress_adjacency(Adjacency.from_lists(lists), 7, 3, 2,
                                    encode_blocks=8, device="cpu")
    base = str(tmp_path / "g")
    res.prelude.save(base)
    save_states(base, res.states)
    save_pointers(base, res.pointers)
    arcs = sum(map(len, lists))
    for extra in ([], ["--gpu", "--device", "cpu", "--lanes", "4"],
                  ["--tpu", "--device", "cpu", "--lanes", "4"]):
        assert cli.main(["bench-seq", base] + extra) == 0
        assert json.loads(capsys.readouterr().out)["arcs"] == arcs


@pytest.mark.slow
def test_compress_cnr2000_blocks_on_cpu(tmp_path, capsys):
    """The full drive on the CPU: cnr-2000 at 512 encode blocks with the
    device model search, decoded back by the sequential reader."""
    base = str(tmp_path / "cnr")
    assert cli.main(["compress", CNR, base, "-l", "2", "--encode-blocks",
                     "512", "--tpu-model-search", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["nodes"] == 325557 and out["arcs"] == 3216152
    adj, _ = load_bvgraph(CNR)
    seq = ANSBvGraphSeq.load(base).decode_all()
    assert np.array_equal(seq.succs, adj.succs)
