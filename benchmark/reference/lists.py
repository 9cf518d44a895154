"""The plain side of the comparison: a configuration's lists, from the
frozen reader or generator its graph names, and the count of lists that
an answer gets wrong.

Nothing here imports the program; the answers it judges arrive as
tensors or arrays in the layouts the program documents.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import bvgraph_plain, synth_plain


def graph_lists(graph: dict, bench_dir: str):
    """(offsets int64 [n + 1], succs int32 [arcs]) of the graph a
    configuration names: {"kind": "bvgraph", "basename": path under the
    benchmark's folder}, or {"kind": "synth", "nodes": n, "seed": s} for
    the tests' small graphs."""
    kind = graph["kind"]
    if kind == "bvgraph":
        return bvgraph_plain.read_bvgraph(
            os.path.join(bench_dir, graph["basename"]))
    if kind == "synth":
        return synth_plain.synth_web_graph(int(graph["nodes"]),
                                           seed=int(graph["seed"]))
    raise ValueError(f"unknown graph kind {kind!r}")


def lists_of(offsets: np.ndarray, succs: np.ndarray, nodes: np.ndarray):
    """(offs int64 [len(nodes) + 1], vals) : the lists of `nodes`, in
    their order, repeats included."""
    nodes = np.asarray(nodes, np.int64)
    d = offsets[nodes + 1] - offsets[nodes]
    offs = np.zeros(len(nodes) + 1, np.int64)
    np.cumsum(d, out=offs[1:])
    idx = np.repeat(offsets[nodes] - offs[:-1], d) + np.arange(offs[-1])
    return offs, succs[idx]


def count_wrong(ref_offsets: torch.Tensor, ref_succs: torch.Tensor,
                nodes: torch.Tensor, got_start: torch.Tensor,
                got_deg: torch.Tensor, got_stride: int,
                got_values: torch.Tensor) -> int:
    """How many of the answer's lists differ from the reference's.

    Answer list i is node nodes[i]'s: got_deg[i] values, the k-th at
    got_values[got_start[i] + k * got_stride]. A list is wrong when its
    length differs, when one of its values differs, or when one of its
    positions lies outside got_values. All tensors on one device;
    integer values are compared as int64."""
    nodes = nodes.long()
    lo = ref_offsets[nodes]
    ref_deg = ref_offsets[nodes + 1] - lo
    bad = ref_deg != got_deg.long()
    d = torch.where(bad, torch.zeros_like(ref_deg), ref_deg)
    total = int(d.sum())
    if total and got_values.numel() == 0:
        bad |= d > 0
    elif total:
        owner = torch.repeat_interleave(
            torch.arange(len(nodes), device=nodes.device), d)
        first = torch.cumsum(d, 0) - d
        k = torch.arange(total, device=nodes.device) - first[owner]
        gi = got_start.long()[owner] + k * got_stride
        inside = (gi >= 0) & (gi < got_values.numel())
        got = got_values.reshape(-1)[
            gi.clamp(0, got_values.numel() - 1)].long()
        ref = ref_succs[lo[owner] + k].long()
        differs = (got != ref) | ~inside
        bad[owner[differs]] = True
    return int(bad.sum())
