"""A fixup node layout with one path thousands of levels deep, and the
lists it resolves to, computed level by level without the fixup: the
root holds `width` elements of its own; every later node of the path
holds one of its own and copies its parent's first width - 1 successors;
a few one-node paths branch off rows of the long path (waiting on their
ready flags) and copy their parent's last successor."""

import numpy as np
import torch

from webgraph_ans_torch.ops.fixup_cuda import FOLLOWS

G = 8


def deep_path_layout(levels: int, width: int = 3, branches: int = 20,
                     seed: int = 0):
    """(val [S, G] int32, nodes [nd, 5], srcs [E], lists): the layout and
    each row's sorted list (lists[q], in row order)."""
    rng = np.random.default_rng(seed)
    nd = levels + branches
    S = width * (-(-nd // G))
    val = rng.integers(0, 1 << 20, (S, G)).astype(np.int32)
    # row q's output rows, in lane q % G
    start = width * (np.arange(nd) // G) * G + np.arange(nd) % G
    parents = np.concatenate([[-1], np.arange(levels - 1),
                              rng.integers(0, levels, branches)])
    nodes, srcs, lists = [], [], []
    for q in range(nd):
        own = int(start[q])
        if q == 0:
            src = [own + k * G for k in range(width)]
            vals = [int(val.flat[s]) for s in src]
            link = -1
        else:
            p = int(parents[q])
            j = range(width - 1) if q < levels else (width - 1,)
            src = [own] + [~k for k in j]
            vals = [int(val.flat[own])] + [lists[p][k] for k in j]
            link = FOLLOWS if q < levels else p
            if q >= levels:
                nodes[p][4] = 1
        nodes.append([len(srcs), len(src), own, link, 0])
        srcs += src
        lists.append(sorted(vals))
    return (torch.from_numpy(val), torch.tensor(nodes, dtype=torch.int32),
            torch.tensor(srcs, dtype=torch.int32), lists)


def resolved(val, nodes, lists):
    """val with each row's list written to its output rows."""
    out = val.clone().view(-1)
    for (_, deg, start, _, _), lst in zip(nodes.tolist(), lists):
        out[start + np.arange(deg) * val.shape[1]] = torch.tensor(
            lst, dtype=torch.int32)
    return out.view(val.shape)
