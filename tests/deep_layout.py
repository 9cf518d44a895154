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
    """(val [S, G] int32, nodes [nd, 6], srcs [E], lists): the layout, as
    built (each row ranked over the runs the kernel finds), and each row's
    sorted list (lists[q], in row order)."""
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
        nodes.append([len(srcs), len(src), own, link, 0, -1])
        srcs += src
        lists.append(sorted(vals))
    return (torch.from_numpy(val), torch.tensor(nodes, dtype=torch.int32),
            torch.tensor(srcs, dtype=torch.int32), lists)


def resolved(val, nodes, lists):
    """val with each row's list written to its output rows."""
    out = val.clone().view(-1)
    for (_, deg, start, *_), lst in zip(nodes.tolist(), lists):
        out[start + np.arange(deg) * val.shape[1]] = torch.tensor(
            lst, dtype=torch.int32)
    return out.view(val.shape)


def seeded_chains(seed: int, n: int = 400, lanes: int = 8):
    """emit_post._node_layout's arguments for n seeded nodes laid out in
    `lanes` lanes, and the val channel they index: (args, val [S, G]
    int32). Each node references up to 12 nodes back, and about 70% of
    them are dirty, so dirty chains run many levels deep. A dirty node's
    span holds its elements in a random order with holes between them,
    and its copies of the parent's list as placeholders of distinct
    positions j in a random order; values outside the last lane are
    drawn below 6, so copies and known values tie. Degrees run past 64, so rows
    and parents fall on both sides of the two-run form's limits."""
    from webgraph_ans_torch.ops import emit_post as ep

    rng = np.random.default_rng(seed)
    ids = np.arange(n)
    deg = rng.choice([0, 1, 2, 2, 2, 2, 3, 5, 9, 17, 40, 64, 65, 90], n)
    ref = np.minimum(rng.integers(0, 13, n), ids)
    parent = ids - ref
    dirty = rng.random(n) < 0.7
    ddep = ep.chain_sums(np.where(dirty & (ref > 0), parent, -1),
                         dirty.astype(np.int64))
    order = ids[dirty][np.lexsort((ids[dirty], ddep[dirty]))]
    holes = np.where(dirty, rng.integers(0, 3, n), 0)
    span = deg + holes
    lane = ids % lanes
    first = np.zeros(n, np.int64)          # each node's first row
    for l in range(lanes):
        x = ids[lane == l]
        first[x] = np.cumsum(span[x]) - span[x]
    S = int((first + span).max()) + 1
    G = lanes
    startsF = first * G + lane
    val = rng.integers(0, 1 << 20, (S, G)).astype(np.int32)
    val[:, :-1] %= 6
    ordl, rowf, vals, codes = [], [], [], []
    for o, x in enumerate(order):
        p, d = parent[x], deg[x]
        c = 0
        if ref[x] > 0 and deg[p] > 0:
            c = int(rng.integers(0, min(d, deg[p]) + 1))
        kind = np.array([ep.C_PLACE] * c + [ep.C_EL] * (d - c)
                        + [ep.C_HOLE] * holes[x])
        kind = kind[rng.permutation(len(kind))]
        j = iter(rng.permutation(deg[p])[:c])
        for k, code in enumerate(kind):
            f = startsF[x] + k * G
            ordl.append(o)
            rowf.append(f)
            codes.append(code)
            vals.append(next(j) if code == ep.C_PLACE else val.flat[f])
    mc = {"parent": parent, "ddep": ddep}
    args = (mc, deg, startsF, G, order, np.array(ordl, np.int64),
            np.array(rowf, np.int64), np.array(vals, np.int64),
            np.array(codes, np.int64))
    return args, torch.from_numpy(val)
