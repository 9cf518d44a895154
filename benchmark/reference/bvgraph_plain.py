"""A plain reader of WebGraph's BVGraph format (`<base>.graph` and
`<base>.properties`), in pure Python over a string of bits.

It is the benchmark's own witness of a LAW graph's lists: it shares no
code with the program under test. It follows the format as WebGraph's
BVGraph.java reads it sequentially (default codes: outdegree gamma,
reference unary, block count and blocks gamma, intervals gamma,
residuals zeta_k):

- outdegree d; nothing more when d == 0;
- with a window, the reference r; with r > 0 the copy blocks, which
  alternate copy and skip over the list of node x - r, the first block
  a copy, every block after the first stored as its length - 1, and the
  rest of that list copied when the block count is even;
- with min_interval_length > 0, the interval count, each interval's
  left end (the first as a signed offset from x, the others as the gap
  past the previous interval's end, minus one) and its length -
  min_interval_length;
- the residuals: the first as a signed offset from x, then each gap
  minus one.

The list is the sorted union of the copied values, the intervals and
the residuals.
"""

from __future__ import annotations

import numpy as np

DEFAULT_FLAGS = ""


def read_properties(basename: str) -> dict:
    """The `key=value` lines of `<basename>.properties` (comments left out)."""
    props = {}
    with open(basename + ".properties", encoding="latin-1") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            key, value = line.split("=", 1)
            props[key.strip()] = value.strip()
    return props


def read_bvgraph(basename: str):
    """(offsets int64 [n + 1], succs int32 [arcs]): every node's list, in
    node order. Raises on flags other than the default codes and when the
    lists disagree with the properties' node and arc counts."""
    p = read_properties(basename)
    if p.get("compressionflags", DEFAULT_FLAGS) != DEFAULT_FLAGS:
        raise NotImplementedError(
            f"compression flags {p['compressionflags']!r}: only the default "
            "codes are read")
    n = int(p["nodes"])
    window = int(p["windowsize"])
    min_iv = int(p["minintervallength"])
    zk = int(p.get("zetak", 3))
    raw = np.fromfile(basename + ".graph", dtype=np.uint8)
    bits = (np.unpackbits(raw) + ord("0")).tobytes()
    find = bits.find
    pos = 0

    def unary():
        nonlocal pos
        q = find(b"1", pos)
        if q < 0:
            raise ValueError("the bit stream ended inside a unary code")
        v = q - pos
        pos = q + 1
        return v

    def fixed(k):
        nonlocal pos
        if k == 0:
            return 0
        v = int(bits[pos:pos + k], 2)
        pos += k
        return v

    def gamma():
        m = unary()
        return ((1 << m) | fixed(m)) - 1

    def zeta():
        h = unary()
        left = 1 << (h * zk)
        m = fixed(h * zk + zk - 1)
        if m < left:
            return m + left - 1
        return (m << 1) + fixed(1) - 1

    def nat2int(v):
        return (v >> 1) ^ -(v & 1)

    ring = [[] for _ in range(window + 1)]
    degs = np.zeros(n, np.int64)
    out = []
    for x in range(n):
        d = gamma()
        lst = []
        if d:
            copied = []
            r = unary() if window > 0 else 0
            if r > 0:
                ref = ring[(x - r) % (window + 1)]
                nblocks = gamma()
                i, copy = 0, True
                for b in range(nblocks):
                    length = gamma() + (1 if b else 0)
                    if copy:
                        copied.extend(ref[i:i + length])
                    i += length
                    copy = not copy
                if nblocks % 2 == 0:
                    copied.extend(ref[i:])
            extra = d - len(copied)
            ivs = []
            if extra > 0 and min_iv > 0:
                count = gamma()
                prev = 0
                for j in range(count):
                    if j == 0:
                        left = x + nat2int(gamma())
                    else:
                        left = prev + gamma() + 1
                    length = gamma() + min_iv
                    ivs.extend(range(left, left + length))
                    prev = left + length
            res = []
            nres = extra - len(ivs)
            if nres > 0:
                prev = x + nat2int(zeta())
                res.append(prev)
                for _ in range(nres - 1):
                    prev += zeta() + 1
                    res.append(prev)
            lst = sorted(copied + ivs + res)
            if len(lst) != d:
                raise ValueError(f"node {x}: {len(lst)} successors, "
                                 f"outdegree {d}")
        ring[x % (window + 1)] = lst
        degs[x] = d
        out.extend(lst)
    if len(out) != int(p["arcs"]):
        raise ValueError(f"{len(out)} arcs read, the properties say "
                         f"{p['arcs']}")
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(degs, out=offsets[1:])
    return offsets, np.asarray(out, dtype=np.int32)
