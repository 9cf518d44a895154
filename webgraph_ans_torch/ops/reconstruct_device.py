"""Per-node tables from aux-mode decode output, on the device.

The part of the JAX package's device reconstructor
(webgraph_ans_tpu/ops/reconstruct_device.py) that the merged-emit path
needs: `parse_stats` turns decode_blocks(emit_aux=True) output into each
node's outdegree, reference, parent and reference-chain depth (the
planner's `_safe_boundaries` reads parent and depth), and the buffer
quantizer and token-order cumulative sum that ops/emit_post.py uses.
The sort-path reconstruction built on the same tables is still to port
(ROADMAP module item 4).

Component ids: 0 outdegree, 1 reference, ..., 8 residual gap, 9 node
summary, 0xF invalid (see ops/decode_torch.py).
"""

from __future__ import annotations

import torch

from .decode_torch import NIB_SUM, P_OUT, P_REF, UNROLL


def _quant(x: int) -> int:
    """Buffer-size quantizer: smallest m<<k >= x with m in 4..7 (1, 1.25,
    1.5, 1.75 times a power of two), minimum 16."""
    x = max(int(x), 16)
    k = max(x.bit_length() - 3, 0)
    return -(-x >> k) << k


def unpack_nibbles(cpk: torch.Tensor, rows: int) -> torch.Tensor:
    """[rows//8, L] packed nibble words -> [rows, L] int32 codes."""
    shifts = torch.arange(UNROLL, dtype=torch.int64, device=cpk.device) * 4
    words = cpk.long() & 0xFFFFFFFF
    return ((words[:, None, :] >> shifts[None, :, None]) & 0xF).reshape(
        rows, -1).to(torch.int32)


def _unpack4(out: torch.Tensor, cap: int):
    """Aux-mode decode output -> step-major (v, a1, a2, nib) [cap, L]
    int32 arrays; lane l's tokens run down column l."""
    return (out[:cap], out[cap:2 * cap], out[2 * cap:3 * cap],
            unpack_nibbles(out[3 * cap:], cap))


def _cumsum_tok(x: torch.Tensor) -> torch.Tensor:
    """int32 cumulative sum in token (column-major) order over a
    step-major [rows, L] array."""
    flat = x.t().reshape(-1)
    cs = torch.cumsum(flat, 0, dtype=torch.int64).to(torch.int32)
    return cs.reshape(x.shape[1], x.shape[0]).t()


def _tok_gather(x2d: torch.Tensor, m: torch.Tensor, cap: int):
    """x2d[m % cap, m // cap] for lane-major flat token indices m (clamped
    into the array, as an XLA gather clamps)."""
    G = x2d.shape[1]
    flat = x2d.reshape(-1)
    idx = torch.clamp((m % cap) * G + m // cap, 0, flat.numel() - 1)
    return flat[idx.long()]


def parse_stats(out: torch.Tensor, num_nodes: int, cap: int) -> dict:
    """Per-node tables of an aux-mode decode ([3cap + cap//8, L] output of
    decode_blocks(emit_aux=True), lanes in node order): outdegree d,
    reference ref, parent = x - ref (clamped into [0, n)), and the
    reference-chain depth (0 without a reference, parent's depth + 1
    otherwise), resolved as a wavefront. All int32 [n] on out's device."""
    n = num_nodes
    dev = out.device
    v, _, _, nib = _unpack4(out, cap)
    G = v.shape[1]
    rows = torch.arange(cap, dtype=torch.int32, device=dev)[:, None]
    cols = torch.arange(G, dtype=torch.int32, device=dev)[None, :]
    pos = (cols * cap + rows).expand(cap, G)      # lane-major flat index
    is_out = nib == P_OUT
    is_sum = nib == NIB_SUM

    nd = torch.clamp(_cumsum_tok(is_out.to(torch.int32)) - 1, 0, n - 1)
    # one scatter finds each node's outdegree-token position
    idx = torch.where(is_out, nd, torch.where(is_sum, n + nd, 2 * n))
    spp = torch.zeros(2 * n + 1, dtype=torch.int32, device=dev)
    spp[idx.reshape(-1).long()] = pos.reshape(-1)
    sp = spp[:n]

    d = _tok_gather(v, sp, cap)
    ref = torch.where(_tok_gather(nib, sp + 1, cap) == P_REF,
                      _tok_gather(v, sp + 1, cap), 0)
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    parent = torch.clamp(ids - ref, 0, n - 1)
    depth = torch.where(ref > 0, -1, 0).to(torch.int32)
    for k in range(n):
        if not bool((depth < 0).any()):
            break
        depth = torch.where((depth < 0) & (depth[parent.long()] == k),
                            k + 1, depth).to(torch.int32)
    return dict(d=d, ref=ref, parent=parent, depth=depth)
