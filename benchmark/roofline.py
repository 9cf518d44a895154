"""Peaks of the card and the least work of the benchmark's calls.

The work is counted from what a call needs, never from how the program
plans it: a full decode reads the artifact's `.ans` bytes once and
writes each successor and each node's offset once, 4 bytes each, so a
plan that pads, splits or re-decodes leaves the bound where it is.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet (80 GB HBM3, 700 W): bytes per second.
HBM_BYTES_PER_S = 3.35e12


def decode_bytes(ans_bytes: int, nodes: int, arcs: int) -> int:
    """Bytes a full decode to the lists must move: the `.ans` file read
    once, 4 B a successor and 4 B a node written once."""
    return int(ans_bytes) + 4 * int(arcs) + 4 * int(nodes)


def decode_seconds(ans_bytes: int, nodes: int, arcs: int) -> float:
    """The least time of a full decode on the card: its bytes over HBM's
    peak rate (the decode's integer work is far below the card's)."""
    return decode_bytes(ans_bytes, nodes, arcs) / HBM_BYTES_PER_S
