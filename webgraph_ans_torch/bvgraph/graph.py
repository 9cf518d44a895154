"""In-memory adjacency representation + BVGraph input loading.

`Adjacency` is the framework's exchange format between the host runtime and
the device pipeline: CSR-style offsets + concatenated successors. It plays the
role of the reference's `BvGraphSeq` input iterator
(reference: src/bvgraph/random_access.rs:101-132).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np

from ..utils import native
from . import properties as props_mod


@dataclasses.dataclass
class Adjacency:
    offsets: np.ndarray  # uint64, length n+1
    succs: np.ndarray    # uint32, length num_arcs

    @property
    def num_nodes(self) -> int:
        return len(self.offsets) - 1

    @property
    def num_arcs(self) -> int:
        return int(len(self.succs))

    def successors(self, node: int) -> np.ndarray:
        return self.succs[int(self.offsets[node]) : int(self.offsets[node + 1])]

    def outdegrees(self) -> np.ndarray:
        return np.diff(self.offsets).astype(np.int64)

    @staticmethod
    def from_lists(lists: list[list[int]]) -> "Adjacency":
        offsets = np.zeros(len(lists) + 1, dtype=np.uint64)
        offsets[1:] = np.cumsum([len(l) for l in lists], dtype=np.uint64)
        succs = np.fromiter(
            (s for l in lists for s in l), dtype=np.uint32, count=int(offsets[-1])
        )
        return Adjacency(offsets, succs)

    def to_lists(self) -> list[list[int]]:
        return [list(map(int, self.successors(i))) for i in range(self.num_nodes)]


def load_bvgraph(basename: str) -> tuple[Adjacency, props_mod.BvGraphProperties]:
    """Decodes a WebGraph BVGraph (`basename.graph` + `basename.properties`)
    into an in-memory Adjacency via the native sequential scanner."""
    p = props_mod.BvGraphProperties.load(basename)
    data = props_mod.graph_bytes(basename)
    lib = native.get_lib()
    handle = native.check_ptr(
        lib.wgt_bvgraph_scan(
            native.as_ptr(data, ctypes.c_uint8),
            len(data),
            p.nodes,
            p.window_size,
            p.min_interval_length,
            p.zeta_k,
            p.outdegree_code,
            p.reference_code,
            p.block_code,
            p.residual_code,
        )
    )
    offsets, succs = native.fetch_adjacency(lib, handle)
    return Adjacency(offsets, succs), p
