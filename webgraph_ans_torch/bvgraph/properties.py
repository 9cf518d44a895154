"""BVGraph `.properties` parsing and compression-flag resolution.

Replaces the input-side configuration handling the reference delegates to the
`webgraph` crate (reference: src/bvgraph/random_access.rs:101-103 loads
`.graph` + `.properties` through `BvGraphSeq::with_basename`).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

# Instantaneous code ids shared with native/src/bitstream.hpp.
UNARY = 0
GAMMA = 1
DELTA = 2
ZETA = 3
NIBBLE = 4

# GOLOMB needs a per-stream modulus parameter that LAW .properties files
# never carry; it stays unsupported (clear error) like in round 1.
_CODE_BY_NAME = {"UNARY": UNARY, "GAMMA": GAMMA, "DELTA": DELTA, "ZETA": ZETA, "NIBBLE": NIBBLE, "GOLOMB": -1}


@dataclasses.dataclass
class BvGraphProperties:
    nodes: int
    arcs: int
    window_size: int
    max_ref_count: int
    min_interval_length: int
    zeta_k: int = 3
    # Per-stream instantaneous codes (BVGraph defaults).
    outdegree_code: int = GAMMA
    reference_code: int = UNARY
    block_code: int = GAMMA
    residual_code: int = ZETA

    @staticmethod
    def load(basename: str) -> "BvGraphProperties":
        path = basename + ".properties"
        props: dict[str, str] = {}
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#") or "=" not in line:
                    continue
                k, v = line.split("=", 1)
                props[k.strip()] = v.strip()

        p = BvGraphProperties(
            nodes=int(props["nodes"]),
            arcs=int(props["arcs"]),
            window_size=int(props.get("windowsize", 7)),
            max_ref_count=int(props.get("maxrefcount", 3)),
            min_interval_length=int(props.get("minintervallength", 4)),
            zeta_k=int(props.get("zetak", 3)),
        )

        flags = props.get("compressionflags", "")
        for token in (t.strip() for t in flags.split("|") if t.strip()):
            stream, _, code_name = token.rpartition("_")
            code = _CODE_BY_NAME.get(code_name)
            if code is None or code < 0:
                raise NotImplementedError(f"unsupported compression flag: {token}")
            if stream == "OUTDEGREES":
                p.outdegree_code = code
            elif stream == "REFERENCES":
                p.reference_code = code
            elif stream in ("BLOCKS", "BLOCK_COUNT"):
                p.block_code = code
            elif stream == "RESIDUALS":
                p.residual_code = code
            elif stream == "OFFSETS":
                pass  # offsets file not used; we build our own
            else:
                raise NotImplementedError(f"unsupported compression flag: {token}")
        return p


def graph_bytes(basename: str) -> np.ndarray:
    """Read-only uint8 view of `.graph`, mmap-backed: multi-GiB inputs
    (eu-2015 is 12.8 GiB) page in on demand instead of loading into RAM
    (reference capability: webgraph MmapHelper, SURVEY.md section 2.2)."""
    return np.memmap(basename + ".graph", dtype=np.uint8, mode="r")


def exists(basename: str) -> bool:
    return os.path.exists(basename + ".graph") and os.path.exists(basename + ".properties")
