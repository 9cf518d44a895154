"""Fixtures of the benchmark's own tests: a tiny configuration on the CPU
and a data cache of its own. Tests that need the card carry the `cuda`
marker and decide inside the test whether one is there."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = {"name": "tiny", "graph": {"kind": "synth", "nodes": 600, "seed": 7},
        "nodes": 600, "arcs": 5989,
        "store": {"compression_window": 7, "max_ref_count": 3,
                  "min_interval_length": 2},
        "decode_lanes": 64}
TINY_DECODE = {"entry": "decode", "warmup_calls": 4, "checked": 1,
               "check_range": [1, 2], "min_calls": 3}
TINY_QUERY = {"entry": "query", "batch": 16, "distribution": "uniform",
              "warmup_seed": 1, "warmup_batches": 1, "min_calls": 3}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped without one")


@pytest.fixture(scope="session")
def tiny_cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("bench_cache"))


def need_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
