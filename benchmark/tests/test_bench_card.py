"""On the card: a short run of each configuration's decode cell through
run.py, correct, with its metrics. Skipped without a GPU; run on the
card with `python3 -m pytest benchmark/tests -m cuda`."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import system

from conftest import need_card


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["cnr2000.decode"])
def test_short_run_on_the_card(cell):
    need_card()
    out = subprocess.run(
        [sys.executable, os.path.join(system.BENCH_DIR, "run.py"),
         "--workload", cell, "--seed", "2147483659", "--seconds", "2",
         "--trace", "0"], capture_output=True, text=True, timeout=1200,
        cwd=system.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert "decode_ns_per_arc" in res["metrics"]
