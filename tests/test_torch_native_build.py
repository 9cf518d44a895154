"""tests/jax_native_build.py against the race it repairs: processes that
start together while the JAX package's native library is missing. A copy
of webgraph_ans_tpu/native is built in a temporary directory while another
process loads the library the moment its path appears; every load must
find a complete library ("file too short" was the in-place build's
fault, seen under the tier-1 command's six workers)."""

import os
import shutil
import subprocess
import sys

import jax_native_build

TESTS = os.path.dirname(os.path.abspath(__file__))

_LOAD_ON_SIGHT = r"""
import ctypes, os, sys, time
lib = os.path.join(sys.argv[1], "libwgans.so")
t0 = time.time()
while not os.path.exists(lib):
    if time.time() - t0 > 300:
        sys.exit("the library never appeared")
    time.sleep(0.0005)
ctypes.CDLL(lib)
print("loaded")
"""

_ENSURE = r"""
import ctypes, os, sys, time
import jax_native_build
time.sleep(float(sys.argv[2]))
jax_native_build.ensure(sys.argv[1])
ctypes.CDLL(os.path.join(sys.argv[1], "libwgans.so"))
print("loaded")
"""


def test_concurrent_builds_never_expose_a_partial_library(tmp_path):
    native = tmp_path / "native"
    native.mkdir()
    shutil.copy(os.path.join(jax_native_build.JAX_NATIVE_DIR, "Makefile"),
                native)
    shutil.copytree(os.path.join(jax_native_build.JAX_NATIVE_DIR, "src"),
                    native / "src")
    assert not jax_native_build.fresh(str(native))
    env = dict(os.environ, PYTHONPATH=TESTS)
    procs = [subprocess.Popen([sys.executable, "-c", _LOAD_ON_SIGHT,
                               str(native)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)]
    # staggered starts: the later ones arrive while the first links
    procs += [subprocess.Popen([sys.executable, "-c", _ENSURE, str(native),
                                str(delay)], env=env, stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)
              for delay in (0.0, 0.5, 2.0)]
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0 and out.strip() == "loaded", err
    assert jax_native_build.fresh(str(native))
    # no per-process target is left behind
    assert sorted(os.listdir(native)) == ["Makefile", "libwgans.so", "src"]
