"""Builds the JAX package's native library safely for the port's tests.

`webgraph_ans_tpu.utils.native.get_lib` runs `make` into
`webgraph_ans_tpu/native/libwgans.so` in place when the library is missing
or older than its sources. Test workers that start together can then load
the file while the linker is still writing it, and `ctypes.CDLL` fails
with "file too short". The port's test files that call the JAX package's
native code call `ensure()` when they are imported, that is while every
worker collects, before any test runs: it builds the library under an
exclusive lock into a per-process name and renames it into place, so the
JAX loader then finds an up-to-date library and never runs `make`.

This module is not a test file; pytest does not collect it.
"""

from __future__ import annotations

import fcntl
import os
import subprocess

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_NATIVE_DIR = os.path.join(REPO, "webgraph_ans_tpu", "native")


def fresh(native_dir: str) -> bool:
    """The JAX loader's own test: the library exists and is no older than
    any .cpp or .hpp under src/."""
    lib = os.path.join(native_dir, "libwgans.so")
    src = os.path.join(native_dir, "src")
    newest = max(os.path.getmtime(os.path.join(src, f))
                 for f in os.listdir(src) if f.endswith((".cpp", ".hpp")))
    return os.path.exists(lib) and os.path.getmtime(lib) >= newest


def ensure(native_dir: str = JAX_NATIVE_DIR) -> None:
    """Builds native_dir's libwgans.so unless it is fresh. The lock is an
    flock on the Makefile, so no lock file is left behind; the library
    appears under its name only once it is complete (os.replace)."""
    with open(os.path.join(native_dir, "Makefile")) as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if fresh(native_dir):
            return
        tmp = f"libwgans.so.{os.getpid()}.tmp"
        subprocess.run(["make", "-s", f"TARGET={tmp}"], cwd=native_dir,
                       check=True, capture_output=True, text=True)
        os.replace(os.path.join(native_dir, tmp),
                   os.path.join(native_dir, "libwgans.so"))
