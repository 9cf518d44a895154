"""Builds the port's CUDA kernels (csrc/*.cu) with nvcc for sm_90a into
shared libraries with a plain C interface, loaded by ctypes, and checks
the tensors and packs the codec parameters a wrapper hands to a kernel.

A library is rebuilt when it is missing or older than its source or any
shared header in csrc/. `build_many` starts one nvcc per source at once.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import time

import torch

from ..utils import trace

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")


class KernelError(RuntimeError):
    """A CUDA kernel failed to build or to launch. Callers that fall back
    to another path on an unsupported input let this propagate, so that a
    fallback never hides a kernel."""


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if not os.path.exists(path):
        raise KernelError("nvcc not found: the CUDA kernels are built on "
                           "first use and need the CUDA toolkit")
    return path


def _command(source: str, tmp: str) -> list:
    return [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-I", CSRC_DIR, "-o", tmp, source]


def _fresh(source: str, lib_path: str) -> bool:
    if not os.path.exists(lib_path):
        return False
    deps = [source] + glob.glob(os.path.join(os.path.dirname(source),
                                             "*.cuh"))
    return os.path.getmtime(lib_path) >= max(map(os.path.getmtime, deps))


def build(source: str, lib_path: str, force: bool = False) -> dict:
    """Compiles `source` into `lib_path` unless an up-to-date build exists.
    Returns {"path", "seconds", "log", "built"} (log: nvcc's -Xptxas -v
    report, empty when nothing was built)."""
    return build_many([(source, lib_path)], force)[0]


def build_many(pairs, force: bool = False) -> list:
    """Builds several (source, lib_path) pairs with one nvcc each, all
    started together. Returns build()'s dicts in order; raises naming
    every failed source once all compilers have finished. A
    `kernel.build` stage (its sources, and those it built); each nvcc run
    counts in `kernel_builds`."""
    names = [os.path.basename(source) for source, _ in pairs]
    with trace.stage("kernel.build", sources=names) as stage:
        results = _build_many(pairs, force)
        built = [n for n, r in zip(names, results) if r["built"]]
        stage.set(built=built)
    trace.count("kernel_builds", len(built))
    return results


def _build_many(pairs, force: bool) -> list:
    t0 = time.perf_counter()
    procs = []
    for source, lib_path in pairs:
        if not force and _fresh(source, lib_path):
            procs.append(None)
            continue
        os.makedirs(os.path.dirname(lib_path), exist_ok=True)
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        procs.append((tmp, subprocess.Popen(
            _command(source, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    results, errors = [], []
    for (source, lib_path), entry in zip(pairs, procs):
        if entry is None:
            results.append({"path": lib_path, "seconds": 0.0, "log": "",
                            "built": False})
            continue
        tmp, proc = entry
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed ({proc.returncode}) on {source}:\n"
                          f"{log}")
            continue
        os.replace(tmp, lib_path)
        results.append({"path": lib_path,
                        "seconds": time.perf_counter() - t0, "log": log,
                        "built": True})
    if errors:
        raise KernelError("\n".join(errors))
    return results


def codec_params(params):
    """The codec parameters as the kernels' C argument: 47 long longs, 9 x
    (offset, log_m, mask, radix, fold_off), then slots and max_folds."""
    flat = [int(v) for c in range(9) for v in params[c]]
    flat += [int(params[9]), int(params[10])]
    return (ctypes.c_longlong * len(flat))(*flat)


def check(t: torch.Tensor, name: str, dtype, shape, device):
    """Raises unless t lies on `device` with this dtype and shape and is
    contiguous."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
