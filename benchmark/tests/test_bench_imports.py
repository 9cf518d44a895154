"""The benchmark loads neither JAX nor the JAX package, and its plain
side nothing of the program."""

import ast
import glob
import os
import subprocess
import sys

from benchmark import harness, system

REF_DIR = os.path.join(system.BENCH_DIR, "reference")

# A whole CPU run of each entry, then every file of the benchmark and
# every metric reader: what run.py can reach, loaded in one process.
REACH = """
import glob, importlib, json, os, sys, time
sys.path.insert(0, {root!r})
from benchmark import harness
sys.path.insert(0, os.path.join({root!r}, "benchmark", "tests"))
from conftest import TINY, TINY_DECODE, TINY_QUERY
for cell, mix in (("cnr2000.decode", TINY_DECODE),
                  ("cnr2000.query_uniform", TINY_QUERY)):
    harness.run(cell, 1, 0.01, False, t0=time.perf_counter(), cfg=TINY,
                mix=mix, device="cpu", cache_root={cache!r})
for path in glob.glob(os.path.join({root!r}, "benchmark", "**", "*.py"),
                      recursive=True):
    rel = os.path.relpath(path, {root!r})[:-3].split(os.sep)
    if "tests" in rel:
        continue
    if rel[1] == "metrics":
        harness.load_reader(rel[2])
    else:
        importlib.import_module(".".join(p for p in rel
                                         if p != "__init__"))
print(json.dumps(harness.forbidden_modules()))
"""


def test_run_loads_no_jax(tiny_cache):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run(
        [sys.executable, "-c", REACH.format(root=system.ROOT,
                                            cache=tiny_cache)],
        capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def top_level_imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_names_jax_and_reference_names_no_program():
    for path in glob.glob(os.path.join(system.BENCH_DIR, "**", "*.py"),
                          recursive=True):
        names = set(top_level_imports(path))
        assert not names & set(harness.FORBIDDEN), path
        if path.startswith(REF_DIR + os.sep):
            assert system.PORT not in names, path


def test_reference_alone_loads_no_program():
    code = (f"import sys; sys.path.insert(0, {system.ROOT!r}); "
            "import benchmark.reference.lists; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            f"{{{system.PORT!r}, 'jax', 'webgraph_ans_tpu'}}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "[]"


def test_forbidden_names_compare_whole_top_level_names():
    sys.modules.setdefault("webgraph_ans_tpu_like", sys)
    try:
        assert "webgraph_ans_tpu_like" not in harness.forbidden_modules()
    finally:
        del sys.modules["webgraph_ans_tpu_like"]


def test_a_loaded_jax_is_found(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "webgraph_ans_tpu", sys)
    found = harness.forbidden_modules()
    assert "jax.numpy" in found and "webgraph_ans_tpu" in found
