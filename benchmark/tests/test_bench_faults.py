"""A run with the timed path broken underneath comes out not correct,
once for each fault a cell can have, and so does the control; the same
run unbroken comes out correct. On the CPU: the harness's look for a
card is skipped, the port runs its plain PyTorch versions on a tiny
graph. (The exchange between cards is no fault of these one-card
cells.)"""

import time

import numpy as np
import pytest
import torch

from benchmark import control, harness, system

from conftest import TINY, TINY_DECODE, TINY_QUERY

CELLS = {"decode": ("cnr2000.decode", TINY_DECODE),
         "query": ("cnr2000.query_uniform", TINY_QUERY)}


class Stale(system.PortSystem):
    """Every call after the first hands back the previous answer."""

    last = None

    def decode(self):
        if self.last is None:
            self.last = super().decode()
        return self.last

    def query(self, q):
        if self.last is None:
            self.last = super().query(q)
        return self.last


class Half(system.PortSystem):
    """Half of each answer left out: the second half of the nodes' or
    queries' lists are empty."""

    def decode(self):
        succs2d, starts, degs = super().decode()
        degs = degs.clone()
        degs[len(degs) // 2:] = 0
        return succs2d, starts, degs

    def query(self, q):
        offs, vals = super().query(q)
        offs = np.asarray(offs, np.int64).copy()
        h = len(q) // 2
        offs[h + 1:] = offs[h]
        return offs, vals[:offs[h]]


class Altered(system.PortSystem):
    """One successor altered where it is produced."""

    def decode(self):
        succs2d, starts, degs = super().decode()
        x = int(torch.nonzero(degs > 0)[0])
        succs2d.reshape(-1)[starts[x]] += 1
        return succs2d, starts, degs

    def query(self, q):
        offs, vals = super().query(q)
        vals = np.asarray(vals).copy()
        vals[0] += 1
        return offs, vals


class SortPath(system.PortSystem):
    """Each decode served by the sort path, which runs no merged-emit
    kernel: on the card its launch count stays where it was."""

    def decode(self):
        return self.dec._adjacency_via_sort_path(self.lanes)

    def counters(self):
        return {"decode_emit": 0}


class FullDecode(system.PortSystem):
    """Each batch served by the full-decode plan, not by per-query
    lanes."""

    def query(self, q):
        self.ra._full_decode_cheaper = lambda nuniq: True
        return super().query(q)


def run_cell(kind, make_system, cache):
    cell, mix = CELLS[kind]
    return harness.run(cell, 2**31 + 11, 0.01, False,
                       t0=time.perf_counter(), cfg=TINY, mix=mix,
                       device="cpu", cache_root=cache,
                       make_system=make_system)


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_unbroken_run_is_correct(kind, tiny_cache):
    res = run_cell(kind, system.PortSystem, tiny_cache)
    assert res["correct"], res["checks"]
    assert res["checks"]["answers_checked"]["value"] >= 2
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault", [Stale, Half, Altered],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("kind", sorted(CELLS))
def test_fault_is_not_correct(kind, fault, tiny_cache):
    res = run_cell(kind, fault, tiny_cache)
    assert not res["correct"]
    assert res["checks"]["wrong_lists"]["value"] > 0
    assert res["failed"] >= 1


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_control_is_not_correct(kind, tiny_cache):
    res = run_cell(kind, control.ControlSystem, tiny_cache)
    assert not res["correct"]
    assert res["checks"]["wrong_lists"]["value"] > 0


@pytest.mark.parametrize("kind,path,check", [
    ("decode", SortPath, "emit_launches_per_decode"),
    ("query", FullDecode, "full_decode_batches")])
def test_other_path_is_not_correct(kind, path, check, tiny_cache):
    res = run_cell(kind, path, tiny_cache)
    assert res["checks"]["wrong_lists"]["value"] == 0
    assert check in res["checks"]
    assert not res["correct"]
