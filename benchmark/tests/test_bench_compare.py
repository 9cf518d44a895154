"""The list comparison: exact answers pass; one altered arc, a swapped
query order or a list cut short fail."""

import numpy as np
import torch

from benchmark.reference import lists

OFFS = np.array([0, 2, 2, 5, 6], np.int64)
SUCCS = np.array([1, 3, 0, 1, 2, 3], np.int32)


def wrong_of_query(q, offs, vals):
    offs = np.asarray(offs, np.int64)
    return lists.count_wrong(
        torch.from_numpy(OFFS), torch.from_numpy(SUCCS), torch.from_numpy(q),
        torch.from_numpy(offs[:-1]), torch.from_numpy(np.diff(offs)), 1,
        torch.from_numpy(np.asarray(vals, np.int64)))


def test_exact_query_answer_passes():
    q = np.array([3, 0, 0, 2, 1], np.int64)
    offs, vals = lists.lists_of(OFFS, SUCCS, q)
    assert wrong_of_query(q, offs, vals) == 0


def test_one_altered_arc_fails():
    q = np.array([3, 0, 2], np.int64)
    offs, vals = lists.lists_of(OFFS, SUCCS, q)
    vals = vals.copy()
    vals[3] += 1
    assert wrong_of_query(q, offs, vals) == 1


def test_swapped_query_order_fails():
    q = np.array([0, 2], np.int64)
    offs, vals = lists.lists_of(OFFS, SUCCS, q[::-1].copy())
    assert wrong_of_query(q, offs, vals) == 2


def test_short_or_out_of_range_answers_fail():
    q = np.array([2], np.int64)
    assert wrong_of_query(q, [0, 2], [0, 1]) == 1       # a list cut short
    assert wrong_of_query(q, [0, 3], [0, 1]) == 1       # past the values
    assert wrong_of_query(q, [0, 3], []) == 1           # no values at all


def test_strided_layout_of_the_full_decode():
    # node x's k-th successor at values[start[x] + k * L], L = 2 columns
    L = 2
    grid = np.full((4, L), -1, np.int64)
    start = np.array([0, 0, 1, 7], np.int64)
    for x in range(4):
        for k, v in enumerate(SUCCS[OFFS[x]:OFFS[x + 1]]):
            grid.reshape(-1)[start[x] + k * L] = v
    args = (torch.from_numpy(OFFS), torch.from_numpy(SUCCS),
            torch.arange(4), torch.from_numpy(start),
            torch.from_numpy(np.diff(OFFS)), L)
    assert lists.count_wrong(*args, torch.from_numpy(grid)) == 0
    grid.reshape(-1)[start[2] + 2 * L] += 1
    assert lists.count_wrong(*args, torch.from_numpy(grid)) == 1
