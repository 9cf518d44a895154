"""The merged-emit kernel's queue representation against the reference's.

csrc/decode_emit.cu keeps each bounded queue as a circular buffer in
shared memory (`Queue`), with O(1) pushes and pops, where the plain
version (ops/emit_torch._Queue) and the TPU kernel push one-hot and pop by
shifting every slot down. Slot 0 is visible even when a queue is empty
(the stale residual head in `val`, the stale meta head in `xch` under
mark_deg, the fill rows), and a push at a full queue writes nothing but
still counts, so the two must agree on every slot, stale ones included.
`CircularQueue` models the kernel's queue step for step; hypothesis holds
it against `_Queue` on random sequences of pushes and pops.
"""

from __future__ import annotations

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from webgraph_ans_torch.ops.emit_torch import QC, QN, QR, _Queue


class CircularQueue:
    """decode_emit.cu's Queue: logical slot k at physical slot (h + k) % Q;
    a push at logical slot n unless the queue is full (it still counts);
    a pop copies the old last logical slot (physical h - 1) into the
    vacated physical slot h, then advances h."""

    def __init__(self, slots, n: int):
        self.b = [list(s) for s in slots]
        self.Q = len(slots)
        self.h, self.n = 0, n

    def push(self, *fields):
        if self.n < self.Q:
            self.b[(self.h + self.n) % self.Q] = list(fields)
        self.n += 1

    def pop(self):
        self.b[self.h] = list(self.b[(self.h - 1) % self.Q])
        self.h = (self.h + 1) % self.Q
        self.n -= 1

    def slot(self, k: int) -> list:
        return self.b[(self.h + k) % self.Q]


class NaiveCircularQueue(CircularQueue):
    """A plain circular buffer: its pop only advances h."""

    def pop(self):
        self.h = (self.h + 1) % self.Q
        self.n -= 1


class ShiftDown:
    """emit_torch._Queue on one lane, driven one operation at a time."""

    def __init__(self, slots, n: int):
        Q, F = len(slots), len(slots[0])
        rows = torch.tensor(slots, dtype=torch.int32).reshape(Q * F, 1)
        self.q = _Queue(rows, F)
        self.n = torch.tensor([n], dtype=torch.int32)
        self.on = torch.tensor([True])

    def push(self, *fields):
        self.n = self.q.push(self.n, self.on,
                             *(torch.tensor([f], dtype=torch.int32)
                               for f in fields))

    def pop(self):
        self.n = self.q.shift(self.n, self.on)

    def slot(self, k: int) -> list:
        return [int(v) for v in self.q.q[k, :, 0]]


def run(queues, ops):
    """Applies ops ("push", fields) / ("pop",) to every queue, popping
    only a non-empty queue (the kernel pops only then), and checks after
    each that all agree on the count and on every slot."""
    ref, *others = queues
    for op in ops:
        if op[0] == "pop":
            if int(ref.n) == 0:
                continue
            for q in queues:
                q.pop()
        else:
            for q in queues:
                q.push(*op[1])
        for q in others:
            assert int(q.n) == int(ref.n)
            for k in range(q.Q):
                assert q.slot(k) == ref.slot(k), (op, k)


def ints():
    return st.integers(-2 ** 31, 2 ** 31 - 1)


@st.composite
def case(draw, Q: int, F: int):
    """Initial slots (zeroed, or any values as a register file may hold),
    an initial count up to Q, and a run of pushes and pops whose mix
    ranges from push-heavy (full queues, overflow pushes) to pop-heavy
    (empty queues read through slot 0)."""
    zero = draw(st.booleans())
    slots = [[0 if zero else draw(ints()) for _ in range(F)]
             for _ in range(Q)]
    n = draw(st.integers(0, Q))
    push_share = draw(st.sampled_from([0.25, 0.5, 0.75, 0.9]))
    ops = []
    for _ in range(draw(st.integers(0, 4 * Q + 8))):
        if draw(st.floats(0, 1)) < push_share:
            ops.append(("push", [draw(ints()) for _ in range(F)]))
        else:
            ops.append(("pop",))
    return slots, n, ops


# (Q, fields): the copy/interval/residual queues (2 fields), the meta
# queue (3), and small queues that fill at once
SHAPES = [(QC, 2), (QR, 2), (QN, 3), (3, 1), (2, 2)]


def test_shapes_are_the_kernels():
    assert (QC, QR, QN) == (16, 12, 4)


@pytest.mark.parametrize("Q,F", SHAPES)
@settings(max_examples=120, deadline=None, database=None)
@given(data=st.data())
def test_circular_matches_shift_down(Q, F, data):
    slots, n, ops = data.draw(case(Q, F))
    run([ShiftDown(slots, n), CircularQueue(slots, n)], ops)


def test_fixed_sequence_q3():
    """Q = 3, zeroed: push a, pop, push b, push c, pop, pop. The
    shift-down array ends with slot 0 = 0; a plain circular buffer's head
    would read a; the kernel's queue reads 0."""
    a, b, c = [11], [22], [33]
    ops = [("push", a), ("pop",), ("push", b), ("push", c), ("pop",),
           ("pop",)]
    ref, model = ShiftDown([[0]] * 3, 0), CircularQueue([[0]] * 3, 0)
    naive = NaiveCircularQueue([[0]] * 3, 0)
    for q in (ref, model, naive):
        for op in ops:
            q.pop() if op[0] == "pop" else q.push(*op[1])
    assert int(ref.n) == model.n == naive.n == 0
    assert ref.slot(0) == model.slot(0) == [0]
    assert naive.slot(0) == a
    run([ShiftDown([[0]] * 3, 0), CircularQueue([[0]] * 3, 0)], ops)


def test_full_queue_push_counts_and_writes_nothing():
    """Pushes at a full queue count but write nothing; the pops after them
    expose the last slot repeated, as the shift-down pop leaves it."""
    ops = [("push", [v, -v]) for v in range(1, 7)] + [("pop",)] * 6
    run([ShiftDown([[0, 0]] * 4, 0), CircularQueue([[0, 0]] * 4, 0)], ops)
    model = CircularQueue([[0, 0]] * 4, 0)
    for op in ops[:6]:
        model.push(*op[1])
    assert model.n == 6 and [model.slot(k) for k in range(4)] == [
        [1, -1], [2, -2], [3, -3], [4, -4]]
    for _ in range(5):
        model.pop()
    assert model.n == 1 and model.slot(0) == [4, -4]


def test_empty_queue_slot0_after_wraparound():
    """A queue that wraps its head several times and ends empty reads, in
    slot 0, the value the shift-down array holds there."""
    ops = []
    for v in range(1, 40):
        ops += [("push", [v, 2 * v, 3 * v])] * (v % 3 + 1)
        ops += [("pop",)] * (v % 4 + 1)
    ops += [("pop",)] * 8
    ref = ShiftDown([[5, 6, 7]] * QN, 2)
    model = CircularQueue([[5, 6, 7]] * QN, 2)
    run([ref, model], ops)
    assert int(ref.n) == model.n == 0
    assert ref.slot(0) == model.slot(0)
