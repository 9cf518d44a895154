"""The reader of `ra_wave_ms.query`: the port's wave decode seconds (the
`wave_decode` spans the generator logs from `last_wave_seconds`) a
measured batch, on synthetic span lists; None off the card, on the decode
entry and where no measured batch ran a wave decode."""

import math
import types

import pytest

from benchmark import harness

NAME = "ra_wave_ms.query"


def spans(*items):
    """The benchmark's spans: ("batch", attrs) or ("wave_decode", seconds,
    the index of its batch)."""
    out = []
    for item in items:
        if item[0] == "batch":
            out.append({"name": "batch", "parent": None, "start": 0.0,
                        "end": 0.03, **item[1]})
        else:
            out.append({"name": "wave_decode", "parent": item[2],
                        "seconds": item[1]})
    return types.SimpleNamespace(items=out)


def run_of(items, entry="query", peak=1):
    return types.SimpleNamespace(entry=entry, peak_bytes=peak, spans=items)


WINDOW = spans(
    ("batch", {"warmup": True}), ("wave_decode", 0.5, 0),   # set-up
    ("batch", {}), ("wave_decode", 0.008, 2),
    ("batch", {}),                                          # no wave
    ("batch", {}), ("wave_decode", 0.004, 5),
    ("batch", {"traced": True}), ("wave_decode", 0.02, 7))  # traced


def test_mean_wave_ms_over_the_measured_batches():
    got = harness.load_reader(NAME)(run_of(WINDOW))
    assert math.isclose(got, 1e3 * (0.008 + 0.004) / 3, rel_tol=1e-9)


@pytest.mark.parametrize("case", ["off the card", "decode entry",
                                  "no wave", "no batch"])
def test_reader_gives_none(case):
    items = WINDOW
    if case == "no wave":
        items = spans(("batch", {}), ("batch", {}),
                      ("batch", {"traced": True}), ("wave_decode", 0.01, 2))
    elif case == "no batch":
        items = spans()
    run = run_of(items, entry="decode" if case == "decode entry"
                 else "query", peak=None if case == "off the card" else 1)
    assert harness.load_reader(NAME)(run) is None
