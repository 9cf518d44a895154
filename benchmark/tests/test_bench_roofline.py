"""The roofline's bytes come from the artifact and the lists alone."""

import types

from benchmark import harness, roofline


def test_decode_bytes():
    assert roofline.decode_bytes(1000, 10, 100) == 1000 + 400 + 40
    assert roofline.decode_seconds(3350, 0, 0) == 3350 / 3.35e12


def test_roofline_reads_only_the_artifact_the_lists_and_the_trace():
    # a run record with nothing of the program's plan: the reader still
    # reads, so it cannot have counted bytes from the plan
    tr = {"ops": 4, "device_s": {"decode_emit_kernel<7>": 4e-3,
                                 "fill": 1e-3},
          "device_total_s": 5e-3, "busy_s": 5e-3, "window_s": 6e-3}
    run = types.SimpleNamespace(entry="decode", ans_bytes=1_053_108,
                                nodes=325_557, arcs=3_216_152, trace=tr)
    share = harness.load_reader("decode_emit_roofline.decode")(run)
    bound = roofline.decode_seconds(1_053_108, 325_557, 3_216_152)
    assert share == 100 * bound / 1e-3
    post = harness.load_reader("post_ms.decode")(run)
    assert abs(post - 0.25) < 1e-12
    idle = harness.load_reader("idle_share.decode")(run)
    assert abs(idle - 100 / 6) < 1e-9


def test_trace_readers_are_silent_without_the_kernel():
    tr = {"ops": 4, "device_s": {"other": 1e-3}, "device_total_s": 1e-3,
          "busy_s": 1e-3, "window_s": 2e-3}
    run = types.SimpleNamespace(entry="decode", ans_bytes=1, nodes=1,
                                arcs=1, trace=tr)
    assert harness.load_reader("decode_emit_roofline.decode")(run) is None
    assert harness.load_reader("post_ms.decode")(run) is None
