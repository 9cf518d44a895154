"""The merged-emit kernel's plain version against decode_emit_pallas
(interpret mode) on the artifacts whose nodes go dirty across lanes: a
phase-sampled one without intervals, where lanes start at entry points
with no halo (row code 7), and a window-16 one with safe breaks; each also
runs at a small ring depth (row codes 8 and 9). The harness is
test_torch_emit.py's; the work is split over two files so that the test
runner's workers share it.
"""

import pytest

from test_torch_emit import _Runs, cases, check_case, codes_seen

HERE = ("no_intervals_sampled", "w16_safe")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _Runs(tmp_path_factory.mktemp("torch_emit_dirty"))


@pytest.mark.parametrize("name,T,mark_deg", cases(HERE))
def test_emit_plain_matches_pallas_dirty(runs, name, T, mark_deg):
    check_case(runs, name, T, mark_deg)


def test_fixtures_hit_dirty_codes_across_lanes(runs):
    """Cross-lane parents (7), tainted parents (8), ring overflow (9)."""
    assert {7, 8, 9} <= codes_seen(runs, HERE)
