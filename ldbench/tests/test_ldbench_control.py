"""The controls of ``correct`` at a size a test run holds: where the
program reads 0 mismatches, the reference computed in float32 and the
port's own float32 scan (no exact refinish) do not."""

import pytest

from ldbench.control import readings


@pytest.mark.parametrize("seed", [1, 2])
def test_the_float32_controls_fail_a_scan(tiny, seed):
    out = readings(tiny, "t21_scan", seed, "cpu")
    assert out["program"] == 0
    assert out["f32_reference"] > 0
    assert out["port_f32_scan"] > 0


def test_the_float32_control_fails_a_mixed_ploidy_scan(tiny):
    out = readings(tiny, "tX_scan", 3, "cpu")
    assert out["program"] == 0 and out["f32_reference"] > 0
    assert "port_f32_scan" not in out  # the segments need the exact finish


def test_the_float32_control_fails_ld_area(tiny):
    out = readings(tiny, "t21_area", 2, "cpu")
    assert out["program"] == 0 and out["f32_reference"] > 0


@pytest.mark.chip
@pytest.mark.parametrize("cell", ["chr21_scan_w1mb"])
def test_the_controls_fail_at_the_cells_size(card, cell):
    from ldbench.spec import Spec

    out = readings(Spec(), cell, 4294967357)
    assert out["program"] == 0 and out["f32_reference"] > 0
