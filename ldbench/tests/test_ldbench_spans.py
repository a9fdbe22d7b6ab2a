"""The readers of the program's spans (``ldbench/metrics/scan.open_s.py``
and the rest): a tiny traced run on the CPU gives each a number, except
the device timer of pass 1, which the CPU does not have; a program that
keeps none of these stats (an older checkout) gives None, not an error."""

import types

import pytest

from ldbench.run import run_cell

SCAN = ("scan.open_s", "scan.upload_host_s", "scan.upload_copy_s",
        "scan.format_s", "scan.emit_s", "scan.unspanned_s")
MIXED = ("scanx.repack_s", "scanx.rect_wait_s", "scanx.rect_exact_s")
ALL = SCAN + MIXED + ("scan.pass1_device_s",)


@pytest.mark.parametrize("cell,names", [("t21_scan", SCAN),
                                        ("tX_scan", SCAN + MIXED)])
def test_a_traced_run_reads_every_span(tiny, cell, names):
    out, _ = run_cell(tiny, cell, 2_147_483_659, 0.1, True, "cpu")
    assert out["correct"] is True
    got = out["metrics"]
    for name in names:
        assert got[name]["unit"] == "s" and got[name]["value"] >= 0, name
    assert "scan.pass1_device_s" not in got  # no device timer on the CPU
    assert got["scan.upload_host_s"]["value"] + got["scan.upload_copy_s"][
        "value"] <= got["scan.upload_s"]["value"] + 1e-3
    assert got["scan.format_s"]["value"] + got["scan.emit_s"]["value"] <= (
        got["scan.write_s"]["value"] + 1e-3)


@pytest.mark.parametrize("name", ALL)
def test_a_program_without_the_stats_reads_none(tiny, name):
    run = types.SimpleNamespace(records=[types.SimpleNamespace(
        wall_s=1.0, stats={"write_s": 0.5, "upload_s": 0.2})])
    assert tiny.reader(name)(run) is None
