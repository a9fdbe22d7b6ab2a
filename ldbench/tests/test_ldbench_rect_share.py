"""The reader of ``scanx.rect_candidate_share``: 100 x the mean of the
mixed scan's ``rect_candidates`` over the mean of its ``rect_cells``, from
a run's stats and from a tiny traced chrX run on the CPU; None where no
job reports them (a program without the engine's threshold test, or a
chromosome without rectangles)."""

import types

from ldbench.run import run_cell

NAME = "scanx.rect_candidate_share"


def _run(*stats):
    return types.SimpleNamespace(records=[
        types.SimpleNamespace(wall_s=1.0, stats=s) for s in stats])


def test_it_reads_the_candidates_over_the_cells(tiny):
    read = tiny.reader(NAME)
    got = read(_run({"rect_cells": 1000, "rect_candidates": 3},
                    {"rect_cells": 3000, "rect_candidates": 5}))
    assert abs(got - 100.0 * 4 / 2000) < 1e-12


def test_it_reads_none_without_the_counters(tiny):
    read = tiny.reader(NAME)
    assert read(_run({"rect_finish_s": 1.0, "rect_exact_s": 0.5})) is None
    assert read(_run({"rect_cells": 0, "rect_candidates": 0})) is None
    assert read(_run()) is None


def test_a_traced_chrx_run_reads_the_share(tiny):
    out, _ = run_cell(tiny, "tX_scan", 2_147_483_659, 0.1, True, "cpu")
    assert out["correct"] is True
    got = out["metrics"][NAME]
    assert got["unit"] == "%" and 0 < got["value"] < 100
    out, _ = run_cell(tiny, "t21_scan", 2_147_483_659, 0.1, True, "cpu")
    assert NAME not in out["metrics"]
