"""A run of the harness on the CPU at a tiny size (the card check skipped,
the port's plain versions under ``-E torch``): its result line's shape,
``correct`` coming out false for each fault a cell can have, the import
guard, and no result without a card or outside a checkout."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from ldbench.run import forbidden_modules, run_cell
from ldbench.spec import ROOT


def _run(spec, cell, trace=False):
    out, _ = run_cell(spec, cell, 2_147_483_659, 0.1, trace, "cpu")
    return out


def test_a_run_is_correct_and_prints_its_result_line(tiny):
    out = _run(tiny, "t21_scan")
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    assert set(out["metrics"]) == {"scan_s", "setup_s"}
    for m in out["metrics"].values():
        assert m["value"] > 0 and m["unit"] == "s"
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert out["checks"]["mismatched_rows"] == {"value": 0, "limit": 0}
    json.dumps(out)


def test_a_traced_run_reports_the_layers_and_the_trace(tiny):
    out = _run(tiny, "tX_scan", trace=True)
    assert list(out)[-1] == "checks" and "breakdown" in out
    assert out["correct"] is True
    assert out["metrics"]["test.jobs"]["value"] == out["attempted"]
    assert out["metrics"]["scan.write_s"]["unit"] == "s"
    assert "scanx.rect_dispatch_s" in out["metrics"]
    assert out["metrics"]["scanx.rect_finish_s"]["value"] > 0
    # no device on the CPU: the device's readers find nothing to read
    assert "device_idle.scan" not in out["metrics"]
    assert "scan.kernel_roofline" not in out["metrics"]
    assert out["device"]["window_s"] > 0 and out["device"]["busy_s"] == 0
    for key in ("device_ops", "idle_gaps"):
        assert len(out["breakdown"][key]) <= 10


def test_an_area_run_counts_the_queries(tiny):
    out = _run(tiny, "t21_area")
    assert out["correct"] is True
    assert set(out["metrics"]) == {"area_queries_per_s", "setup_s"}
    assert out["metrics"]["area_queries_per_s"]["unit"] == "queries/s"


def _half_the_hits(monkeypatch):
    from ld_tools_tpu_torch.ops import ld_stream

    orig = ld_stream.stream_threshold_scan

    def half(*a, **kw):
        h = orig(*a, **kw)
        s = slice(0, None, 2)
        return dataclasses.replace(
            h, i=h.i[s], j=h.j[s], r_square=h.r_square[s],
            d_prime=h.d_prime[s], r_square_is_int_zero=h.r_square_is_int_zero[s],
            d_prime_is_int_zero=h.d_prime_is_int_zero[s])
    monkeypatch.setattr(ld_stream, "stream_threshold_scan", half)


def _scan_answer_altered(monkeypatch):
    from ld_tools_tpu_torch.ops import ld_stream

    orig = ld_stream._exact_refilter_counts

    def altered(*a, **kw):
        h = orig(*a, **kw)
        h.r_square = h.r_square.copy()
        h.r_square[len(h.r_square) // 2] += 1e-3
        return h
    monkeypatch.setattr(ld_stream, "_exact_refilter_counts", altered)


def _scan_unchanged(monkeypatch):
    from ld_tools_tpu_torch.tools import scan

    orig = scan.scan_chromosome

    def unchanged(data, config, chrom, **kw):  # the output left empty
        report = orig(data, config, chrom, **dict(kw, write=False))
        os.makedirs(config.trg_dir_path, exist_ok=True)
        path = os.path.join(config.trg_dir_path, "unwritten.tsv")
        open(path, "w").close()
        return dataclasses.replace(report, path=path)
    monkeypatch.setattr(scan, "scan_chromosome", unchanged)


def _half_the_queries(monkeypatch):
    from ld_tools_tpu_torch.tools import area

    orig = area.create_src_dict

    def half(*a, **kw):
        return {c: rows[::2] for c, rows in orig(*a, **kw).items()}
    monkeypatch.setattr(area, "create_src_dict", half)


def _area_answer_altered(monkeypatch):
    from ld_tools_tpu_torch.tools import area

    orig = area.measures_rounded_block_both

    def altered(*a, **kw):
        r2r, r2iz, dpr, dpiz = orig(*a, **kw)
        hit = np.argwhere(r2r >= 0.8)
        if hit.size:
            r2r = r2r.copy()
            r2r[tuple(hit[len(hit) // 2])] += 1e-4
        return r2r, r2iz, dpr, dpiz
    monkeypatch.setattr(area, "measures_rounded_block_both", altered)


def _area_unchanged(monkeypatch):
    from ld_tools_tpu_torch.tools import area

    monkeypatch.setattr(area.AreaRunner, "process_file", lambda self, f: 0)


@pytest.mark.parametrize("cell,fault", [
    ("t21_scan", _half_the_hits), ("tX_scan", _half_the_hits),
    ("t21_scan", _scan_answer_altered), ("tX_scan", _scan_answer_altered),
    ("t21_scan", _scan_unchanged),
    ("t21_area", _half_the_queries), ("t21_area", _area_answer_altered),
    ("t21_area", _area_unchanged),
], ids=lambda x: x if isinstance(x, str) else x.__name__.strip("_"))
def test_a_fault_in_the_timed_path_makes_the_run_incorrect(tiny, monkeypatch,
                                                         cell, fault):
    fault(monkeypatch)
    out = _run(tiny, cell)
    assert out["correct"] is False
    assert out["failed"] == out["attempted"]
    name = "mismatched_files" if "area" in cell else "mismatched_rows"
    assert out["checks"][name]["value"] > 0


def test_the_import_guard_compares_whole_top_level_names():
    assert forbidden_modules(["ld_tools_tpu_torch", "ld_tools_tpu_torch.ops",
                              "numpy", "torch"]) == []
    assert forbidden_modules(["ld_tools_tpu.ops.ld_pallas"]) == ["ld_tools_tpu"]
    assert forbidden_modules(["jax", "jaxlib.xla_client", "flax"]) == \
        ["flax", "jax", "jaxlib"]
    assert forbidden_modules(["jax_like", "ldbench"]) == []


def test_a_tiny_run_loads_no_forbidden_module(tiny):
    code = ("import sys, json; sys.path.insert(0, sys.argv[1]);"
            "from ldbench.tests.conftest import tiny_bench, write_tiny;"
            "from ldbench.spec import Spec; from pathlib import Path;"
            "from ldbench.run import run_cell, forbidden_modules;"
            "spec = Spec(bench=tiny_bench(), extra_dirs=[write_tiny("
            "Path(sys.argv[2]))]);"
            "out, _ = run_cell(spec, 't21_scan', 7, 0.1, False, 'cpu');"
            "print(json.dumps([out['correct'], forbidden_modules()]))")
    res = subprocess.run([sys.executable, "-c", code, str(ROOT),
                          str(tiny.dirs[0])], capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.splitlines()[-1]) == [True, []]


def _cli(cwd, *extra):
    return subprocess.run(
        [sys.executable, "ldbench/run.py", "--workload", "chr21_scan_w1mb",
         "--seed", "4294967311", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_without_a_card_there_is_no_result_and_no_cpu_fallback():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the CPU-only case")
    res = _cli(ROOT)
    assert res.returncode != 0
    assert "{" not in res.stdout
    assert "CUDA card" in res.stderr


def test_outside_a_checkout_there_is_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "ldbench", tmp_path / "ldbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _cli(tmp_path)
    assert res.returncode != 0
    assert "{" not in res.stdout


@pytest.mark.chip
def test_a_cell_on_the_card(card):
    """One short run of the first cell on the card, correct."""
    from ldbench.spec import Spec

    out, _ = run_cell(Spec(), "chr21_scan_w1mb", 4294967329, 1.0, False)
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu"
