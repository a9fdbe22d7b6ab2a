"""The port's bench entry points (ld_tools_tpu_torch/bench) on the CPU, at
small sizes: the headline line's shape against bench.py's, no CPU fallback,
the K8 stage rows, the suite's artifact, and the configs it refuses."""

import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from ld_tools_tpu_torch.bench import kernels, microkernels, suite
from ld_tools_tpu_torch.bench.oracle import oracle_ld
from ld_tools_tpu_torch.ops import ld_kernels as tk

from .oracle import oracle_ld as reference_oracle_ld

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _no_card_env():
    return dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")


def _bench_py_metric():
    with open(os.path.join(REPO, "bench.py")) as fh:
        return re.search(r'"metric": "([^"]+)"', fh.read()).group(1)


def test_headline_on_the_cpu_prints_bench_py_line():
    out = subprocess.run(
        [sys.executable, "-m", "ld_tools_tpu_torch.bench", "--device", "cpu"],
        cwd=REPO, env=_no_card_env(), capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    # bench.py's CPU line: no spread (one timing, not samples)
    assert set(rec) == {"metric", "value", "unit", "vs_baseline"}
    assert rec["metric"] == _bench_py_metric()
    assert rec["unit"] == "pairs/s"
    assert rec["value"] > 0 and rec["vs_baseline"] > 0
    assert "device: cpu" in out.stderr
    report = [json.loads(ln) for ln in out.stderr.splitlines()
              if ln.startswith('{"launches"')]
    assert report and not any(report[0]["launches"].values())


def test_headline_without_a_card_fails_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "ld_tools_tpu_torch.bench"], cwd=REPO,
        env=_no_card_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "no CUDA card" in out.stderr


def test_microkernels_on_the_cpu_print_four_stage_rows(capsys):
    result = microkernels.main(["--device", "cpu", "--v", "200",
                                "--block", "128"])
    assert result is None
    rows = capsys.readouterr().out.strip().splitlines()
    assert [r.split()[0] for r in rows] == list(tk.STAGES)
    for row in rows:
        # a host-clock time at this size may be rejected (NaN) under load:
        # the row still names its stage and says it is no device number
        float(row.split()[1])
        assert "no device peak" in row


def test_microkernels_only_filters_the_stages(capsys):
    got = microkernels.run(v=130, block=128, only="fast", device="cpu")
    assert list(got) == ["fast"]
    assert got["fast"]["launches"] == 0  # plain versions launch nothing
    assert len(capsys.readouterr().out.strip().splitlines()) == 1


def test_kernels_variants_route_to_the_ported_sites(capsys, monkeypatch):
    assert [v[0] for v in kernels.VARIANTS] == [
        "dense/512/fast/r2only", "dense/1024/fast/r2only",
        "dense/512/exact/r2only", "dense/512/exact/r2+dp",
        "packed/1024/exact/r2only", "packed/1024/fast/r2only",
        "bf16/512/exact/r2only"]
    assert kernels.SITES == {"dense": tk.ld_triangle_blocks,
                             "packed": tk.ld_triangle_blocks_packed,
                             "bf16": tk.ld_triangle_blocks_bf16}
    # a fixed time in place of the CPU clock's (a differenced host time can
    # come out NaN under load; sweep_seconds has its own fake-timer tests):
    # one sweep still runs through the variant's site, on the plain version
    swept = []

    def fixed_time(make_many, datasets):
        swept.append(float(make_many(1)(datasets, 0.0)))
        return 2e-3, {}

    monkeypatch.setattr(kernels, "sweep_seconds", fixed_time)
    got = kernels.run(v=150, only="512/exact/r2+dp", device="cpu")
    assert got == {"dense/512/exact/r2+dp": 2.0}
    assert len(swept) == 1 and np.isfinite(swept[0])
    assert not any(s.launches for s in tk.LAUNCH_SITES)
    (row,) = capsys.readouterr().out.strip().splitlines()
    assert row.split()[:2] == ["dense/512/exact/r2+dp", "2.00"]
    assert "(cpu: plain version, no device peak)" in row


def test_suite_config5_writes_its_artifact(tmp_path, monkeypatch):
    monkeypatch.setattr(suite, "CONFIG5_VARIANTS", 128)
    path = tmp_path / "suite.json"
    rows = suite.main(["--configs", "5", "--device", "cpu", "--out",
                       str(path)])
    with open(path) as fh:
        art = json.load(fh)
    assert art["results"] == rows
    (row,) = rows
    assert row["config"] == "5_batch_8chrom" and row["run_idx"] == 0
    assert row["chroms_on_host"] == 8 and row["device"] == "cpu"
    assert row["seconds"] >= 0 and "torch" in art["meta"]
    assert art["meta"]["device"].startswith("device: cpu")


def test_suite_scan_configs_at_a_small_size(monkeypatch, capsys):
    monkeypatch.setattr(suite, "CONFIG4_VARIANTS", 1280)
    monkeypatch.setattr(suite, "CONFIG0_VARIANTS", 40)
    monkeypatch.setattr(suite, "CONFIG0_SAMPLES", 16)
    rows = suite.main(["--configs", "4,0", "--device", "cpu"])
    assert [r["config"] for r in rows] == [
        "4_chr21_scan_100k", "4_chr21_scan_100k_warm",
        "4b_chr21_scan_100k_exact", "4b_chr21_scan_100k_exact_warm",
        "0_ingest", "0_ingest"]
    # cold = warm; the exact f64 refilter keeps a subset of the device
    # filter's hits (which sit one rounding step below the threshold)
    hits = [r["hits"] for r in rows[:4]]
    assert hits[0] == hits[1] >= hits[2] == hits[3] > 0
    assert "phases" in rows[0] and rows[0]["device"] == "cpu"


def test_suite_scan_data_is_the_jax_suites():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_suite", os.path.join(REPO, "scripts", "bench_suite.py"))
    jax_suite = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_suite)
    for got, want in zip(suite._scan_dataset(640 * 3, 46_000_000, 4),
                         jax_suite._scan_dataset(640 * 3, 46_000_000, 4)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("correlated", [True, False])
def test_gb_fixture_is_the_jax_suites(correlated, tmp_path):
    """The port's _write_gb_fixture writes the JAX suite's file byte for
    byte (the same synth stream, lines and BGZF blocks)."""
    from scripts.bench_suite import _write_gb_fixture

    got, want = tmp_path / "port.vcf.gz", tmp_path / "jax.vcf.gz"
    kw = dict(rs_base=7, n_base=64, correlated=correlated)
    n_got = suite._write_gb_fixture(str(got), "3", 30, 200_000,
                                    np.random.default_rng(5), **kw)
    n_want = _write_gb_fixture(str(want), "3", 30, 200_000,
                               np.random.default_rng(5), **kw)
    assert n_got == n_want and n_got[0] % 64 == 0
    assert got.read_bytes() == want.read_bytes()


def _wg_rows(path):
    """(i positions, j positions, r^2 strings) of a scan TSV."""
    with open(path) as fh:
        rows = [ln.rstrip("\n").split("\t") for ln in fh
                if not ln.startswith("#")]
    return [(int(r[0]), int(r[2]), r[5]) for r in rows]


def test_suite_wg_at_a_small_scale(monkeypatch, tmp_path):
    """Config wg at TPU_LD_WG_SCALE=2,0.002 with 500 samples on the CPU:
    its four rows, hits, and chromosome 1's hit set and r^2 values equal
    a brute-force recount with tests/oracle.py of the genotypes the
    fixture wrote (regenerated with the JAX package's synth)."""
    from ld_tools_tpu.ingest import synth as jax_synth
    from ld_tools_tpu_torch.ingest.store import ChromData

    monkeypatch.setenv("TPU_LD_WG_SCALE", "2,0.002")
    monkeypatch.setenv("TPU_LD_WG_DIR", str(tmp_path))
    monkeypatch.setattr(suite, "WG_SAMPLES", 500)
    path = tmp_path / "suite.json"
    rows = suite.main(["--configs", "wg", "--device", "cpu", "--out",
                       str(path)])
    assert [r["config"] for r in rows] == [
        "wg_prep_5gb", "wg_prep_5gb_rerun", "wg_scan_100kb",
        "wg_e2e_prep_plus_scan"]
    prep, rerun, scan, e2e = rows
    assert prep["n_chroms"] == scan["n_chroms"] == 2
    assert scan["hits"] > 0 and scan["device"] == "cpu"
    assert scan["launches"] == {}  # the plain versions launch nothing
    assert scan["hits"] == sum(c["hits"] for c in scan["chroms"].values())
    assert scan["pairs_in_window"] > scan["hits"]
    assert set(scan["phases"]) == set(suite.WG_PHASES)
    assert e2e["seconds"] == pytest.approx(
        prep["seconds"] + scan["seconds"], abs=2e-3)
    with open(path) as fh:
        assert json.load(fh)["results"] == rows

    (data,) = [p for p in tmp_path.iterdir() if p.is_dir()]
    n = ChromData(str(data), "1").n_variants
    n_hap = 2 * suite.WG_SAMPLES
    base = jax_synth.correlated_haplotypes(
        np.random.default_rng(100), suite.WG_BASE_ROWS, n_hap)
    # variant v (1-based) at position 50 v carries base line v % n_base
    G = base[np.arange(1, n + 1) % suite.WG_BASE_ROWS]
    window = suite.WG_MAX_DIST // 50
    c1 = G.sum(axis=1).astype(np.float64)
    p = c1 / n_hap
    want = {}
    for lo in range(0, n, 512):
        hi = min(lo + 512, n)
        j0 = max(0, lo - window)
        cab = G[lo:hi].astype(np.float64) @ G[j0:hi].T.astype(np.float64)
        d = cab / n_hap - p[lo:hi, None] * p[None, j0:hi]
        den = (p * (1 - p))[lo:hi, None] * (p * (1 - p))[None, j0:hi]
        with np.errstate(divide="ignore", invalid="ignore"):
            r2 = np.where(den > 0, d * d / den, 0.0)
        ii, jj = np.nonzero(r2 >= 0.75)  # no pair below rounds to 0.8
        for i, j in zip(ii + lo, jj + j0):
            if j < i <= j + window:
                ref = reference_oracle_ld(G[i].tolist(), G[j].tolist())
                if ref["r_square"] >= 0.8:
                    want[(50 * (i + 1), 50 * (j + 1))] = ref["r_square"]
    got = _wg_rows(data / "scan_out" / "ld_scan_chr1_r_0.8.tsv")
    assert len(got) == scan["chroms"]["1"]["hits"] > 0
    assert {(a, b) for a, b, _ in got} == set(want)
    for a, b, r2 in got:
        assert float(r2) == want[a, b]


def test_suite_0gb_on_a_small_fixture(monkeypatch, tmp_path):
    """Config 0gb generates its fixture into $TPU_LD_GB_FIXTURE and keeps
    it, one row per thread count; the next run reuses it."""
    monkeypatch.setattr(suite, "GB_SAMPLES", 20)
    monkeypatch.setattr(suite, "GB_TARGET_BYTES", 1 << 20)
    fixture = tmp_path / "gb" / "1.vcf.gz"
    monkeypatch.setenv("TPU_LD_GB_FIXTURE", str(fixture))
    threads = sorted({1, 2, os.cpu_count() or 1})
    first = suite.main(["--configs", "0gb", "--device", "cpu"])
    made = fixture.stat().st_mtime_ns
    with open(str(fixture) + ".meta.json") as fh:
        meta = json.load(fh)
    again = suite.main(["--configs", "0gb", "--device", "cpu"])
    assert fixture.stat().st_mtime_ns == made
    for rows in (first, again):
        assert [r["n_threads"] for r in rows] == threads
        assert [r["run_idx"] for r in rows] == list(range(len(threads)))
        for r in rows:
            assert r["config"] == "0gb_ingest"
            assert r["variants"] == meta["v"] > 0
            assert r["peak_rss_mb"] > 0 and r["packed_mb"] > 0
            assert r["mb_per_s"] > 0 and r["seconds"] > 0


def test_suite_tool_configs_at_a_small_size(monkeypatch, tmp_path):
    """Configs 1 (ld_lite) and 3 (ld_area) run on the CPU, cold and warm,
    and write their rows; ld_area finds its hits (runs of correlated
    rows) and the CPU counts launch nothing."""
    monkeypatch.setattr(suite, "CONFIG1_SAMPLES", 20)
    monkeypatch.setattr(suite, "CONFIG3_SAMPLES", 20)
    monkeypatch.setattr(suite, "CONFIG3_VARIANTS", 400)
    monkeypatch.setattr(suite, "CONFIG3_QUERIES", 4)
    monkeypatch.setattr(suite, "CONFIG3_FLANK", 20_000)
    path = tmp_path / "suite.json"
    rows = suite.main(["--configs", "1,3", "--device", "cpu", "--out",
                       str(path)])
    assert [r["config"] for r in rows] == [
        "1_ld_lite_pair", "1b_ld_lite_pair_warm", "3_ld_area_50q_250kb",
        "3_ld_area_50q_250kb_warm"]
    assert all(r["device"] == "cpu" and r["seconds"] >= 0 for r in rows)
    assert rows[2]["files"] == rows[3]["files"] > 0
    assert rows[2]["engine_launches"] == rows[3]["engine_launches"] == 0
    with open(path) as fh:
        assert json.load(fh)["results"] == rows


def test_suite_triangle_configs_at_a_small_size(monkeypatch, tmp_path):
    """Configs 2 (ld_triangle, the per-cell path), 6 (the streamed table,
    then the per-cell hover microbenchmark) and 6c
    (the columnar heatmap past the pooled overview's threshold, shrunk)
    run on the CPU, cold and warm, and write their rows with the phases;
    the CPU counts launch nothing."""
    from ld_tools_tpu_torch.io import heatmap

    monkeypatch.setattr(suite, "CONFIG2_SAMPLES", 20)
    monkeypatch.setattr(suite, "CONFIG2_VARIANTS", 40)
    monkeypatch.setattr(suite, "CONFIG6_VARIANTS", 300)
    monkeypatch.setattr(suite, "CONFIG6B_VARIANTS", 60)
    monkeypatch.setattr(suite, "CONFIG6C_VARIANTS", 700)
    monkeypatch.setattr(heatmap, "_OVERVIEW_MIN", 600)
    path = tmp_path / "suite.json"
    rows = suite.main(["--configs", "2,6,6c", "--device", "cpu", "--out",
                       str(path)])
    assert [r["config"] for r in rows] == [
        "2_ld_triangle_500_eur", "2b_ld_triangle_500_eur_warm",
        "6_triangle_10k_table", "6_triangle_10k_table_warm",
        "6b_hover_percell_2000_microbench",
        "6b_hover_percell_2000_microbench_warm",
        "6c_heatmap_columnar_10k", "6c_heatmap_columnar_10k_warm"]
    assert all(r["device"] == "cpu" and r["engine_launches"] == 0
               and r["seconds"] >= 0 for r in rows)
    assert rows[0]["matrices"] == rows[1]["matrices"] == 1
    assert {"dispatch_s", "finish_s", "encode_s", "figure_s",
            "write_s"} <= set(rows[0]["phases"])
    assert {"dispatch_s", "count_wait_s", "finish_s",
            "write_s"} == set(rows[2]["phases"])
    assert rows[2]["tsv_mb"] == rows[3]["tsv_mb"] > 0
    assert set(rows[4]["phases"]) == {"exact_s", "hover_format_s"}
    assert {"finish_s", "encode_s", "figure_s"} <= set(rows[6]["phases"])
    assert rows[6]["html_mb"] == rows[7]["html_mb"] > 0
    with open(path) as fh:
        assert json.load(fh)["results"] == rows


def test_suite_refuses_unknown_configs():
    with pytest.raises(SystemExit):
        suite.main(["--configs", "7", "--device", "cpu"])


def test_oracle_is_the_tests_oracle():
    rng = np.random.default_rng(11)
    for n_a, n_b, pa, pb in ((200, 200, 0.3, 0.6), (64, 80, 0.5, 0.5),
                             (50, 50, 0.0, 0.4), (30, 30, 1.0, 1.0)):
        a = list(map(int, rng.random(n_a) < pa))
        b = list(map(int, rng.random(n_b) < pb))
        got, want = oracle_ld(a, b), reference_oracle_ld(a, b)
        assert got == want
        assert {k: type(v) for k, v in got.items()} == {
            k: type(v) for k, v in want.items()}
