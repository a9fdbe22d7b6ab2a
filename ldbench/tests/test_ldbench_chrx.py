"""The whole-chrX cell (``chrX_scan_w1mb``: ``ld_scan -z 0.8 -w 1000000``
over kg3_chrX) and the mixed-ploidy yardstick (``ldbench/mixed_work.py``)
on the CPU: the real BENCHMARK.json resolves the cell and its
configuration holds the published numbers; the least work of a scan over
ploidy segments equals a count pair by pair, and for one segment
``work.scan_ops``; a traced run of a chrX-shaped cell (kg3_chrX's keys,
its rows, span, PAR1 bound and window cut together) is correct and reads
``mfu.scanx``, ``scanx.kernel_roofline`` and ``scanx.merge_s``, which a
one-profile cell does not."""

import json

import numpy as np
import pytest

from ldbench import data, mixed_work, tracing, work
from ldbench.run import run_cell
from ldbench.spec import Spec
from ldbench.tests.conftest import tiny_bench, write_tiny

SEED = 2_147_483_743
ROWS = 4096
NEW = ("mfu.scanx", "scanx.kernel_roofline", "scanx.merge_s")


def test_the_benchmark_resolves_the_chrx_cell():
    spec = Spec()
    cell = spec.cell("chrX_scan_w1mb")
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "kg3_chrX", "scan_w1mb", 1)
    assert [m["name"] for m in spec.end_to_end(cell, "scan_s")] == [
        "scan_s", "setup_s"]
    layers = {m["name"] for m in spec.per_layer(cell, {"scan_s", "setup_s"})}
    par1 = {m["name"] for m in spec.per_layer(
        spec.cell("chrX_par1_scan_w1mb"), {"scan_s", "setup_s"})}
    w1mb = {m["name"] for m in spec.per_layer(spec.cell("chr21_scan_w1mb"),
                                              {"scan_s", "setup_s"})}
    # chrX_par1's metrics, the scan driver's summed over the segments, the
    # plan; none that reads None for a mixed chromosome
    assert par1 <= layers and set(NEW) <= par1
    assert layers - par1 == {"scan.upload_s", "scan.upload_host_s",
                             "scan.upload_copy_s", "scan.finish_s",
                             "scan.pass1_device_s", "scan.plan_s"}
    assert not {"scan.kernel_roofline", "mfu.scan",
                "scan.cohort_repack_s"} & layers
    assert layers - set(NEW) - {m for m in par1 if m.startswith("scanx.")} \
        <= w1mb
    for name in NEW:
        assert callable(spec.reader(name))


def test_the_chrx_deployment_holds_the_published_numbers():
    """1000 Genomes phase 3 chrX: 2,504 samples, 3,468,093 variants from
    10,001 to PAR2's end (156,030,895), PAR1 to 2,781,479, nothing cut;
    the data's assumptions are chr21's, the source its own."""
    spec = Spec()
    x, par1 = spec.config("kg3_chrX"), spec.config("kg3_chrX_par1")
    chr21 = spec.config("kg3_chr21")
    assert (x["chrom"], x["n_samples"], x["n_variants"], x["first_pos"],
            x["first_pos"] + x["span_bp"] - 1, x["par1_end"]) == (
                "X", 2504, 3_468_093, 10_001, 156_030_895, 2_781_479)
    assert x["n_variants"] == x["source_n_variants"] == \
        par1["source_n_variants"]
    assert x["reduced"] == [] and x["straddle_rows"] == 32
    assert x["paper"] == par1["source"] == chr21["source"]
    assert x["source"].endswith("ALL.chrX_GRCh38.genotypes.20170504.vcf.gz")
    assert all(c["source"] != x["source"]
               for c in spec.bench["configs"] if c["name"] != "kg3_chrX")
    for key in ("ld_run_rows", "flip", "freq"):
        assert x[key] == chr21[key], key
    assert x["warm_rows"] == 65_536
    assert "not checked" in x["assumed"][0]
    assert any("PAR2" in a and "haploid" in a for a in x["assumed"])
    entry = {c["name"]: c for c in spec.bench["configs"]}["kg3_chrX"]
    assert entry["file"] == "ldbench/configs/kg3_chrX.json"
    assert entry["reduced"] == [] and entry["source"] == x["source"]


def _brute_ops(pos, pgroup, profiles, cohort, max_dist) -> float:
    """2 x the walk length of every pair i > j the scan evaluates, pair by
    pair: a profile's list inside a run of one profile, the shorter list
    across two runs."""
    n = [2 * len(cohort) if profiles is None else
         int(sum(profiles[p][s] for s in cohort)) for p in range(2)]
    run = np.concatenate([[0], np.cumsum(np.diff(pgroup) != 0)])
    ops = 0
    for i in range(len(pos)):
        for j in range(i):
            if max_dist is not None and pos[i] - pos[j] > max_dist:
                continue
            pi, pj = pgroup[i], pgroup[j]
            ops += 2 * (n[pi] if run[i] == run[j] else min(n[pi], n[pj]))
    return float(ops)


@pytest.mark.parametrize("max_dist", [None, 40, 7])
@pytest.mark.parametrize("runs", [(30,), (12, 25), (10, 20, 15), (1, 40, 1)])
def test_the_mixed_least_work_is_a_pair_by_pair_count(max_dist, runs):
    rng = np.random.default_rng([len(runs), max_dist or 0])
    v = sum(runs)
    pos = np.sort(rng.choice(400, size=v, replace=False)) + 100
    pgroup = np.concatenate([np.full(r, k % 2, dtype=np.int16)
                             for k, r in enumerate(runs)])
    profiles = np.full((2, 9), 2, dtype=np.uint8)
    profiles[1, [0, 3, 4, 8]] = 1
    cohort = np.array([0, 1, 3, 5, 8])
    got = mixed_work.mixed_scan_ops(pos, pgroup, profiles, cohort, max_dist)
    assert got == _brute_ops(pos, pgroup, profiles, cohort, max_dist)
    assert got > 0


@pytest.mark.parametrize("max_dist", [None, 1_000, 25])
def test_one_segment_is_the_one_profile_yardstick(max_dist):
    rng = np.random.default_rng(7)
    pos = np.sort(rng.choice(50_000, size=700, replace=False)) + 1
    cohort = np.arange(0, 40, 3)
    want = work.scan_ops(pos, max_dist, 2 * cohort.size)
    for pgroup in (None, np.zeros(pos.size, dtype=np.int16)):
        assert mixed_work.mixed_scan_ops(pos, pgroup, None, cohort,
                                         max_dist) == want
    profiles = np.full((1, 40), 2, dtype=np.uint8)
    assert mixed_work.mixed_scan_ops(pos, np.zeros(pos.size, np.int16),
                                     profiles, cohort, max_dist) == want


@pytest.fixture
def chrx(tmp_path):
    """A Spec with the tiny whole-chrX cell ``tXw_scan`` in the test's
    folder only: kg3_chrX's keys, its rows, span, PAR1 bound and window
    cut together."""
    real = Spec().config("kg3_chrX")
    scale = ROWS / real["n_variants"]
    first = real["first_pos"]
    config = {k: v for k, v in real.items() if k != "name"}
    config.update(n_variants=ROWS, span_bp=round(real["span_bp"] * scale),
                  par1_end=first + round((real["par1_end"] - first) * scale),
                  n_samples=50, warm_rows=1024)
    window = round(1_000_000 * scale)
    top = write_tiny(tmp_path / "tiny")
    for kind, name, body in (
            ("configs", "tinyXw", config),
            ("traffic", "tscanXw", {
                "tool": "ld_scan", "args": ["-z", "0.8", "-w", str(window)],
                "metric": {"name": "scan_s", "per": "job"}}),
            ("workloads", "tXw_scan", {"config": "tinyXw",
                                       "traffic": "tscanXw", "chips": 1})):
        (top / kind / f"{name}.json").write_text(json.dumps(body))
    bench = tiny_bench()
    bench["workloads"].append({"name": "tXw_scan", "why": "test",
                               "config": "tinyXw", "traffic": "tscanXw",
                               "chips": 1})
    bench["end_to_end"][0]["workloads"].append("tXw_scan")
    for m in bench["per_layer"]:
        m["workloads"] = m.get("workloads", []) + ["tXw_scan"]
    return Spec(bench=bench, extra_dirs=[top]), config, window


def test_a_traced_chrx_shaped_run_reads_the_mixed_metrics(chrx, monkeypatch):
    """The CPU has no published peak and its trace no CUDA kernel: both
    are given here (1e12 operations a second, 2 s of kernels a job), so
    that the readers' arithmetic is held; on the card they come from
    peaks.json and the trace."""
    spec, config, window = chrx
    peak = {"int8_ops_per_s": 1e12}
    monkeypatch.setattr(work, "peaks", lambda kind: peak)
    monkeypatch.setattr(tracing.Trace, "kernel_s", lambda self, a, b: 2.0)
    out, _ = run_cell(spec, "tXw_scan", SEED, 0.1, True, "cpu")
    assert out["correct"] is True
    assert out["checks"]["mismatched_rows"] == {"value": 0, "limit": 0}
    assert out["checks"]["empty_reference"] == {"value": 0, "limit": 0}
    got = {k: out["metrics"][k] for k in NEW}
    assert [got[k]["unit"] for k in NEW] == ["%", "%", "s"]
    ds = data.make_dataset(config, SEED, "cpu")
    least = mixed_work.mixed_scan_ops(ds.pos, ds.pgroup, ds.profiles,
                                      np.arange(len(ds.panel)), window) / 1e12
    assert least > 0
    assert got["scanx.kernel_roofline"]["value"] == pytest.approx(
        100 * least / 2.0)
    assert 0 < got["mfu.scanx"]["value"] < 100
    assert got["scanx.merge_s"]["value"] > 0
    # a chromosome of one profile reads none of them
    out, _ = run_cell(spec, "t21_scan", SEED, 0.1, True, "cpu")
    assert not set(NEW) & set(out["metrics"])
    assert "mfu.scan" in out["metrics"]
