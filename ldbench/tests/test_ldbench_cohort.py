"""The population-subset cell (``chr21_scan_eur``: ``ld_scan -e EUR``) at a
tiny size on the CPU: a run is correct and reads the program's cohort
repack; the reference really applies the cohort (the full cohort's TSV
fails against it, and the program's EUR TSV passes); the reference's
cohort lists agree with the plain-Python recount pair by pair; the
real BENCHMARK.json resolves the cell; and its configuration holds chr21's
store with the EUR cohort."""

import json

import numpy as np
import pytest
import torch

from ldbench import data, jobs, reference
from ldbench.run import run_cell
from ldbench.spec import Spec
from ldbench.tests.conftest import TINY, tiny_bench, write_tiny

# 530 samples round-robined over the 26 populations: EUR's five get 21
# each, 105 samples, 210 haplotypes (not a multiple of 8)
EUR_CONFIG = dict(TINY["configs"]["tiny21"], n_samples=530)
EUR_TRAFFIC = {"tool": "ld_scan",
               "args": ["-z", "0.8", "-w", "20000", "-e", "EUR"],
               "metric": {"name": "scan_s", "per": "job"}}
FULL_TRAFFIC = dict(EUR_TRAFFIC, args=["-z", "0.8", "-w", "20000"])
SEED = 2_147_483_671


@pytest.fixture
def eur(tmp_path):
    """A Spec with the tiny EUR cell ``teur_scan`` (and its full-cohort
    twin ``tall_scan``) in the test's folder only."""
    top = write_tiny(tmp_path / "tiny")
    for kind, name, body in (
            ("configs", "tiny21_530", EUR_CONFIG),
            ("traffic", "tscan_eur", EUR_TRAFFIC),
            ("traffic", "tscan_all", FULL_TRAFFIC),
            ("workloads", "teur_scan", {"config": "tiny21_530",
                                        "traffic": "tscan_eur", "chips": 1}),
            ("workloads", "tall_scan", {"config": "tiny21_530",
                                        "traffic": "tscan_all", "chips": 1})):
        (top / kind / f"{name}.json").write_text(json.dumps(body))
    bench = tiny_bench()
    cells = ["teur_scan", "tall_scan"]
    for name in cells:
        bench["workloads"].append(dict(
            name=name, why="test",
            **json.loads((top / "workloads" / f"{name}.json").read_text())))
    bench["end_to_end"][0]["workloads"] += cells
    for m in bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + cells
    return Spec(bench=bench, extra_dirs=[top])


def _job(spec, cell, tmp_path):
    c = spec.cell(cell)
    config = spec.config(c["config"])
    ds = data.make_dataset(config, SEED, "cpu")
    store = data.prepare_store(str(tmp_path / f"store_{cell}"), ds)
    return jobs.make_job(spec.traffic(c["traffic"]), config, ds, store,
                         str(tmp_path / f"work_{cell}"), SEED, "cpu")


def test_a_traced_eur_run_is_correct_and_reads_the_repack(eur):
    out, _ = run_cell(eur, "teur_scan", SEED, 0.1, True, "cpu")
    assert out["correct"] is True
    assert out["checks"]["mismatched_rows"] == {"value": 0, "limit": 0}
    assert out["checks"]["empty_reference"] == {"value": 0, "limit": 0}
    got = out["metrics"]
    assert got["scan.cohort_repack_s"]["unit"] == "s"
    assert 0 < got["scan.cohort_repack_s"]["value"] <= \
        got["scan.open_s"]["value"]
    full, _ = run_cell(eur, "tall_scan", SEED, 0.1, True, "cpu")
    assert full["correct"] is True
    assert full["metrics"]["scan.cohort_repack_s"]["value"] == 0.0


def test_the_full_cohort_fails_against_the_eur_reference(eur, tmp_path):
    job = _job(eur, "teur_scan", tmp_path)
    assert job.cohort.size == 105 and (2 * job.cohort.size) % 8
    header, body, looked = job.expected()
    assert body
    rec = job.run(0)
    assert rec.stats["cohort_haplotypes"] == 210
    assert rec.stats["repack_rows"] == job.ds.n_variants
    with open(rec.path) as fh:
        assert job.mismatched_rows(fh.read(), header, body, looked) == 0
    job.args = list(FULL_TRAFFIC["args"])  # the same store, every sample
    full = job.run(1)
    assert full.stats["repack_rows"] == 0
    with open(full.path) as fh:
        _, _, rows = fh.read().partition("\n")
    # the header aside (it names the cohort), the rows differ
    assert job.mismatched_rows(header.partition("\n")[0] + "\n" + rows,
                               header, body, looked) > 0


def test_the_float32_controls_fail_the_eur_cell(eur):
    from ldbench.control import readings

    out = readings(eur, "teur_scan", SEED, "cpu")
    assert out["program"] == 0
    assert out["f32_reference"] > 0 and out["port_f32_scan"] > 0


def test_the_reference_cohort_lists_agree_with_the_oracle():
    ds = data.make_dataset(EUR_CONFIG, SEED, "cpu")
    cohort, _ = jobs._cohort(ds.panel, "both", "EUR")
    assert all(ds.panel[s][2] == "EUR" for s in cohort)
    lists = reference.Lists(ds, "cpu", cohort)
    assert lists.n == [2 * cohort.size]
    bits = np.unpackbits(ds.gp, axis=1, count=ds.n_hap)
    cols = np.stack([2 * cohort, 2 * cohort + 1], axis=1).ravel()
    assert np.array_equal(lists.own.numpy(), bits[:, cols].sum(axis=1))
    rng = np.random.default_rng(7)
    i = rng.integers(1, ds.n_variants, 300)
    j = np.maximum(i - rng.integers(1, 16, 300), 0)  # inside the LD runs
    far = rng.integers(0, ds.n_variants, (2, 100))
    i = np.concatenate([i, far.max(axis=0)])
    j = np.concatenate([j, far.min(axis=0)])
    keep = i > j
    i, j = i[keep], j[keep]
    len_i, len_j = lists.lengths(i), lists.lengths(j)
    ld = reference.finish(lists.pair_counts(i, j),
                          lists.own[torch.from_numpy(i)],
                          lists.own[torch.from_numpy(j)],
                          np.minimum(len_i, len_j), len_i, len_j)
    got = [f"{a}\t{b}" for a, b in zip(reference.fmt4(ld.r2, ld.r2_iz),
                                       reference.fmt4(ld.dp, ld.dp_iz))]
    want = [reference.oracle_line(ds, cohort, a, b)
            for a, b in zip(i.tolist(), j.tolist())]
    assert got == want
    assert sum(float(g.split("\t")[0]) >= 0.8 for g in got) > 10


def test_the_benchmark_resolves_the_eur_cell():
    spec = Spec()
    cell = spec.cell("chr21_scan_eur")
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "kg3_chr21_eur", "scan_w1mb_eur", 1)
    traffic = spec.traffic(cell["traffic"])
    assert traffic["args"][-2:] == ["-e", "EUR"]
    layers = {m["name"] for m in spec.per_layer(cell, {"scan_s", "setup_s"})}
    assert "scan.cohort_repack_s" in layers and "scan.open_s" in layers
    assert callable(spec.reader("scan.cohort_repack_s"))
    # the frozen panel's EUR: 485 of 2,504 samples (the release has 503)
    config = spec.config(cell["config"])
    panel = data.make_panel(config["n_samples"], np.random.default_rng(0))
    cohort, _ = jobs._cohort(panel, "both", "EUR")
    assert cohort.size == 485


def test_the_eur_deployment_holds_chr21s_store_and_names_its_cohort():
    """The EUR configuration makes the store of ``kg3_chr21`` from a seed
    (every number of it the same) and differs in the cohort alone, which
    its traffic selects."""
    spec = Spec()
    eur, full = spec.config("kg3_chr21_eur"), spec.config("kg3_chr21")
    for key in set(full) - {"name", "source", "deployment", "assumed"}:
        assert eur[key] == full[key], key
    assert eur["assumed"][:len(full["assumed"])] == full["assumed"]
    assert eur["source"] != full["source"]
    args = spec.traffic(spec.cell("chr21_scan_eur")["traffic"])["args"]
    assert args[args.index("-e") + 1] == eur["cohort"] == "EUR"


@pytest.mark.chip
def test_the_controls_fail_at_the_eur_cells_size(card):
    from ldbench.control import readings

    out = readings(Spec(), "chr21_scan_eur", 4294967371)
    assert out["program"] == 0
    assert out["f32_reference"] > 0 and out["port_f32_scan"] > 0
