"""The chr2 cell (``chr2_scan_w1mb``: ``ld_scan -z 0.8 -w 1000000`` over
chr2) at a tiny size on the CPU: a run of a chr2-shaped cell (chr2's
density of variants, its window cut with its rows) is correct and reads
the scan's plan; the real BENCHMARK.json resolves the cell; and its
configuration holds the published numbers."""

import json

import pytest

from ld_tools_tpu_torch.ingest import prep
from ldbench.run import run_cell
from ldbench.spec import Spec
from ldbench.tests.conftest import tiny_bench, write_tiny

SEED = 2_147_483_693
ROWS = 4096


@pytest.fixture
def chr2(tmp_path):
    """A Spec with the tiny chr2 cell ``t2_scan`` in the test's folder
    only: kg3_chr2's keys, its rows, span and window cut together."""
    real = Spec().config("kg3_chr2")
    scale = ROWS / real["n_variants"]
    config = {k: v for k, v in real.items() if k != "name"}
    config.update(n_variants=ROWS, span_bp=round(real["span_bp"] * scale),
                  n_samples=50, warm_rows=1024)
    window = round(1_000_000 * scale)
    top = write_tiny(tmp_path / "tiny")
    for kind, name, body in (
            ("configs", "tiny2", config),
            ("traffic", "tscan2", {
                "tool": "ld_scan", "args": ["-z", "0.8", "-w", str(window)],
                "metric": {"name": "scan_s", "per": "job"}}),
            ("workloads", "t2_scan", {"config": "tiny2", "traffic": "tscan2",
                                      "chips": 1})):
        (top / kind / f"{name}.json").write_text(json.dumps(body))
    bench = tiny_bench()
    bench["workloads"].append({"name": "t2_scan", "why": "test",
                               "config": "tiny2", "traffic": "tscan2",
                               "chips": 1})
    bench["end_to_end"][0]["workloads"].append("t2_scan")
    for m in bench["per_layer"]:
        m["workloads"] = m.get("workloads", []) + ["t2_scan"]
    return Spec(bench=bench, extra_dirs=[top])


def test_a_traced_chr2_shaped_run_is_correct_and_reads_the_plan(chr2):
    out, _ = run_cell(chr2, "t2_scan", SEED, 0.1, True, "cpu")
    assert out["correct"] is True
    assert out["checks"]["mismatched_rows"] == {"value": 0, "limit": 0}
    assert out["checks"]["empty_reference"] == {"value": 0, "limit": 0}
    plan = out["metrics"]["scan.plan_s"]
    assert plan["unit"] == "s" and plan["value"] > 0


def test_the_benchmark_resolves_the_chr2_cell():
    spec = Spec()
    cell = spec.cell("chr2_scan_w1mb")
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "kg3_chr2", "scan_w1mb", 1)
    assert spec.traffic("scan_w1mb")["args"] == ["-z", "0.8", "-w",
                                                 "1000000"]
    layers = {m["name"] for m in spec.per_layer(cell, {"scan_s", "setup_s"})}
    w1mb = {m["name"] for m in spec.per_layer(spec.cell("chr21_scan_w1mb"),
                                              {"scan_s", "setup_s"})}
    assert layers == w1mb and "scan.plan_s" in layers
    assert callable(spec.reader("scan.plan_s"))
    assert [m["name"] for m in spec.end_to_end(cell, "scan_s")] == [
        "scan_s", "setup_s"]


def test_the_chr2_deployment_holds_the_published_numbers():
    """1000 Genomes phase 3 chr2: 2,504 samples, 7,081,600 variants over
    242 Mb (GRCh38: 242.2 Mb), nothing cut; the data's assumptions are
    chr21's."""
    spec = Spec()
    chr2, chr21 = spec.config("kg3_chr2"), spec.config("kg3_chr21")
    assert (chr2["chrom"], chr2["n_samples"], chr2["n_variants"],
            chr2["first_pos"], chr2["span_bp"]) == (
                "2", 2504, 7_081_600, 1, 242_000_000)
    assert chr2["reduced"] == []
    # chr21's paper, but a source of its own: the release's GRCh38 folder,
    # which the port's prep reads the chromosome files from
    assert chr2["paper"] == chr21["source"] == \
        "https://doi.org/10.1038/nature15393"
    assert chr2["source"] == prep.HG38_INDEX_URL.replace("ftp://", "https://")
    assert all(c["source"] != chr2["source"]
               for c in spec.bench["configs"] if c["name"] != "kg3_chr2")
    for key in ("ld_run_rows", "flip", "freq", "par1_end", "warm_rows",
                "straddle_rows"):
        assert chr2[key] == chr21[key], key
    # the genotypes and the panel as chr21's; the count's origin first
    assert "not checked" in chr2["assumed"][0]
    assert [chr2["assumed"][k] for k in (1, 3)] == [
        chr21["assumed"][k] for k in (1, 3)]
    entry = {c["name"]: c for c in spec.bench["configs"]}["kg3_chr2"]
    assert entry["file"] == "ldbench/configs/kg3_chr2.json"
    assert entry["reduced"] == [] and entry["source"] == chr2["source"]


@pytest.mark.chip
def test_the_controls_fail_at_the_chr2_cells_size(card):
    from ldbench.control import readings

    out = readings(Spec(), "chr2_scan_w1mb", 4294967389)
    assert out["program"] == 0
    assert out["f32_reference"] > 0 and out["port_f32_scan"] > 0
