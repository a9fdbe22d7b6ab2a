"""The chr2 deployment (ldbench/configs/kg3_chr2.json) through the port's
scan on the CPU: a store made by the benchmark's generator from the
configuration's keys, its rows and span cut together so that the density
of variants stays chr2's, and the window cut with them, scanned by
``ld_scan -E torch -C 2 -z 0.8 -w <window>`` in the packed layout that the
whole chromosome takes on the card; the TSV must equal, byte for byte, the
one the benchmark's plain reference expects."""

import json
import os

from ld_tools_tpu_torch import ld_scan
from ld_tools_tpu_torch.ops import ld_stream

from ldbench import data, jobs, reference
from ldbench.spec import ROOT

CONFIG = json.loads((ROOT / "ldbench" / "configs" / "kg3_chr2.json")
                    .read_text())
ROWS = 6000
SEED = 2_147_483_689


def _cut(rows: int) -> dict:
    scale = rows / CONFIG["n_variants"]
    return dict(CONFIG, n_variants=rows,
                span_bp=round(CONFIG["span_bp"] * scale))


def test_a_cut_chr2_scans_to_the_references_tsv(tmp_path, monkeypatch):
    config = _cut(ROWS)
    ds = data.make_dataset(config, SEED, "cpu")
    assert ds.chrom == "2" and ds.n_hap == 5008 and ds.pgroup is None
    density = CONFIG["n_variants"] / CONFIG["span_bp"]
    assert ds.pos[-1] - ds.pos[0] < config["span_bp"]
    assert abs(ds.n_variants / config["span_bp"] / density - 1) < 1e-3
    store = data.prepare_store(str(tmp_path / "store"), ds)
    # the window cut with the rows: about 29 rows in it, as 1 Mb holds
    # about 29,260 of chr2's
    max_dist = round(1_000_000 * ROWS / CONFIG["n_variants"])
    monkeypatch.setenv("TPU_LD_DENSE_RESIDENT_BYTES", "0")  # packed: K6/K4
    ld_stream.clear_resident_cache()
    out = str(tmp_path / "out")
    (report,) = ld_scan.main(["-C", "2", "-D", store, "-t", out, "-E",
                              "torch", "-z", "0.8", "-w", str(max_dist)])
    assert report.stats["resident_packed"] == 1.0
    assert report.stats["blocks"] >= 1

    cohort, text = jobs._cohort(ds.panel, "both", "all")
    prm = reference.ScanParams(measure="r_square", thres=0.8,
                               max_dist=max_dist,
                               band=2 * config["ld_run_rows"] - 1,
                               n_far=jobs.FAR_PAIRS)
    lists = reference.Lists(ds, "cpu", cohort)
    hits, _ = reference.scan_hits(ds, lists, prm, SEED)
    want = (reference.scan_header(ds, prm, text)
            + reference.scan_body(ds, hits))
    with open(report.path) as fh:
        got = fh.read()
    assert hits.i.size > 1000
    assert got == want
    assert os.path.basename(report.path) == "ld_scan_chr2_r_0.8.tsv"
    assert (ds.pos[hits.i] - ds.pos[hits.j] <= max_dist).all()
