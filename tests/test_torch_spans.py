"""The port's phase spans (utils/profiling.span) and the scan's stats that
they keep, on the CPU (-E torch): the helper itself, a scan that enters no
profiler code while none records, a traced scan whose spans are
``user_annotation`` events in the same Chrome trace, and the split keys of
a single- and a mixed-ploidy scan adding up to the phases they split.

The stores are those of tests/test_torch_scan_cli.py (chr5, 90 variants)
and tests/test_torch_mixed_scan.py (chrX: two ploidy segments, three runs,
cross-segment rectangles), written here by the port's own ingest."""

import collections
import json
import os
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ld_tools_tpu_torch.ingest import prep, synth
from ld_tools_tpu_torch.ops import ld_stream
from ld_tools_tpu_torch.tools.common import DataConfig
from ld_tools_tpu_torch.tools.scan import ScanConfig, scan_chromosome
from ld_tools_tpu_torch.utils import profiling
from ld_tools_tpu_torch.utils.profiling import SPANNED, span

# the scan's spans and the stats key each adds to: every scan, and a
# mixed-ploidy scan besides
SCAN_SPANS = {
    "scan.open": "open_s", "scan.host_prep": "host_prep_s",
    "scan.upload": "upload_s", "scan.upload_host": "upload_host_s",
    "scan.upload_copy": "upload_copy_s", "scan.plan": "plan_s",
    "scan.count": "count_s", "scan.fetch": "fetch_s",
    "scan.finish": "finish_s", "scan.write": "write_s",
    "scan.format": "format_s", "scan.emit": "emit_s",
}
MIXED_SPANS = {
    "scanx.repack": "repack_s", "scanx.rect_dispatch": "rect_dispatch_s",
    "scanx.rect_finish": "rect_finish_s", "engine.wait": "rect_wait_s",
    "scanx.rect_exact": "rect_exact_s", "scanx.merge": "merge_s",
}
# the benchmark's own span names (ldbench/tracing.SPANS), which the
# program's must never take
BENCH_SPANS = {"tool.prep_check", "tool.scan_chromosome", "tool.scan_format",
               "driver.scan", "driver.upload", "finish.scan", "mixed.repack",
               "engine.issue", "finish.counts", "finish.area", "area.write"}
KINDS = ("single", "mixed")


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """{"single": (store, chrom), "mixed": (store, chrom)}."""
    single = str(tmp_path_factory.mktemp("intgen"))
    synth.generate_dataset(single, n_samples=30,
                           chrom_variant_counts={"5": 90}, seed=7)
    prep.prep_intgen_data(single)

    mixed = str(tmp_path_factory.mktemp("intgen_x"))
    rng = np.random.default_rng(77)
    panel = synth.make_panel(24, rng)
    panel[0] = (panel[0][0], panel[0][1], panel[0][2], "male")
    panel[1] = (panel[1][0], panel[1][1], panel[1][2], "female")
    synth.write_panel(os.path.join(mixed, "samples.txt"), panel)
    GX, hapX = synth.make_chrx_layout(rng, 36, [r[3] for r in panel],
                                      par_bounds=(0.25, 0.75))
    synth.write_vcf(os.path.join(mixed, "X.vcf.gz"), "X",
                    [r[0] for r in panel], GX, haploid_masks=hapX)
    prep.prep_intgen_data(mixed)
    return {"single": (single, "5"), "mixed": (mixed, "X")}


def _scan(stores, kind, out):
    """One chromosome's scan through the tool, the resident cache cleared
    first so that it uploads; (report, the wall around scan_chromosome)."""
    ld_stream.clear_resident_cache()
    store, chrom = stores[kind]
    data = DataConfig.resolve(store, True, "both", "all")
    config = ScanConfig(chroms=(chrom,), trg_dir_path=str(out),
                        ld_measure="r_square", ld_low_thres=0.2,
                        max_dist=None, device="cpu")
    t0 = time.perf_counter()
    report = scan_chromosome(data, config, chrom)
    return report, time.perf_counter() - t0


def _spans(kind):
    return {**SCAN_SPANS, **(MIXED_SPANS if kind == "mixed" else {})}


@pytest.mark.parametrize("raises", [False, True])
def test_a_span_adds_to_its_key_and_its_root_to_spanned(raises):
    """Each span adds its seconds, also when its body raises; the root
    (key ``spanned_s``) adds its direct children's, not its own or its
    grandchildren's."""
    stats, inner = {}, {}

    def body():
        with span("test.root", stats, SPANNED):
            with span("test.child", stats, "child_s"):
                with span("test.grandchild", inner, "grandchild_s"):
                    time.sleep(0.002)
            time.sleep(0.003)  # in the root, under no child
            with span("test.child", stats, "child_s"):
                if raises:
                    raise KeyError("inside")

    if raises:
        with pytest.raises(KeyError, match="inside"):
            body()
    else:
        body()
    assert stats["child_s"] >= 0.002
    assert inner["grandchild_s"] >= 0.002
    assert stats[SPANNED] == pytest.approx(stats["child_s"])
    assert not profiling._OPEN.stack  # every span closed
    with span("test.again", stats, "child_s"):
        pass
    assert stats["child_s"] > stats[SPANNED]


@pytest.mark.parametrize("kind", KINDS)
def test_an_untraced_scan_enters_no_profiler_code(stores, tmp_path,
                                                  monkeypatch, kind):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    report, _ = _scan(stores, kind, tmp_path)
    assert report.n_hits > 0


@pytest.mark.parametrize("kind", KINDS)
def test_a_traced_scan_puts_each_span_in_the_chrome_trace(stores, tmp_path,
                                                          kind):
    """Under a CPU profile every span is a user_annotation event, and the
    events of a span sum to its stats key within 10 % or 5 ms."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        report, _ = _scan(stores, kind, tmp_path / "out")
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    summed = collections.Counter()
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            summed[e["name"]] += float(e["dur"]) / 1e6
    assert "scan.chromosome" in summed
    for name, key in _spans(kind).items():
        assert name in summed, name
        assert abs(summed[name] - report.stats[key]) <= max(
            0.1 * report.stats[key], 5e-3), (name, summed[name],
                                             report.stats[key])
    assert not BENCH_SPANS & set(summed)


@pytest.mark.parametrize("kind", KINDS)
def test_a_scan_reports_its_split_phases(stores, tmp_path, kind):
    """Every new key is there; each split adds up to at most the phase it
    splits, and the spans to at most the scan's wall (within 1 ms); the
    TSV is what an untraced scan writes, and ``tsv_bytes`` its size."""
    report, wall = _scan(stores, kind, tmp_path / "a")
    st = report.stats
    keys = {"open_s", "upload_host_s", "upload_copy_s", "format_s", "emit_s",
            "tsv_bytes", SPANNED} | set(_spans(kind).values())
    assert keys <= set(st)
    assert "pass1_device_s" not in st  # the CPU has no device timer
    tol = 1e-3
    assert st["upload_host_s"] + st["upload_copy_s"] <= st["upload_s"] + tol
    assert st["format_s"] + st["emit_s"] <= st["write_s"] + tol
    assert st[SPANNED] <= wall + tol
    assert st[SPANNED] >= st["open_s"] + st["upload_s"] + st["write_s"]
    if kind == "mixed":
        assert (st["rect_wait_s"] + st["rect_exact_s"]
                <= st["rect_finish_s"] + tol)
        assert st["rects"] > 0 and st["repack_s"] > 0
    assert st["tsv_bytes"] == os.path.getsize(report.path)
    with profile(activities=[ProfilerActivity.CPU]):
        traced, _ = _scan(stores, kind, tmp_path / "b")
    with open(report.path, "rb") as a, open(traced.path, "rb") as b:
        assert a.read() == b.read()
