"""The port's mixed-ploidy (chrX/chrY) ld_scan (-E torch, on the CPU)
against the JAX tool on tests/test_ploidy_e2e.py's store: per-segment
triangle scans plus the engine's cross-segment rectangles must write the
JAX tool's TSV byte for byte, with and without a window, with both
measures, on either side of the engine's host cutoff, over a two-shard
CPU mesh (-d 2) and as two processes of a gloo group
(tests/test_ploidy_e2e.py:355, :394, :424; tests/test_distributed.py:339).
"""

import json
import os
import sys
import types

import numpy as np
import pytest

from ld_tools_tpu.ingest import prep_intgen_data, synth
from ld_tools_tpu.ops import engine as jax_engine
from ld_tools_tpu.tools import scan as jax_scan
from ld_tools_tpu_torch import ld_scan as torch_ld_scan
from ld_tools_tpu_torch.ops import engine

from .test_torch_distributed import _launch_pair


@pytest.fixture(scope="module")
def xstore(tmp_path_factory):
    """chrX (males haploid outside the PAR bands: two ploidy segments and
    three runs) and chrY (male-only, haploid: one profile)."""
    d = str(tmp_path_factory.mktemp("intgen_x"))
    rng = np.random.default_rng(77)
    panel = synth.make_panel(24, rng)
    panel[0] = (panel[0][0], panel[0][1], panel[0][2], "male")
    panel[1] = (panel[1][0], panel[1][1], panel[1][2], "female")
    synth.write_panel(os.path.join(d, "samples.txt"), panel)
    names = [r[0] for r in panel]
    genders = [r[3] for r in panel]
    GX, hapX = synth.make_chrx_layout(rng, 36, genders,
                                      par_bounds=(0.25, 0.75))
    synth.write_vcf(os.path.join(d, "X.vcf.gz"), "X", names, GX,
                    haploid_masks=hapX)
    male_names = [n for n, g in zip(names, genders) if g == "male"]
    GY = synth.correlated_haplotypes(rng, 12, 2 * len(male_names))
    GY[:, 1::2] = 0
    synth.write_vcf(
        os.path.join(d, "Y.vcf.gz"), "Y", male_names, GY,
        haploid_masks=np.ones((12, len(male_names)), dtype=bool),
        pos_step=500, rsids=[f"rs9{i:04d}" for i in range(12)],
    )
    prep_intgen_data(d)
    return d


def _jax_tsv(store, trg, chrom, measure="r_square", thres=0.2,
             max_dist=None, gend_names="both"):
    assert jax_scan.run(types.SimpleNamespace(
        chroms=chrom, trg_dir_path=trg, intgen_dir_path=store,
        skip_intgen_data_ver=True, gend_names=gend_names, pop_names="all",
        ld_measure=measure, ld_low_thres=thres, max_dist=max_dist,
        checkpoint_dir=None, devices=None, engine="xla")) == 1
    (name,) = os.listdir(trg)
    return name, open(os.path.join(trg, name), "rb").read()


def _torch_argv(store, trg, chrom, measure="r_square", thres=0.2,
                max_dist=None, gend_names="both"):
    argv = ["-C", chrom, "-D", store, "-t", trg, "-f", "-E", "torch",
            "-l", measure, "-z", str(thres), "-g", gend_names]
    return argv + (["-w", str(max_dist)] if max_dist is not None else [])


@pytest.mark.parametrize("counts", ["host", "device"])
@pytest.mark.parametrize("measure,thres", [("r_square", 0.2),
                                           ("d_prime", 0.9),
                                           ("r_square", 0.0004),
                                           ("d_prime", 0.0004)])
@pytest.mark.parametrize("max_dist", [None, 9000])
def test_chrx_scan_tsv_is_byte_identical(xstore, tmp_path, monkeypatch,
                                         caplog, counts, measure, thres,
                                         max_dist):
    """The mixed scan: its segments, then its rectangles through the
    engine (the store's jobs are below the host cutoff; "device" sets it
    to 0 in both engines so the rectangles take the device count).  The
    engine tests the threshold beside the counts; at 0.0004, under the
    test's 5e-4 margin, every cell of a rectangle is a candidate."""
    if counts == "device":
        for eng in (engine, jax_engine):
            monkeypatch.setattr(eng, "_HOST_COUNTS_MACS", 0)
    kw = dict(measure=measure, thres=thres, max_dist=max_dist)
    name, want = _jax_tsv(xstore, str(tmp_path / "jax"), "X", **kw)
    with caplog.at_level("INFO", logger="tpu_ld.tools.scan"), \
            caplog.at_level("INFO", logger="tpu_ld.ops.segment_scan"):
        (report,) = torch_ld_scan.main(_torch_argv(
            xstore, str(tmp_path / "torch"), "X", **kw))
    assert os.path.basename(report.path) == name
    assert open(report.path, "rb").read() == want
    assert report.n_hits > 0
    st = report.stats
    assert st["segments"] == 3 and st["rects"] > 0
    assert st["blocks"] > 0 and st["hit_blocks"] > 0
    assert st["blocks_checked"] == st["hit_blocks"]
    assert 0 < st["rect_candidates"] <= st["rect_cells"]
    if thres < 5e-4 and max_dist is None:
        assert st["rect_candidates"] == st["rect_cells"]
    assert (f"rect_candidates {st['rect_candidates']} of rect_cells "
            f"{st['rect_cells']}") in caplog.text
    # every segment's resident gathered from the store's rows on upload
    assert st["resident_gather"] == st["segments"]
    assert f"resident_gather {st['segments']}" in caplog.text


def _clipped_rows(segments, pos, max_dist):
    """The rows both sides of the rectangles cover, counted plainly: each
    later segment's rows within ``max_dist`` of the row before it (the
    nearest earlier row), and each earlier segment's rows within it of
    the later segment's first row, once for every later segment."""
    d = np.inf if max_dist is None else max_dist
    rows = 0
    for bi in range(1, len(segments)):
        seg = segments[bi]
        rows += int((pos[seg.start:seg.stop] - pos[seg.start - 1] <= d).sum())
        for earlier in segments[:bi]:
            rows += int((pos[seg.start] - pos[earlier.start:earlier.stop]
                         <= d).sum())
    return rows


@pytest.mark.parametrize("max_dist,rect_rows,gend_names", [
    (4000, 2048, "both"),   # a window that clips both sides
    (None, 2048, "both"),   # no window: every row of both sides
    (None, 4, "both"),      # ragged last row blocks and earlier chunks
    (4000, 2048, "male"),   # every segment a column subset
    (None, 4, "male"),
])
def test_chrx_rectangles_gather_their_sides_on_the_device(
        xstore, tmp_path, monkeypatch, caplog, max_dist, rect_rows,
        gend_names):
    """The rectangles' two sides are the store's packed rows gathered by
    ``gather_rows_device`` (its plain twin on the CPU) with each
    segment's columns, never repacked on the host: the TSV is the JAX
    tool's byte for byte, and ``rect_gather_rows`` counts the clipped rows
    of both sides."""
    from ld_tools_tpu_torch.ingest import pack
    from ld_tools_tpu_torch.ops import segment_scan
    from ld_tools_tpu_torch.tools.common import DataConfig
    from ld_tools_tpu_torch.tools.scan import ploidy_segments

    def no_repack(*a, **kw):
        raise AssertionError("the scan repacked rows on the host")

    monkeypatch.setattr(pack, "pack_columns", no_repack)
    monkeypatch.setattr(segment_scan, "_RECT_ROWS", rect_rows)
    data = DataConfig.resolve(xstore, True, gend_names, "all")
    cd = data.store().chrom("X")
    segments = ploidy_segments(cd, data.sample_names)
    pos = np.asarray(cd.pos)
    assert len(segments) == 3
    if gend_names == "male":  # the earlier sides are column subsets too
        assert all(seg.cols is not None for seg in segments)
    else:
        assert segments[0].cols is None and segments[1].cols is not None
    if rect_rows < 2048:
        assert (segments[2].stop - segments[2].start) % rect_rows
    want_rows = _clipped_rows(segments, pos, max_dist)
    if max_dist is not None:  # the window clips both sides
        assert want_rows < _clipped_rows(segments, pos, None)
        assert (pos[segments[1].start] - pos[segments[0].start]) > max_dist
        assert (pos[segments[1].stop - 1] - pos[segments[0].stop - 1]
                > max_dist)
    kw = dict(thres=0.2, max_dist=max_dist, gend_names=gend_names)
    name, want = _jax_tsv(xstore, str(tmp_path / "jax"), "X", **kw)
    with caplog.at_level("INFO", logger="tpu_ld.ops.segment_scan"):
        (report,) = torch_ld_scan.main(_torch_argv(
            xstore, str(tmp_path / "torch"), "X", **kw))
    assert open(report.path, "rb").read() == want and report.n_hits > 0
    st = report.stats
    assert st["rect_gather_rows"] == want_rows > 0
    assert f"rect_gather_rows {want_rows}" in caplog.text
    assert st["rect_candidates"] > 0 and st["repack_s"] > 0


@pytest.mark.parametrize("gend_names", ["male", "both"])
def test_chry_scan_tsv_is_byte_identical(xstore, tmp_path, gend_names):
    """One haploid profile: the single-profile path, no rectangles."""
    name, want = _jax_tsv(xstore, str(tmp_path / "jax"), "Y",
                          gend_names=gend_names)
    (report,) = torch_ld_scan.main(_torch_argv(
        xstore, str(tmp_path / "torch"), "Y", gend_names=gend_names))
    assert open(report.path, "rb").read() == want and report.n_hits > 0
    assert "segments" not in report.stats
    assert report.stats["resident_gather"] == 1.0


def test_chrx_scan_over_a_mesh_is_byte_identical(xstore, tmp_path):
    """-d 2: each segment's scan over [cpu] * 2, the rectangles as
    before; the JAX tool's unsharded bytes (test_ploidy_e2e.py:424)."""
    name, want = _jax_tsv(xstore, str(tmp_path / "jax"), "X",
                          max_dist=9000)
    (report,) = torch_ld_scan.main(_torch_argv(
        xstore, str(tmp_path / "torch"), "X", max_dist=9000) + ["-d", "2"])
    assert open(report.path, "rb").read() == want
    # the segments' shard counts summed: two shards in each of three
    assert report.stats["segments"] == 3 and report.stats["shards"] == 6


def test_chrx_scan_as_two_processes_is_byte_identical(xstore, tmp_path):
    """``python -m ld_tools_tpu_torch.ld_scan -C X`` as two ranks of a
    gloo group: the segments' tiles split inside the scan, the rectangle
    jobs strided across the ranks and met in one allgather; rank 0's TSV
    is the JAX tool's (tests/test_distributed.py:339)."""
    name, want = _jax_tsv(xstore, str(tmp_path / "jax"), "X")
    out = tmp_path / "torch"
    cmd = [sys.executable, "-m", "ld_tools_tpu_torch.ld_scan",
           *_torch_argv(xstore, str(out), "X")]
    outs = _launch_pair(cmd, retry_ok=lambda o: all(rc == 0 for rc, _, _ in o))
    for rc, _, err in outs:
        assert rc == 0, err[-3000:]
        (report,) = [json.loads(ln) for ln in err.splitlines()
                     if ln.startswith('{"launches"')]
        assert set(report["launches"].values()) == {0}
        assert report["engine"] == 0  # the CPU counts launch nothing
    assert os.listdir(out) == [name]
    assert open(out / name, "rb").read() == want
