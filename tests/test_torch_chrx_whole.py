"""A whole chrX through the port's scan on the CPU, and the mixed scan's
merge.

- The kg3_chrX deployment (ldbench/configs/kg3_chrX.json: PAR1, then
  every male haploid to the chromosome's end), its rows, span, PAR1 bound
  and window cut together so that the density of variants stays chrX's,
  made by the benchmark's generator and scanned by ``ld_scan -E torch -C
  X -z 0.8`` with the haploid segment in the packed layout over its
  gathered columns (``TPU_LD_DENSE_RESIDENT_BYTES`` between the two
  segments' int8 sizes) and PAR1 in the int8 one: the TSV must equal, byte
  for byte, the one the benchmark's plain reference expects, with the
  window and without it.
- The same with a PAR2, the store written by the port's ``ingest/synth``
  and ``prep`` from a VCF: three segments, two later ones whose
  rectangles the merge interleaves; the reference looks at every pair.
- ``segment_scan._merge`` against a plain lexsort of every hit on random
  parts: the same arrays, dtypes included, and ``merge_sorted_hits``
  counts only the hits in the rows the rectangles touched.
"""

import json
import os

import numpy as np
import pytest

from ld_tools_tpu_torch import ld_scan
from ld_tools_tpu_torch.ingest import prep_intgen_data, synth
from ld_tools_tpu_torch.ops import ld_stream, segment_scan
from ld_tools_tpu_torch.ops.ld_stream import ScanHits

from ldbench import data, jobs, reference
from ldbench.spec import ROOT

CONFIG = json.loads((ROOT / "ldbench" / "configs" / "kg3_chrX.json")
                    .read_text())
ROWS = 6000
SEED = 2_147_483_735  # PAR1's last row at alt frequency 0.91: rectangle hits
LIMIT = "TPU_LD_DENSE_RESIDENT_BYTES"
FIELDS = segment_scan._FIELDS


def _cut(rows: int) -> dict:
    """kg3_chrX with ``rows`` variants over a span cut by the same share,
    the PAR1 bound moved with it."""
    scale = rows / CONFIG["n_variants"]
    first = CONFIG["first_pos"]
    return dict(CONFIG, n_variants=rows,
                span_bp=round(CONFIG["span_bp"] * scale),
                par1_end=first + round((CONFIG["par1_end"] - first) * scale))


def _int8_bytes(rows: int, n_cols: int) -> int:
    """The int8 resident of ``rows`` rows of ``n_cols`` columns, as the
    scan driver sizes it against the limit."""
    w = ld_stream._round_up(-(-n_cols // 8), 128)
    return ld_stream._padded_rows(rows, ld_stream._BAND,
                                  ld_stream._CHUNK) * w * 8


def _segments(pgroup) -> list:
    cuts = (np.flatnonzero(np.diff(pgroup)) + 1).tolist()
    return list(zip([0, *cuts], [*cuts, pgroup.size]))


def _scan(store, out, chrom, max_dist, thres=0.8):
    ld_stream.clear_resident_cache()
    argv = ["-C", chrom, "-D", store, "-t", out, "-E", "torch", "-z",
            str(thres)]
    (report,) = ld_scan.main(argv + ([] if max_dist is None
                                     else ["-w", str(max_dist)]))
    with open(report.path) as fh:
        return report, fh.read()


def _expected(ds, max_dist, band, n_far, seed, thres=0.8) -> tuple:
    cohort, text = jobs._cohort(ds.panel, "both", "all")
    prm = reference.ScanParams(measure="r_square", thres=thres,
                               max_dist=max_dist, band=band, n_far=n_far)
    lists = reference.Lists(ds, "cpu", cohort)
    hits, _ = reference.scan_hits(ds, lists, prm, seed)
    return hits, (reference.scan_header(ds, prm, text)
                  + reference.scan_body(ds, hits))


@pytest.mark.parametrize("window", [True, False])
def test_a_cut_whole_chrx_scans_to_the_references_tsv(tmp_path, monkeypatch,
                                                      caplog, window):
    config = _cut(ROWS)
    ds = data.make_dataset(config, SEED, "cpu")
    (p0, p1), (h0, h1) = _segments(ds.pgroup)
    assert ds.chrom == "X" and ds.n_hap == 5008 and p0 == 0 and h1 == ROWS
    assert (ds.pos[p1 - 1] <= config["par1_end"] < ds.pos[h0])
    assert 0.015 < p1 / ROWS < 0.022  # PAR1's share of chrX's rows
    assert ds.pos[-1] <= config["first_pos"] + config["span_bp"] - 1
    store = data.prepare_store(str(tmp_path / "store"), ds)
    # the window cut with the rows: about 38 rows, as 1 Mb holds about
    # 22,230 of chrX's
    max_dist = round(1_000_000 * ROWS / CONFIG["n_variants"]) if window \
        else None
    haploid_cols = int(ds.profiles[1].sum())
    assert _int8_bytes(p1, 5008) < _int8_bytes(h1 - h0, haploid_cols)
    monkeypatch.setenv(LIMIT, str(_int8_bytes(p1, 5008)))
    with caplog.at_level("INFO", logger="tpu_ld.ops.segment_scan"):
        report, got = _scan(str(tmp_path / "store"), str(tmp_path / "out"),
                            "X", max_dist)
    st = report.stats
    # PAR1 int8 over the full layout, the haploid stretch packed over its
    # gathered columns (512-byte rows at the panel's size)
    assert st["segments"] == 2
    assert st["resident_dense"] == 1 and st["resident_packed"] == 1
    assert st["resident_gather"] == 2
    assert ld_stream._round_up(-(-haploid_cols // 8), 128) == 512
    assert (f"segment rows {h0}-{h1}: {h1 - h0} rows, {haploid_cols} "
            "alleles, resident packed, columns gathered") in caplog.text
    assert (f"segment rows 0-{p1}: {p1} rows, 5008 alleles, resident "
            "int8, columns full layout") in caplog.text

    hits, want = _expected(ds, max_dist, 2 * config["ld_run_rows"] - 1
                           + config["straddle_rows"], jobs.FAR_PAIRS, SEED)
    assert got == want
    cross = int(((hits.i >= h0) & (hits.j < h0)).sum())
    assert cross > 0 and hits.i.size > 1000
    assert st["merge_hits"] == hits.i.size
    if window:
        # the rectangles touch the rows within the window of the bound
        touched = int(np.searchsorted(ds.pos, ds.pos[p1 - 1] + max_dist,
                                      side="right"))
        assert st["merge_sorted_hits"] == int(
            ((hits.i >= h0) & (hits.i < touched)).sum())
        assert 0 < st["merge_sorted_hits"] < 0.1 * st["merge_hits"]
        assert (ds.pos[hits.i] - ds.pos[hits.j] <= max_dist).all()
    else:  # the whole later segment
        assert st["merge_sorted_hits"] == int((hits.i >= h0).sum())


@pytest.fixture(scope="module")
def par2_store(tmp_path_factory):
    """chrX with PAR1, the haploid stretch and PAR2 from the port's synth,
    written as a VCF and ingested by the port's prep; the Dataset the
    reference reads from the same genotypes."""
    d = str(tmp_path_factory.mktemp("intgen_par2"))
    rng = np.random.default_rng(24)
    panel = synth.make_panel(24, rng)
    panel[0] = panel[0][:3] + ("male",)
    panel[1] = panel[1][:3] + ("female",)
    synth.write_panel(os.path.join(d, "samples.txt"), panel)
    v = 480
    genders = [r[3] for r in panel]
    G, hap = synth.make_chrx_layout(rng, v, genders, par_bounds=(0.3, 0.7))
    lo, hi = int(0.3 * v), int(0.7 * v)
    # LD across each bound: the rows past it carry, in their own list's
    # columns, the leading alleles of the row before it, a rare allele
    # (the zip of a list of 48 with one of 36 keeps such pairs above 0.4)
    male = np.array([g == "male" for g in genders])
    dead = 2 * np.flatnonzero(male) + 1
    hap_cols = np.flatnonzero(~np.isin(np.arange(2 * len(panel)), dead))
    for row in (lo - 1, hi - 1):
        G[row] = rng.random(G.shape[1]) < 0.15
    G[hi - 1, dead] = 0
    for k in range(6):
        G[lo + k] = 0
        G[lo + k, hap_cols] = G[lo - 1, :hap_cols.size]
        G[hi + k] = 0
        G[hi + k, :hap_cols.size] = G[hi - 1, hap_cols]
    pos = (np.arange(v, dtype=np.int64) + 1) * 1000
    synth.write_vcf(os.path.join(d, "X.vcf.gz"), "X", [r[0] for r in panel],
                    G, pos=pos,
                    rsids=[f"rs{data.RSID_BASE + k}" for k in range(v)],
                    haploid_masks=hap)
    prep_intgen_data(d)
    pgroup = np.zeros(v, dtype=np.int16)
    pgroup[lo:hi] = 1
    profiles = np.full((2, len(panel)), 2, dtype=np.uint8)
    profiles[1, male] = 1
    ds = data.Dataset(chrom="X", gp=np.packbits(G.astype(np.uint8), axis=1),
                      pos=pos, n_hap=2 * len(panel), panel=list(panel),
                      pgroup=pgroup, profiles=profiles)
    return d, ds


@pytest.mark.parametrize("max_dist", [20_000, None])
def test_a_chrx_with_par2_scans_to_the_references_tsv(par2_store, tmp_path,
                                                      monkeypatch, max_dist):
    """Three segments (PAR1, the haploid stretch, PAR2): the later two
    each meet the earlier ones in rectangles, and the merge interleaves
    both; every pair is looked at by the reference (its band the whole
    chromosome)."""
    store, ds = par2_store
    segs = _segments(ds.pgroup)
    assert len(segs) == 3
    monkeypatch.setenv(LIMIT, "0")  # every segment packed
    report, got = _scan(store, str(tmp_path / "out"), "X", max_dist,
                        thres=0.4)
    hits, want = _expected(ds, max_dist, ds.n_variants, 0, SEED, thres=0.4)
    assert got == want
    st = report.stats
    assert st["segments"] == 3 and st["resident_packed"] == 3
    (_, _), (b0, b1), (c0, _) = segs
    for s0, s1 in ((b0, b1), (c0, ds.n_variants)):  # two rectangle sets
        assert ((hits.i >= s0) & (hits.i < s1) & (hits.j < s0)).any()
    assert st["merge_hits"] == hits.i.size
    if max_dist is None:  # every row of both later segments
        assert st["merge_sorted_hits"] == int((hits.i >= b0).sum())
    else:
        assert 0 < st["merge_sorted_hits"] < int((hits.i >= b0).sum())


# ---- the merge -------------------------------------------------------------

def _lexsort_merge(parts) -> dict:
    """Every hit concatenated and lexsorted by (i, j): the plain merge."""
    cat = {f: np.concatenate([getattr(p, f) for p in parts]) for f in FIELDS}
    order = np.lexsort((cat["j"], cat["i"]))
    return {f: a[order] for f, a in cat.items()}


def _hits(i, j, rng) -> ScanHits:
    n = i.size
    return ScanHits(i=i.astype(np.int64), j=j.astype(np.int64),
                    r_square=rng.random(n), d_prime=rng.random(n) * 2 - 1,
                    r_square_is_int_zero=rng.random(n) < 0.1,
                    d_prime_is_int_zero=rng.random(n) < 0.1, exact=True)


def _pairs(rng, rows_i, rows_j, n):
    """``n`` distinct pairs (i, j), i in ``rows_i``, j in ``rows_j``, j < i."""
    ii = rng.integers(*rows_i, size=4 * n + 8)
    jj = rng.integers(*rows_j, size=4 * n + 8)
    ok = jj < ii
    key = np.unique(ii[ok] * 1_000_003 + jj[ok])
    key = rng.permutation(key)[:n]
    return key // 1_000_003, key % 1_000_003


def _random_case(rng, bounds, window, n_seg_hits, n_chunks):
    """Segment parts (each sorted, over its own rows; an empty one where
    ``n_seg_hits`` says 0), rectangle parts in the rectangles' job order
    (a block of 16 rows, then the earlier rows in ``n_chunks`` column
    chunks, in column order; each part sorted by (i, j), some empty) and
    the touched ranges: each later segment's first ``window`` rows (None:
    all of them)."""
    segs, rects, touched = [], [], []
    for k, (s0, s1) in enumerate(bounds):
        i, j = _pairs(rng, (s0, s1), (s0, s1), n_seg_hits[k])
        order = np.lexsort((j, i))
        segs.append(_hits(i[order], j[order], rng))
        if k == 0:
            continue
        hi = s1 if window is None else min(s1, s0 + window)
        touched.append((s0, hi))
        i, j = _pairs(rng, (s0, hi), (0, s0), 300)
        chunk = np.searchsorted(np.linspace(0, s0, n_chunks + 1)[1:-1], j,
                                side="right")
        job = (i - s0) // 16 * n_chunks + chunk
        order = np.lexsort((j, i, job))
        i, j, job = i[order], j[order], job[order]
        for part in np.split(np.arange(i.size),
                             np.flatnonzero(np.diff(job)) + 1):
            rects.append(_hits(i[part], j[part], rng))
        rects.append(_hits(i[:0], j[:0], rng))
    return segs, rects, touched


@pytest.mark.parametrize("bounds,window,n_seg_hits,n_chunks", [
    ([(0, 400)], 40, [900], 1),                              # one segment
    ([(0, 150), (150, 600)], 40, [200, 1500], 3),
    ([(0, 150), (150, 600)], None, [200, 1500], 2),          # no window
    ([(0, 100), (100, 500), (500, 700)], 30, [150, 1200, 300], 4),
    ([(0, 100), (100, 500), (500, 700)], None, [150, 1200, 300], 1),
    ([(0, 100), (100, 500), (500, 700)], 30, [0, 1200, 0], 2),  # empty parts
    ([(0, 100), (100, 101), (101, 500)], 30, [150, 0, 800], 2),
])
def test_the_merge_equals_a_lexsort_of_every_hit(bounds, window, n_seg_hits,
                                                 n_chunks):
    rng = np.random.default_rng([24, len(bounds), n_chunks])
    segs, rects, touched = _random_case(rng, bounds, window, n_seg_hits,
                                        n_chunks)
    assert len(rects) >= 3 * (len(bounds) - 1)  # several parts a range
    stats = {}
    got = segment_scan._merge(segs, rects, touched, stats)
    want = _lexsort_merge(segs + rects)
    for f in FIELDS:
        a = getattr(got, f)
        assert a.dtype == want[f].dtype and np.array_equal(a, want[f]), f
    in_touched = np.zeros(want["i"].size, dtype=bool)
    for lo, hi in touched:
        in_touched |= (want["i"] >= lo) & (want["i"] < hi)
    assert stats["merge_hits"] == want["i"].size
    assert stats["merge_sorted_hits"] == int(in_touched.sum())
    if len(bounds) == 1:
        assert stats["merge_sorted_hits"] == 0


def test_the_cooperative_merge_takes_one_gathered_part():
    """A cooperative scan's rectangles arrive as one part, every
    process's hits concatenated in no order: lexsorted as one part, the
    merge then sorts only them and the segments' touched rows."""
    rng = np.random.default_rng(2424)
    segs, rects, touched = _random_case(
        rng, [(0, 100), (100, 500), (500, 700)], 30, [150, 1200, 300], 3)
    one = segment_scan._concat(rects)
    shuffled = rng.permutation(one.i.size)
    one = segment_scan._lexsorted({f: getattr(one, f)[shuffled]
                                   for f in FIELDS})
    stats = {}
    got = segment_scan._merge(segs, [one], touched, stats)
    want = _lexsort_merge(segs + rects)
    for f in FIELDS:
        assert np.array_equal(getattr(got, f), want[f]), f
    assert 0 < stats["merge_sorted_hits"] < stats["merge_hits"]


def test_the_merge_of_nothing_is_empty():
    stats = {}
    got = segment_scan._merge([], [], [], stats)
    assert got.i.size == 0 and got.i.dtype == np.int64
    assert stats == {"merge_hits": 0, "merge_sorted_hits": 0}
    with pytest.raises(ValueError):
        rng = np.random.default_rng(1)
        segment_scan._merge([], [_hits(np.array([50]), np.array([3]), rng)],
                            [(0, 40)], {})
