"""The windowed scan's plan (ops/ld_stream._scan_blocks and _scan_tiles):
built from each block row's and row band's run of kept columns, it gives
exactly the blocks, tiles, homes and batches of the plan it replaced, which
enumerated every block pair and looped over every tile up to the diagonal
(kept below as the reference); a scan's checkpoint files and a cooperative
scan's split follow; and at chr2's size (7,081,600 rows) the plan's memory
follows the kept blocks, not the block pairs."""

import os
import tracemalloc

import numpy as np
import pytest

from ld_tools_tpu_torch.ops import ld_stream


# ---- the plan before its rewrite, kept as the reference -------------------

def ref_scan_blocks(v, pos, count_block, max_dist):
    nb = -(-v // count_block)
    bi, bj = np.tril_indices(nb)
    if max_dist is not None:
        row_lo = bi * count_block
        col_hi = bj * count_block + count_block - 1
        below = col_hi < row_lo
        row_s = np.minimum(row_lo, v - 1)
        col_e = np.minimum(col_hi, v - 1)
        far = pos[row_s] - pos[col_e] > max_dist
        keep = ~(below & far)
        bi, bj = bi[keep], bj[keep]
    return bi, bj


def ref_scan_tiles(v, pos, band, chunk, bi, bj, count_block, max_dist):
    n_r, n_c = -(-v // band), -(-v // chunk)
    tr = bi.astype(np.int64) * count_block // band
    tc = bj.astype(np.int64) * count_block // chunk
    has_block = np.zeros((n_r, n_c), dtype=bool)
    has_block[tr, tc] = True
    tiles = []
    for r0 in range(0, v, band):
        nr = min(band, v - r0)
        for c0 in range(0, r0 + nr, chunk):
            if max_dist is not None:
                last = min(c0 + chunk, v) - 1
                if (last < r0 and int(pos[r0]) - int(pos[last]) > max_dist
                        and not has_block[r0 // band, c0 // chunk]):
                    continue
            tiles.append((r0, c0))
    index = np.full((n_r, n_c), -1, dtype=np.int64)
    for k, (r0, c0) in enumerate(tiles):
        index[r0 // band, c0 // chunk] = k
    return tiles, index[tr, tc]


def _pruned_but_kept(v, pos, band, chunk, bi, bj, count_block, max_dist):
    """Tiles the reference's distance pruning drops and keeps all the same
    for a block in them (the ``has_block`` exception)."""
    tiles, _ = ref_scan_tiles(v, pos, band, chunk, bi, bj, count_block,
                              max_dist)
    return sum(1 for r0, c0 in tiles
               if min(c0 + chunk, v) - 1 < r0
               and pos[r0] - pos[min(c0 + chunk, v) - 1] > max_dist)


# ---- cases ----------------------------------------------------------------

def _positions(kind, v, seed=5):
    rng = np.random.default_rng(seed)
    if kind == "uniform":  # about one variant in 34 bp, as chr2
        return np.sort(rng.choice(34 * v, v, replace=False)).astype(np.int64)
    if kind == "clustered":  # dense clusters far apart
        pos = np.sort(rng.choice(2 * v, v, replace=False)).astype(np.int64)
        return pos + (np.arange(v) // 700) * 5_000_000
    # gaps (some wider than every window but the widest)
    return np.cumsum(np.where(rng.random(v) < 0.01, 2_000_000,
                              rng.integers(1, 3000, v))).astype(np.int64)


# (v, positions, count_block, band, chunk, max_dist)
CASES = {
    "window-0": (3001, "uniform", 640, 3840, 7680, 0),
    "window-1": (3001, "gaps", 300, 256, 512, 1),
    "typical": (9999, "uniform", 640, 1024, 2048, 30_000),
    "wider-than-chromosome": (5000, "uniform", 640, 1024, 2048, 10**9),
    "no-window": (4100, "uniform", 640, 1024, 2048, None),
    "ragged-v": (7681 + 641, "gaps", 640, 3840, 7680, 1_000_000),
    "block-not-dividing-tiles": (9999, "gaps", 300, 256, 512, 500),
    "block-wider-than-band": (9999, "gaps", 640, 256, 512, 20_000),
    "clustered": (12_000, "clustered", 640, 1024, 2048, 1_000_000),
    "gaps-past-window": (12_000, "gaps", 100, 256, 512, 1_000_000),
    "one-block": (500, "uniform", 640, 256, 512, 1000),
    "one-row": (1, "uniform", 640, 256, 512, 1000),
}


def _batches(home, n_tiles, n_proc, proc_idx, max_tiles_per_call):
    """Each batch's blocks as ``stream_threshold_scan`` groups them: this
    process's tiles ``tiles[proc_idx::n_proc]``, ``max_tiles_per_call``
    of them a batch."""
    mine = home % n_proc == proc_idx
    batch_of = home // n_proc // max_tiles_per_call
    n_batches = -(-len(range(proc_idx, n_tiles, n_proc))
                  // max_tiles_per_call)
    return [np.flatnonzero(mine & (batch_of == k)) for k in range(n_batches)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_plan_equals_the_reference_plan(case):
    v, kind, count_block, band, chunk, max_dist = CASES[case]
    pos = _positions(kind, v)
    band = min(band, -(-v // 256) * 256)  # as the scan clamps them
    chunk = min(chunk, -(-v // 512) * 512)
    want_bi, want_bj = ref_scan_blocks(v, pos, count_block, max_dist)
    bi, bj = ld_stream._scan_blocks(v, pos, count_block, max_dist)
    for got, want in ((bi, want_bi), (bj, want_bj)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    want_tiles, want_home = ref_scan_tiles(v, pos, band, chunk, want_bi,
                                           want_bj, count_block, max_dist)
    tiles, home = ld_stream._scan_tiles(v, pos, band, chunk, bi, bj,
                                        count_block, max_dist)
    assert tiles == want_tiles
    assert all(type(x) is int for t in tiles for x in t)
    assert home.dtype == want_home.dtype
    np.testing.assert_array_equal(home, want_home)
    assert (home >= 0).all()
    # the cooperative split and the batches (and so the checkpoints'
    # numbering) follow from the tiles and the homes
    for n_proc in (1, 2, 3):
        for proc_idx in range(n_proc):
            for per_call in (1, 2, 512):
                got = _batches(home, len(tiles), n_proc, proc_idx, per_call)
                want = _batches(want_home, len(want_tiles), n_proc, proc_idx,
                                per_call)
                assert len(got) == len(want)
                for a, b in zip(got, want):
                    np.testing.assert_array_equal(a, b)
    if case in ("block-not-dividing-tiles", "block-wider-than-band"):
        assert _pruned_but_kept(v, pos, band, chunk, want_bi, want_bj,
                                count_block, max_dist) > 0
    if max_dist is not None and case not in ("wider-than-chromosome",
                                             "one-block", "one-row"):
        assert want_bi.size < (-(-v // count_block)) ** 2 // 2  # it prunes


def _scan(G, pos, ckpt, **kw):
    ld_stream.clear_resident_cache()
    return ld_stream.stream_threshold_scan(
        G, pos, thres=0.5, max_dist=3000, band=256, chunk=512,
        count_block=100, max_tiles_per_call=2, checkpoint_dir=str(ckpt),
        device="cpu", **kw)


def test_a_scan_checkpoints_the_same_batches_as_under_the_reference_plan(
        tmp_path, monkeypatch):
    rng = np.random.default_rng(11)
    v, h = 1500, 96
    base = rng.random((v // 4 + 1, h)) < rng.uniform(0.1, 0.9, (v // 4 + 1, 1))
    G = np.repeat(base, 4, axis=0)[:v].astype(np.int8)
    G ^= (rng.random((v, h)) < 0.03).astype(np.int8)
    pos = np.cumsum(np.where(rng.random(v) < 0.02, 50_000,
                             rng.integers(1, 60, v))).astype(np.int64)
    new = _scan(G, pos, tmp_path / "new")
    monkeypatch.setattr(ld_stream, "_scan_blocks", ref_scan_blocks)
    monkeypatch.setattr(ld_stream, "_scan_tiles", ref_scan_tiles)
    old = _scan(G, pos, tmp_path / "old")
    assert new.stats["batches"] == old.stats["batches"] > 2
    assert new.stats["blocks"] == old.stats["blocks"]
    names = sorted(os.listdir(tmp_path / "new"))
    assert names == sorted(os.listdir(tmp_path / "old"))
    assert len(names) == new.stats["batches"]
    for name in names:
        a, b = np.load(tmp_path / "new" / name), np.load(tmp_path / "old" / name)
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key])
    assert new.i.size > 0
    np.testing.assert_array_equal(new.i, old.i)
    np.testing.assert_array_equal(new.j, old.j)
    # a resumed scan under the new plan reads the reference plan's files
    monkeypatch.undo()
    again = _scan(G, pos, tmp_path / "old")
    assert again.stats["batches_resumed"] == again.stats["batches"]
    np.testing.assert_array_equal(again.i, old.i)
    np.testing.assert_array_equal(again.r_square, old.r_square)


# chr2 of 1000 Genomes phase 3 (ldbench/configs/kg3_chr2.json)
CHR2_ROWS, CHR2_SPAN = 7_081_600, 242_000_000


def test_the_plan_at_chr2s_size_costs_the_kept_blocks():
    """The plan of a ``-w 1000000`` scan of chr2 at the scan's tiling.
    Bound: the plan holds a few int64 arrays over the kept blocks (the two
    coordinates, their tiles, keys and homes) and smaller ones over the
    block rows and tiles, so its peak is a small multiple of the
    coordinates' 16 bytes a kept block: 8 x that.  Enumerating every block
    pair, as the old plan did, needs 8 bytes a pair for each int64 array
    over the 61.2 M pairs (490 MB an array), about 60 times the bound."""
    rng = np.random.default_rng(2)
    v = CHR2_ROWS
    pos = (np.sort(rng.integers(0, CHR2_SPAN - v, v)) + np.arange(v) + 1)
    count_block, band, chunk = 640, ld_stream._BAND, ld_stream._CHUNK
    tracemalloc.start()
    try:
        bi, bj = ld_stream._scan_blocks(v, pos, count_block, 1_000_000)
        tiles, home = ld_stream._scan_tiles(v, pos, band, chunk, bi, bj,
                                            count_block, 1_000_000)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    n_blocks = bi.size
    nb = -(-v // count_block)
    assert 400_000 < n_blocks < 700_000  # about 47 blocks a block row
    assert n_blocks < nb * (nb + 1) // 2 // 100
    assert peak < 8 * 16 * n_blocks, (peak, n_blocks)
    assert home.size == n_blocks and len(tiles) < 20_000
    assert (np.diff(bi) >= 0).all() and (bj <= bi).all()
    # every kept block's closest pair lies within the window, or the block
    # touches the diagonal
    below = bj < bi
    gap = pos[bi[below] * count_block] - pos[bj[below] * count_block
                                             + count_block - 1]
    assert (gap <= 1_000_000).all()


def test_the_scan_logs_its_blocks_and_batches(tmp_path, caplog):
    from ld_tools_tpu_torch.ingest import prep, synth
    from ld_tools_tpu_torch.tools.common import DataConfig
    from ld_tools_tpu_torch.tools.scan import ScanConfig, scan_chromosome

    store = str(tmp_path / "intgen")
    synth.generate_dataset(store, n_samples=30,
                           chrom_variant_counts={"5": 90}, seed=7)
    prep.prep_intgen_data(store)
    ld_stream.clear_resident_cache()
    data = DataConfig.resolve(store, True, "both", "all")
    config = ScanConfig(chroms=("5",), trg_dir_path=str(tmp_path / "out"),
                        ld_measure="r_square", ld_low_thres=0.2,
                        max_dist=1_000_000, device="cpu")
    with caplog.at_level("INFO"):
        report = scan_chromosome(data, config, "5")
    line = next(r.getMessage() for r in caplog.records
                if "pairs above threshold" in r.getMessage())
    assert (f"blocks {report.stats['blocks']}, "
            f"batches {report.stats['batches']}, ") in line
    assert report.stats["blocks"] >= 1 and report.stats["batches"] >= 1
