"""The mixed-ploidy scan's cross-segment rectangles: the threshold test on
the counts (``ops/ld_kernels.exact_keep_mask`` with each side's list
length), the engine's job that
applies it (``ops/engine.rect_candidates_async``) and the f64 finish of
the cells it passes (``ops/ld_stream._exact_refilter_counts``, the
scan's own finish), against the full-block
path they replace: every cell of a rectangle finished in f64
(``exact_ld_from_counts`` with each side's list length), rounded to four
places, ``>= thres`` and, with a window, the distance test."""

import numpy as np
import pytest
import torch

from ld_tools_tpu_torch.ops import engine
from ld_tools_tpu_torch.ops.exact import exact_ld_from_counts, round4
from ld_tools_tpu_torch.ops.ld_kernels import KEEP_MARGIN, exact_keep_mask
from ld_tools_tpu_torch.ops.ld_stream import _exact_refilter_counts

MEASURES = ("r_square", "d_prime")
THRESHOLDS = (0.8, 0.2, 1.0, 0.0)
# (len1, len2): each side's own list length; the zip is the shorter
LENGTHS = ((60, 100), (100, 60), (80, 80))


def _rounded(c_ab, c1, c2, len1, len2, measure):
    """The full-block path's 4-place values (0.0 at the int-0 cells)."""
    n = min(len1, len2)
    ex = exact_ld_from_counts(c_ab, c1, c2, n, len1=len1, len2=len2)
    if measure == "r_square":
        meas, iz = ex.r_square, ex.r_square_is_int_zero
    else:
        meas, iz = ex.d_prime, ex.d_prime_is_int_zero
    rounded = round4(meas)
    rounded[iz] = 0.0
    return rounded, ex


def _mask(c_ab, c1, c2, len1, len2, thres, measure):
    args = (torch.from_numpy(np.asarray(c_ab, np.int32)),
            torch.from_numpy(np.asarray(c1, np.int32))[:, None],
            torch.from_numpy(np.asarray(c2, np.int32))[None, :],
            min(len1, len2), thres - KEEP_MARGIN,
            0 if measure == "r_square" else 1)
    keep = exact_keep_mask(*args, len1=len1, len2=len2)
    if len1 == len2:  # the one-ploidy call, lengths left to default
        assert torch.equal(keep, exact_keep_mask(*args))
    return keep.numpy()


@pytest.mark.parametrize("len1,len2", LENGTHS)
@pytest.mark.parametrize("measure", MEASURES)
def test_the_mask_keeps_every_cell_of_a_count_grid(len1, len2, measure):
    """Every alt count of each side (0 and the list's length included:
    the monomorphic rows) against every co-occurrence count up to the zip
    length: the mask at thres - 5e-4 keeps each cell that rounds to >=
    thres, at each threshold, and the grid holds cells that round to the
    threshold itself and to 1e-4 either side of it."""
    n = min(len1, len2)
    c1 = np.arange(len1 + 1)
    c2 = np.arange(len2 + 1)
    near = {t: 0 for t in THRESHOLDS}
    for k in range(n + 1):
        c_ab = np.full((c1.size, c2.size), k)
        rounded, _ = _rounded(c_ab, c1, c2, len1, len2, measure)
        for thres in THRESHOLDS:
            want = rounded >= thres
            got = _mask(c_ab, c1, c2, len1, len2, thres, measure)
            assert not (want & ~got).any(), (k, thres)
            if thres > 0:
                assert (~got).any()  # the test drops something
            for step in (-1e-4, 0.0, 1e-4):
                near[thres] += int((rounded == round(thres + step, 4)).sum())
    for thres, count in near.items():
        if thres < 1.0:
            assert count > 0, thres


def _rows(rng, v, length, base):
    """{0, 1} rows of ``length`` haplotypes: copies of ``base``'s rows with
    a few flips (LD inside the zip), and monomorphic, all-alt and
    near-monomorphic rows among them."""
    g = base[rng.integers(0, base.shape[0], v), :length].copy()
    flip = rng.random(g.shape) < rng.choice([0.0, 0.01, 0.05, 0.3], v)[:, None]
    g ^= flip.astype(np.int8)
    g[0] = 0
    g[1] = 1
    g[2] = 0
    g[2, -1] = 1
    g[3] = 1
    g[3, 0] = 0
    return g


def _block(rng, v1, v2, len1, len2):
    base = (rng.random((12, max(len1, len2)))
            < rng.uniform(0.02, 0.98, 12)[:, None]).astype(np.int8)
    g1 = _rows(rng, v1, len1, base)
    g2 = _rows(rng, v2, len2, base)
    n = min(len1, len2)
    c_ab = g1[:, :n].astype(np.int64) @ g2[:, :n].T.astype(np.int64)
    return g1, g2, c_ab, g1.sum(axis=1), g2.sum(axis=1)


@pytest.mark.parametrize("len1,len2", [(5008, 3775), (3775, 5008),
                                       (5008, 5008), (37, 61),
                                       (60000, 45000), (45000, 60000)])
@pytest.mark.parametrize("measure", MEASURES)
def test_the_mask_keeps_every_cell_of_random_rows(len1, len2, measure):
    """Rows at the panel's list lengths (PAR 5,008, non-PAR 3,775): the
    mask keeps each cell the full-block path keeps; past the zip the
    longer side's alt count may exceed the zip length.  A 30,000-sample
    cohort (60,000 and 45,000 haplotypes, a few rows) has products past
    2^31, which the mask's integers hold."""
    rng = np.random.default_rng(len1 * 7 + len2)
    big = max(len1, len2) > 46340
    _, g2, c_ab, c1, c2 = _block(rng, *((16, 18) if big else (120, 140)),
                                 len1, len2)
    if len2 > len1:
        assert (c2 > min(len1, len2)).any()
    if big:
        assert (c1[:, None] * c2[None, :] >= 2**31).any()
    for thres in THRESHOLDS:
        rounded, _ = _rounded(c_ab, c1, c2, len1, len2, measure)
        want = rounded >= thres
        got = _mask(c_ab, c1, c2, len1, len2, thres, measure)
        assert not (want & ~got).any(), thres
        if 0 < thres < 1:
            assert want.any()


def _old_hits(g1, g2, c1, c2, len1, len2, r0, c0, pos1, pos2, measure,
              thres, max_dist):
    """The full-block path: every cell finished, rounded, filtered."""
    n = min(len1, len2)
    c_ab, _, _ = engine.pair_counts(g1[:, :n], g2[:, :n], device="cpu")
    rounded, ex = _rounded(c_ab, c1, c2, len1, len2, measure)
    keep = rounded >= thres
    if max_dist is not None:
        keep &= np.abs(pos1[:, None] - pos2[None, :]) <= max_dist
    ii, jj = np.nonzero(keep)
    return ((ii + r0).astype(np.int64), (jj + c0).astype(np.int64),
            ex.r_square[keep], ex.d_prime[keep],
            ex.r_square_is_int_zero[keep], ex.d_prime_is_int_zero[keep])


@pytest.mark.parametrize("counts", ["host", "device"])
@pytest.mark.parametrize("len1,len2", [(5008, 3775), (3775, 5008),
                                       (5008, 5008)])
@pytest.mark.parametrize("measure,thres", [("r_square", 0.8),
                                           ("d_prime", 0.9),
                                           ("r_square", 0.0004),
                                           ("d_prime", 0.0)])
@pytest.mark.parametrize("max_dist", [None, 3000])
def test_the_candidates_finish_to_the_full_block_hits(
        monkeypatch, counts, len1, len2, measure, thres, max_dist):
    """The engine's candidates, finished by ``_exact_refilter_counts``
    with each side's list length, give the
    full-block path's six arrays bit for bit, in its order; at a
    threshold under the margin every cell is a candidate (and the equal
    lengths reach the native pairwise finisher past 65,536 cells)."""
    if counts == "device":  # the engine's device route, on the CPU
        monkeypatch.setattr(engine, "_HOST_COUNTS_MACS", 0)
    rng = np.random.default_rng(len1 + 3 * len2 + int(thres * 10))
    v1, v2 = 260, 300
    g1, g2, _, c1, c2 = _block(rng, v1, v2, len1, len2)
    r0, c0 = 5000, 1000
    pos1 = np.sort(rng.integers(20_000, 30_000, v1))
    pos2 = np.sort(rng.integers(15_000, 25_000, v2))
    n = min(len1, len2)
    fin = engine.rect_candidates_async(
        *_tensors(g1[:, :n], g2[:, :n], c1, c2), n, len1, len2,
        thres - KEEP_MARGIN, 0 if measure == "r_square" else 1, pos1=pos1,
        pos2=pos2, max_dist=max_dist)
    rows, cols, c_ab = fin()
    if thres <= KEEP_MARGIN and max_dist is None:
        assert rows.size == v1 * v2
    _assert_old_hits(rows, cols, c_ab, g1, g2, c1, c2, len1, len2, r0, c0,
                     pos1, pos2, measure, thres, max_dist)


def _tensors(g1, g2, c1, c2):
    """The engine's operands as CPU tensors: int8 rows, int32 counts."""
    return (torch.from_numpy(np.ascontiguousarray(g1, np.int8)),
            torch.from_numpy(np.ascontiguousarray(g2, np.int8)),
            torch.from_numpy(np.asarray(c1, np.int32)),
            torch.from_numpy(np.asarray(c2, np.int32)))


def _assert_old_hits(rows, cols, c_ab, g1, g2, c1, c2, len1, len2, r0, c0,
                     pos1, pos2, measure, thres, max_dist):
    """The candidates, finished with each side's list length, are the
    full-block path's six arrays, bit for bit and in its order."""
    hits = _exact_refilter_counts(c_ab, c1[rows], c2[cols], min(len1, len2),
                                  rows + r0, cols + c0, measure, thres,
                                  len1=len1, len2=len2)
    got = (hits.i, hits.j, hits.r_square, hits.d_prime,
           hits.r_square_is_int_zero, hits.d_prime_is_int_zero)
    want = _old_hits(g1, g2, c1, c2, len1, len2, r0, c0, pos1, pos2,
                     measure, thres, max_dist)
    assert want[0].size > 0 and hits.exact
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("counts", ["host", "device"])
@pytest.mark.parametrize("len1,len2", [(5008, 3775), (3775, 5008),
                                       (37, 61), (61, 37)])
@pytest.mark.parametrize("measure,thres", [("r_square", 0.2),
                                           ("d_prime", 0.9),
                                           ("r_square", 0.0004)])
def test_sides_of_one_width_zip_to_the_shorter_list(
        monkeypatch, counts, len1, len2, measure, thres):
    """Each side's whole list, padded with zeros to one width (a multiple
    of 16 past both lists), as the mixed scan gathers them: the longer
    side has alt alleles past the zip, the shorter side's zeros there
    leave them out of the product, and with ``n_hap`` the zip length the
    candidates finish to the hits of the host-sliced zip, bit for bit."""
    if counts == "device":
        monkeypatch.setattr(engine, "_HOST_COUNTS_MACS", 0)
    rng = np.random.default_rng(len1 * 5 + len2 + int(thres * 10))
    v1, v2 = 200, 230
    g1, g2, _, c1, c2 = _block(rng, v1, v2, len1, len2)
    n = min(len1, len2)
    longer = g1 if len1 > len2 else g2
    assert longer[:, n:].any()  # alt alleles past the zip
    width = -(-max(len1, len2) // 16) * 16 + 16
    pad1, pad2 = (np.zeros((g.shape[0], width), np.int8) for g in (g1, g2))
    pad1[:, :len1] = g1
    pad2[:, :len2] = g2
    r0, c0 = 300, 7
    pos1 = np.sort(rng.integers(20_000, 30_000, v1))
    pos2 = np.sort(rng.integers(15_000, 25_000, v2))
    for max_dist in (None, 3000):
        rows, cols, c_ab = engine.rect_candidates_async(
            *_tensors(pad1, pad2, c1, c2), n, len1, len2,
            thres - KEEP_MARGIN, 0 if measure == "r_square" else 1,
            pos1=pos1, pos2=pos2, max_dist=max_dist)()
        _assert_old_hits(rows, cols, c_ab, g1, g2, c1, c2, len1, len2, r0,
                         c0, pos1, pos2, measure, thres, max_dist)


def test_no_candidate_is_no_hit():
    empty = np.zeros(0, np.int64)
    hits = _exact_refilter_counts(empty, empty, empty, 10, empty, empty,
                                  "r_square", 0.8, len1=10, len2=20)
    for name in ("i", "j", "r_square", "d_prime", "r_square_is_int_zero",
                 "d_prime_is_int_zero"):
        assert getattr(hits, name).size == 0, name
    assert hits.i.dtype == np.int64 and hits.r_square_is_int_zero.dtype == bool
