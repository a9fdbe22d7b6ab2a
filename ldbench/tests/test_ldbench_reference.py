"""The plain reference against a brute-force NumPy count of every pair on
tiny stores (one ploidy, and a PAR1 bound with haploid males past it), the
rounding and formatting against Python's own, and the float32 control
against the float64 reference."""

import numpy as np
import pytest
import torch

from ldbench import data, reference


def _ds(par1_end=None, seed=5, v=512, run=8, n_samples=40):
    config = dict(chrom="X" if par1_end else "21", n_samples=n_samples,
                  n_variants=v,
                  first_pos=1, span_bp=v * 50, ld_run_rows=run, flip=0.02,
                  freq=[0.05, 0.95], par1_end=par1_end,
                  straddle_rows=8 if par1_end else 0)
    return config, data.make_dataset(config, seed, "cpu")


def _lists(ds):
    """Each row's genotype list (all samples), as the reference tool
    appends them: hapA, then hapB where the cell is diploid."""
    bits = np.unpackbits(ds.gp, axis=1, count=ds.n_hap)
    out = []
    for r in range(ds.n_variants):
        p = 0 if ds.pgroup is None else int(ds.pgroup[r])
        keep = [c for s in range(len(ds.panel)) for c in (2 * s, 2 * s + 1)
                if c % 2 == 0 or ds.profiles is None or ds.profiles[p, s] == 2]
        out.append(bits[r, keep].astype(np.int64))
    return out


def _brute(ds, thres, max_dist):
    """Every pair i > j, counted with NumPy, finished in Python floats."""
    lists = _lists(ds)
    hits = []
    for i in range(ds.n_variants):
        for j in range(i):
            if max_dist is not None and ds.pos[i] - ds.pos[j] > max_dist:
                continue
            a, b = lists[i], lists[j]
            n = min(a.size, b.size)
            p_ab = int(a[:n] @ b[:n]) / n
            p_a, q_a = int(a.sum()) / n, int((a == 0).sum()) / n
            p_b, q_b = int(b.sum()) / n, int((b == 0).sum()) / n
            d = p_ab - p_a * p_b
            den = (min(p_a * q_b, q_a * p_b) if d >= 0
                   else max(-p_a * p_b, -q_a * q_b))
            dp = 0 if den == 0 else d / den
            r2 = 0 if dp == 0 else (d ** 2) / (p_a * q_a * p_b * q_b)
            if round(r2, 4) >= thres:
                hits.append((i, j, str(round(r2, 4)), str(round(dp, 4))))
    return hits


@pytest.mark.parametrize("par1_end,max_dist", [(None, None), (None, 4000),
                                               (12_800, 6000)])
def test_scan_reference_equals_a_brute_force_count(par1_end, max_dist):
    config, ds = _ds(par1_end)
    band = 2 * config["ld_run_rows"] - 1 + config["straddle_rows"]
    prm = reference.ScanParams(measure="r_square", thres=0.8,
                               max_dist=max_dist, band=band, n_far=500)
    hits, looked = reference.scan_hits(ds, reference.Lists(ds, "cpu"), prm,
                                       seed=3)
    got = list(zip(hits.i.tolist(), hits.j.tolist(), hits.r2, hits.dp))
    want = _brute(ds, 0.8, max_dist)
    assert len(want) > 100
    assert got == want
    assert looked  # the sampled far pairs
    if par1_end:  # pairs across the bound are among the hits
        lo = int(np.searchsorted(ds.pos, par1_end, side="right"))
        assert any(i >= lo > j for i, j, _, _ in want)


def test_area_reference_equals_a_brute_force_count():
    _, ds = _ds()
    lists = _lists(ds)
    prm = reference.AreaParams(measure="r_square", thres=0.8, flank=2000)
    queries = [3, 100, 257, 511]
    files = reference.area_files(ds, reference.Lists(ds, "cpu"), queries, prm,
                                 ('"male","female"', '"ALL"'))
    n_hits = 0
    for q in queries:
        lo, hi = ds.pos[q] - prm.flank, ds.pos[q] + prm.flank
        want = []
        for o in range(ds.n_variants):
            if o == q or not lo < ds.pos[o] <= hi:
                continue
            a, b = lists[q], lists[o]
            n = a.size
            p_ab, p_a, p_b = int(a @ b) / n, int(a.sum()) / n, int(b.sum()) / n
            q_a, q_b = int((a == 0).sum()) / n, int((b == 0).sum()) / n
            d = p_ab - p_a * p_b
            den = (min(p_a * q_b, q_a * p_b) if d >= 0
                   else max(-p_a * p_b, -q_a * q_b))
            dp = 0 if den == 0 else d / den
            r2 = 0 if dp == 0 else (d ** 2) / (p_a * q_a * p_b * q_b)
            if round(r2, 4) >= 0.8:
                want.append(f"{ds.pos[o]}\trs{100_000 + o}\tA\tG\tSNP\t"
                            f"{round(p_b, 4)}\t{round(r2, 4)}\t{round(dp, 4)}"
                            f"\t{ds.pos[o] - ds.pos[q]}")
        text = files[f"rs{100_000 + q}"]
        if not want:
            assert text is None
            continue
        lines = text.splitlines()
        assert lines[0] == ('##chr="21" gends="male","female" pops="ALL" '
                            'each_flank=2000 r_square_thres=0.8')
        assert lines[2].startswith(f"{ds.pos[q]}\trs{100_000 + q}\t")
        assert lines[3:] == want
        n_hits += len(want)
    assert n_hits > 0


def test_rounding_and_strings_are_pythons():
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.uniform(-1, 3, 20_000),
                        np.arange(-10_000, 10_001) / 1e4 + 0.5e-4,
                        [0.00005, -0.00001, 0.0, 1.0, 0.99995, 2.00015]])
    iz = np.zeros(x.size, bool)
    iz[::97] = True
    want = ["0" if z else str(round(float(v), 4)) for v, z in zip(x, iz)]
    assert reference.fmt4(x, iz) == want
    assert reference.fmt4(torch.from_numpy(x), torch.from_numpy(iz)) == want
    assert [reference.thres_k(t) for t in (0.8, 0.85, 0.1, 1.0)] == \
        [8000, 8500, 1000, 10_000]


def test_the_float32_finish_differs_from_the_float64_one():
    _, ds = _ds(v=2048, n_samples=1000)
    prm = reference.ScanParams(measure="r_square", thres=0.8, max_dist=None,
                               band=15, n_far=0)
    lists = reference.Lists(ds, "cpu")
    h64, _ = reference.scan_hits(ds, lists, prm, seed=1)
    h32, _ = reference.scan_hits(ds, lists, prm, seed=1, dtype=torch.float32)
    a = set(reference.scan_body(ds, h64).splitlines())
    b = set(reference.scan_body(ds, h32).splitlines())
    assert len(a ^ b) > 0
