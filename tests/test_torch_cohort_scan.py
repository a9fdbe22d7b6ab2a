"""The port's ld_scan over a population subset (``-e EUR``, ``-e EUR -g
female``) on the CPU (-E torch): the cohort's bit columns gathered from
the store's rows as they are uploaded (``gather_rows_device``'s plain
version; stats ``cohort_repack_s``), into the int8 or the packed resident
layout, then scanned.

Each TSV is held byte for byte against the JAX tool's on the same store,
and against a plain float64 recount of r^2 and D' for every pair of the
cohort's genotype lists, written here.  The store's 60 samples give EUR 15
(30 haplotypes, not a multiple of 8: the packed rows end in a partial
byte).  The stats name the cohort and the layout."""

import os
import types

import numpy as np
import pytest

from ld_tools_tpu.ingest import prep_intgen_data, synth
from ld_tools_tpu.tools import scan as jax_scan
from ld_tools_tpu_torch import ld_scan as torch_ld_scan
from ld_tools_tpu_torch.ingest import pack
from ld_tools_tpu_torch.ingest.store import HaplotypeStore

CHROMS = {"5": 90, "11": 40}
N_SAMPLES = 60
LIMIT = "TPU_LD_DENSE_RESIDENT_BYTES"
COHORTS = [("EUR", "both"), ("EUR", "female"), ("EAS,AMR", "male")]


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("intgen"))
    synth.generate_dataset(d, n_samples=N_SAMPLES,
                           chrom_variant_counts=CHROMS, seed=17)
    prep_intgen_data(d)
    return d


def _samples(store, pops, gend):
    """Indices into the store's samples of the cohort, from samples.txt
    (name, population, super-population, gender), in store order."""
    rows = [ln.split() for ln in open(os.path.join(store, "samples.txt"))
            if ln.strip()]
    gends = {"both": ("male", "female")}.get(gend, (gend,))
    want = set(pops.split(","))
    keep = {r[0] for r in rows if (r[1] in want or r[2] in want)
            and r[3] in gends}
    names = HaplotypeStore(store).chrom("5").samples
    return np.asarray([k for k, n in enumerate(names) if n in keep])


def _scan(store, trg, pops, gend, measure="r_square", thres=0.5,
          max_dist=None):
    argv = ["-C", "all", "-D", store, "-t", trg, "-f", "-E", "torch",
            "-l", measure, "-z", str(thres), "-e", pops, "-g", gend]
    if max_dist is not None:
        argv += ["-w", str(max_dist)]
    return {r.chrom: r for r in torch_ld_scan.main(argv)}


def _tsv(trg, chrom, measure="r_square", thres=0.5):
    with open(os.path.join(trg, f"ld_scan_chr{chrom}_{measure[0]}_"
                                f"{thres}.tsv"), "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("pops,gend", COHORTS)
@pytest.mark.parametrize("layout", ["int8", "packed"])
@pytest.mark.parametrize("measure,thres,max_dist",
                         [("r_square", 0.5, None), ("d_prime", 0.8, 12_000)])
def test_cohort_tsv_is_byte_identical_to_jax(store, tmp_path, monkeypatch,
                                             pops, gend, layout, measure,
                                             thres, max_dist):
    if layout == "packed":
        monkeypatch.setenv(LIMIT, "0")
    want_dir, got_dir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jax_scan.run(types.SimpleNamespace(
        chroms="all", trg_dir_path=want_dir, intgen_dir_path=store,
        skip_intgen_data_ver=True, gend_names=gend, pop_names=pops,
        ld_measure=measure, ld_low_thres=thres, max_dist=max_dist,
        checkpoint_dir=None, devices=None, engine="xla"))
    reports = _scan(store, got_dir, pops, gend, measure, thres, max_dist)
    assert sorted(reports) == sorted(CHROMS)
    for chrom in CHROMS:
        got = _tsv(got_dir, chrom, measure, thres)
        assert got == _tsv(want_dir, chrom, measure, thres), chrom
    assert sum(r.n_hits for r in reports.values()) > 0
    dense = float(layout == "int8")
    for r in reports.values():
        assert r.stats["resident_dense"] == dense
        assert r.stats["resident_packed"] == 1.0 - dense


def _recount(bits, thres, measure):
    """{(i, j): (r2 string, D' string)} of every pair i > j whose rounded
    measure reaches ``thres``: counts as integers, the finish in Python
    floats (float64) one operation at a time, as the reference tool's
    calc_ld, and each value written as ``str(round(v, 4))``."""
    g = bits.astype(np.int64)
    c_ab = g @ g.T
    c = g.sum(axis=1).tolist()
    n = g.shape[1]
    out = {}
    for i in range(g.shape[0]):
        for j in range(i):
            p_ab = int(c_ab[i, j]) / n
            p_a, q_a = c[i] / n, (n - c[i]) / n
            p_b, q_b = c[j] / n, (n - c[j]) / n
            d = p_ab - p_a * p_b
            den = (min(p_a * q_b, q_a * p_b) if d >= 0
                   else max(-p_a * p_b, -q_a * q_b))
            dp = 0 if den == 0 else d / den
            r2 = 0 if dp == 0 else (d ** 2) / (p_a * q_a * p_b * q_b)
            if round(r2 if measure == "r_square" else dp, 4) >= thres:
                out[(i, j)] = (str(round(r2, 4)), str(round(dp, 4)))
    return out


@pytest.mark.parametrize("pops,gend", COHORTS)
@pytest.mark.parametrize("measure,thres", [("r_square", 0.5),
                                           ("d_prime", 0.8)])
def test_cohort_tsv_equals_a_float64_recount(store, tmp_path, pops, gend,
                                             measure, thres):
    trg = str(tmp_path / "torch")
    _scan(store, trg, pops, gend, measure, thres)
    samples = _samples(store, pops, gend)
    cols = np.stack([2 * samples, 2 * samples + 1], axis=1).ravel()
    st = HaplotypeStore(store)
    n_hits = 0
    for chrom in CHROMS:
        cd = st.chrom(chrom)
        bits = np.unpackbits(np.asarray(cd.packed), axis=1,
                             count=cd.n_haplotypes)[:, cols]
        want = _recount(bits, thres, measure)
        pos, rsid = np.asarray(cd.pos), np.asarray(cd.rsid)
        lines = _tsv(trg, chrom, measure, thres).decode().splitlines()[2:]
        got = {}
        for ln in lines:
            pa, ra, pb, rb, dist, r2, dp = ln.split("\t")
            i = int(np.searchsorted(pos, int(pa)))
            j = int(np.searchsorted(pos, int(pb)))
            assert (rsid[i], rsid[j]) == (ra, rb)
            assert int(dist) == int(pa) - int(pb)
            got[(i, j)] = (r2, dp)
        assert got == want, chrom
        n_hits += len(want)
    assert n_hits > 0


@pytest.mark.parametrize("pops,gend", COHORTS)
def test_cohort_stats_name_the_repack(store, tmp_path, pops, gend):
    reports = _scan(store, str(tmp_path / "t"), pops, gend)
    n_hap = 2 * _samples(store, pops, gend).size
    if pops == "EUR" and gend == "both":
        assert n_hap == 30 and n_hap % 8  # a partial last byte
    for chrom, r in reports.items():
        s = r.stats
        assert s["resident_gather"] == 1.0
        assert 0 < s["cohort_repack_s"] <= s["upload_s"]
        assert s["cohort_haplotypes"] == n_hap
        assert s["repack_rows"] == CHROMS[chrom]
        assert s["resident_dense"] == 1.0  # far below the default limit


def test_the_full_cohort_is_read_zero_copy(store, tmp_path):
    reports = _scan(store, str(tmp_path / "t"), "all", "both")
    for r in reports.values():
        assert r.stats["cohort_repack_s"] == 0.0
        assert r.stats["resident_gather"] == 1.0
        assert r.stats["repack_rows"] == 0
        assert r.stats["cohort_haplotypes"] == 2 * N_SAMPLES
        assert r.stats["resident_dense"] == 1.0


# samples at the store's end that a super-population of their own sets
# apart: the other five select the first 57 samples, 114 haplotypes, a
# prefix of each row that stops inside its last byte
TAIL = 3
PREFIX = "AFR,AMR,EAS,EUR,SAS"


@pytest.fixture(scope="module")
def tail_store(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("intgen_tail"))
    synth.generate_dataset(d, n_samples=N_SAMPLES,
                           chrom_variant_counts=CHROMS, seed=23)
    path = os.path.join(d, "samples.txt")
    with open(path) as fh:
        lines = fh.read().splitlines()
    for k in range(len(lines) - TAIL, len(lines)):
        name, _, _, gend = lines[k].split("\t")
        lines[k] = "\t".join((name, "TLP", "TAIL", gend))
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    prep_intgen_data(d)
    return d


@pytest.mark.parametrize("layout", ["int8", "packed"])
def test_a_cohort_that_stops_inside_the_last_byte_is_byte_identical_to_jax(
        tail_store, tmp_path, monkeypatch, layout):
    """The cohort's columns are 0..113 of rows of 15 bytes: the same
    bytes as the full panel's, whose last 6 bits are the samples left out.
    The scan gathers the 114 columns (and counts them), as the JAX tool
    repacks them."""
    if layout == "packed":
        monkeypatch.setenv(LIMIT, "0")
    samples = _samples(tail_store, PREFIX, "both")
    np.testing.assert_array_equal(samples, np.arange(N_SAMPLES - TAIL))
    n_hap = 2 * samples.size
    assert -(-n_hap // 8) == -(-2 * N_SAMPLES // 8) and n_hap % 8
    want_dir, got_dir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jax_scan.run(types.SimpleNamespace(
        chroms="all", trg_dir_path=want_dir, intgen_dir_path=tail_store,
        skip_intgen_data_ver=True, gend_names="both", pop_names=PREFIX,
        ld_measure="r_square", ld_low_thres=0.5, max_dist=None,
        checkpoint_dir=None, devices=None, engine="xla"))
    reports = _scan(tail_store, got_dir, PREFIX, "both")
    for chrom, r in reports.items():
        assert _tsv(got_dir, chrom) == _tsv(want_dir, chrom), chrom
        s = r.stats
        assert s["cohort_haplotypes"] == n_hap
        assert s["repack_rows"] == CHROMS[chrom]
        assert s["resident_gather"] == 1.0
        assert s["resident_dense"] == float(layout == "int8")
    assert sum(r.n_hits for r in reports.values()) > 0


def test_the_repack_keeps_the_cohort_columns(store):
    """``pack.pack_columns`` over the EUR columns equals the columns
    gathered from the unpacked rows, the last byte's padding bits 0."""
    cd = HaplotypeStore(store).chrom("5")
    samples = _samples(store, "EUR", "both")
    cols = np.stack([2 * samples, 2 * samples + 1], axis=1).ravel()
    got = pack.pack_columns(np.asarray(cd.packed), cols, cd.n_haplotypes,
                            chunk_rows=16)
    full = np.unpackbits(np.asarray(cd.packed), axis=1,
                         count=cd.n_haplotypes)
    assert got.shape == (CHROMS["5"], -(-cols.size // 8))
    assert np.array_equal(np.unpackbits(got, axis=1, count=cols.size),
                          full[:, cols])
    assert not np.unpackbits(got, axis=1)[:, cols.size:].any()
