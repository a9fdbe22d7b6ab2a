"""The port's count engine (ld_tools_tpu_torch/ops/engine.py) against the
JAX engine (ld_tools_tpu/ops/engine.py) on the CPU.

Every output here is an integer count or an f64 host finish, so the JAX
engine runs in this process and every array must be equal, dtypes
included: both sides of the host cutoff (f32 host BLAS below
``_HOST_COUNTS_MACS``, the device product above it), the int16 downcast
of the device counts and its int32 form past 32,767 haplotypes, the
refusal of unequal haplotype axes, ``ResidentCounts`` and its misaligned
tail, the all-pairs and mixed-ploidy paths, and two tool threads issuing
counts at once.  Mirrors the engine cases of tests/test_ld_math.py.
"""

import threading

import numpy as np
import pytest
import torch

from ld_tools_tpu.ops import engine as je
from ld_tools_tpu_torch.ops import engine as te

from .conftest import random_haplotypes


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)


def _assert_same_exact(got, want, names=("r_square", "d_prime", "p1", "p2",
                                         "r_square_is_int_zero",
                                         "d_prime_is_int_zero")):
    for name in names:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("va,vb,h", [
    (5, 7, 130),        # below the cutoff: host f32 BLAS, int32 counts
    (1, 1, 5008),       # one ld_lite pair: host
    (300, 260, 1000),   # above: the device product, int16 counts
    (130, 129, 4001),   # above, ragged rows and haplotypes
])
def test_pair_counts_match_jax(rng, va, vb, h):
    a = random_haplotypes(rng, va, h)
    b = random_haplotypes(rng, vb, h)
    a[0] = 0
    b[-1] = 1
    host = va * vb * h < te._HOST_COUNTS_MACS
    got = te.pair_counts(a, b, device="cpu")
    want = je.pair_counts(a, b)
    _assert_same(got, want)
    assert got[0].dtype == (np.int32 if host else np.int16)
    np.testing.assert_array_equal(
        got[0], a.astype(np.int64) @ b.T.astype(np.int64))


def test_device_counts_past_int16_stay_int32(rng):
    """At 32,768 haplotypes and more the counts may pass int16: the
    device path keeps int32, as JAX's _downcast_counts does."""
    h = 32_800
    a = random_haplotypes(rng, 48, h, maf_low=0.9, maf_high=1.0)
    b = random_haplotypes(rng, 48, h, maf_low=0.9, maf_high=1.0)
    a[0] = 1
    b[0] = 1
    assert 48 * 48 * h >= te._HOST_COUNTS_MACS
    got = te.pair_counts(a, b, device="cpu")
    _assert_same(got, je.pair_counts(a, b))
    assert got[0].dtype == np.int32 and int(got[0].max()) > 32767


def test_downcast_rule_is_jax_rule():
    c = torch.arange(6, dtype=torch.int32)
    for hap_axis, dt in ((512, torch.int16), (32767, torch.int16),
                         (32768, torch.int32)):
        assert te._downcast_counts(c, hap_axis).dtype == dt
        assert str(np.asarray(je._downcast_counts(
            np.arange(6, dtype=np.int32), hap_axis)).dtype) == \
            str(dt).replace("torch.", "")
    assert te._HOST_COUNTS_MACS == je._HOST_COUNTS_MACS


@pytest.mark.parametrize("small", [True, False])
def test_unequal_haplotype_axes_raise(small):
    n = 4 if small else 400
    a = np.zeros((n, 64), dtype=np.int8)
    b = np.zeros((n, 65), dtype=np.int8)
    for fn in (je.pair_counts_async,
               lambda x, y: te.pair_counts_async(x, y, device="cpu")):
        with pytest.raises(ValueError, match="haplotype axes differ"):
            fn(a, b)


def test_cuda_without_a_card_raises_above_the_cutoff(monkeypatch, rng):
    """Work above the cutoff asked for the card raises without one;
    work below it runs on the host in both packages (the reference's
    rule), so one ld_lite pair never needs the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = random_haplotypes(rng, 300, 1000)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        te.pair_counts_async(a, a)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        te.ResidentCounts(a, block_pad=128)
    te.reset_launches()
    _assert_same(te.pair_counts(a[:2], a[:3]), je.pair_counts(a[:2], a[:3]))
    assert te.count_on_device.launches == 0


def test_exact_pair_ld_matches_jax(rng):
    a = random_haplotypes(rng, 130, 600, maf_low=0.0, maf_high=1.0)
    b = random_haplotypes(rng, 150, 600, maf_low=0.0, maf_high=1.0)
    a[3] = 0
    _assert_same_exact(te.exact_pair_ld(a, b, device="cpu"),
                       je.exact_pair_ld(a, b))
    _assert_same_exact(te.exact_pair_ld(a, b, 599, device="cpu"),
                       je.exact_pair_ld(a, b, 599))


@pytest.mark.parametrize("block", [4096, 32])
def test_exact_all_pairs_matches_jax(rng, block):
    """The single-call path and the resident, two-slot blocked path,
    mirrored upper half included (test_ld_math.py:156, :336)."""
    G = random_haplotypes(rng, 70, 48, maf_low=0.1, maf_high=0.9)
    G[9] = 0
    got = te.exact_all_pairs(G, block=block, device="cpu")
    _assert_same_exact(got, je.exact_all_pairs(G, block=block))
    if block != 4096:
        _assert_same_exact(got, te.exact_all_pairs(G, device="cpu"))


def test_resident_counts_match_jax(rng):
    """Upload-once block counts equal JAX's and pair_counts on the same
    slices (test_ld_math.py:233)."""
    G = random_haplotypes(rng, 300, 130, maf_low=0.0, maf_high=1.0)
    res = te.ResidentCounts(G, block_pad=128, device="cpu")
    jres = je.ResidentCounts(G, block_pad=128)
    np.testing.assert_array_equal(res.row_counts, jres.row_counts)
    for r0, r1 in ((0, 128), (128, 256), (256, 300)):
        got = res.block_async(r0, r1, r1)()
        _assert_same(got, jres.block_async(r0, r1, r1)())
        ref_ab, ref1, ref2 = te.pair_counts(G[r0:r1], G[:r1], device="cpu")
        np.testing.assert_array_equal(got[0].astype(np.int64),
                                      ref_ab.astype(np.int64))
        np.testing.assert_array_equal(got[1], ref1)


def test_resident_counts_misaligned_tail_raises(rng):
    """(test_ld_math.py:355) A start whose padded block leaves the matrix
    raises in both engines instead of counting other rows."""
    G = (rng.random((300, 32)) < 0.4).astype(np.int8)
    for rc in (te.ResidentCounts(G, block_pad=128, device="cpu"),
               je.ResidentCounts(G, block_pad=128)):
        rc.block_async(256, 300, 300)()  # aligned tail: fine
        with pytest.raises(ValueError, match="aligned"):
            rc.block_async(257, 300, 300)
        with pytest.raises(ValueError, match="exceeds"):
            rc.block_async(0, 128, 400)


def test_two_threads_issue_counts_at_once(rng):
    """tools/common.map_files runs files on threads: two threads issuing
    and finalizing async counts at once get their own results (no shared
    stream, event or buffer), under a short switch interval."""
    import sys

    jobs = []
    for k in range(6):
        a = random_haplotypes(rng, 200 + 10 * k, 700)
        b = random_haplotypes(rng, 190, 700)
        jobs.append((a, b, je.pair_counts(a, b)))
    results = [[None] * len(jobs) for _ in range(2)]
    errors = []

    def worker(t):
        try:
            fins = [te.pair_counts_async(a, b, device="cpu")
                    for a, b, _ in jobs]
            for k, fin in enumerate(fins):
                results[t][k] = fin()
        except Exception as exc:  # re-raised in the main thread
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    for t in range(2):
        for got, (_, _, want) in zip(results[t], jobs):
            _assert_same(got, want)


@pytest.fixture(scope="module")
def chrx(tmp_path_factory):
    """A chrX-like store (males haploid outside the PAR bands), as
    tests/test_ploidy_e2e.py builds it."""
    from ld_tools_tpu.ingest import prep_intgen_data, synth

    d = str(tmp_path_factory.mktemp("intgen_x"))
    rng = np.random.default_rng(77)
    panel = synth.make_panel(24, rng)
    panel[0] = (panel[0][0], panel[0][1], panel[0][2], "male")
    panel[1] = (panel[1][0], panel[1][1], panel[1][2], "female")
    synth.write_panel(f"{d}/samples.txt", panel)
    names = [r[0] for r in panel]
    genders = [r[3] for r in panel]
    GX, hapX = synth.make_chrx_layout(rng, 36, genders,
                                      par_bounds=(0.25, 0.75))
    synth.write_vcf(f"{d}/X.vcf.gz", "X", names, GX, haploid_masks=hapX)
    prep_intgen_data(d)
    return d


def test_mixed_pair_ld_matches_jax(chrx):
    """PAR and non-PAR rows on both sides: the per-group count jobs,
    their zip truncation and the pair-dependent frequencies equal JAX's."""
    from ld_tools_tpu.tools.common import DataConfig as JaxData
    from ld_tools_tpu_torch.tools.common import DataConfig

    rows1 = [0, 3, 12, 18, 30, 35]
    rows2 = list(range(36))
    got, want = [], []
    for cfg, eng, out in ((DataConfig, te, got), (JaxData, je, want)):
        data = cfg.resolve(chrx, True, "both", "all")
        cd = data.store().chrom("X")
        cp = cd.cohort_ploidy(data.sample_names)
        kw = {"device": "cpu"} if eng is te else {}
        out.append(eng.mixed_pair_ld(cd, cp, rows1, rows2, **kw))
        out.append(eng.mixed_pair_ld_async(cd, cp, rows2[::-1], rows1,
                                           **kw)())
    for g, w in zip(got, want):
        _assert_same_exact(g, w)
        np.testing.assert_array_equal(g.own_freq1, w.own_freq1)
        np.testing.assert_array_equal(g.own_freq2, w.own_freq2)
        assert g.pair(1, 4) == w.pair(1, 4)
        assert list(g.r_square_rounded().ravel()) == \
            list(w.r_square_rounded().ravel())
    assert got[0].p2.ndim == 2 and np.unique(got[0].p2[0]).size > 1
