"""The port's streamed scan (plain versions on the CPU) against
ld_tools_tpu.ops.ld_stream.stream_threshold_scan.

The JAX scan runs both ways its own tests run it: the XLA tile path
(use_pallas=False) and the Pallas count and band kernels in interpret
mode.  Hit sets, f64 values and int-zero masks must be identical.  The
f32 values of a fast (exact=False) scan are held to 1e-6 abs against the
JAX scan run without FMA, as in test_torch_ld_kernels.
"""

import numpy as np
import pytest
import torch

from ld_tools_tpu.ops import ld_stream as jls
from ld_tools_tpu_torch.ops import ld_kernels as tk
from ld_tools_tpu_torch.ops import ld_stream as tls

from .conftest import random_haplotypes
from .test_torch_ld_kernels import assert_f32_close, jax_without_fma

JAX_ENGINES = {
    "xla": dict(use_pallas=False, band=16, chunk=16),
    "pallas": dict(use_pallas=True, interpret=True, band=16, chunk=16,
                   count_block=8),
}


def _data(rng, v=58, h=90):
    """Correlated runs of rows (so thresholds keep pairs), monomorphic and
    near-monomorphic rows, ragged V, ascending positions."""
    G = random_haplotypes(rng, v, h, maf_low=0.05, maf_high=0.95)
    for k in range(1, v):
        if k % 5:
            flip = rng.random(h) < 0.04
            G[k] = np.where(flip, 1 - G[k - 1], G[k - 1])
    G[7] = 0
    G[13] = 1
    G[21] = 0
    G[21, 3] = 1
    pos = np.sort(rng.choice(200_000, size=v, replace=False)).astype(np.int64)
    return G, pos


def _assert_same_hits(got, want):
    np.testing.assert_array_equal(got.i, want.i)
    np.testing.assert_array_equal(got.j, want.j)
    assert got.exact == want.exact
    if want.exact:
        for name in ("r_square", "d_prime", "r_square_is_int_zero",
                     "d_prime_is_int_zero"):
            a, b = getattr(got, name), getattr(want, name)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    else:
        for name in ("r_square", "d_prime"):
            assert_f32_close(getattr(got, name), getattr(want, name))
    assert len(want.i) > 0


MEASURES = ["r_square", "d_prime"]
MAX_DISTS = [None, 30_000]


def _compare_data():
    return _data(np.random.default_rng(58))


def _scan_kw(measure, max_dist, exact):
    return dict(pos=_compare_data()[1], measure=measure, thres=0.6,
                max_dist=max_dist, exact=exact)


@pytest.fixture(scope="module")
def jax_fast_scans():
    """The JAX fast (exact=False) scans of test_scan_matches_jax, keyed
    by (engine, measure, max_dist), from one child process without FMA."""
    G = _compare_data()[0]
    calls = {
        (engine, measure, max_dist): (
            "ld_tools_tpu.ops.ld_stream", "stream_threshold_scan", (G,),
            dict(**_scan_kw(measure, max_dist, False), **JAX_ENGINES[engine]))
        for engine in JAX_ENGINES for measure in MEASURES
        for max_dist in MAX_DISTS
    }
    return dict(zip(calls, jax_without_fma(list(calls.values()))))


@pytest.mark.parametrize("engine", sorted(JAX_ENGINES))
@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("max_dist", MAX_DISTS)
@pytest.mark.parametrize("exact", [True, False])
def test_scan_matches_jax(request, engine, measure, max_dist, exact):
    G = _compare_data()[0]
    kw = _scan_kw(measure, max_dist, exact)
    if exact:
        want = jls.stream_threshold_scan(G, **kw, **JAX_ENGINES[engine])
    else:
        fast = request.getfixturevalue("jax_fast_scans")
        want = fast[engine, measure, max_dist]
    got = tls.stream_threshold_scan(G, device="cpu", count_block=16, **kw)
    _assert_same_hits(got, want)


@pytest.mark.parametrize("measure", ["r_square", "d_prime"])
@pytest.mark.parametrize("max_dist", [None, 30_000])
def test_packed_scan_matches_jax(rng, measure, max_dist):
    G, pos = _data(rng)
    gp = np.packbits(G.astype(np.uint8), axis=1)
    kw = dict(pos=pos, measure=measure, thres=0.6, max_dist=max_dist,
              exact=True)
    want = jls.stream_threshold_scan(
        G_packed=gp, n_haplotypes=G.shape[1], **kw, **JAX_ENGINES["pallas"])
    got = tls.stream_threshold_scan(
        G_packed=gp, n_haplotypes=G.shape[1], device="cpu", **kw)
    _assert_same_hits(got, want)


@pytest.mark.parametrize("engine", sorted(JAX_ENGINES))
@pytest.mark.parametrize("measure", ["r_square", "d_prime"])
def test_f32_fallback_mask_matches_jax(rng, monkeypatch, engine, measure):
    """Cohorts past the int32-exact bound take the f32 measure as the
    mask; forced here in both packages by lowering the bound."""
    monkeypatch.setattr(jls, "_EXACT_MASK_MAX_HAP", 8)
    monkeypatch.setattr(tls, "_EXACT_MASK_MAX_HAP", 8)
    G, pos = _data(rng)
    kw = dict(pos=pos, measure=measure, thres=0.5, exact=True)
    want = jls.stream_threshold_scan(G, **kw, **JAX_ENGINES[engine])
    got = tls.stream_threshold_scan(G, device="cpu", count_block=8, **kw)
    _assert_same_hits(got, want)


@pytest.mark.parametrize("packed", [False, True])
def test_prepare_resident_matches_jax_layout(rng, packed):
    """The port's device tensors equal the JAX scan's resident arrays
    (read back from its resident cache): padding, the 0 reciprocal of
    monomorphic and padding rows, the -2^30 position sentinel."""
    G, pos = _data(rng, v=300, h=77)
    h = G.shape[1]
    src = np.packbits(G.astype(np.uint8), axis=1) if packed else G
    jls.clear_resident_cache()
    try:
        inp = dict(G_packed=src, n_haplotypes=h) if packed else dict(G=src)
        jls.stream_threshold_scan(pos=pos, thres=0.9, resident_key="k",
                                  **inp)
        (entry,) = jls._RESIDENT_CACHE.values()
    finally:
        jls.clear_resident_cache()
    g_j, c1_j, ipq_j, pos_j, packed_j, c1_full_j = entry
    assert not packed_j  # the JAX scan inflated the bytes on device too
    res = tls.prepare_resident(src, h, pos, "cpu", packed=packed)
    for got, want in ((res.g, g_j), (res.c1, c1_j), (res.ipq, ipq_j),
                      (res.pos, pos_j)):
        want = np.asarray(want)
        assert got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(res.c1_full, c1_full_j)
    assert res.g.shape[0] > G.shape[0] and (res.pos[G.shape[0]:] == -(2**30)).all()
    assert (res.ipq[7] == 0) and (res.ipq[13] == 0) and (res.ipq[G.shape[0]:] == 0).all()


def test_resident_cache_hit_skips_the_upload(rng):
    G, pos = _data(rng)
    tls.clear_resident_cache()
    try:
        kw = dict(pos=pos, thres=0.6, device="cpu", resident_key="chr-test")
        a = tls.stream_threshold_scan(G, **kw)
        b = tls.stream_threshold_scan(G, **kw)
    finally:
        tls.clear_resident_cache()
    assert a.stats["resident_hit"] == 0.0 and b.stats["resident_hit"] == 1.0
    np.testing.assert_array_equal(a.i, b.i)
    np.testing.assert_array_equal(a.r_square, b.r_square)


@pytest.mark.parametrize("count_block", [8, 16, 64])
def test_hits_do_not_depend_on_the_tiling(rng, count_block):
    G, pos = _data(rng)
    ref = tls.stream_threshold_scan(G, pos=pos, thres=0.6, device="cpu")
    got = tls.stream_threshold_scan(G, pos=pos, thres=0.6, device="cpu",
                                    count_block=count_block)
    np.testing.assert_array_equal(got.i, ref.i)
    np.testing.assert_array_equal(got.j, ref.j)
    np.testing.assert_array_equal(got.r_square, ref.r_square)
    assert got.stats["device_hits"] >= len(got.i)


def test_pass_two_must_agree_with_pass_one(rng, monkeypatch):
    """A block whose pass-2 hits differ from its pass-1 count stops the
    scan instead of splitting hits wrongly."""
    G, pos = _data(rng)
    real = tk.ld_band_count

    def off_by_one(*a, **k):
        out = real(*a, **k)
        out[int(torch.argmax(out))] += 1
        return out

    monkeypatch.setattr(tls, "ld_band_count", off_by_one)
    with pytest.raises(RuntimeError, match="disagree with pass-1"):
        tls.stream_threshold_scan(G, pos=pos, thres=0.6, device="cpu")


def test_scan_validates_like_jax(rng):
    G, pos = _data(rng)
    with pytest.raises(ValueError, match="ascending"):
        tls.stream_threshold_scan(G, pos=pos[::-1].copy(), thres=0.6,
                                  max_dist=10, device="cpu")
    with pytest.raises(ValueError, match="pos length"):
        tls.stream_threshold_scan(G, pos=pos[:-1], thres=0.6, max_dist=10,
                                  device="cpu")
    with pytest.raises(ValueError, match="measure"):
        tls.stream_threshold_scan(G, pos=pos, thres=0.6, measure="r",
                                  device="cpu")
    empty = tls.stream_threshold_scan(G[:0], thres=0.6, device="cpu")
    assert empty.i.size == 0 and empty.exact
