"""The port's scan over the packed resident layout (the store's bytes kept
packed on the device; kernels K6 and K4) against the JAX scan, on the CPU.

The JAX scan runs its packed layout both ways its own tests run it (the
XLA tile path and the Pallas kernels in interpret mode).  Hit sets, f64
values and int-zero masks must be identical, the resident tensors equal
to the JAX resident cache entry, and the ``auto`` layout rule
($TPU_LD_DENSE_RESIDENT_BYTES) must choose as the JAX scan chooses.
"""

import numpy as np
import pytest

from ld_tools_tpu.ingest import prep_intgen_data, synth
from ld_tools_tpu.ops import ld_stream as jls
from ld_tools_tpu.tools import scan as jax_scan
from ld_tools_tpu_torch import ld_scan as torch_ld_scan
from ld_tools_tpu_torch.ops import ld_stream as tls

from .test_torch_scan import JAX_ENGINES, _assert_same_hits, _data
from .test_torch_scan_cli import _jax_args, _read_all

LIMIT = "TPU_LD_DENSE_RESIDENT_BYTES"


def _packed_data(seed, v=58, h=77):
    G, pos = _data(np.random.default_rng(seed), v=v, h=h)
    return G, np.packbits(G.astype(np.uint8), axis=1), pos


def _jax_resident_entry(**kw):
    """The JAX scan's resident cache entry (g, c1, ipq, pos, packed,
    c1_full) after one scan with ``kw``."""
    jls.clear_resident_cache()
    try:
        jls.stream_threshold_scan(thres=0.9, resident_key="k", **kw)
        (entry,) = jls._RESIDENT_CACHE.values()
    finally:
        jls.clear_resident_cache()
    return entry


@pytest.mark.parametrize("engine", sorted(JAX_ENGINES))
@pytest.mark.parametrize("measure", ["r_square", "d_prime"])
@pytest.mark.parametrize("max_dist", [None, 30_000])
def test_packed_resident_scan_matches_jax(engine, measure, max_dist):
    G, gp, pos = _packed_data(58)
    kw = dict(G_packed=gp, n_haplotypes=G.shape[1], pos=pos,
              measure=measure, thres=0.6, max_dist=max_dist, exact=True,
              resident="packed")
    want = jls.stream_threshold_scan(**kw, **JAX_ENGINES[engine])
    got = tls.stream_threshold_scan(**kw, device="cpu", count_block=16)
    _assert_same_hits(got, want)
    assert got.stats["resident_packed"] == 1.0
    assert got.stats["blocks_checked"] == got.stats["hit_blocks"] > 0
    # the layout moves no hit
    dense = tls.stream_threshold_scan(**dict(kw, resident="dense"),
                                      device="cpu", count_block=16)
    assert dense.stats["resident_packed"] == 0.0
    _assert_same_hits(got, dense)


def test_prepare_resident_packed_matches_jax_entry():
    """resident="packed": the uint8 bytes, their 128-byte padding, the
    per-row vectors and the packed flag of the JAX resident cache entry."""
    G, gp, pos = _packed_data(300, v=300)
    h = G.shape[1]
    g_j, c1_j, ipq_j, pos_j, packed_j, c1_full_j = _jax_resident_entry(
        G_packed=gp, n_haplotypes=h, pos=pos, resident="packed")
    assert packed_j
    res = tls.prepare_resident(gp, h, pos, "cpu", packed=True,
                               resident="packed")
    assert res.packed and res.h_bits == res.g.shape[1] * 8
    for got, want in ((res.g, g_j), (res.c1, c1_j), (res.ipq, ipq_j),
                      (res.pos, pos_j)):
        want = np.asarray(want)
        assert got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(res.c1_full, c1_full_j)
    assert res.g.shape[1] == 128 and not res.g[:, gp.shape[1]:].any()


@pytest.mark.parametrize("over", [0, 1])
def test_auto_rule_matches_jax(monkeypatch, over):
    """"auto" inflates while v_pad * w_bytes * 8 <= the limit, and keeps
    the bytes packed one byte past it, in both packages."""
    G, gp, pos = _packed_data(90, v=90)
    h = G.shape[1]
    v_pad, w = tls.prepare_resident(gp, h, pos, "cpu", packed=True,
                                    resident="packed").g.shape
    monkeypatch.setenv(LIMIT, str(v_pad * w * 8 - over))
    entry = _jax_resident_entry(G_packed=gp, n_haplotypes=h, pos=pos)
    res = tls.prepare_resident(gp, h, pos, "cpu", packed=True)
    assert res.packed == entry[4] == bool(over)
    np.testing.assert_array_equal(res.g.numpy(), np.asarray(entry[0]))
    got = tls.stream_threshold_scan(G_packed=gp, n_haplotypes=h, pos=pos,
                                    thres=0.6, device="cpu")
    assert got.stats["resident_packed"] == float(over)
    _assert_same_hits(got, jls.stream_threshold_scan(
        G_packed=gp, n_haplotypes=h, pos=pos, thres=0.6))


def test_limit_is_read_like_jax(monkeypatch):
    monkeypatch.delenv(LIMIT, raising=False)
    assert tls.dense_resident_limit() == 4 << 30
    monkeypatch.setenv(LIMIT, "123")
    assert tls.dense_resident_limit() == 123


def test_dense_input_and_dense_request_stay_dense(monkeypatch):
    monkeypatch.setenv(LIMIT, "0")
    G, gp, pos = _packed_data(40, v=40)
    assert not tls.prepare_resident(G, G.shape[1], pos, "cpu").packed
    assert not tls.prepare_resident(gp, G.shape[1], pos, "cpu", packed=True,
                                    resident="dense").packed
    assert tls.prepare_resident(gp, G.shape[1], pos, "cpu",
                                packed=True).packed


def test_resident_cache_key_holds_the_layout():
    """A dense entry is never served to a packed request, nor the other
    way round."""
    G, gp, pos = _packed_data(58)
    kw = dict(G_packed=gp, n_haplotypes=G.shape[1], pos=pos, thres=0.6,
              device="cpu", resident_key="chr-test")
    tls.clear_resident_cache()
    try:
        a = tls.stream_threshold_scan(**kw, resident="dense")
        b = tls.stream_threshold_scan(**kw, resident="packed")
        c = tls.stream_threshold_scan(**kw, resident="packed")
    finally:
        tls.clear_resident_cache()
    assert [x.stats["resident_hit"] for x in (a, b, c)] == [0.0, 0.0, 1.0]
    assert [x.stats["resident_packed"] for x in (a, b, c)] == [0.0, 1.0, 1.0]
    _assert_same_hits(b, a)
    _assert_same_hits(c, a)


CHROMS = {"5": 90, "11": 40}


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("intgen"))
    synth.generate_dataset(d, n_samples=30, chrom_variant_counts=CHROMS,
                           seed=11)
    prep_intgen_data(d)
    return d


@pytest.mark.parametrize("measure,thres", [("r_square", 0.5),
                                           ("d_prime", 0.8)])
@pytest.mark.parametrize("max_dist", [None, 12_000])
def test_packed_layout_tsv_is_byte_identical(store, tmp_path, monkeypatch,
                                             measure, thres, max_dist):
    """Under a limit of 0 bytes both tools keep the store's bytes packed
    on the device; the port's -E torch TSV equals the JAX tool's."""
    monkeypatch.setenv(LIMIT, "0")
    want_dir = str(tmp_path / "jax")
    got_dir = str(tmp_path / "torch")
    jax_scan.run(_jax_args(store, want_dir, measure, thres, max_dist,
                           "both"))
    argv = ["-C", "all", "-D", store, "-t", got_dir, "-f", "-E", "torch",
            "-l", measure, "-z", str(thres)]
    if max_dist is not None:
        argv += ["-w", str(max_dist)]
    reports = torch_ld_scan.main(argv)
    assert all(r.stats["resident_packed"] == 1.0 for r in reports)
    want, got = _read_all(want_dir), _read_all(got_dir)
    assert list(got) == list(want) and len(want) == len(CHROMS)
    for name in want:
        assert got[name] == want[name], name
    assert sum(r.n_hits for r in reports) > 0
