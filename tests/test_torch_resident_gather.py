"""The scan's resident gathered from the store's raw packed rows
(``prepare_resident(..., cols=...)``, ``gather_rows_device``'s plain
version on the CPU) against the resident of the rows repacked on the host
(``pack.pack_columns``), in the port and in the JAX scan.

Every field of ``Resident`` must be equal: the padded matrix in both
layouts, the per-row vectors and the host alt counts.  The column lists
are the full panel (the identity), a population subset of whole samples
(30 haplotypes, a partial last byte) and a chrX haploid profile (females'
two columns, males' one: an odd count), over row counts that the staging
chunk does not divide.
"""

import numpy as np
import pytest
import torch

from ld_tools_tpu.ops import ld_stream as jls
from ld_tools_tpu_torch.ingest import pack
from ld_tools_tpu_torch.ops import ld_kernels as lk
from ld_tools_tpu_torch.ops import ld_stream as tls

from .test_torch_scan import _assert_same_hits, _data

LIMIT = "TPU_LD_DENSE_RESIDENT_BYTES"
N_SAMPLES = 40


def _store(seed, v=50):
    """(raw packed rows of 80 haplotypes, positions)."""
    G, pos = _data(np.random.default_rng(seed), v=v, h=2 * N_SAMPLES)
    return np.packbits(G.astype(np.uint8), axis=1), pos


def _cols(kind):
    if kind == "identity":
        return np.arange(2 * N_SAMPLES)
    if kind == "subset":  # 15 samples, both haplotypes each
        samples = np.array([1, 2, 4, 5, 9, 11, 12, 17, 20, 23, 27, 30, 31,
                            35, 38])
        return np.stack([2 * samples, 2 * samples + 1], axis=1).ravel()
    # haploid profile: samples 0..20 diploid, 21..39 one column
    cols = []
    for s in range(N_SAMPLES):
        cols.append(2 * s)
        if s <= 20:
            cols.append(2 * s + 1)
    return np.asarray(cols)


def _jax_resident(gp, n_hap, pos):
    """(g, c1, ipq, pos, packed, c1_full) of the JAX scan's resident."""
    jls.clear_resident_cache()
    try:
        jls.stream_threshold_scan(G_packed=gp, n_haplotypes=n_hap, pos=pos,
                                  thres=0.9, resident_key="k")
        (entry,) = jls._RESIDENT_CACHE.values()
    finally:
        jls.clear_resident_cache()
    return entry


@pytest.mark.parametrize("kind", ["identity", "subset", "haploid"])
@pytest.mark.parametrize("layout", ["dense", "packed"])
def test_gathered_resident_equals_the_repacked_one(monkeypatch, kind,
                                                   layout):
    if layout == "packed":
        monkeypatch.setenv(LIMIT, "0")
    raw, pos = _store(11)
    cols = _cols(kind)
    n_hap = cols.size
    if kind == "haploid":
        assert n_hap % 2 and n_hap % 8
    repacked = pack.pack_columns(raw, cols, 2 * N_SAMPLES, chunk_rows=16)
    stats = {}
    monkeypatch.setattr(tls, "_STAGE_ROWS", 7)
    got = tls.prepare_resident(raw, n_hap, pos, "cpu", packed=True,
                               cols=cols, stats=stats)
    want = tls.prepare_resident(repacked, n_hap, pos, "cpu", packed=True)
    assert raw.shape[0] % 7
    assert got.packed == want.packed == (layout == "packed")
    for name in ("g", "c1", "ipq", "pos"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert got.c1_full.dtype == want.c1_full.dtype == np.int64
    np.testing.assert_array_equal(got.c1_full, want.c1_full)
    # and the JAX scan's resident of the host-repacked rows
    g_j, c1_j, ipq_j, pos_j, packed_j, c1_full_j = _jax_resident(
        repacked, n_hap, pos)
    assert got.packed == packed_j
    for a, b in ((got.g, g_j), (got.c1, c1_j), (got.ipq, ipq_j),
                 (got.pos, pos_j)):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(got.c1_full, c1_full_j)
    assert stats["resident_gather"] == 1.0
    assert stats["resident_dense"] == float(layout == "dense")
    assert stats["gather_rows_s"] > 0


@pytest.mark.parametrize("kind", ["identity", "subset", "haploid"])
@pytest.mark.parametrize("dense", [True, False])
def test_plain_gather_equals_numpy(kind, dense):
    """gather_rows_device_plain: the listed bits of each row, 0 past the
    list (over garbage in ``out``), and their counts."""
    raw, _ = _store(12, v=30)
    cols = _cols(kind)
    bits = np.unpackbits(raw, axis=1)[:, cols]
    width = 16 * -(-(cols.size if dense else -(-cols.size // 8)) // 16)
    out = torch.full((raw.shape[0], width), 7,
                     dtype=torch.int8 if dense else torch.uint8)
    counts = torch.full((raw.shape[0],), -1, dtype=torch.int32)
    lk.gather_rows_device(torch.from_numpy(raw),
                          torch.from_numpy(cols.astype(np.int32)), out,
                          counts)
    if dense:
        want = np.zeros((raw.shape[0], width), dtype=np.int8)
        want[:, :cols.size] = bits
    else:
        want = np.zeros((raw.shape[0], width), dtype=np.uint8)
        packed = np.packbits(bits, axis=1)
        want[:, :packed.shape[1]] = packed
    np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_array_equal(counts.numpy(), bits.sum(axis=1))
    assert lk.gather_rows_device.launches == 0  # no kernel on the CPU


@pytest.mark.parametrize("bad", ["column", "narrow", "dtype", "rows"])
def test_gather_refuses_what_the_kernel_does_not_take(bad):
    raw = torch.from_numpy(_store(13, v=30)[0][:4].copy())
    cols = torch.arange(8, dtype=torch.int32)
    out = torch.zeros((4, 16), dtype=torch.int8)
    counts = torch.zeros((4,), dtype=torch.int32)
    if bad == "column":
        cols = torch.tensor([0, 80], dtype=torch.int32)
    elif bad == "narrow":
        cols = None  # 80 columns into 16-byte int8 rows
    elif bad == "dtype":
        cols = cols.to(torch.int64)
    else:
        out = torch.zeros((3, 16), dtype=torch.int8)
    with pytest.raises((TypeError, ValueError)):
        lk.gather_rows_device(raw, cols, out, counts)


def test_scan_columns_reads_the_identity_as_no_list():
    """Only the list of every bit of the row is the identity: a prefix
    that stops inside the last byte leaves out haplotypes whose bits are
    there, so it stays a list."""
    assert tls.scan_columns(None, 10) is None
    assert tls.scan_columns(np.arange(80), 10) is None
    for n in (77, 79, 72):
        np.testing.assert_array_equal(tls.scan_columns(np.arange(n), 10),
                                      np.arange(n))
    with pytest.raises(ValueError):
        tls.scan_columns(np.array([3, 80]), 10)
    with pytest.raises(ValueError):
        tls.scan_columns(np.array([], dtype=np.int64), 10)


@pytest.mark.parametrize("kind", ["subset", "haploid"])
def test_scan_of_gathered_columns_equals_the_repacked_scan(kind):
    """stream_threshold_scan(G_packed=raw, cols=...) returns the hits of
    the scan of the host-repacked rows, and a cached resident of the full
    panel is never served to the cohort."""
    raw, pos = _store(14, v=58)
    cols = _cols(kind)
    repacked = pack.pack_columns(raw, cols, 2 * N_SAMPLES)
    kw = dict(pos=pos, thres=0.5, device="cpu", count_block=16)
    want = tls.stream_threshold_scan(G_packed=repacked,
                                     n_haplotypes=cols.size, **kw)
    tls.clear_resident_cache()
    try:
        full = tls.stream_threshold_scan(G_packed=raw,
                                         n_haplotypes=2 * N_SAMPLES,
                                         resident_key="chr", **kw)
        got = tls.stream_threshold_scan(G_packed=raw, cols=cols,
                                        resident_key="chr", **kw)
    finally:
        tls.clear_resident_cache()
    assert full.stats["resident_hit"] == got.stats["resident_hit"] == 0.0
    assert got.stats["resident_gather"] == 1.0
    _assert_same_hits(got, want)
    assert want.i.size > 0
    with pytest.raises(ValueError):
        tls.stream_threshold_scan(G_packed=raw, cols=cols,
                                  n_haplotypes=cols.size + 1, **kw)


def test_checkpoints_of_a_cohort_are_its_own(tmp_path):
    """The checkpoint fingerprint holds the column list: a cohort's scan
    resumes from its own batches, never from another cohort's of the same
    shape."""
    raw, pos = _store(15, v=58)
    a = np.arange(0, 60)
    b = np.arange(20, 80)
    kw = dict(pos=pos, thres=0.5, device="cpu", count_block=16,
              checkpoint_dir=str(tmp_path), max_tiles_per_call=1, band=16,
              chunk=16)
    tls.stream_threshold_scan(G_packed=raw, cols=a, **kw)
    n_files = len(list(tmp_path.iterdir()))
    second = tls.stream_threshold_scan(G_packed=raw, cols=b, **kw)
    assert second.stats["batches_resumed"] == 0
    assert len(list(tmp_path.iterdir())) == 2 * n_files
    again = tls.stream_threshold_scan(G_packed=raw, cols=b, **kw)
    assert again.stats["batches_resumed"] == again.stats["batches"] > 0
    _assert_same_hits(again, second)
