"""ld_gather_rows_kernel (csrc/ld_gather_rows.cu) against its plain
version, byte for byte and count for count, on the card.

The kernel runs only there: each test skips without a CUDA card.  This
file imports no JAX, so that it runs where the port runs alone:
``python -m pytest --noconftest tests/test_torch_gather_kernel.py``.
The shapes are the store's: 5,008 haplotypes a row (626 bytes, so rows
start off every 16-byte boundary), the full panel (the identity) and a
970-haplotype cohort of whole samples, in both layouts, in launches
that fill the grid (every warp walks several rows), with a staging chunk
that ends inside the rows (the scan's own 65,536-row chunk among them)
and the resident's padding rows and columns.  The mixed-ploidy scan's
rectangles take their two sides from the same kernel
(``ops/segment_scan._side_rows``): those sides, and a small chrX scan's
TSV, against the CPU's, whose TSV tests/test_torch_mixed_scan.py holds to
the JAX tool's byte for byte.
"""

import os

import numpy as np
import pytest
import torch

from ld_tools_tpu_torch.ops import ld_kernels as lk
from ld_tools_tpu_torch.ops import ld_stream as ls

N_HAP = 5008
LIMIT = "TPU_LD_DENSE_RESIDENT_BYTES"


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: ld_gather_rows_kernel runs only there")


def _rows(v, seed):
    """(v, 626) packed rows with all-0, all-1 and one-bit rows."""
    rng = np.random.default_rng(seed)
    freqs = rng.uniform(0.02, 0.98, size=(v, 1))
    G = (rng.random((v, N_HAP)) < freqs).astype(np.uint8)
    G[3] = 0
    G[4] = 1
    G[5] = 0
    G[5, N_HAP - 1] = 1
    return np.packbits(G, axis=1), np.arange(v, dtype=np.int64) * 40


def _cohort():
    """485 samples' two columns each, spread over the panel (970)."""
    samples = np.sort(np.random.default_rng(7).choice(N_HAP // 2, 485,
                                                      replace=False))
    return np.stack([2 * samples, 2 * samples + 1], axis=1).ravel()


@pytest.mark.parametrize("n_cols", [970, N_HAP])
@pytest.mark.parametrize("dense", [True, False])
@pytest.mark.parametrize("v", [1000, 40_000])
def test_gather_kernel_equals_plain(n_cols, dense, v):
    """One launch over ``v`` rows: at 1,000 each warp takes one row, at
    40,000 the grid is full and each warp walks several rows through its
    shared-memory slice."""
    _card()
    raw, _ = _rows(v, seed=1)
    cols = None if n_cols == N_HAP else torch.from_numpy(
        _cohort().astype(np.int32))
    n_bytes = 128 * -(-n_cols // 1024)  # a packed row, padded to 128
    width = 8 * n_bytes if dense else n_bytes
    dtype = torch.int8 if dense else torch.uint8
    outs = {}
    for dev in ("cpu", "cuda"):
        out = torch.full((raw.shape[0], width), 0x5A, dtype=dtype,
                         device=dev)
        counts = torch.full((raw.shape[0],), -1, dtype=torch.int32,
                            device=dev)
        lk.gather_rows_device(torch.from_numpy(raw).to(dev),
                              None if cols is None else cols.to(dev), out,
                              counts)
        outs[dev] = (out.cpu(), counts.cpu())
    torch.cuda.synchronize()
    assert torch.equal(outs["cuda"][0], outs["cpu"][0])
    assert torch.equal(outs["cuda"][1], outs["cpu"][1])
    assert int(outs["cuda"][1][4]) == n_cols


@pytest.mark.parametrize("kind", ["identity", "cohort"])
@pytest.mark.parametrize("layout", ["dense", "packed"])
@pytest.mark.parametrize("v,stage", [(2500, 1000), (69_857, None)])
def test_gathered_resident_on_the_card_equals_the_plain_one(monkeypatch,
                                                            kind, layout, v,
                                                            stage):
    """prepare_resident on the card (pinned chunks of 1,000 rows, or of
    the scan's own 65,536, the last one partial) equals it on the CPU,
    field by field, and launched the kernel once a chunk."""
    _card()
    if layout == "packed":
        monkeypatch.setenv(LIMIT, "0")
    if stage is not None:
        monkeypatch.setattr(ls, "_STAGE_ROWS", stage)
    raw, pos = _rows(v, seed=2)
    cols = None if kind == "identity" else _cohort()
    n_hap = N_HAP if cols is None else cols.size
    lk.reset_launches()
    stats = {}
    got = ls.prepare_resident(raw, n_hap, pos, "cuda", packed=True,
                              cols=cols, stats=stats)
    torch.cuda.synchronize()
    assert lk.gather_rows_device.launches == -(-v // ls._STAGE_ROWS)
    want = ls.prepare_resident(raw, n_hap, pos, "cpu", packed=True,
                               cols=cols)
    assert got.packed == want.packed == (layout == "packed")
    for name in ("g", "c1", "ipq", "pos"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), \
            name
    np.testing.assert_array_equal(got.c1_full, want.c1_full)
    assert stats["resident_gather"] == 1.0 and stats["gather_rows_s"] > 0


@pytest.mark.parametrize("kind", ["identity", "cohort"])
def test_rectangle_sides_on_the_card_equal_the_plain_ones(kind):
    """One side of the rectangles, rows 3 to 4,099 of the store's (a
    range that starts off every 16-byte boundary): the int8 rows, the
    counts on the card and the counts home equal the plain twin's."""
    from ld_tools_tpu_torch.ops import segment_scan

    _card()
    raw, _ = _rows(4100, seed=3)
    cols = None if kind == "identity" else _cohort()
    lk.reset_launches()
    sides = {}
    for dev in ("cpu", "cuda"):
        cols_dev = None if cols is None else torch.from_numpy(
            cols.astype(np.int32)).to(dev)
        stats = {"repack_s": 0.0, "rect_gather_rows": 0}
        rows, counts, home = segment_scan._side_rows(
            raw, 3, 4100, cols_dev, N_HAP, torch.device(dev), stats)
        sides[dev] = (rows.cpu(), counts.cpu(), home)
        assert stats["rect_gather_rows"] == 4097 and stats["repack_s"] > 0
    assert lk.gather_rows_device.launches == 1
    assert torch.equal(sides["cuda"][0], sides["cpu"][0])
    assert torch.equal(sides["cuda"][1], sides["cpu"][1])
    np.testing.assert_array_equal(sides["cuda"][2], sides["cpu"][2])
    n_cols = N_HAP if cols is None else cols.size
    assert int(sides["cuda"][0][4 - 3].sum()) == n_cols  # the all-1 row
    assert not sides["cuda"][0][:, n_cols:].any()


@pytest.mark.parametrize("max_dist", [None, 150_000])
def test_a_small_chrx_scan_on_the_card_writes_the_plain_tsv(
        tmp_path, monkeypatch, max_dist):
    """A chrX store of 1,500 variants over 300 samples (PAR1, the males'
    haploid stretch, PAR2) scanned with -E cuda and -E torch, with
    rectangles of 128-row blocks: the same TSV bytes, and the card's
    gather launched once for each segment's resident and once for each
    side of a rectangle."""
    from ld_tools_tpu_torch import ld_scan
    from ld_tools_tpu_torch.ingest import prep_intgen_data, synth
    from ld_tools_tpu_torch.ops import segment_scan

    _card()
    store = str(tmp_path / "store")
    os.makedirs(store)
    rng = np.random.default_rng(23)
    panel = synth.make_panel(300, rng)
    synth.write_panel(os.path.join(store, "samples.txt"), panel)
    G, hap = synth.make_chrx_layout(rng, 1500, [r[3] for r in panel],
                                    par_bounds=(0.2, 0.9))
    synth.write_vcf(os.path.join(store, "X.vcf.gz"), "X",
                    [r[0] for r in panel], G, haploid_masks=hap)
    prep_intgen_data(store)
    monkeypatch.setattr(segment_scan, "_RECT_ROWS", 128)
    sides = []
    side_rows = segment_scan._side_rows

    def counted(*a, **kw):
        sides.append(a[2] - a[1])
        return side_rows(*a, **kw)

    monkeypatch.setattr(segment_scan, "_side_rows", counted)
    tsv = {}
    for engine in ("torch", "cuda"):
        lk.reset_launches()
        del sides[:]
        argv = ["-C", "X", "-D", store, "-t", str(tmp_path / engine), "-f",
                "-E", engine, "-z", "0.2"]
        (report,) = ld_scan.main(argv + ([] if max_dist is None
                                         else ["-w", str(max_dist)]))
        tsv[engine] = open(report.path, "rb").read()
        st = report.stats
        assert st["segments"] == 3 and st["rect_candidates"] > 0
        assert st["rect_gather_rows"] == sum(sides) > 0
    assert lk.gather_rows_device.launches == 3 + len(sides)
    assert tsv["cuda"] == tsv["torch"] and tsv["cuda"].count(b"\n") > 10
