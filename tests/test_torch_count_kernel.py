"""The host side of the CUDA kernels that a CPU run can check: the C ABI
the ctypes bindings declare, the tile walks of the count and block
kernels, each form's stage of the wgmma core and which instance each
launch site reaches.

The kernels themselves run only on the card (chip_smoke.py holds each
against its plain version there); their plain versions' parity with
ld_pallas is in test_torch_ld_kernels.py and test_torch_packed_kernels.py.
"""

import ctypes
import glob
import os
import re

import numpy as np
import pytest
import torch

from ld_tools_tpu_torch.ops import _cuda_build
from ld_tools_tpu_torch.ops import ld_kernels as lk


def _c_prototypes() -> dict:
    """{name: (kind, ...)} of every function defined inside an
    ``extern "C" {`` block of csrc/*.cu; kind is "P" (a pointer), "I"
    (an int) or "F" (a float) per argument."""
    protos = {}
    for path in sorted(glob.glob(os.path.join(_cuda_build.CSRC, "*.cu"))):
        with open(path) as fh:
            src = fh.read()
        for block in re.findall(r'extern "C" \{(.*?)\}\s*// extern "C"', src,
                                re.S):
            for name, args in re.findall(
                    r"^[\w *]+?\b(ldk_\w+)\(([^)]*)\)\s*\{", block, re.M):
                kinds = []
                for arg in args.split(","):
                    arg = " ".join(arg.split())
                    if "*" in arg:
                        kinds.append("P")
                    elif arg.split()[-2] == "float":
                        kinds.append("F")
                    elif arg.split()[-2] == "int":
                        kinds.append("I")
                    else:
                        raise AssertionError(f"{name}: unknown argument {arg!r}")
                protos[name] = tuple(kinds)
    return protos


def _count_tile_walk(cij, n_rows: int, block_m: int, block_n: int) -> dict:
    """The live tiles of the count kernel's walk, decoded as its
    ``count_tile_at`` decodes them: {name: int64 array} with "t" (the
    walk index), "k" (the block), "row0"/"col0" (the tile's first matrix
    row/column), "rows" (its rows inside the block and the matrix) and
    "cols" (its columns inside the block).  A tile is live when its last
    row lies below its first column; the kernel loads nothing of the
    others.  The kernel walks on its own; this mirrors its rule."""
    tm, tn = lk.COUNT_TILE
    n_tm, n_tn = -(-block_m // tm), -(-block_n // tn)
    cij = np.asarray(cij, dtype=np.int64).reshape(-1)
    t = np.arange(lk.count_tiles(cij.size, block_m, block_n), dtype=np.int64)
    k, s = np.divmod(t, n_tm * n_tn)
    tr, tc = np.divmod(s, n_tn)
    row0 = (cij[k] >> 16) * block_m + tr * tm
    col0 = (cij[k] & 0xFFFF) * block_n + tc * tn
    rows = np.minimum(np.minimum(tm, block_m - tr * tm), n_rows - row0)
    cols = np.minimum(tn, block_n - tc * tn)
    live = (rows > 0) & (col0 < row0 + rows - 1)
    return {name: a[live] for name, a in (
        ("t", t), ("k", k), ("row0", row0), ("col0", col0), ("rows", rows),
        ("cols", cols))}


_KIND = {ctypes.c_void_p: "P", ctypes.c_int: "I", ctypes.c_float: "F"}


def test_the_c_sources_define_each_bound_entry_point_once():
    protos = _c_prototypes()
    assert set(protos) == set(_cuda_build._SIGNATURES) | {"ldk_error_string"}
    assert _cuda_build.SOURCES == tuple(sorted(
        glob.glob(os.path.join(_cuda_build.CSRC, "*.cu"))))


def test_no_source_defines_the_retired_packed_triangle_entry():
    """K2 runs as ld_block_kernel<FORM_BITS, STORE_TRIANGLE> through
    ldk_block_triangle: the warp-level MMA entry point ldk_triangle and
    its source are gone from the bindings and from csrc/, and no source
    issues mma.sync."""
    assert "ldk_triangle" not in _cuda_build._SIGNATURES
    assert "ldk_triangle" not in _c_prototypes()
    assert not os.path.exists(os.path.join(_cuda_build.CSRC, "ld_kernels.cu"))
    for path in _cuda_build.SOURCES + _cuda_build.HEADERS:
        with open(path) as fh:
            assert "mma.sync" not in fh.read(), path


def test_block_triangle_takes_the_bit_plane_form():
    """ldk_block_triangle launches the FORM_BITS instance: the form
    check admits it and the dispatch names launch_block<FORM_BITS,
    STORE_TRIANGLE>."""
    with open(os.path.join(_cuda_build.CSRC, "ld_block_sm90.cu")) as fh:
        src = fh.read()
    body = src[src.index("int ldk_block_triangle("):
               src.index("int ldk_block_sweep(")]
    assert "form != FORM_BITS" in body
    assert "launch_block<FORM_BITS, STORE_TRIANGLE>" in body


def test_a_library_built_from_another_set_of_sources_is_stale(tmp_path,
                                                               monkeypatch):
    """The rebuild rule notices a deleted or added source, not only a
    newer one: a library left from an older tree (with a source since
    deleted) is rebuilt even though it is newer than every file."""
    src = tmp_path / "a.cu"
    hdr = tmp_path / "a.cuh"
    for f in (src, hdr):
        f.write_text("//\n")
    lib = tmp_path / "lib.so"
    monkeypatch.setattr(_cuda_build, "SOURCES", (str(src),))
    monkeypatch.setattr(_cuda_build, "HEADERS", (str(hdr),))
    monkeypatch.setattr(_cuda_build, "LIB", str(lib))
    monkeypatch.setattr(_cuda_build, "MANIFEST", str(lib) + ".sources")
    assert _cuda_build._stale()                       # no library
    lib.write_text("")
    assert _cuda_build._stale()                       # no manifest
    (tmp_path / "lib.so.sources").write_text("a.cu\nold.cu\na.cuh\n")
    assert _cuda_build._stale()                       # another set
    (tmp_path / "lib.so.sources").write_text(_cuda_build._manifest())
    os.utime(src, (1, 1))
    os.utime(hdr, (1, 1))
    assert not _cuda_build._stale()                   # up to date
    os.utime(hdr, None)
    os.utime(lib, (2, 2))
    assert _cuda_build._stale()                       # a newer header


@pytest.mark.parametrize("entry", sorted(_cuda_build._SIGNATURES))
def test_ctypes_signatures_match_the_c_prototypes(entry):
    """Each entry point's ctypes argtypes have the count and the pointer /
    int / float kind of its C prototype: a mismatch would otherwise show
    only on the card, as a cut pointer or a misread argument."""
    want = _c_prototypes()[entry]
    got = tuple(_KIND[t] for t in _cuda_build._SIGNATURES[entry])
    assert got == want


@pytest.mark.parametrize("block,n_rows", [
    (16, 16 * 9 + 5),
    (200, 200 * 4 + 37),
    (640, 640 * 3 + 1),
    (1000, 1000 * 2 + 999),
    (2048, 2048 + 300),
])
def test_count_tile_walk_covers_every_strict_lower_cell_once(block, n_rows):
    """At count blocks the 128 x 320 tile does and does not divide, with a
    ragged last block: every cell of every listed block that lies below
    the diagonal inside the matrix falls in exactly one live tile of the
    walk, and no live tile holds nothing to count."""
    nb = -(-n_rows // block)
    bi, bj = np.tril_indices(nb)
    keep = np.random.default_rng(block).random(bi.size) < 0.8
    keep[bi == nb - 1] = True  # the ragged block row always
    bi, bj = bi[keep], bj[keep]
    cij = lk.pack_block_coords(bi, bj)
    walk = _count_tile_walk(cij, n_rows, block, block)
    assert lk.count_tiles(len(cij), block, block) >= walk["t"].size > 0
    assert np.all(np.diff(walk["t"]) > 0)
    hits = np.zeros((len(cij), block, block), dtype=np.int32)
    for k, row0, col0, rows, cols in zip(walk["k"], walk["row0"],
                                         walk["col0"], walk["rows"],
                                         walk["cols"]):
        r = row0 + np.arange(rows)[:, None]
        c = col0 + np.arange(cols)[None, :]
        lr, lc = row0 - bi[k] * block, col0 - bj[k] * block
        cells = c < r
        assert cells.any(), "a live tile with nothing to count"
        hits[k, lr:lr + rows, lc:lc + cols] += cells
    rows = bi[:, None] * block + np.arange(block)[None, :]
    cols = bj[:, None] * block + np.arange(block)[None, :]
    want = ((cols[:, None, :] < rows[:, :, None])
            & (rows < n_rows)[:, :, None])
    np.testing.assert_array_equal(hits, want.astype(np.int32))


def _block_source_rule() -> tuple:
    """(CT_M, divisor, wide, narrow) as the C sources state them: the tile
    rows (csrc/ld_sm90_core.cuh) and block_tile_n's rule, TN = wide where
    divisor divides the block side, else narrow (csrc/ld_block_sm90.cu)."""
    with open(os.path.join(_cuda_build.CSRC, "ld_sm90_core.cuh")) as fh:
        ct_m = int(re.search(r"constexpr int CT_M = (\d+);", fh.read())[1])
    with open(os.path.join(_cuda_build.CSRC, "ld_block_sm90.cu")) as fh:
        rule = re.search(r"block_tile_n\(int block_n\) \{\s*return block_n "
                         r"% (\d+) == 0 \? (\d+) : (\d+);", fh.read())
    return (ct_m,) + tuple(int(x) for x in rule.groups())


def _block_tile_walk(cij, n_rows: int, block_m: int, block_n: int,
                     store: str, n_rows_b: int = None) -> dict:
    """The live tiles of ld_block_kernel's walk, decoded as its
    ``Walk<WALK_TRIANGLE | WALK_SWEEP, TN>::at`` decodes them, with the
    tile from the C sources' rule: {name: int64 array} with "t", "k",
    "row0"/"col0" (the tile's first matrix row/column), "lr0"/"lc0" (its
    offset inside the block), "rows"/"cols" (the cells it writes) and
    "rows_in"/"cols_in" (its rows inside the rows' matrix, of n_rows, and
    its columns inside the columns' matrix, of n_rows_b, n_rows unless
    given: the rest read TMA's zeros and zero vectors).  The triangle
    writes the tile's cells inside the block and the matrix and computes a
    tile only when it holds one; the sweep writes every cell of the block,
    past the matrices too."""
    tm, div, wide, narrow = _block_source_rule()
    tn = wide if block_n % div == 0 else narrow
    n_tm, n_tn = -(-block_m // tm), -(-block_n // tn)
    cij = np.asarray(cij, dtype=np.int64).reshape(-1)
    t = np.arange(cij.size * n_tm * n_tn, dtype=np.int64)
    k, s = np.divmod(t, n_tm * n_tn)
    tr, tc = np.divmod(s, n_tn)
    lr0, lc0 = tr * tm, tc * tn
    row0 = (cij[k] >> 16) * block_m + lr0
    col0 = (cij[k] & 0xFFFF) * block_n + lc0
    rows = np.minimum(tm, block_m - lr0)
    cols = np.minimum(tn, block_n - lc0)
    rows_in = np.clip(n_rows - row0, 0, rows)
    cols_in = np.clip((n_rows if n_rows_b is None else n_rows_b) - col0, 0,
                      cols)
    if store == "triangle":
        rows = np.minimum(rows, n_rows - row0)
        cols = np.minimum(cols, n_rows - col0)
        live = (rows > 0) & (cols > 0)
    else:
        live = np.ones(t.size, dtype=bool)
    return {name: a[live] for name, a in (
        ("t", t), ("k", k), ("row0", row0), ("col0", col0), ("lr0", lr0),
        ("lc0", lc0), ("rows", rows), ("cols", cols), ("rows_in", rows_in),
        ("cols_in", cols_in))}


def test_block_tile_rule_is_the_c_sources():
    """ops/ld_kernels.block_tile_n and block_tiles (the grid the wrappers
    pass) are the C sources' tile width and walk length at every block
    side the kernel takes; 320 wide where it divides the block, else 256."""
    tm, div, wide, narrow = _block_source_rule()
    assert (tm, div, wide, narrow) == (lk.BLOCK_TILE_M, 320, 320, 256)
    for side in range(1, lk.MAX_COUNT_BLOCK + 1):
        tn = wide if side % div == 0 else narrow
        assert lk.block_tile_n(side) == tn
        assert lk.block_tiles(3, side, side) == 3 * -(-side // tm) * -(
            -side // tn)
    assert [lk.block_tile_n(b) for b in (512, 640, 1000, 1024)] == [
        256, 320, 256, 256]


@pytest.mark.parametrize("store", ["triangle", "sweep", "sweep_two"])
@pytest.mark.parametrize("block,n_rows", [
    (16, 16 * 9 + 5),
    (200, 200 * 4 + 37),
    (512, 512 * 3 + 100),
    (640, 640 * 3 + 1),
    (1000, 1000 * 2 + 999),
    (1024, 1024 * 2 + 1),
    (2048, 2048 + 300),
])
def test_block_tile_walk_writes_every_cell_once(block, n_rows, store):
    """At block sides the tile does and does not divide, with a ragged
    matrix edge, at the tile width the wrapper picks: the triangle
    (K1 / K8, K1b) writes every cell of every listed block that lies
    inside the matrix exactly once and none outside it, and computes no
    tile without such a cell; the sweep (K3, K4) writes every cell of every
    listed block exactly once, past the matrix edge too.  The dense
    sweep's two matrices (``sweep_two``: g_rows shorter than g_cols, as a
    scan's shards or the grid sweep give it) leave the same walk, and a
    cell reads real rows exactly when its row lies in g_rows and its
    column in g_cols.  The walk is as long as the wrapper's block_tiles."""
    nb = -(-n_rows // block)
    rng = np.random.default_rng(block)
    if store == "triangle":
        bi, bj = np.tril_indices(nb)
    else:  # a scan's hit blocks: any pairs, in any order
        bi, bj = np.divmod(rng.permutation(nb * nb), nb)
    keep = rng.random(bi.size) < 0.8
    keep[bi == nb - 1] = True  # the ragged block row always
    bi, bj = bi[keep], bj[keep]
    cij = lk.pack_block_coords(bi, bj)
    # the sweep's rows from a matrix shorter than its columns' by a ragged
    # count (both ragged against the block)
    n_rows_a = n_rows - (block // 2 + 3) if store == "sweep_two" else n_rows
    walk = _block_tile_walk(cij, n_rows_a, block, block,
                            "triangle" if store == "triangle" else "sweep",
                            n_rows_b=n_rows)
    n_tiles = lk.block_tiles(len(cij), block, block)
    assert walk["t"].size <= n_tiles and np.all(np.diff(walk["t"]) > 0)
    if store != "triangle":
        assert walk["t"].size == n_tiles
    hits = np.zeros((len(cij), block, block), dtype=np.int8)
    real = np.zeros_like(hits)
    for k, row0, col0, lr0, lc0, rows, cols, rows_in, cols_in in zip(
            walk["k"], walk["row0"], walk["col0"], walk["lr0"], walk["lc0"],
            walk["rows"], walk["cols"], walk["rows_in"], walk["cols_in"]):
        assert rows > 0 and cols > 0, "a live tile with nothing to write"
        assert (row0 - bi[k] * block, col0 - bj[k] * block) == (lr0, lc0)
        hits[k, lr0:lr0 + rows, lc0:lc0 + cols] += 1
        real[k, lr0:lr0 + rows_in, lc0:lc0 + cols_in] += 1
    rows = bi[:, None] * block + np.arange(block)[None, :]
    cols = bj[:, None] * block + np.arange(block)[None, :]
    inside = (rows < n_rows_a)[:, :, None] & (cols < n_rows)[:, None, :]
    if store == "triangle":
        want = inside
    else:
        want = np.ones_like(hits, dtype=bool)
    np.testing.assert_array_equal(hits, want.astype(np.int8))
    np.testing.assert_array_equal(real, inside.astype(np.int8))


_FORMS = {"s8": "FORM_S8", "bf16": "FORM_BF16", "tf32": "FORM_TF32"}


def _core_source() -> str:
    with open(os.path.join(_cuda_build.CSRC, "ld_sm90_core.cuh")) as fh:
        return fh.read()


@pytest.mark.parametrize("n", [160, 128])
@pytest.mark.parametrize("kind", sorted(_FORMS))
def test_each_form_steps_k_by_one_swizzle_row_a_stage(kind, n):
    """Every wgmma form of the core reads a ring stage of one 128-byte
    swizzle row a row: KB / elem_bytes elements of K (128 s8, 64 bf16, 32
    f32), consumed by KB / 32 wgmmas of 32 bytes of K each (k32 s8, k16
    bf16, k8 tf32), so the descriptor's +2 (32 bytes) a k-step walks the
    stage in every form.  Read from csrc/ld_sm90_core.cuh: KB, the
    element sizes, each wgmma instruction's shape and operand types, and
    the main loop's k-steps."""
    src = _core_source()
    kb = int(re.search(r"constexpr int KB = (\d+);", src)[1])
    rule = re.search(r"elem_bytes\(int form\) \{\s*return form == FORM_BF16 "
                     r"\? (\d+) : form == FORM_TF32 \? (\d+) : (\d+);", src)
    elem = dict(zip(("bf16", "tf32", "s8"), (int(x) for x in rule.groups())))
    assert kb == 128 and elem == {"s8": 1, "bf16": 2, "tf32": 4}
    ((k, acc),) = set(re.findall(
        rf'"m64n{n}k(\d+)\.(\w+)\.{kind}\.{kind}"', src))
    assert int(k) * elem[kind] == 32
    assert acc == ("s32" if kind == "s8" else "f32")
    assert "for (int kk = 0; kk < KB / 32; ++kk)" in src
    assert "da + 2 * kk, db0 + 2 * kk" in src
    assert kb // elem[kind] == {"s8": 128, "bf16": 64, "tf32": 32}[kind]
    # wgmma_half picks this instruction for the form (s8: the last branch)
    head = rf"{_FORMS[kind]}\) \{{" if kind != "s8" else r"\} else \{"
    sel = re.search(head + r"\s*if constexpr \(WIDE\) wgmma_m64n160k(\d+)"
                    r"\(d, da, db, accumulate\);\s*else wgmma_m64n128k(\d+)",
                    src)
    assert sel and int(sel[1]) == int(sel[2]) == int(k)


# launch site -> (the entry point it reaches on the card, the form it passes)
_ROUTES = {
    "ld_triangle_blocks": ("ldk_block_triangle", _cuda_build.FORM_S8),
    "ld_stage_blocks": ("ldk_block_triangle", _cuda_build.FORM_S8),
    "ld_triangle_blocks_bf16": ("ldk_block_triangle", _cuda_build.FORM_BF16),
    "ld_triangle_blocks_tf32": ("ldk_block_triangle", _cuda_build.FORM_TF32),
    "ld_triangle_blocks_packed": ("ldk_block_triangle", _cuda_build.FORM_BITS),
    "ld_band_sweep_blocks": ("ldk_block_sweep", _cuda_build.FORM_S8),
    "ld_band_sweep_blocks_packed": ("ldk_block_sweep", _cuda_build.FORM_BITS),
}


@pytest.mark.parametrize("site_name", sorted(_ROUTES))
def test_each_site_launches_its_instance(site_name, monkeypatch):
    """Through its public entry, each triangle and sweep site reaches the
    library entry point of its instance with its form: K1 / K8 and the
    bf16 and tf32 sites (K1b) and the packed triangle (K2)
    ldk_block_triangle, the dense and packed sweeps (K3, K4)
    ldk_block_sweep, each with the persistent grid min(SMs, tiles).
    _launch, the card check and the SM count are faked."""
    calls = []

    def launch(entry, dev, *args):
        calls.append((entry, args))
        return 0

    monkeypatch.setattr(lk, "_launch", launch)
    monkeypatch.setattr(lk, "_on_card", lambda *tensors: True)
    monkeypatch.setattr(lk, "_sm_count", lambda dev: 132)
    lk.reset_launches()
    site = getattr(lk, site_name)
    entry, form = _ROUTES[site_name]
    block, nb = 640, 3
    dtype = torch.uint8 if form == _cuda_build.FORM_BITS else torch.int8
    g = torch.zeros((2 * block, 32), dtype=dtype)
    vec = torch.ones((2 * block,), dtype=torch.float32)
    cij = torch.from_numpy(lk.pack_block_coords([0, 1, 1], [0, 0, 1]))
    if site_name == "ld_stage_blocks":
        site(g, vec, vec, cij, 16, block=block, stage="fast")
    elif entry == "ldk_block_sweep":
        site(g, g, vec, vec, vec, vec, cij, 16, outs=("cab", "r2"),
             block_m=block, block_n=block)
    else:
        site(g, vec, vec, cij, 16, block_m=block, block_n=block,
             epilogue="fast", want_dprime=False)
    ((got_entry, args),) = calls
    assert got_entry == entry
    # the prototype's arguments but the stream, which _launch appends
    assert len(args) == len(_cuda_build._SIGNATURES[entry]) - 1
    at_form = 16 if entry == "ldk_block_sweep" else 12
    assert args[at_form] == form
    assert args[at_form + 1] == min(132, lk.block_tiles(nb, block, block))
    assert site.launches == 1
    assert {f.__name__ for f in lk.LAUNCH_SITES} == set(_ROUTES) | {
        "ld_band_count", "ld_band_count_packed", "ld_band_count_sharded",
        "gather_rows_device"}
    lk.reset_launches()


@pytest.mark.parametrize("cols", [None, [5, 0, 9]])
@pytest.mark.parametrize("dense", [True, False])
def test_gather_site_launches_its_entry(monkeypatch, cols, dense):
    """gather_rows_device reaches ldk_gather_rows with the rows, the list
    (NULL for every column), the columns a row gets, the layout, the
    output width and a grid of a few blocks an SM; the prototype's
    arguments but the stream, which _launch appends."""
    calls = []

    def launch(entry, dev, *args):
        calls.append((entry, args))
        return 0

    monkeypatch.setattr(lk, "_launch", launch)
    monkeypatch.setattr(lk, "_on_card", lambda *tensors: True)
    monkeypatch.setattr(lk, "_sm_count", lambda dev: 132)
    lk.reset_launches()
    src = torch.zeros((100, 3), dtype=torch.uint8)
    c = None if cols is None else torch.tensor(cols, dtype=torch.int32)
    out = torch.zeros((100, 32), dtype=torch.int8 if dense else torch.uint8)
    counts = torch.zeros((100,), dtype=torch.int32)
    lk.gather_rows_device(src, c, out, counts)
    ((entry, args),) = calls
    assert entry == "ldk_gather_rows"
    assert len(args) == len(_cuda_build._SIGNATURES[entry]) - 1
    assert args[1:3] == (100, 3)
    assert (args[3] is None) == (cols is None)
    assert args[4:8] == (24 if cols is None else 3, int(dense), 32, 13)
    assert lk.gather_rows_device.launches == 1
    lk.reset_launches()
