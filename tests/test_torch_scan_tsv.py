"""The scan's TSV writer (ld_tools_tpu_torch/io/scan_tsv.py): the native
writer's bytes against the plain path's (``format_rounded`` and one
f-string a line, what the tool wrote before), and each value field against
``str(round(v, 4))``; the inputs that send a whole file down the plain
path (a value that is not finite or too large, an rsID past ASCII, a
failed build), with the same bytes and the counters that say so; and the
tool's own scan through both paths."""

import os
import shutil

import numpy as np
import pytest

from ld_tools_tpu_torch.io import scan_tsv
from ld_tools_tpu_torch.ops import ld_stream

HEADER = ['##chr="21" gends="both" pops="all" r_square_thres=0.8 '
          "max_dist=None",
          "#hg38_pos_1\trsID_1\thg38_pos_2\trsID_2\tdist\tr2\tD'"]


def _hits(rng, n, n_rows=64, r2=None, dp=None, int_zero=0.0):
    """(pos, rsid, i, j, r2, r2_iz, dp, dp_iz) of n hits over n_rows rows."""
    pos = np.sort(rng.choice(np.arange(1, 50_000_000), n_rows,
                             replace=False)).astype(np.int64)
    rsid = np.array([f"rs{k}" for k in rng.integers(1, 10 ** 9, n_rows)])
    i = rng.integers(1, n_rows, n)
    j = rng.integers(0, i)
    r2 = rng.uniform(0.0, 1.0, n) if r2 is None else np.asarray(r2, float)
    dp = rng.uniform(-1.0, 1.0, n) if dp is None else np.asarray(dp, float)
    return (pos, rsid, i, j, r2, rng.random(r2.size) < int_zero, dp,
            rng.random(dp.size) < int_zero)


def _write(path, cols):
    stats = {}
    scan_tsv.write_scan_tsv(str(path), HEADER, *cols, stats)
    with open(path, "rb") as fh:
        return fh.read(), stats


def _plain(path, cols):
    scan_tsv._write_plain(str(path), HEADER, *cols, {})
    with open(path, "rb") as fh:
        return fh.read()


def _check_values(body, cols):
    """Every line's fields against the hit's numbers, each value against
    ``str(round(v, 4))`` (``0`` for an int 0)."""
    pos, rsid, i, j, r2, r2_iz, dp, dp_iz = cols
    lines = body.decode().split("\n")
    assert lines[:2] == HEADER and lines[-1] == ""
    lines = lines[2:-1]
    assert len(lines) == len(i)
    for k, line in enumerate(lines):
        f = line.split("\t")
        assert f[:5] == [str(pos[i[k]]), str(rsid[i[k]]), str(pos[j[k]]),
                         str(rsid[j[k]]), str(pos[i[k]] - pos[j[k]])], k
        assert f[5] == ("0" if r2_iz[k] else str(round(float(r2[k]), 4)))
        assert f[6] == ("0" if dp_iz[k] else str(round(float(dp[k]), 4)))


CASES = {
    "in_range": dict(n=3_000, int_zero=0.0),
    # chrX's cross-ploidy truncation: r² past 1, D' past ±1
    "out_of_range": dict(
        r2=[3.5312, 1.0001, 2.71828, 1.5, 3.53, 1_234_567.891_23, 0.8],
        dp=[13.7227, -13.72, 3.2644, -1.00005, 1.0, 7.0, -2_000_000.5]),
    "negative_zero": dict(r2=[-0.0, -0.00001, -0.00004999, 0.0, -0.0],
                          dp=[-0.00004, -0.0, 0.00004, -1e-12, -0.00005]),
    "int_zero": dict(n=500, int_zero=0.3),
    "near_ties": dict(r2=[0.00005, 0.12345, 0.99995, 0.00015, 0.5, 1.00005],
                      dp=[-0.00005, -0.12345, 0.33335, -0.99995, 0.00025,
                          0.87655]),
    "empty": dict(n=0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_native_bytes_are_the_plain_paths(tmp_path, rng, case):
    kw = dict(CASES[case])
    n = kw.pop("n", None)
    if n is None:
        n = len(kw["r2"])
    cols = _hits(rng, n, **kw)
    body, stats = _write(tmp_path / "native.tsv", cols)
    assert stats["tsv_native"] == 1 and "tsv_plain_reason" not in stats
    assert body == _plain(tmp_path / "plain.tsv", cols)
    _check_values(body, cols)
    assert stats["format_s"] >= 0 and stats["emit_s"] >= 0


def test_the_lines_cross_the_render_buffer(tmp_path, rng, monkeypatch):
    """A render buffer of a few lines: the file is written in many
    chunks, and each line whole."""
    monkeypatch.setattr(scan_tsv, "_BUF_BYTES", 300)
    cols = _hits(rng, 2_000, int_zero=0.05)
    body, stats = _write(tmp_path / "native.tsv", cols)
    assert stats["tsv_native"] == 1
    assert body == _plain(tmp_path / "plain.tsv", cols)
    _check_values(body, cols)


def test_rsids_that_fill_the_itemsize(tmp_path, rng):
    """rsIDs as wide as the array's itemsize (no NUL) beside short ones;
    and the store's '<U' array, not converted first."""
    cols = list(_hits(rng, 400, n_rows=8))
    cols[1] = np.array(["rs123456789012", "rs1", "rs98765432109x",
                        "rs22", "rs333333333333", "rs4444", "rs55555555555a",
                        "rs6"])
    assert cols[1].dtype == np.dtype("<U14")
    body, stats = _write(tmp_path / "native.tsv", cols)
    assert stats["tsv_native"] == 1
    assert body == _plain(tmp_path / "plain.tsv", cols)
    _check_values(body, cols)
    assert b"\x00" not in body


@pytest.mark.parametrize("value", [np.nan, np.inf, -np.inf, 2e11])
@pytest.mark.parametrize("measure", [4, 6])  # r2, dp in the columns
def test_a_value_it_cannot_render_takes_the_plain_path(tmp_path, rng, value,
                                                       measure):
    """Not finite, or |m| >= 10^15 (past which a double's shortest repr
    need not be the 4-place decimal): the whole file is the plain
    path's; the same value under an int-0 flag prints 0, natively."""
    cols = list(_hits(rng, 50))
    cols[measure] = cols[measure].copy()
    cols[measure][7] = value
    body, stats = _write(tmp_path / "a.tsv", cols)
    assert stats["tsv_native"] == 0 and stats["tsv_plain_reason"] == "value"
    assert body == _plain(tmp_path / "plain.tsv", cols)
    cols[measure + 1] = cols[measure + 1].copy()
    cols[measure + 1][7] = True
    body, stats = _write(tmp_path / "b.tsv", cols)
    assert stats["tsv_native"] == 1
    assert body == _plain(tmp_path / "plain_b.tsv", cols)
    _check_values(body, cols)


def test_an_rsid_past_ascii_takes_the_plain_path(tmp_path, rng):
    cols = list(_hits(rng, 300, n_rows=16))
    cols[1] = cols[1].copy()
    cols[1][int(cols[2][150])] = "rsé中"
    body, stats = _write(tmp_path / "a.tsv", cols)
    assert stats["tsv_native"] == 0 and stats["tsv_plain_reason"] == "rsid"
    assert body == _plain(tmp_path / "plain.tsv", cols)
    assert body.count(b"\n") == 2 + 300


@pytest.mark.parametrize("row", [-1, 64])
def test_a_row_outside_the_store_raises_before_the_native_writer(
        tmp_path, rng, row):
    """The native writer reads pos[i[k]] and rsid[j[k]] unchecked: a row
    past either array is refused in Python, as the plain path's index
    would be."""
    cols = list(_hits(rng, 10, n_rows=64))
    cols[3] = cols[3].copy()
    cols[3][4] = row
    with pytest.raises(IndexError):
        _write(tmp_path / "a.tsv", cols)


@pytest.mark.parametrize("fault", ["no_compiler", "compile_error"])
def test_a_failed_build_takes_the_plain_path(tmp_path, rng, monkeypatch,
                                             fault):
    """A library that cannot be built: the plain path, once tried in a
    process; the library is looked for in its own place here, so the
    port's build stays as it is."""
    monkeypatch.setattr(scan_tsv, "_lib", None)
    monkeypatch.setattr(scan_tsv, "_LIB", str(tmp_path / "libscan_tsv.so"))
    if fault == "no_compiler":
        monkeypatch.setattr(scan_tsv, "_CXX", str(tmp_path / "no-g++"))
    else:
        src = tmp_path / "scan_tsv.cpp"
        src.write_text("this is not C++\n")
        monkeypatch.setattr(scan_tsv, "_SRC", str(src))
    cols = _hits(rng, 200, int_zero=0.1)
    body, stats = _write(tmp_path / "a.tsv", cols)
    assert stats["tsv_native"] == 0
    assert stats["tsv_plain_reason"] == "toolchain"
    assert body == _plain(tmp_path / "plain.tsv", cols)
    assert isinstance(scan_tsv._lib, scan_tsv.NativeUnavailable)
    assert not os.path.exists(scan_tsv._LIB)
    assert not [p for p in os.listdir(tmp_path) if ".tmp." in p]


def test_the_library_is_rebuilt_when_its_source_is_newer(tmp_path, rng,
                                                         monkeypatch):
    src = tmp_path / "scan_tsv.cpp"
    shutil.copy(scan_tsv._SRC, src)
    monkeypatch.setattr(scan_tsv, "_SRC", str(src))
    monkeypatch.setattr(scan_tsv, "_LIB", str(tmp_path / "libscan_tsv.so"))
    monkeypatch.setattr(scan_tsv, "_lib", None)
    scan_tsv._load()
    built = os.path.getmtime(scan_tsv._LIB)
    monkeypatch.setattr(scan_tsv, "_lib", None)
    scan_tsv._load()  # up to date: not built again
    assert os.path.getmtime(scan_tsv._LIB) == built
    os.utime(src, (built + 10, built + 10))
    monkeypatch.setattr(scan_tsv, "_lib", None)
    cols = _hits(rng, 100)
    body, stats = _write(tmp_path / "a.tsv", cols)
    assert os.path.getmtime(scan_tsv._LIB) > built
    assert stats["tsv_native"] == 1
    assert body == _plain(tmp_path / "plain.tsv", cols)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    from ld_tools_tpu_torch.ingest import prep, synth

    d = str(tmp_path_factory.mktemp("intgen"))
    synth.generate_dataset(d, n_samples=30, chrom_variant_counts={"5": 90},
                           seed=7)
    prep.prep_intgen_data(d)
    return d


@pytest.mark.parametrize("plain", [False, True])
def test_the_scan_tool_writes_through_it(store, tmp_path, monkeypatch,
                                         plain):
    """ld_scan -E torch: tsv_native 1 and the TSV of the plain path byte
    for byte; with the library made unavailable, tsv_native 0 and the
    same bytes."""
    from ld_tools_tpu_torch.tools.common import DataConfig
    from ld_tools_tpu_torch.tools.scan import ScanConfig, scan_chromosome

    def scan(out):
        ld_stream.clear_resident_cache()
        data = DataConfig.resolve(store, True, "both", "all")
        config = ScanConfig(chroms=("5",), trg_dir_path=str(out),
                            ld_measure="r_square", ld_low_thres=0.2,
                            max_dist=None, device="cpu")
        report = scan_chromosome(data, config, "5")
        with open(report.path, "rb") as fh:
            return report, fh.read()

    def unavailable():
        raise scan_tsv.NativeUnavailable("no toolchain in this test")

    if plain:
        monkeypatch.setattr(scan_tsv, "_load", unavailable)
    report, body = scan(tmp_path / "a")
    assert report.n_hits > 0
    assert report.stats["tsv_native"] == int(not plain)
    assert report.stats.get("tsv_plain_reason") == (
        "toolchain" if plain else None)
    assert report.stats["tsv_bytes"] == len(body)
    monkeypatch.setattr(scan_tsv, "_load", unavailable)
    _, oracle = scan(tmp_path / "b")
    assert body == oracle
