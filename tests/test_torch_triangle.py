"""The port's ld_triangle (-E torch, on the CPU) against the JAX tool on
the same synthetic stores: every file it writes (TSV, heatmap HTML and
JSON) must be byte-identical, on the three routes (the per-cell object
path, the streamed table, the columnar heatmap and its pooled overview),
on autosomes and on chrX/chrY.  Mirrors tests/test_tools_e2e.py:230-370,
tests/test_ploidy_e2e.py:199-310, tests/test_heatmap_columnar.py and
tests/test_heatmap_overview.py.  Also the CLI surface, the entry points
(``python -m ld_tools_tpu_torch.ld_triangle`` and the multiplexer
``python -m ld_tools_tpu_torch``) and -E cuda raising without a card
before anything is prepared.

Every file value comes from integer counts and the f64 finish, so the
JAX tool runs in-process.
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from ld_tools_tpu.io import heatmap as jax_heatmap
from ld_tools_tpu.ops import engine as jax_engine
from ld_tools_tpu.tools import triangle as jax_triangle
from ld_tools_tpu_torch import __main__ as multiplexer
from ld_tools_tpu_torch import ld_triangle as torch_ld_triangle
from ld_tools_tpu_torch.io import heatmap
from ld_tools_tpu_torch.ops import engine
from ld_tools_tpu_torch.tools import triangle

from .conftest import random_haplotypes
from .oracle import oracle_ld
from .test_heatmap_columnar import _client_hover, _decode, _reference_hover
from .test_ploidy_e2e import _flat_lists, xenv  # noqa: F401
from .test_tools_e2e import _cohort_lists, env  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEATMAPS = {"jax": jax_heatmap, "torch": heatmap}


@pytest.fixture(params=["host", "device"])
def counts(request, monkeypatch):
    """Which side of the engines' host cutoff the stores' jobs take: as
    they are (host f32 BLAS: the stores are small), or the device path
    of both engines (the cutoff set to 0 in both)."""
    if request.param == "device":
        for eng in (engine, jax_engine):
            monkeypatch.setattr(eng, "_HOST_COUNTS_MACS", 0)
    return request.param


def _args(e, trg, **kw):
    return types.SimpleNamespace(
        src_dir_path=kw.get("src", e.src), intgen_dir_path=e.intgen,
        trg_top_dir_path=trg, meta_lines_quan=0, skip_intgen_data_ver=True,
        gend_names=kw.get("gend_names", "both"), pop_names="all",
        ld_measure=kw.get("measure", "r_square"),
        ld_low_thres=kw.get("thres", None),
        matrix_type=kw.get("matrix_type", "both"),
        heatmap_json=kw.get("heatmap_json", True),
        disp_letters=kw.get("disp_letters", False), color_pal="greens",
        font_size=None, square_shape=False,
        dont_disp_footer=kw.get("dont_disp_footer", False),
        max_proc_quan=kw.get("max_proc_quan", 4), engine="torch",
    )


def _tree(trg):
    out = {}
    for dirpath, _, files in os.walk(trg):
        for name in files:
            p = os.path.join(dirpath, name)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, trg)] = fh.read()
    return out


def _both(tmp_path, e, **kw):
    """The port's and the JAX tool's files for the same arguments; they
    must be byte-identical.  Returns the port's {path: bytes} and the
    runner's phase sums."""
    got_dir, want_dir = str(tmp_path / "torch"), str(tmp_path / "jax")
    stats = {}
    n_got = triangle.run(_args(e, got_dir, **kw), stats)
    n_want = jax_triangle.run(_args(e, want_dir, **kw))
    got, want = _tree(got_dir), _tree(want_dir)
    assert n_got == n_want == stats["matrices"]
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    return got, stats


def _tsv_body(data):
    lines = data.decode().splitlines()
    return lines[2].split("\t")[2:], [ln.split("\t") for ln in lines[4:]]


@pytest.mark.parametrize("matrix_type", ["heatmap", "table", "both"])
@pytest.mark.parametrize("measure,thres", [("r_square", None),
                                           ("d_prime", 0.9)])
def test_triangle_files_are_identical(env, tmp_path, matrix_type, measure,
                                      thres, counts):
    """(test_tools_e2e.py:230, :262, :313) Every route's files on both
    chromosomes, with and without the threshold's zeroing."""
    got, stats = _both(tmp_path, env, matrix_type=matrix_type,
                       measure=measure, thres=thres)
    ext = {"heatmap": {"html", "json"}, "table": {"tsv"},
           "both": {"html", "json", "tsv"}}[matrix_type]
    assert {n.rsplit(".", 1)[1] for n in got} == ext
    assert len(got) == 2 * len(ext) and stats["matrices"] == 2
    assert set(triangle.PHASES) < set(stats)


def test_triangle_tsv_matches_oracle(env, tmp_path):
    """(test_tools_e2e.py:230) The port's table against the oracle."""
    got, _ = _both(tmp_path, env, matrix_type="table", thres=0.4)
    rsids, rows = _tsv_body(got[os.path.join("query_LD_matr",
                                             "query_chr5_r.tsv")])
    gl = _cohort_lists(env, "5", rsids)
    for i, row in enumerate(rows):
        for j in range(len(rsids)):
            want = "0"
            if j < i:
                r2 = oracle_ld(gl[rsids[i]], gl[rsids[j]])["r_square"]
                want = str(r2) if r2 >= 0.4 else "0"
            assert row[2 + j] == want, (i, j)


def test_triangle_heatmap_with_letters_is_identical(env, tmp_path):
    """(test_tools_e2e.py:283) -i -j: values and rsID labels on the
    heatmap, hover text before the threshold."""
    got, _ = _both(tmp_path, env, matrix_type="heatmap", disp_letters=True,
                   thres=0.5)
    fig = json.loads(got[os.path.join("query_LD_matr", "query_chr5_r.json")])
    trace = fig["data"][0]
    assert len(trace["z"]) == 18 and "r2:" in trace["hovertext"][2][1]
    assert len(fig["layout"]["annotations"]) == 18 * 18


def test_triangle_single_variant_chrom_skipped(env, tmp_path):
    """(test_tools_e2e.py:305)"""
    src = tmp_path / "src1"
    src.mkdir()
    (src / "one.txt").write_text(list(env.rs_by_chrom["11"])[0] + "\n")
    args = _args(env, str(tmp_path / "t"), src=str(src))
    assert triangle.run(args) == 0 == jax_triangle.run(args)
    assert not os.path.exists(tmp_path / "t" / "one_LD_matr")


@pytest.mark.parametrize("measure", ["r_square", "d_prime"])
def test_triangle_table_equals_both(env, tmp_path, measure):
    """(test_tools_e2e.py:318) The streamed table is the per-cell path's
    table byte for byte (and the JAX tool's)."""
    table, _ = _both(tmp_path / "t", env, matrix_type="table",
                     measure=measure, thres=0.4)
    both, _ = _both(tmp_path / "b", env, matrix_type="both",
                    measure=measure, thres=0.4)
    assert table and all(both[name] == data for name, data in table.items())


def _small_blocks(monkeypatch, row_block, columnar=False):
    """Shrink the streamed functions' row block in both packages."""
    names = ["_write_table_streamed"]
    if columnar:
        names.append("_build_heatmap_columnar")
    for runner in (triangle.TriangleRunner, jax_triangle.TriangleRunner):
        for name in names:
            orig = getattr(runner, name)

            def small(self, *a, _orig=orig, **kw):
                kw["row_block"] = row_block
                return _orig(self, *a, **kw)

            monkeypatch.setattr(runner, name, small)


def _count_resident_blocks(monkeypatch):
    calls = []
    orig = engine.ResidentCounts.block_async

    def spy(self, r0, r1, c_hi):
        calls.append((r0, r1, c_hi))
        return orig(self, r0, r1, c_hi)

    monkeypatch.setattr(engine.ResidentCounts, "block_async", spy)
    return calls


@pytest.mark.parametrize("row_block", [4, 8])
def test_triangle_streamed_multiblock_pipeline(env, tmp_path, monkeypatch,
                                               row_block, counts):
    """(test_tools_e2e.py:343) Small row blocks run the streamed writer's
    two-slot pipeline over several blocks: chr5's 18 rows (past 2 x
    row_block, a ragged last block) over ResidentCounts, chr11's 7 over
    ``pair_counts_async``; the files stay the JAX tool's."""
    _small_blocks(monkeypatch, row_block)
    blocks = _count_resident_blocks(monkeypatch)
    got, stats = _both(tmp_path, env, matrix_type="table", thres=0.4)
    assert len(got) == 2
    # chr5 (18 rows) goes through ResidentCounts; chr11 (7) does not
    assert [b[0] for b in blocks] == list(range(0, 18, row_block))
    assert blocks[-1][1] == 18 and 18 % row_block


def test_triangle_ragged_resident_columnar(env, tmp_path, monkeypatch,
                                           counts):
    """n just above 2 x row_block (18 rows, blocks of 8): the columnar
    heatmap and its '-o both' table from ResidentCounts' blocks, every
    r0 block-aligned, the last block ragged."""
    monkeypatch.setattr(heatmap, "_HOVER_CELLS_MAX", 4)
    monkeypatch.setattr(jax_heatmap, "_HOVER_CELLS_MAX", 4)
    _small_blocks(monkeypatch, 8, columnar=True)
    blocks = _count_resident_blocks(monkeypatch)
    got, stats = _both(tmp_path, env, matrix_type="both")
    assert blocks == [(0, 8, 8), (8, 16, 16), (16, 18, 18)]
    fig = json.loads(got[os.path.join("query_LD_matr", "query_chr5_r.json")])
    assert fig["columnar"]["n"] == 18 and stats["matrices"] == 2


@pytest.mark.parametrize("measure,thres", [("r_square", None),
                                           ("d_prime", 0.5)])
def test_triangle_columnar_files_are_identical(env, tmp_path, monkeypatch,
                                               measure, thres):
    """(test_heatmap_columnar.py) Past the per-cell cap the columnar
    payload (int16 triangles, O(n) strings) is the JAX tool's, and the
    client's hover reassembly of the port's payload is the reference's
    hover text."""
    monkeypatch.setattr(heatmap, "_HOVER_CELLS_MAX", 4)
    monkeypatch.setattr(jax_heatmap, "_HOVER_CELLS_MAX", 4)
    got, _ = _both(tmp_path, env, matrix_type="heatmap", measure=measure,
                   thres=thres, dont_disp_footer=True)
    col = json.loads(got[os.path.join("query_LD_matr",
                                      f"query_chr5_{measure[0]}.json")]
                     )["columnar"]
    assert col["n"] == 18 and col["qw"] == 2
    rs5 = col["rsids"]
    gl = _cohort_lists(env, "5", rs5)
    for i in range(1, col["n"]):
        for j in range(i):
            assert _client_hover(col, i, j) == _reference_hover(
                env, "5", rs5, gl, i, j), (i, j)


def test_triangle_chrx_table_is_identical(xenv, tmp_path, counts):
    """(test_ploidy_e2e.py:199) The chrX table: pairs inside and across
    the PAR bounds through the grouped engine, against the oracle."""
    got, _ = _both(tmp_path, xenv, matrix_type="table",
                   dont_disp_footer=True, max_proc_quan=1)
    order, rows = _tsv_body(got[os.path.join("query_LD_matr",
                                             "query_chrX_r.tsv")])
    gl = _flat_lists(xenv, "X")
    for i, row in enumerate(rows):
        for j in range(i):
            want = oracle_ld(gl[order[i]], gl[order[j]])["r_square"]
            assert row[2 + j] == str(want), (i, j)


def test_triangle_chrx_hover_pair_freqs_are_identical(xenv, tmp_path,
                                                      counts):
    """(test_ploidy_e2e.py:240) Pair-dependent hover frequencies on the
    per-cell path."""
    got, _ = _both(tmp_path, xenv, matrix_type="heatmap",
                   dont_disp_footer=True, max_proc_quan=1)
    hover = json.loads(got[os.path.join(
        "query_LD_matr", "query_chrX_r.json")])["data"][0]["hovertext"]
    order = sorted(xenv.rs_x, key=lambda r: xenv.rs_x[r])
    gl = _flat_lists(xenv, "X")
    want = oracle_ld(gl[order[30]], gl[order[3]])
    assert f"{order[3]}.alt_freq: {want['var_2_alt_freq']}<br>" in hover[30][3]


def test_triangle_chrx_columnar_is_identical(xenv, tmp_path, monkeypatch):
    """(test_heatmap_columnar.py:185) The mixed chromosome's columnar
    payload: int32 codes and pair-dependent frequency triangles."""
    monkeypatch.setattr(heatmap, "_HOVER_CELLS_MAX", 4)
    monkeypatch.setattr(jax_heatmap, "_HOVER_CELLS_MAX", 4)
    got, _ = _both(tmp_path, xenv, matrix_type="both",
                   dont_disp_footer=True, max_proc_quan=1)
    col = json.loads(got[os.path.join(
        "query_LD_matr", "query_chrX_r.json")])["columnar"]
    assert col["qw"] == 4 and "f1q" in col and "freqq" not in col
    assert len(_decode(col, "f1q")) == col["n"] * (col["n"] - 1) // 2


def test_triangle_chry_table_is_identical(xenv, tmp_path):
    """(test_ploidy_e2e.py:278) chrY, males only, D'."""
    got, _ = _both(tmp_path, xenv, matrix_type="table", gend_names="male",
                   measure="d_prime", dont_disp_footer=True)
    order, rows = _tsv_body(got[os.path.join("query_LD_matr",
                                             "query_chrY_d.tsv")])
    gl = _flat_lists(xenv, "Y", gends=("male",))
    for i, row in enumerate(rows):
        for j in range(i):
            want = oracle_ld(gl[order[i]], gl[order[j]])["d_prime"]
            assert row[2 + j] == str(want), (i, j)


def test_triangle_max_proc_gives_the_same_files(env, tmp_path):
    """-p 1 and -p 3 over three source files give the same files, which
    are the JAX tool's."""
    src = tmp_path / "multi_src"
    src.mkdir()
    rs5 = list(env.rs_by_chrom["5"])
    rs11 = list(env.rs_by_chrom["11"])
    for k, sel in enumerate((rs5[:9] + rs11, rs5[5:], rs5[::2])):
        (src / f"q{k}.txt").write_text("\n".join(sel) + "\n")
    p3, stats = _both(tmp_path / "p3", env, src=str(src), max_proc_quan=3)
    assert len(p3) == 4 * 3 and stats["matrices"] == 4
    p1_dir = str(tmp_path / "p1")
    triangle.run(_args(env, p1_dir, src=str(src), max_proc_quan=1))
    assert _tree(p1_dir) == p3


def test_triangle_json_only_with_j(env, tmp_path):
    """-j writes the figure's JSON beside the HTML; without it there is
    none, in both tools."""
    got, _ = _both(tmp_path / "j", env, matrix_type="heatmap")
    plain, _ = _both(tmp_path / "no_j", env, matrix_type="heatmap",
                     heatmap_json=False)
    assert sum(n.endswith(".json") for n in got) == 2
    assert not any(n.endswith(".json") for n in plain)
    assert all(plain[n] == got[n] for n in plain)


def _overview(tmp_path, tool, n, measure, thres=None, json_too=True,
              also_table=False):
    """(test_heatmap_overview.py:39) The columnar heatmap function of ``tool``
    driven with a bare runner on n random rows (one monomorphic)."""
    mod = triangle if tool == "torch" else jax_triangle
    extra = {"device": "cpu"} if tool == "torch" else {}
    cfg = mod.TriangleConfig(
        src_dir_path=".", trg_top_dir_path=".", meta_lines_quan=0,
        ld_measure=measure, ld_low_thres=thres,
        matrix_type="both" if also_table else "heatmap",
        heatmap_json=json_too, disp_letters=False, color_pal="greens",
        font_size=None, square_shape=False, dont_disp_footer=True, **extra)
    runner = types.SimpleNamespace(config=cfg, data=types.SimpleNamespace(
        pop_names=("ALL",), gend_names=("male", "female")))
    G = random_haplotypes(np.random.default_rng(17), n, 64, maf_low=0.05,
                          maf_high=0.95)
    G[5] = 0  # monomorphic: int-0 sentinels in the codes
    rs = [f"rs{i}" for i in range(n)]
    poss = list(range(1000, 1000 + 100 * n, 100))

    class _CD:
        def annotation(self, name):
            return np.asarray(["A"] * n)

    out = tmp_path / tool
    out.mkdir()
    mod.TriangleRunner._build_heatmap_columnar(
        runner, _CD(), "1", list(range(n)), rs, poss, G, None, "ov",
        str(out), row_block=16, also_table=also_table)
    return _tree(str(out))


@pytest.mark.parametrize("measure,thres,json_too,also_table", [
    ("r_square", None, True, False), ("d_prime", 0.4, False, True)])
def test_overview_files_are_identical(tmp_path, monkeypatch, measure, thres,
                                      json_too, also_table):
    """(test_heatmap_overview.py:76, :145, :243) Past _OVERVIEW_MIN
    (shrunk in both packages) the pooled overview HTML, the full JSON and
    the '-o both' table are the JAX tool's."""
    for mod in HEATMAPS.values():
        monkeypatch.setattr(mod, "_OVERVIEW_MIN", 20)
        monkeypatch.setattr(mod, "_OVERVIEW_P", 8)
    got = _overview(tmp_path, "torch", 37, measure, thres, json_too,
                    also_table)
    want = _overview(tmp_path, "jax", 37, measure, thres, json_too,
                     also_table)
    assert got == want
    html = got[f"ov_chr1_{measure[0]}.html"].decode()
    assert '"overview"' in html and '"columnar"' not in html
    assert (f"ov_chr1_{measure[0]}.json" in got) == json_too
    assert (f"ov_chr1_{measure[0]}.tsv" in got) == also_table


def test_overview_full_override_is_identical(tmp_path, monkeypatch):
    """(test_heatmap_overview.py:160) TPU_LD_HEATMAP_FULL=1 keeps the full
    columnar HTML past _OVERVIEW_MIN, in both tools."""
    monkeypatch.setenv("TPU_LD_HEATMAP_FULL", "1")
    for mod in HEATMAPS.values():
        monkeypatch.setattr(mod, "_OVERVIEW_MIN", 20)
    got = _overview(tmp_path, "torch", 30, "r_square", json_too=False)
    assert got == _overview(tmp_path, "jax", 30, "r_square", json_too=False)
    assert '"columnar"' in got["ov_chr1_r.html"].decode()


@pytest.mark.parametrize("tool", sorted(HEATMAPS))
def test_pool_rows_composite_bruteforce(rng, tool):
    """(test_heatmap_overview.py:168) Block-streamed pooling equals
    whole-matrix brute force for any block split, in the port's copy of
    io/heatmap.py as in the JAX package's."""
    hm = HEATMAPS[tool]
    n, f = 29, 4
    P = -(-n // f)
    vals = np.round(rng.random((n, n)) * 2 - 1, 4)
    iz = rng.random((n, n)) < 0.1
    pooled = np.full((P, P), -1, dtype=np.int64)
    for r0 in range(0, n, 7):
        r1 = min(r0 + 7, n)
        hm.pool_rows_composite(pooled, vals[r0:r1, :r1], iz[r0:r1, :r1],
                               r0, r1, f)
    q = np.maximum(np.where(iz, 0, np.rint(vals * 1e4).astype(np.int64)), 0)
    for pi in range(P):
        for pj in range(P):
            best = -1
            for i in range(pi * f, min((pi + 1) * f, n)):
                for j in range(pj * f, min((pj + 1) * f, i)):
                    best = max(best, (q[i, j] << 34) | (i << 17) | j)
            assert pooled[pi, pj] == best


def test_heatmap_copy_keeps_the_jax_constants_and_templates():
    """The port's io/heatmap.py keeps the JAX module's caps, code widths
    and embedded HTML/JS templates byte for byte."""
    for name in ("_HOVER_CELLS_MAX", "_OVERVIEW_MIN", "_OVERVIEW_P",
                 "_POOL_SHIFT", "_Q_WIDTHS", "_HTML_TEMPLATE",
                 "_HTML_TEMPLATE_COLUMNAR", "_HTML_TEMPLATE_OVERVIEW"):
        assert getattr(heatmap, name) == getattr(jax_heatmap, name), name
    assert heatmap._HOVER_CELLS_MAX == 500 and heatmap._OVERVIEW_MIN == 4096
    assert triangle.FOOTER_TEXT == jax_triangle.FOOTER_TEXT


def test_triangle_entry_point_writes_the_jax_files(env, tmp_path):
    argv = ["-S", env.src, "-D", env.intgen, "-f", "-t",
            str(tmp_path / "torch"), "-o", "both", "-j", "-E", "torch"]
    stats = {}
    assert torch_ld_triangle.main(argv, stats) == 2 == stats["matrices"]
    jax_triangle.run(_args(env, str(tmp_path / "jax")))
    assert _tree(str(tmp_path / "torch")) == _tree(str(tmp_path / "jax"))


def test_multiplexer_triangle_writes_the_jax_files(env, tmp_path, capsys,
                                                  monkeypatch):
    """``python -m ld_tools_tpu_torch triangle ... -E torch`` is
    ld_triangle's entry point; its launch report follows the run."""
    monkeypatch.setattr(sys, "argv", list(sys.argv))
    assert multiplexer.main(["triangle", "-S", env.src, "-D", env.intgen,
                             "-f", "-t", str(tmp_path / "torch"), "-o",
                             "table", "-E", "torch"]) == 0
    report = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert report["engine"] == engine.count_on_device.launches
    jax_triangle.run(_args(env, str(tmp_path / "jax"), matrix_type="table"))
    assert _tree(str(tmp_path / "torch")) == _tree(str(tmp_path / "jax"))


def test_multiplexer_help_lists_tpu_ld_commands():
    """``--help`` lists tpu_ld.py's commands with its descriptions; an
    unknown command exits 2."""
    sys.path.insert(0, REPO)
    try:
        import tpu_ld
    finally:
        sys.path.remove(REPO)
    assert multiplexer.COMMANDS == tpu_ld.COMMANDS
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-m", "ld_tools_tpu_torch",
                          "--help"], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    for name, (_, desc) in tpu_ld.COMMANDS.items():
        assert f"  {name:<9} {desc}" in out.stdout
    assert multiplexer.main(["nope"]) == 2


def test_multiplexer_prep_packs_the_store(tmp_path, capsys):
    """``prep -D`` runs the port's own ingest (scripts/prep_data.py's
    stage): the conversion db and the packed store appear."""
    from ld_tools_tpu_torch.ingest import HaplotypeStore, synth

    d = str(tmp_path)
    synth.generate_dataset(d, n_samples=6, chrom_variant_counts={"3": 5},
                           seed=1)
    assert multiplexer.main(["prep", "-D", d]) == 0
    assert capsys.readouterr().out.startswith("ready: ")
    assert os.path.exists(tmp_path / "conversion.db")
    assert HaplotypeStore(d).chrom("3").pos.shape == (5,)


def test_triangle_raises_without_a_card_before_prep(monkeypatch, tmp_path):
    """-E cuda (the default) with no card raises before any data
    preparation, from the entry point and from the multiplexer."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", list(sys.argv))
    argv = ["-S", str(tmp_path), "-D", str(tmp_path)]
    with pytest.raises(RuntimeError, match="no CUDA card"):
        torch_ld_triangle.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        multiplexer.main(["triangle"] + argv)
    assert not os.path.exists(tmp_path / "conversion.db")
