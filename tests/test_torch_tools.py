"""The port's ld_lite and ld_area (-E torch, on the CPU) against the JAX
tools on the same synthetic stores: ld_lite's table string and ld_area's
TSV, JSON and rsIDs files must be byte-identical, on autosomes and on
chrX/chrY (mixed ploidy), and the errors the same.  Mirrors
tests/test_tools_e2e.py and tests/test_ploidy_e2e.py.  Also the ported
CLIs' RU/EN identity and flag surface (tests/test_cli.py; ld_triangle's
too), and -E cuda raising without a card before anything is prepared.
"""

import os
import types

import numpy as np
import pytest
import torch

from ld_tools_tpu.cli import _shared as jax_shared
from ld_tools_tpu.ingest import prep_intgen_data, synth
from ld_tools_tpu.ops import engine as jax_engine
from ld_tools_tpu.tools import area as jax_area
from ld_tools_tpu.tools import common as jcommon
from ld_tools_tpu.tools import lite as jax_lite
from ld_tools_tpu_torch import ld_area as torch_ld_area
from ld_tools_tpu_torch import ld_lite as torch_ld_lite
from ld_tools_tpu_torch.cli import _shared
from ld_tools_tpu_torch.ops import engine
from ld_tools_tpu_torch.tools import area, lite
from ld_tools_tpu_torch.tools import common as tcommon


@pytest.fixture(params=["host", "device"])
def counts(request, monkeypatch):
    """Which side of the engines' host cutoff the stores' jobs take: as
    they are (host f32 BLAS: the stores are small), or the device path
    of both engines (the cutoff set to 0 in both)."""
    if request.param == "device":
        for eng in (engine, jax_engine):
            monkeypatch.setattr(eng, "_HOST_COUNTS_MACS", 0)
    return request.param


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """tests/test_tools_e2e.py's autosome store and query file."""
    d = str(tmp_path_factory.mktemp("intgen"))
    rs_by_chrom = synth.generate_dataset(
        d, n_samples=25, chrom_variant_counts={"5": 18, "11": 7}, seed=42
    )
    prep_intgen_data(d)
    src = str(tmp_path_factory.mktemp("src"))
    all_rs = list(rs_by_chrom["5"]) + list(rs_by_chrom["11"])
    with open(os.path.join(src, "query.txt"), "w") as fh:
        fh.write("\n".join(all_rs) + "\n")
    return types.SimpleNamespace(intgen=d, rs_by_chrom=rs_by_chrom, src=src)


@pytest.fixture(scope="module")
def xenv(tmp_path_factory):
    """tests/test_ploidy_e2e.py's chrX (males haploid outside the PAR
    bands) and chrY (male-only, haploid) store and query file."""
    d = str(tmp_path_factory.mktemp("intgen_x"))
    rng = np.random.default_rng(77)
    panel = synth.make_panel(24, rng)
    panel[0] = (panel[0][0], panel[0][1], panel[0][2], "male")
    panel[1] = (panel[1][0], panel[1][1], panel[1][2], "female")
    synth.write_panel(os.path.join(d, "samples.txt"), panel)
    names = [r[0] for r in panel]
    genders = [r[3] for r in panel]
    GX, hapX = synth.make_chrx_layout(rng, 36, genders,
                                      par_bounds=(0.25, 0.75))
    rs_x = synth.write_vcf(os.path.join(d, "X.vcf.gz"), "X", names, GX,
                           haploid_masks=hapX)
    male_names = [n for n, g in zip(names, genders) if g == "male"]
    GY = synth.correlated_haplotypes(rng, 12, 2 * len(male_names))
    GY[:, 1::2] = 0
    rs_y = synth.write_vcf(
        os.path.join(d, "Y.vcf.gz"), "Y", male_names, GY,
        haploid_masks=np.ones((12, len(male_names)), dtype=bool),
        pos_step=500, rsids=[f"rs9{i:04d}" for i in range(12)],
    )
    prep_intgen_data(d)
    src = str(tmp_path_factory.mktemp("src_x"))
    with open(os.path.join(src, "query.txt"), "w") as fh:
        fh.write("\n".join(list(rs_x) + list(rs_y)) + "\n")
    return types.SimpleNamespace(intgen=d, src=src, rs_x=list(rs_x),
                                 rs_y=list(rs_y))


def _lite_args(intgen, rs1, rs2, **kw):
    return types.SimpleNamespace(
        rs_id_1=rs1, rs_id_2=rs2, intgen_dir_path=intgen,
        skip_intgen_data_ver=True, gend_names=kw.get("gend_names", "both"),
        pop_names=kw.get("pop_names", "all"), engine="torch",
    )


def _both_lite(intgen, rs1, rs2, **kw):
    args = _lite_args(intgen, rs1, rs2, **kw)
    return lite.run(args), jax_lite.run(args)


def test_lite_table_is_identical(env, counts):
    rs = list(env.rs_by_chrom["5"])
    for a, b in ((rs[0], rs[3]), (rs[5], rs[1]), (rs[2], rs[2])):
        got, want = _both_lite(env.intgen, a, b)
        assert got == want and a in got


def test_lite_chrx_cross_region_and_chry_tables_are_identical(xenv, counts):
    """PAR x PAR, non-PAR x non-PAR, PAR x non-PAR both ways (lists of
    unequal length) and a chrY pair (test_ploidy_e2e.py:119, :134)."""
    rs = xenv.rs_x
    par, nonpar = rs[2], rs[18]
    for a, b in ((rs[0], par), (rs[12], nonpar), (par, nonpar),
                 (nonpar, par)):
        got, want = _both_lite(xenv.intgen, a, b)
        assert got == want, (a, b)
    got, want = _both_lite(xenv.intgen, xenv.rs_y[0], xenv.rs_y[5])
    assert got == want
    got, want = _both_lite(xenv.intgen, xenv.rs_y[0], xenv.rs_y[5],
                           gend_names="male")
    assert got == want


def test_lite_errors_are_the_jax_tool_errors(env):
    """(test_tools_e2e.py:74, :504) The same exception types, raised by
    the port's own copies of them."""
    rs5 = list(env.rs_by_chrom["5"])
    rs11 = list(env.rs_by_chrom["11"])
    for pair, exc in (
            (("notanid", "rs10001"), tcommon.NotRsIdError),
            (("rs999999999", "rs10001"), tcommon.NotInIntgenConvDbError),
            ((rs5[0], rs11[0]), tcommon.DifChrsError)):
        with pytest.raises(exc):
            lite.run(_lite_args(env.intgen, *pair))
        with pytest.raises(getattr(jcommon, exc.__name__)):
            jax_lite.run(_lite_args(env.intgen, *pair))
    with pytest.raises(ValueError, match="no samples match"):
        lite.run(_lite_args(env.intgen, rs5[0], rs5[1], pop_names="ZZZ"))


def test_lite_entry_point_prints_the_table(env, capsys):
    rs = list(env.rs_by_chrom["5"])
    table = torch_ld_lite.main([rs[0], rs[3], "-D", env.intgen, "-f",
                                "-E", "torch"])
    assert capsys.readouterr().out == table + "\n"
    assert table == jax_lite.run(_lite_args(env.intgen, rs[0], rs[3]))


def _area_args(src, intgen, trg, **kw):
    return types.SimpleNamespace(
        src_dir_path=src, intgen_dir_path=intgen, trg_top_dir_path=trg,
        meta_lines_quan=0, skip_intgen_data_ver=True,
        gend_names=kw.get("gend_names", "both"), pop_names="all",
        flank_size=kw.get("flank_size", 10**6),
        ld_thres_measure=kw.get("measure", "r_square"),
        ld_low_thres=kw.get("thres", 0.5),
        trg_file_type=kw.get("file_type", "tsv"),
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


def _both_area(tmp_path, src, intgen, **kw):
    got_dir, want_dir = str(tmp_path / "torch"), str(tmp_path / "jax")
    n_got = area.run(_area_args(src, intgen, got_dir, **kw))
    n_want = jax_area.run(_area_args(src, intgen, want_dir, **kw))
    got, want = _tree(got_dir), _tree(want_dir)
    assert n_got == n_want == len(want)
    assert got == want
    return got


@pytest.mark.parametrize("file_type", ["tsv", "json", "rsids"])
@pytest.mark.parametrize("measure,thres", [("r_square", 0.5),
                                           ("d_prime", 0.9)])
def test_area_files_are_identical(env, tmp_path, file_type, measure, thres,
                                  counts):
    """(test_tools_e2e.py:102, :148)"""
    got = _both_area(tmp_path, env.src, env.intgen, file_type=file_type,
                     measure=measure, thres=thres)
    assert got
    assert all(name.startswith("query_in_LD") for name in got)


@pytest.mark.parametrize("file_type", ["tsv", "json", "rsids"])
def test_area_chrx_chry_files_are_identical(xenv, tmp_path, file_type,
                                            counts):
    """Pair-dependent opponent frequencies and own-list query frequency
    on chrX, the haploid chrY (test_ploidy_e2e.py:143, :443)."""
    got = _both_area(tmp_path, xenv.src, xenv.intgen, file_type=file_type,
                     thres=0.3, max_proc_quan=1)
    assert any(os.sep + "X" + os.sep in n for n in got)
    assert any(os.sep + "Y" + os.sep in n for n in got)


def test_area_grouping_invariant(env, tmp_path, monkeypatch):
    """(test_tools_e2e.py:178) One-query groups give the bytes of the
    default grouping, which are the JAX tool's."""
    wide = _both_area(tmp_path / "wide", env.src, env.intgen, thres=0.2,
                      flank_size=40_000)
    monkeypatch.setattr(area, "_DENSE_CELL_LIMIT", 1)
    narrow_dir = str(tmp_path / "narrow")
    area.run(_area_args(env.src, env.intgen, narrow_dir, thres=0.2,
                        flank_size=40_000))
    assert wide and _tree(narrow_dir) == wide
    assert area._DENSE_CELL_LIMIT == 1


def test_area_high_threshold_writes_nothing(env, tmp_path):
    """(test_tools_e2e.py:199)"""
    assert area.run(_area_args(env.src, env.intgen, str(tmp_path),
                               thres=1.1)) == 0
    chr_dir = os.path.join(str(tmp_path), "query_in_LD", "5")
    assert os.path.isdir(chr_dir) and os.listdir(chr_dir) == []


def test_area_max_proc_gives_the_same_files(env, tmp_path):
    """(test_tools_e2e.py:436) -p 1 and -p 4 over four source files give
    the same files, which are the JAX tool's."""
    src = str(tmp_path / "multi_src")
    os.makedirs(src)
    rs5 = list(env.rs_by_chrom["5"])
    rs11 = list(env.rs_by_chrom["11"])
    for k, sel in enumerate((rs5[:6], rs5[6:14], rs11, rs5[::2])):
        with open(os.path.join(src, f"q{k}.txt"), "w") as fh:
            fh.write("\n".join(sel) + "\n")
    p4 = _both_area(tmp_path / "p4", src, env.intgen, thres=0.3,
                    max_proc_quan=4)
    p1_dir = str(tmp_path / "p1")
    area.run(_area_args(src, env.intgen, p1_dir, thres=0.3, max_proc_quan=1))
    assert p4 and _tree(p1_dir) == p4


def test_area_entry_point_writes_the_jax_files(env, tmp_path):
    argv = ["-S", env.src, "-D", env.intgen, "-f", "-t",
            str(tmp_path / "torch"), "-z", "0.5", "-E", "torch"]
    stats = {}
    n = torch_ld_area.main(argv, stats)
    # one file, two chromosomes: one group each
    assert stats["groups"] == 2 and stats["write_s"] > 0
    jax_area.run(_area_args(env.src, env.intgen, str(tmp_path / "jax"),
                            flank_size=100_000))
    assert n > 0 and _tree(str(tmp_path / "torch")) == _tree(
        str(tmp_path / "jax"))


def test_tools_raise_without_a_card_before_prep(monkeypatch, tmp_path):
    """-E cuda (the default) with no card raises before any data
    preparation, for ld_lite as for ld_area."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        torch_ld_lite.main(["rs1", "rs2", "-D", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        torch_ld_area.main(["-S", str(tmp_path), "-D", str(tmp_path)])
    assert not os.path.exists(tmp_path / "conversion.db")


def _signature(parser):
    """(option_strings, dest, default, choices, type) per action."""
    return [(tuple(a.option_strings), a.dest, a.default,
             tuple(a.choices) if a.choices else None, a.type)
            for a in parser._actions if a.dest != "help"]


def _texts(tool):
    from importlib import import_module

    return [import_module(f"ld_tools_tpu_torch.cli.ld_{tool}_cli_{lang}").TEXT
            for lang in ("en", "ru")]


@pytest.mark.parametrize("tool", ["lite", "area", "triangle"])
def test_ru_en_parsers_identical(tool):
    """(test_cli.py:29) RU and EN build one flag surface."""
    build = getattr(_shared, f"build_{tool}_parser")
    en, ru = _texts(tool)
    assert set(en) == set(ru)
    assert _signature(build("V", en)) == _signature(build("V", ru))


@pytest.mark.parametrize("tool", ["lite", "area", "triangle"])
def test_flag_surface_is_jax_plus_engine(tool):
    """(test_cli.py:41) The JAX tool's flags, names, defaults and
    choices, and -E/--engine {cuda, torch} (default cuda) beside them."""
    from importlib import import_module

    jax_text = import_module(f"ld_tools_tpu.cli.ld_{tool}_cli_en").TEXT
    got = _signature(getattr(_shared, f"build_{tool}_parser")(
        "V", _texts(tool)[0]))
    want = _signature(getattr(jax_shared, f"build_{tool}_parser")(
        "V", jax_text))
    assert got[:-1] == want
    assert got[-1] == (("-E", "--engine"), "engine", "cuda",
                       ("cuda", "torch"), str)


def test_parse_args_roundtrip():
    """(test_cli.py:86)"""
    from ld_tools_tpu_torch.cli.ld_area_cli_en import add_args_en
    from ld_tools_tpu_torch.cli.ld_lite_cli_ru import add_args_ru

    args = add_args_en("V", ["-S", "/src", "-D", "/data", "-f", "-w",
                             "50000", "-z", "0.9", "-o", "json", "-e",
                             "eur,gbr", "-E", "torch"])
    assert (args.src_dir_path, args.skip_intgen_data_ver, args.flank_size,
            args.ld_low_thres, args.trg_file_type, args.pop_names,
            args.engine) == ("/src", True, 50000, 0.9, "json", "eur,gbr",
                             "torch")
    args = add_args_ru("V", ["rs1", "rs2"])
    assert (args.rs_id_1, args.rs_id_2, args.engine) == ("rs1", "rs2",
                                                         "cuda")
