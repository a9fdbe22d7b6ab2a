"""The port's ld_scan tool on the CPU (-E torch) against the JAX tool
(engine xla): the same store in, a byte-identical TSV out.  Also: the
port's ingest copies write the same store bytes as the JAX package's."""

import os
import types

import pytest

from ld_tools_tpu.ingest import prep_intgen_data, synth
from ld_tools_tpu.tools import scan as jax_scan
from ld_tools_tpu_torch import ld_scan as torch_ld_scan
from ld_tools_tpu_torch.ingest import prep as torch_prep

CHROMS = {"5": 90, "11": 40}


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("intgen"))
    synth.generate_dataset(d, n_samples=30, chrom_variant_counts=CHROMS,
                           seed=7)
    prep_intgen_data(d)
    return d


def _jax_args(store, trg, measure, thres, max_dist, gend_names):
    return types.SimpleNamespace(
        chroms="all", trg_dir_path=trg, intgen_dir_path=store,
        skip_intgen_data_ver=True, gend_names=gend_names, pop_names="all",
        ld_measure=measure, ld_low_thres=thres, max_dist=max_dist,
        checkpoint_dir=None, devices=None, engine="xla",
    )


def _read_all(trg):
    return {name: open(os.path.join(trg, name), "rb").read()
            for name in sorted(os.listdir(trg))}


@pytest.mark.parametrize("measure,thres", [("r_square", 0.5),
                                           ("d_prime", 0.8)])
@pytest.mark.parametrize("max_dist", [None, 12_000])
@pytest.mark.parametrize("gend_names", ["both", "male"])
def test_scan_tsv_is_byte_identical(store, tmp_path, measure, thres,
                                    max_dist, gend_names):
    want_dir = str(tmp_path / "jax")
    got_dir = str(tmp_path / "torch")
    jax_scan.run(_jax_args(store, want_dir, measure, thres, max_dist,
                           gend_names))
    argv = ["-C", "all", "-D", store, "-t", got_dir, "-f", "-E", "torch",
            "-l", measure, "-z", str(thres), "-g", gend_names]
    if max_dist is not None:
        argv += ["-w", str(max_dist)]
    reports = torch_ld_scan.main(argv)
    assert sorted(r.chrom for r in reports) == sorted(CHROMS)
    want, got = _read_all(want_dir), _read_all(got_dir)
    assert list(got) == list(want) and len(want) == len(CHROMS)
    for name in want:
        assert got[name] == want[name], name
    assert sum(r.n_hits for r in reports) > 0
    assert all(r.stats["blocks"] > 0 for r in reports)


def test_port_ingest_writes_the_same_store(tmp_path):
    """Both packages prepare the same VCFs into byte-identical stores."""
    dirs = []
    for name, prep in (("jax", prep_intgen_data),
                       ("torch", torch_prep.prep_intgen_data)):
        d = str(tmp_path / name)
        synth.generate_dataset(d, n_samples=12,
                               chrom_variant_counts={"3": 25}, seed=3)
        prep(d)
        dirs.append(os.path.join(d, "tpu_store"))
    files = []
    for root, _, names in os.walk(dirs[0]):
        files += [os.path.relpath(os.path.join(root, n), dirs[0])
                  for n in names]
    assert len(files) >= 7
    for rel in sorted(files):
        with open(os.path.join(dirs[0], rel), "rb") as a, \
                open(os.path.join(dirs[1], rel), "rb") as b:
            assert a.read() == b.read(), rel
