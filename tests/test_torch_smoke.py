"""The port's kernel smoke suite (ld_tools_tpu_torch/bench/smoke.py) on the
CPU, through the plain versions: the JAX script's 17 configurations in its
order, all ok, with the artifact; a plain version broken on purpose fails
its rows and the exit code; the f32 mirror is the JAX script's."""

import json
import os
import re

import numpy as np
import pytest
import torch

from ld_tools_tpu_torch.bench import smoke
from ld_tools_tpu_torch.ops import ld_kernels as tk
from scripts import tpu_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V = 200


def _jax_names():
    """The configuration names of scripts/tpu_smoke.py, in its order, but
    its two Mosaic probes."""
    with open(os.path.join(REPO, "scripts", "tpu_smoke.py")) as fh:
        src = fh.read()
    return re.findall(r'\(\s*"((?:tri|band|count_fused)_[a-z0-9_]+)"', src)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    path = tmp_path_factory.mktemp("smoke") / "smoke.json"
    tk.reset_launches()
    code = smoke.main(["--device", "cpu", "--v", str(V), "--out", str(path)])
    with open(path) as fh:
        return code, json.load(fh)


def test_the_seventeen_jax_configurations_pass(artifact):
    code, art = artifact
    assert code == 0 and art["failures"] == 0
    names = [r["config"] for r in art["results"]]
    assert names == _jax_names() == smoke.NAMES and len(names) == 17
    assert all(r["ok"] for r in art["results"])
    for r in art["results"]:
        if not r["config"].startswith("count_fused"):
            assert r["max_abs_err_vs_f32_order"] <= (
                smoke.MEAS_TOL if "meas" in r["config"] else smoke.TOL)
    # integer outputs are exact
    assert all(r["max_abs_err_vs_f32_order"] == 0 for r in art["results"]
               if r["config"].endswith("_cab"))
    assert "note" not in json.dumps(art["results"])


def test_the_artifact_names_its_device_and_the_probes(artifact):
    _, art = artifact
    meta = art["meta"]
    assert meta["backend"] == "cpu" and meta["v"] == V and meta["h"] == 5008
    assert meta["devices"][0].startswith("device: cpu")
    assert "no counterpart" in meta["probes"]
    assert set(art) == {"meta", "results", "failures"}


def _shifted(fn):
    """``fn`` with its first output moved by one unit (a count) or 1e-4
    (an f32 value)."""
    def broken(*args, **kw):
        out = fn(*args, **kw)
        if isinstance(out, tuple):  # the triangle: (r2, dp or None)
            return (out[0] + 1e-4,) + tuple(out[1:])
        if isinstance(out, dict):   # the band sweep: {name: tensor}
            return {k: v + 1 for k, v in out.items()}
        return out + 1              # the count pass
    return broken


def _raising(fn):
    def broken(*args, **kw):
        raise ArithmeticError("broken on purpose")
    return broken


@pytest.mark.parametrize("plain,how,failed", [
    ("ld_triangle_blocks_plain", _shifted,
     ["tri_dense_exact_dp", "tri_dense_fast", "tri_dense_fast_b640",
      "tri_packed_dense_exact_dp", "tri_packed_dense_fast"]),
    ("ld_band_sweep_blocks_packed_plain", _shifted,
     ["band_packed_count_cab", "band_packed_fetch_fast"]),
    ("ld_band_count_plain", _shifted,
     ["count_fused_dense_r2", "count_fused_dense_dp_dist"]),
    ("ld_band_count_packed_plain", _raising, ["count_fused_packed_r2"]),
])
def test_a_broken_plain_version_fails_its_rows(plain, how, failed, tmp_path,
                                               monkeypatch):
    monkeypatch.setattr(tk, plain, how(getattr(tk, plain)))
    path = tmp_path / "smoke.json"
    assert smoke.main(["--device", "cpu", "--v", "130", "--out",
                       str(path)]) == 1
    with open(path) as fh:
        art = json.load(fh)
    assert [r["config"] for r in art["results"] if not r["ok"]] == failed
    assert art["failures"] == len(failed)
    if how is _raising:
        (row,) = [r for r in art["results"] if not r["ok"]]
        assert row["note"] == "ArithmeticError: broken on purpose"


@pytest.mark.parametrize("epilogue", ["exact", "fast"])
def test_the_f32_mirror_is_the_jax_scripts(epilogue):
    rng = np.random.default_rng(7)
    G = (rng.random((60, 5008)) < rng.uniform(0, 1, (60, 1))).astype(np.int8)
    G[0] = 0
    G[1] = 1
    cab, c1 = smoke.oracle_counts(G)
    want_cab, want_c1 = tpu_smoke.oracle_counts(G)
    np.testing.assert_array_equal(cab, want_cab)
    np.testing.assert_array_equal(c1, want_c1)
    got = smoke.oracle_epilogue_f32(cab, c1, c1, 5008, epilogue)
    want = tpu_smoke.oracle_epilogue_f32(cab, c1, c1, 5008, epilogue)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        else:
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)


def test_the_mirror_holds_the_plain_epilogue_within_tol():
    """The mirror agrees with the port's plain epilogue (the CPU's
    kernel stand-in) within TOL."""
    rng = np.random.default_rng(8)
    G = (rng.random((40, 5008)) < rng.uniform(0, 1, (40, 1))).astype(np.int8)
    r2, dp = tk.ld_triangle_matrix(torch.from_numpy(G), 5008, block_m=128,
                                   block_n=128)
    cab, c1 = smoke.oracle_counts(G)
    want_r2, want_dp = smoke.oracle_epilogue_f32(cab, c1, c1, 5008, "exact")
    tril = np.tril_indices(40, -1)
    assert np.abs(r2.numpy()[tril] - want_r2[tril]).max() <= smoke.TOL
    assert np.abs(dp.numpy()[tril] - want_dp[tril]).max() <= smoke.TOL
