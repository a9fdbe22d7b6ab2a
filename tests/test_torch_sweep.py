"""The port's all-pairs sweeps (parallel/sweep.py) and LD math
(ops/ld_math.py) on the CPU against the JAX package's.

Mirrors tests/test_sharding.py: replicated, ring and trapezoid sweeps at 2
and 4 shards, plus ragged V.  The JAX references run in one child process
with 4 virtual CPU devices and no FMA instructions (see
test_torch_ld_kernels), so f32 values agree within 1e-6.  Integer counts
are exact, and every sharded sweep of the port equals its one-device
sweep bit for bit (each band-by-block product is the same count and
epilogue).
"""

import numpy as np
import pytest
import torch

from ld_tools_tpu_torch.ops import ld_math as tm
from ld_tools_tpu_torch.parallel import (
    all_pairs_replicated,
    all_pairs_ring,
    all_pairs_trapezoid,
    make_mesh,
)

from .conftest import random_haplotypes
from .test_torch_ld_kernels import assert_f32_close, deferred, jax_without_fma

SWEEP = "ld_tools_tpu.parallel.sweep"
MATH = "ld_tools_tpu.ops.ld_math"
SWEEPS = {"replicated": all_pairs_replicated, "ring": all_pairs_ring,
          "trapezoid": all_pairs_trapezoid}
SHARDS = [2, 4]


def _reference_G():
    G = random_haplotypes(np.random.default_rng(8), 100, 96, maf_low=0.05,
                          maf_high=0.95)
    G[3] = 0
    G[4] = 1
    G[5] = 0
    G[5, 7] = 1
    return G


def _ragged_G(seed, v):
    return random_haplotypes(np.random.default_rng(seed), v, 64,
                             maf_low=0.1, maf_high=0.9)


RAGGED = {"replicated": (13, 37), "ring": (13, 37), "trapezoid": (99, 53)}


def _math_inputs():
    rng = np.random.default_rng(21)
    g1 = random_haplotypes(rng, 23, 53, maf_low=0.02, maf_high=0.98)
    g2 = random_haplotypes(rng, 17, 53, maf_low=0.02, maf_high=0.98)
    g1[0] = 0
    g2[1] = 1
    return g1, g2


@pytest.fixture(scope="module")
def jax_refs():
    """Every JAX reference of this module, from one child process."""
    calls = {}
    G = _reference_G()
    for name in SWEEPS:
        for n in SHARDS:
            calls[name, n] = (SWEEP, f"all_pairs_{name}", (G,), {
                "mesh": deferred(SWEEP, "make_mesh", n)})
        seed, v = RAGGED[name]
        calls[name, "ragged"] = (SWEEP, f"all_pairs_{name}",
                                 (_ragged_G(seed, v),),
                                 {"mesh": deferred(SWEEP, "make_mesh", 4)})
    calls["ring", "n120"] = (SWEEP, "all_pairs_ring", (G,), {
        "n_haplotypes": 120, "mesh": deferred(SWEEP, "make_mesh", 1)})
    g1, g2 = _math_inputs()
    calls["counts_int8"] = (MATH, "haplotype_counts_int8", (g1, g2), {})
    calls["counts"] = (MATH, "haplotype_counts", (g1, g2), {})
    calls["allele_counts"] = (MATH, "allele_counts", (g1,), {})
    calls["ld_block"] = (MATH, "ld_block", (g1, g2), {})
    calls["ld_block_n"] = (MATH, "ld_block", (g1, g2), {"n_haplotypes": 60})
    x = np.random.default_rng(3).random(200).astype(np.float32)
    calls["round4"] = (MATH, "round4_f32", (x,), {})
    out = jax_without_fma(list(calls.values()), n_devices=4)
    return dict(zip(calls, out))


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_sweep_matches_jax(jax_refs, name, n):
    G = _reference_G()
    r2, dp = SWEEPS[name](G, mesh=["cpu"] * n)
    want_r2, want_dp = jax_refs[name, n]
    assert r2.shape == dp.shape == (100, 100)
    assert_f32_close(r2.numpy(), want_r2)
    assert_f32_close(dp.numpy(), want_dp)
    if name == "trapezoid":
        assert torch.all(torch.triu(r2, 1) == 0)


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_ragged_sweep_matches_jax(jax_refs, name):
    seed, v = RAGGED[name]
    r2, dp = SWEEPS[name](_ragged_G(seed, v), mesh=["cpu"] * 4)
    want_r2, want_dp = jax_refs[name, "ragged"]
    assert r2.shape == (v, v)
    assert_f32_close(r2.numpy(), want_r2)
    assert_f32_close(dp.numpy(), want_dp)


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_sharded_sweep_equals_one_device(name, n):
    """Every shard layout gives the one-device values bit for bit (the
    trapezoid its lower triangle, zero above)."""
    G = _reference_G()
    one_r2, one_dp = all_pairs_replicated(G, mesh=["cpu"])
    r2, dp = SWEEPS[name](G, mesh=["cpu"] * n)
    if name == "trapezoid":
        one_r2, one_dp = torch.tril(one_r2), torch.tril(one_dp)
        dp = dp + 0.0  # the masked cells hold -0.0 where D' < 0, as in JAX
    assert torch.equal(r2, one_r2)
    assert torch.equal(dp, one_dp)


def test_sweep_n_haplotypes_matches_jax(jax_refs):
    """An explicit n_haplotypes (zero-padded haplotype axis) reaches the
    epilogue as in JAX, where the traced n makes XLA multiply by 1/n."""
    r2, dp = all_pairs_ring(_reference_G(), n_haplotypes=120, mesh=["cpu"])
    want_r2, want_dp = jax_refs["ring", "n120"]
    assert_f32_close(r2.numpy(), want_r2)
    assert_f32_close(dp.numpy(), want_dp)


def test_make_mesh():
    assert make_mesh(3, device="cpu") == [torch.device("cpu")] * 3
    assert make_mesh(device="cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError, match="mix"):
        all_pairs_replicated(_reference_G(), mesh=["cpu", "meta"])


def test_counts_match_jax(jax_refs):
    g1, g2 = (torch.from_numpy(g) for g in _math_inputs())
    got = tm.haplotype_counts_int8(g1, g2)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), jax_refs["counts_int8"])
    got = tm.haplotype_counts(g1, g2)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), jax_refs["counts"])
    np.testing.assert_array_equal(tm.allele_counts(g1).numpy(),
                                  jax_refs["allele_counts"])


@pytest.mark.parametrize("n_haplotypes", [None, 60])
def test_ld_block_matches_jax(jax_refs, n_haplotypes):
    g1, g2 = (torch.from_numpy(g) for g in _math_inputs())
    got = tm.ld_block(g1, g2, n_haplotypes=n_haplotypes)
    want = jax_refs["ld_block" if n_haplotypes is None else "ld_block_n"]
    assert sorted(got) == sorted(want)
    for key in want:
        assert_f32_close(got[key].numpy(), want[key])


def test_round4_matches_jax(jax_refs):
    x = np.random.default_rng(3).random(200).astype(np.float32)
    got = tm.round4_f32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, jax_refs["round4"])


def test_counts_pad_for_the_card_shapes():
    """The operands' zero padding (``torch._int_mm`` wants multiples of 8
    and more than 16 rows) leaves the counts as they are."""
    rng = np.random.default_rng(4)
    a = torch.from_numpy(random_haplotypes(rng, 5, 13))
    b = torch.from_numpy(random_haplotypes(rng, 3, 13))
    want = a.to(torch.int64) @ b.to(torch.int64).t()
    ap = tm._pad2(a, 24, 16)
    bp = tm._pad2(b, 8, 16)
    got = (ap.to(torch.int64) @ bp.to(torch.int64).t())[:5, :3]
    assert torch.equal(got, want)
    assert torch.equal(tm.haplotype_counts_int8(a, b).to(torch.int64), want)
