"""The port's bit-plane kernel sites (K2, K4, K6: the store's bitpacked
bytes) and the bf16 / f32 triangle routes (K1b), plain versions on the
CPU, against ld_tools_tpu.ops.ld_pallas in interpret mode.

Integer outputs (counts, per-block hit counts) must be exactly equal.
f32 values are held to 1e-6 abs against the JAX functions run in one
child process without FMA (see test_torch_ld_kernels).  Each packed site
must also give its dense twin's outputs bit for bit on the unpacked rows,
and K1b must give K1's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ld_tools_tpu.ops import ld_pallas as jk
from ld_tools_tpu_torch.ops import ld_kernels as tk

from .test_torch_ld_kernels import (PALLAS, _haplotypes, _padded,
                                    assert_f32_close, jax_without_fma)

TRI_SHAPES = [(20, 77, 128), (130, 150, 128)]
TRI_EPILOGUES = [("exact", True), ("exact", False), ("fast", False)]
TRI_KERNELS = ["dense", "bitplane"]
MXU_DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
              "float32": (jnp.float32, torch.float32)}
SWEEP_OUTS = [(("cab",), 0), (("r2", "dp"), 0), (("meas",), 0),
              (("meas",), 1), (("cab", "meas", "r2", "dp"), 1)]


def _packed(g, h, width=128):
    """The bitpacked bytes of the first h columns of int8 rows g, padded
    to ``width`` bytes (the JAX packed kernels take a 128-multiple)."""
    gp = np.zeros((g.shape[0], width), dtype=np.uint8)
    b = tk.pack_rows(g[:, :h])
    gp[:, :b.shape[1]] = b
    return gp


def _tri_input(v, h):
    return _haplotypes(np.random.default_rng(v), v, h)


def _sweep_input():
    g, c1, ipq, pos, h = _padded(np.random.default_rng(45), 45, 77, 48, 128)
    return g, _packed(g, h), c1, ipq, h


def _lower(v, block):
    b = np.arange(v) // min(block, -(-v // 128) * 128)
    return b[:, None] >= b[None, :]


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX result of every f32 case of this module, keyed by case,
    all from one child process without FMA."""
    calls = {}
    for v, h, block in TRI_SHAPES:
        G = _tri_input(v, h)
        for epilogue, want_dprime in TRI_EPILOGUES:
            kw = dict(interpret=True, block_m=block, block_n=block,
                      want_dprime=want_dprime, epilogue=epilogue)
            for kernel in TRI_KERNELS:
                calls["tri_packed", kernel, v, h, block, epilogue,
                      want_dprime] = (
                    PALLAS, "ld_triangle_matrix_packed",
                    (tk.pack_rows(G), h), dict(kernel=kernel, **kw))
            for name, (jdt, _) in MXU_DTYPES.items():
                calls["tri_mxu", name, v, h, block, epilogue,
                      want_dprime] = (
                    PALLAS, "ld_triangle_matrix", (G,),
                    dict(mxu_dtype=jdt, **kw))
    _, gp, c1, ipq, h = _sweep_input()
    for outs, sel in SWEEP_OUTS:
        calls["sweep", outs, sel] = (
            PALLAS, "ld_band_sweep",
            (gp[:32], gp, c1[:32], c1, ipq[:32], ipq, h),
            dict(packed=True, outs=outs, sel=sel, block_m=16, block_n=16,
                 interpret=True))
    calls["band_pallas"] = (PALLAS, "ld_band_pallas_packed",
                            (gp[:16], gp, c1[:16], c1, h),
                            dict(block_m=16, block_n=16, interpret=True))
    return dict(zip(calls, jax_without_fma(list(calls.values()))))


@pytest.mark.parametrize("v,h,block", TRI_SHAPES)
@pytest.mark.parametrize("epilogue,want_dprime", TRI_EPILOGUES)
@pytest.mark.parametrize("kernel", TRI_KERNELS)
def test_triangle_matrix_packed_matches_pallas(jax_ref, v, h, block,
                                               epilogue, want_dprime, kernel):
    G = _tri_input(v, h)
    kw = dict(block_m=block, block_n=block, want_dprime=want_dprime,
              epilogue=epilogue)
    r2_j, dp_j = jax_ref["tri_packed", kernel, v, h, block, epilogue,
                         want_dprime]
    r2_t, dp_t = tk.ld_triangle_matrix_packed(
        torch.from_numpy(tk.pack_rows(G)), h, kernel=kernel, **kw)
    assert (dp_t is None) == (dp_j is None)
    lower = _lower(v, block)
    assert_f32_close(r2_t.numpy()[lower], r2_j[lower])
    if dp_t is not None:
        assert_f32_close(dp_t.numpy()[lower], dp_j[lower])
    # the packed forms give the unpacked triangle's values bit for bit
    r2_d, dp_d = tk.ld_triangle_matrix(torch.from_numpy(G), **kw)
    assert torch.equal(r2_t, r2_d)
    assert dp_t is None or torch.equal(dp_t, dp_d)


@pytest.mark.parametrize("v,h,block", TRI_SHAPES)
@pytest.mark.parametrize("epilogue,want_dprime", TRI_EPILOGUES)
@pytest.mark.parametrize("mxu", sorted(MXU_DTYPES))
def test_triangle_mxu_dtypes_match_pallas(jax_ref, v, h, block, epilogue,
                                          want_dprime, mxu):
    G = _tri_input(v, h)
    kw = dict(block_m=block, block_n=block, want_dprime=want_dprime,
              epilogue=epilogue)
    r2_j, dp_j = jax_ref["tri_mxu", mxu, v, h, block, epilogue, want_dprime]
    lower = _lower(v, block)
    r2_d, dp_d = tk.ld_triangle_matrix(torch.from_numpy(G), **kw)
    # by name and by torch dtype: the same route
    for dt in (mxu, MXU_DTYPES[mxu][1]):
        r2_t, dp_t = tk.ld_triangle_matrix(torch.from_numpy(G), mxu_dtype=dt,
                                           **kw)
        assert_f32_close(r2_t.numpy()[lower], r2_j[lower])
        if dp_t is not None:
            assert_f32_close(dp_t.numpy()[lower], dp_j[lower])
        # exact counts: K1b's values are K1's bit for bit
        assert torch.equal(r2_t, r2_d)
        assert dp_t is None or torch.equal(dp_t, dp_d)


@pytest.mark.parametrize("outs,sel", SWEEP_OUTS)
def test_band_sweep_packed_matches_pallas(jax_ref, outs, sel):
    g, gp, c1, ipq, h = _sweep_input()
    want = jax_ref["sweep", outs, sel]
    t = {k: torch.from_numpy(x) for k, x in
         dict(g=g, gp=gp, c1=c1, ipq=ipq).items()}
    got = tk.ld_band_sweep(t["gp"][:32], t["gp"], t["c1"][:32], t["c1"],
                           t["ipq"][:32], t["ipq"], h, packed=True, outs=outs,
                           sel=sel, block_m=16, block_n=16)
    dense = tk.ld_band_sweep(t["g"][:32], t["g"], t["c1"][:32], t["c1"],
                             t["ipq"][:32], t["ipq"], h, packed=False,
                             outs=outs, sel=sel, block_m=16, block_n=16)
    assert list(got) == list(outs)
    for o in outs:
        w = want[o]
        a = got[o].numpy()
        assert a.shape == w.shape and a.dtype == w.dtype
        if o == "cab":
            np.testing.assert_array_equal(a, w)
        else:
            assert_f32_close(a, w)
        assert torch.equal(got[o], dense[o]), o


def test_band_pallas_packed_matches(jax_ref):
    _, gp, c1, _, h = _sweep_input()
    got = tk.ld_band_pallas_packed(
        torch.from_numpy(gp[:16]), torch.from_numpy(gp),
        torch.from_numpy(c1[:16]), torch.from_numpy(c1), h, block_m=16,
        block_n=16)
    for a, b in zip(got, jax_ref["band_pallas"]):
        assert a.shape == b.shape
        assert_f32_close(a.numpy(), b)


@pytest.mark.parametrize("exact_mask", [True, False])
@pytest.mark.parametrize("sel", [0, 1])
@pytest.mark.parametrize("use_dist", [False, True])
@pytest.mark.parametrize("block", [8, 16])
def test_band_count_packed_matches_pallas(rng, exact_mask, sel, use_dist,
                                          block):
    v = 61  # ragged: the last real block is partial
    g, c1, ipq, pos, h = _padded(rng, v, 77, 80, 128)
    gp = _packed(g, h)
    nb = -(-v // block)
    bi, bj = np.tril_indices(nb)
    cij = tk.pack_block_coords(bi, bj)
    max_dist = 150_000
    params_i = [h, max_dist if use_dist else 0]
    thres = 0.3 - 5e-4
    want = np.asarray(jk.ld_band_count(
        jnp.asarray(gp), jnp.asarray(c1), jnp.asarray(ipq), jnp.asarray(pos),
        jnp.asarray(cij), jnp.asarray(params_i, dtype=jnp.int32),
        jnp.asarray([thres], dtype=jnp.float32), packed=True, sel=sel,
        exact_mask=exact_mask, use_dist=use_dist, block_m=block,
        block_n=block, interpret=True))
    kw = dict(sel=sel, exact_mask=exact_mask, use_dist=use_dist,
              block_m=block, block_n=block)
    args = (torch.from_numpy(c1), torch.from_numpy(ipq),
            torch.from_numpy(pos), torch.from_numpy(cij), params_i, [thres])
    got = tk.ld_band_count(torch.from_numpy(gp), *args, packed=True, **kw)
    dense = tk.ld_band_count(torch.from_numpy(g), *args, packed=False, **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, dense)
    assert want.sum() > 0


def test_popcount_rows_are_the_alt_counts(rng):
    G = _haplotypes(rng, 30, 77)
    gp = torch.from_numpy(_packed(G, 77, width=16))
    c1 = tk.popcount_rows(gp)
    assert c1.dtype == torch.float32
    np.testing.assert_array_equal(c1.numpy(), G.sum(axis=1))


def test_packed_plain_versions_count_no_launch(rng):
    tk.reset_launches()
    g, c1, ipq, pos, h = _padded(rng, 20, 64, 32, 128)
    gp = torch.from_numpy(_packed(g, h, width=16))
    c1t, ipqt = torch.from_numpy(c1), torch.from_numpy(ipq)
    cij = torch.from_numpy(tk.pack_block_coords([1, 1], [0, 1]))
    tk.ld_band_count(gp, c1t, ipqt, torch.from_numpy(pos), cij, [h, 0],
                     [0.5], packed=True, sel=0, exact_mask=True,
                     use_dist=False, block_m=16, block_n=16)
    tk.ld_band_sweep_blocks_packed(gp, gp, c1t, c1t, ipqt, ipqt, cij, h,
                                   block_m=16, block_n=16)
    tk.ld_triangle_blocks_packed(gp, c1t, ipqt, cij, h, block_m=16,
                                 block_n=16)
    tk.ld_triangle_matrix(torch.from_numpy(g), mxu_dtype="bfloat16")
    tk.ld_triangle_matrix(torch.from_numpy(g), mxu_dtype="float32")
    tk.ld_stage_blocks(torch.from_numpy(g), c1t, ipqt, cij, h, block=16,
                       stage="exact")
    tk.ld_band_count_sharded(["cpu"] * 2, *(
        tk.shard_replicas(t, ["cpu"])
        for t in (gp, c1t, ipqt, torch.from_numpy(pos))), cij, [h, 0], [0.5],
                             packed=True, sel=0, exact_mask=True,
                             use_dist=False, block_m=16, block_n=16)
    assert all(site.launches == 0 for site in tk.LAUNCH_SITES)
    assert len(tk.LAUNCH_SITES) == 10


def test_packed_sites_take_only_bytes_and_widths_of_16():
    g8 = torch.zeros((16, 16), dtype=torch.int8)
    gp = torch.zeros((16, 24), dtype=torch.uint8)  # 24 bytes: not a 16-multiple
    c = torch.zeros((16, 1))
    cij = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(TypeError, match="uint8"):
        tk.ld_band_sweep_blocks_packed(g8, g8, c, c, c, c, cij, 16,
                                       block_m=16, block_n=16)
    with pytest.raises(TypeError, match="int8"):
        tk.ld_band_sweep_blocks(gp[:, :16], gp[:, :16], c, c, c, c, cij, 16,
                                block_m=16, block_n=16)
    with pytest.raises(ValueError, match="multiple of 16"):
        tk.ld_triangle_blocks_packed(gp, c, c, cij, 16, block_m=16,
                                     block_n=16)
    with pytest.raises(ValueError, match="kernel"):
        tk.ld_triangle_matrix_packed(gp, 16, kernel="planes")
    with pytest.raises(ValueError, match="cannot hold"):
        tk.ld_triangle_matrix_packed(gp, 24 * 8 + 1)
    with pytest.raises(ValueError, match="mxu_dtype"):
        tk.ld_triangle_matrix(g8, mxu_dtype="int4")
