"""The port's kernel wrappers (plain versions on the CPU) against
ld_tools_tpu.ops.ld_pallas run in interpret mode.

Integer outputs (unpacked rows, keep masks, count tiles, per-block hit
counts) must be exactly equal.  f32 values are held to 1e-6 abs against
the JAX functions run in a child process whose XLA CPU backend emits no
FMA instructions (``--xla_cpu_max_isa=AVX``).  With FMA, XLA contracts
d = p_ab - p1*p2 into one fused multiply-add, while PyTorch (and the CUDA
kernels, built with -fmad=false) round the product first; d's cancellation
then amplifies that one-ulp difference past 1e-6 for near-monomorphic
pairs.  Without FMA both sides round every operation on its own.
"""

import os
import pickle
import subprocess
import sys
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ld_tools_tpu.ops import ld_pallas as jk
from ld_tools_tpu_torch.ops import ld_kernels as tk

from .conftest import random_haplotypes

F32_TOL = 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PALLAS = "ld_tools_tpu.ops.ld_pallas"

_NO_FMA_CHILD = """
import dataclasses, importlib, pickle, sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np

def resolve(x):
    if isinstance(x, tuple) and len(x) == 5 and x[0] == "__call__":
        _, mod, fn, args, kw = x
        return getattr(importlib.import_module(mod), fn)(
            *map(resolve, args), **{k: resolve(a) for k, a in kw.items()})
    return x

def call(fn, *args):
    return fn(*args)

with open(sys.argv[1], "rb") as fh:
    calls = pickle.load(fh)
out = []
for call_ in calls:
    r = resolve(("__call__",) + tuple(call_))
    out.append(r if dataclasses.is_dataclass(r)
               else jax.tree.map(np.asarray, r))
with open(sys.argv[1], "wb") as fh:
    pickle.dump(out, fh)
"""


def deferred(mod, fn, *args, **kw):
    """A call that the JAX child makes and passes on as an argument (a
    mesh, a jitted function); module "__main__" names the child's own
    ``call(fn, *args)``."""
    return ("__call__", mod, fn, args, kw)


def jax_without_fma(calls, n_devices=1):
    """Results of ``calls``, a list of (module, function, args, kwargs) of
    the JAX package, run in one child process on an XLA CPU backend
    without FMA instructions and with ``n_devices`` virtual devices;
    arguments may be :func:`deferred` calls; array outputs come back as
    numpy."""
    flags = "--xla_cpu_max_isa=AVX"
    if n_devices > 1:
        flags += f" --xla_force_host_platform_device_count={n_devices}"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS=flags)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "calls.pkl")
        with open(path, "wb") as fh:
            pickle.dump(calls, fh)
        out = subprocess.run([sys.executable, "-c", _NO_FMA_CHILD, path],
                             cwd=REPO, env=env, capture_output=True,
                             text=True, timeout=900)
        assert out.returncode == 0, out.stderr[-4000:]
        with open(path, "rb") as fh:
            return pickle.load(fh)


def assert_f32_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)


def _haplotypes(rng, v, h):
    """Random rows, every third row a noisy copy of its neighbour (so a
    threshold keeps pairs), plus the edge cases: all-0 and all-1 rows, and
    rows one haplotype away from monomorphic."""
    G = random_haplotypes(rng, v, h, maf_low=0.02, maf_high=0.98)
    for k in range(6, v, 3):
        flip = rng.random(h) < 0.05
        G[k] = np.where(flip, 1 - G[k - 1], G[k - 1])
    G[1] = 0
    G[2] = 1
    G[3] = 0
    G[3, 5] = 1
    G[4] = 1
    G[4, 7] = 0
    return G


def _padded(rng, v, h, v_pad, w):
    """int8 (v_pad, w) padded genotypes + f32 c1/ipq + int32 pos."""
    G = _haplotypes(rng, v, h)
    g = np.zeros((v_pad, w), dtype=np.int8)
    g[:v, :h] = G
    c1 = g.astype(np.float32).sum(axis=1, keepdims=True)
    p = c1 / np.float32(h)
    pq = p * (np.float32(1) - p)
    ipq = np.where(pq == 0, np.float32(0),
                   np.float32(1) / np.where(pq == 0, np.float32(1), pq))
    pos = np.full((v_pad,), -(2**30), dtype=np.int32)
    pos[:v] = np.sort(rng.choice(10**6, size=v, replace=False))
    return g, c1.astype(np.float32), ipq.astype(np.float32), pos, h


def test_unpack_rows_device_exact(rng):
    G = random_haplotypes(rng, 9, 67, maf_low=0.05, maf_high=0.95)
    gp = tk.pack_rows(G)
    np.testing.assert_array_equal(gp, jk.pack_rows(G))
    want = np.asarray(jk.unpack_rows_device(gp))
    got = tk.unpack_rows_device(torch.from_numpy(gp)).numpy()
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)


def test_block_coords_and_triangle_coords():
    np.testing.assert_array_equal(
        tk.pack_block_coords([0, 3, 32767], [0, 2, 65535]),
        jk.pack_block_coords([0, 3, 32767], [0, 2, 65535]))
    with pytest.raises(ValueError):
        tk.pack_block_coords([32768], [0])
    for nb in (1, 2, 5):
        for a, b in zip(tk._triangle_coords(nb), jk._triangle_coords(nb)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [96, 5008])
@pytest.mark.parametrize("sel", [0, 1])
def test_exact_keep_mask_exact(rng, n, sel):
    c1 = rng.integers(0, n + 1, size=(40, 1)).astype(np.float32)
    c2 = rng.integers(0, n + 1, size=(1, 50)).astype(np.float32)
    c1[:3, 0] = [0, n, n - 1]
    c2[0, :3] = [0, n, 1]
    lo = np.maximum(0, c1 + c2 - n).astype(np.int64)
    hi = np.minimum(c1, c2).astype(np.int64)
    cab = (lo + (rng.random((40, 50)) * (hi - lo + 1)).astype(np.int64))
    cab = np.minimum(cab, hi).astype(np.int32)
    for thres in (-1e-4, 0.2, 0.7995, 1.0):
        want = np.asarray(jk.exact_keep_mask(
            jnp.asarray(cab), jnp.asarray(c1), jnp.asarray(c2),
            jnp.int32(n), jnp.float32(thres), sel))
        got = tk.exact_keep_mask(torch.from_numpy(cab), torch.from_numpy(c1),
                                 torch.from_numpy(c2), n, thres, sel).numpy()
        np.testing.assert_array_equal(got, want)


TRI_SHAPES = [(20, 100, 128), (130, 150, 128), (200, 90, 64)]
TRI_EPILOGUES = [("exact", True), ("exact", False), ("fast", False)]
SWEEP_OUTS = [(("cab",), 0), (("r2", "dp"), 0), (("meas",), 0),
              (("meas",), 1), (("cab", "meas", "r2", "dp"), 1)]


def _tri_input(v, h):
    return _haplotypes(np.random.default_rng(v), v, h)


def _sweep_input():
    return _padded(np.random.default_rng(45), 45, 120, 48, 128)


def _band_pallas_input():
    return _padded(np.random.default_rng(30), 30, 64, 32, 128)


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX result of every f32 case of this module, keyed by case,
    all from one child process without FMA."""
    calls = {}
    for v, h, block in TRI_SHAPES:
        for epilogue, want_dprime in TRI_EPILOGUES:
            calls["tri", v, h, block, epilogue, want_dprime] = (
                PALLAS, "ld_triangle_matrix", (_tri_input(v, h),),
                dict(interpret=True, block_m=block, block_n=block,
                     want_dprime=want_dprime, epilogue=epilogue))
    g, c1, ipq, _, h = _sweep_input()
    for outs, sel in SWEEP_OUTS:
        calls["sweep", outs, sel] = (
            PALLAS, "ld_band_sweep",
            (g[:32], g, c1[:32], c1, ipq[:32], ipq, h),
            dict(packed=False, outs=outs, sel=sel, block_m=16, block_n=16,
                 interpret=True))
    g, c1, _, _, h = _band_pallas_input()
    calls["band_pallas"] = (PALLAS, "ld_band_pallas",
                            (g[:16], g, c1[:16], c1, h),
                            dict(block_m=16, block_n=16, interpret=True))
    return dict(zip(calls, jax_without_fma(list(calls.values()))))


@pytest.mark.parametrize("v,h,block", TRI_SHAPES)
@pytest.mark.parametrize("epilogue,want_dprime", TRI_EPILOGUES)
def test_triangle_matrix_matches_pallas(jax_ref, v, h, block, epilogue,
                                        want_dprime):
    G = _tri_input(v, h)
    r2_j, dp_j = jax_ref["tri", v, h, block, epilogue, want_dprime]
    r2_t, dp_t = tk.ld_triangle_matrix(
        torch.from_numpy(G), block_m=block, block_n=block,
        want_dprime=want_dprime, epilogue=epilogue)
    assert (dp_t is None) == (dp_j is None)
    # JAX leaves the blocks above the diagonal undefined: compare the
    # lower-triangle blocks the kernel writes
    b = np.arange(v) // min(block, -(-v // 128) * 128)
    lower = b[:, None] >= b[None, :]
    assert_f32_close(r2_t.numpy()[lower], r2_j[lower])
    if dp_t is not None:
        assert_f32_close(dp_t.numpy()[lower], dp_j[lower])
    assert not r2_t.numpy()[~lower].any()


def test_triangle_matrix_refuses_fast_with_dprime():
    G = torch.zeros((8, 16), dtype=torch.int8)
    with pytest.raises(ValueError):
        tk.ld_triangle_matrix(G, epilogue="fast", want_dprime=True)
    for mxu in ("bfloat16", "float32"):
        with pytest.raises(ValueError):
            tk.ld_triangle_matrix(G, mxu_dtype=mxu, epilogue="fast",
                                  want_dprime=True)


@pytest.mark.parametrize("outs,sel", SWEEP_OUTS)
def test_band_sweep_matches_pallas(jax_ref, outs, sel):
    g, c1, ipq, _, h = _sweep_input()
    want = jax_ref["sweep", outs, sel]
    rows = slice(0, 32)
    got = tk.ld_band_sweep(
        torch.from_numpy(g[rows]), torch.from_numpy(g),
        torch.from_numpy(c1[rows]), torch.from_numpy(c1),
        torch.from_numpy(ipq[rows]), torch.from_numpy(ipq), h,
        packed=False, outs=outs, sel=sel, block_m=16, block_n=16)
    assert list(got) == list(outs)
    for o in outs:
        w = want[o]
        t = got[o].numpy()
        assert t.shape == w.shape and t.dtype == w.dtype
        if o == "cab":
            np.testing.assert_array_equal(t, w)
        else:
            assert_f32_close(t, w)


def test_band_pallas_matches(jax_ref):
    g, c1, _, _, h = _band_pallas_input()
    got = tk.ld_band_pallas(torch.from_numpy(g[:16]), torch.from_numpy(g),
                            torch.from_numpy(c1[:16]), torch.from_numpy(c1),
                            h, block_m=16, block_n=16)
    for a, b in zip(got, jax_ref["band_pallas"]):
        assert a.shape == b.shape
        assert_f32_close(a.numpy(), b)


def test_band_sweep_blocks_is_the_grid_sweep(rng):
    """The block-list form gives each block's tile of the grid form."""
    g, c1, ipq, _, h = _padded(rng, 60, 100, 64, 128)
    gt, c1t, ipqt = (torch.from_numpy(x) for x in (g, c1, ipq))
    grid = tk.ld_band_sweep(gt, gt, c1t, c1t, ipqt, ipqt, h, packed=False,
                            outs=("cab", "r2"), block_m=16, block_n=16)
    bi, bj = np.array([3, 0, 2]), np.array([1, 0, 2])
    cij = torch.from_numpy(tk.pack_block_coords(bi, bj))
    blocks = tk.ld_band_sweep_blocks(gt, gt, c1t, c1t, ipqt, ipqt, cij, h,
                                     outs=("cab", "r2"), block_m=16,
                                     block_n=16)
    for k in range(3):
        sl = (slice(16 * bi[k], 16 * bi[k] + 16),
              slice(16 * bj[k], 16 * bj[k] + 16))
        for o in ("cab", "r2"):
            np.testing.assert_array_equal(blocks[o][k].numpy(),
                                          grid[o][sl].numpy())


@pytest.mark.parametrize("exact_mask", [True, False])
@pytest.mark.parametrize("sel", [0, 1])
@pytest.mark.parametrize("use_dist", [False, True])
@pytest.mark.parametrize("block", [8, 16])
def test_band_count_matches_pallas(rng, exact_mask, sel, use_dist, block):
    v = 61  # ragged: the last real block is partial
    g, c1, ipq, pos, h = _padded(rng, v, 90, 80, 128)
    nb = -(-v // block)
    bi, bj = np.tril_indices(nb)
    cij = tk.pack_block_coords(bi, bj)
    max_dist = 150_000
    params_i = [h, max_dist if use_dist else 0]
    thres = 0.3 - 5e-4
    want = np.asarray(jk.ld_band_count(
        jnp.asarray(g), jnp.asarray(c1), jnp.asarray(ipq), jnp.asarray(pos),
        jnp.asarray(cij), jnp.asarray(params_i, dtype=jnp.int32),
        jnp.asarray([thres], dtype=jnp.float32), packed=False, sel=sel,
        exact_mask=exact_mask, use_dist=use_dist, block_m=block,
        block_n=block, interpret=True))
    got = tk.ld_band_count(
        torch.from_numpy(g), torch.from_numpy(c1), torch.from_numpy(ipq),
        torch.from_numpy(pos), torch.from_numpy(cij), params_i, [thres],
        packed=False, sel=sel, exact_mask=exact_mask, use_dist=use_dist,
        block_m=block, block_n=block).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 0


def test_plain_versions_count_no_launch(rng):
    tk.reset_launches()
    g, c1, ipq, pos, h = _padded(rng, 20, 64, 32, 128)
    cij = torch.from_numpy(tk.pack_block_coords([1], [0]))
    tk.ld_band_count(torch.from_numpy(g), torch.from_numpy(c1),
                     torch.from_numpy(ipq), torch.from_numpy(pos), cij,
                     [h, 0], [0.5], packed=False, sel=0, exact_mask=True,
                     use_dist=False, block_m=16, block_n=16)
    assert tk.ld_band_count.launches == 0
    assert tk.ld_band_sweep_blocks.launches == 0
    assert tk.ld_triangle_blocks.launches == 0


def test_packed_kernels_are_not_ported_yet(rng):
    """Kept under its first name: the packed routes are ported now (see
    test_torch_packed_kernels) and take only the store's uint8 bytes, so
    int8 rows handed to them raise."""
    g = torch.zeros((16, 16), dtype=torch.int8)
    c = torch.zeros((16, 1))
    with pytest.raises(TypeError, match="uint8"):
        tk.ld_band_sweep(g, g, c, c, c, c, 16, packed=True, block_m=16,
                         block_n=16)
    with pytest.raises(TypeError, match="uint8"):
        tk.ld_band_count(g, c, c, torch.zeros(16, dtype=torch.int32),
                         torch.zeros(1, dtype=torch.int32), [16, 0], [0.5],
                         packed=True, sel=0, exact_mask=True, use_dist=False)
