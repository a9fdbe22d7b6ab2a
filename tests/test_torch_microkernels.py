"""K8, the staged triangle kernel (``ld_stage_blocks``, plain version on
the CPU), against the JAX package.

The counts and ``scale`` stages are held exactly against
``jax.lax.dot_general`` int8 -> int32 (one f32 multiply on each side for
``scale``).  ``fast`` and ``exact`` are the triangle kernel's two r^2
epilogues: held within 1e-6 against ``ld_pallas._ld_triangle_call`` in
interpret mode, run in a child process without FMA (see
test_torch_ld_kernels), and bit for bit against the port's own
``ld_triangle_blocks_plain``.  Every case has a ragged row count (the last
block is partial) and monomorphic rows; the port gets the unpadded rows,
JAX the rows padded to the block, as its kernel needs.  K8 writes whole
listed blocks, so the comparison covers every cell of the lower-triangle
blocks; JAX leaves the other blocks undefined.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ld_tools_tpu_torch.ops import ld_kernels as tk

from .test_torch_ld_kernels import _haplotypes, assert_f32_close, jax_without_fma

PALLAS = "ld_tools_tpu.ops.ld_pallas"
# (V, haplotypes, padded width, block): V never a multiple of the block
CASES = [(300, 200, 256, 128), (600, 300, 384, 512), (1100, 150, 256, 512)]


def _case(v, h, w, block):
    """(int8 rows (V_pad, w), zero past V, and their f32 alt counts)."""
    v_pad = -(-v // block) * block
    g = np.zeros((v_pad, w), dtype=np.int8)
    g[:v, :h] = _haplotypes(np.random.default_rng(v), v, h)
    return g, g.astype(np.float32).sum(axis=1, keepdims=True)


def _coords(v, block):
    return tk._triangle_coords(-(-v // block))


def _written(v, block):
    """The cells of the listed (lower-triangle) blocks of a (V, V) matrix."""
    b = np.arange(v) // block
    return b[:, None] >= b[None, :]


def _port(v, h, w, block, stage, jitter=1.0):
    """K8 on the unpadded rows: (the (V, V) result, rows, c1, ipq, cij)."""
    g, c1 = _case(v, h, w, block)
    c1 = c1 * np.float32(jitter)
    gt, c1t = torch.from_numpy(g[:v]), torch.from_numpy(c1[:v])
    ipq = tk._ipq_from_counts(c1t, torch.tensor(float(np.float32(h))))
    cij = torch.from_numpy(tk.pack_block_coords(*_coords(v, block)))
    out = tk.ld_stage_blocks(gt, c1t, ipq, cij, h, block=block, stage=stage)
    return out.numpy(), gt, c1t, ipq, cij


@pytest.fixture(scope="module")
def jax_ref():
    """_ld_triangle_call's fast and exact r^2 for every case, from one
    child process without FMA."""
    calls = {}
    for v, h, w, block in CASES:
        g, c1 = _case(v, h, w, block)
        bi, bj = _coords(v, block)
        for stage in ("fast", "exact"):
            calls[v, stage] = (
                PALLAS, "_ld_triangle_call",
                (g, c1, bi, bj, np.asarray([h], dtype=np.int32)),
                dict(block_m=block, block_n=block, interpret=True,
                     want_dprime=False, epilogue=stage))
    return dict(zip(calls, jax_without_fma(list(calls.values()))))


@pytest.mark.parametrize("v,h,w,block", CASES)
@pytest.mark.parametrize("stage", ["counts", "scale"])
def test_stage_counts_and_scale_exact(v, h, w, block, stage):
    jitter = 1.0 + 3e-7  # the bench's per-sweep jitter: c1 not integral
    got, *_ = _port(v, h, w, block, stage, jitter)
    g, c1 = _case(v, h, w, block)
    cab = np.asarray(jax.lax.dot_general(
        jnp.asarray(g[:v]), jnp.asarray(g[:v]), (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32))
    want = cab.astype(np.float32)
    if stage == "scale":
        want = want * (c1[:v] * np.float32(jitter))
    lower = _written(v, block)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got[lower], want[lower])
    assert not got[~lower].any()  # the plain version leaves the rest 0


@pytest.mark.parametrize("v,h,w,block", CASES)
@pytest.mark.parametrize("stage", ["fast", "exact"])
def test_stage_r2_matches_pallas(jax_ref, v, h, w, block, stage):
    got, *_ = _port(v, h, w, block, stage)
    (r2_j, dp_j) = jax_ref[v, stage]
    assert dp_j is None
    lower = _written(v, block)
    assert_f32_close(got[lower], r2_j[:v, :v][lower])


@pytest.mark.parametrize("v,h,w,block", CASES)
@pytest.mark.parametrize("stage", ["fast", "exact"])
def test_stage_r2_is_the_triangle_epilogue(v, h, w, block, stage):
    got, gt, c1t, ipq, cij = _port(v, h, w, block, stage)
    r2, dp = tk.ld_triangle_blocks_plain(gt, c1t, ipq, cij, h, block_m=block,
                                         block_n=block, epilogue=stage,
                                         want_dprime=False)
    assert dp is None
    np.testing.assert_array_equal(got, r2.numpy())


def test_stage_refuses_unknown_stages_and_bad_rows():
    g = torch.zeros((16, 16), dtype=torch.int8)
    c = torch.zeros(16)
    cij = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="stage"):
        tk.ld_stage_blocks(g, c, c, cij, 16, block=16, stage="dprime")
    with pytest.raises(TypeError, match="int8"):
        tk.ld_stage_blocks(g.to(torch.uint8), c, c, cij, 16, block=16,
                           stage="counts")
    with pytest.raises(ValueError, match="16 bytes"):
        tk.ld_stage_blocks(torch.zeros((16, 24), dtype=torch.int8), c, c,
                           cij, 16, block=16, stage="counts")
    assert tk.ld_stage_blocks.launches == 0


@pytest.mark.parametrize("epilogue", ["counts", "scale"])
def test_r2_sites_refuse_the_stage_epilogues(epilogue):
    """counts and scale are K8's epilogues of the triangle kernel; the r^2
    sites keep to fast and exact."""
    g = torch.zeros((16, 16), dtype=torch.int8)
    c = torch.zeros(16)
    cij = torch.zeros(1, dtype=torch.int32)
    for site in (tk.ld_triangle_blocks, tk.ld_triangle_blocks_bf16,
                 tk.ld_triangle_blocks_tf32):
        with pytest.raises(ValueError, match="unknown epilogue"):
            site(g, c, c, cij, 16, block_m=16, block_n=16, epilogue=epilogue,
                 want_dprime=False)
    assert tk.EPILOGUES[:2] == ("exact", "fast")  # enum Epilogue's order
    assert set(tk.EPILOGUES) == set(tk.STAGES)
