"""Blocked all-pairs LD kernels: the counterpart of ld_tools_tpu/ops/ld_pallas.py.

Each wrapper launches its hand-written CUDA kernel for tensors on the
card and runs its plain PyTorch version for tensors on the CPU; any other
device raises.  The kernels: csrc/ld_block_sm90.cu (ld_block_kernel: the
triangle K1 with K8, its form on packed bytes K2 and its bf16 / tf32
forms K1b, the band sweeps K3 and K4) and csrc/ld_count_sm90.cu (the
count pass K5, K6), both on the wgmma / TMA core of
csrc/ld_sm90_core.cuh.  Nothing falls back: a CUDA tensor either goes
through the kernel or the call raises.
Every launching wrapper keeps an integer ``launches`` count, bumped only
where it launches its kernel.

Map to ld_pallas.py (by line):

  _ld_epilogue        :55    plain, f32 exact-order r^2 / D'
  _ipq_from_counts    :93    plain, 1/(p*q), 0 when monomorphic
  _apply_epilogue     :108   plain, the triangle tile finish
  _triangle_coords    :364   host numpy
  ld_triangle_matrix  :509   pads, then ld_triangle_blocks (K1) or, for
                             mxu_dtype bfloat16 / float32, the K1b sites
  unpack_rows_device  :561   plain tensor bit shifts (an XLA op in JAX)
  ld_triangle_matrix_packed :576  pads the bytes, then K1 over the
                             inflated rows or K2 over the bytes
  pack_rows           :670   host numpy
  _fast_r2            :722   plain, divide-free r^2
  ld_band_sweep       :779   grid form of ld_band_sweep_blocks (K3) and
                             ld_band_sweep_blocks_packed (K4)
  exact_keep_mask     :870   plain, integer-exact threshold mask (also
                             over each side's own list length: the
                             mixed-ploidy scan's cross-segment
                             rectangles, the port's own)
  block_keep_mask     :980   plain, the count kernel's mask (both passes)
  ld_band_count       :1014  launches ld_band_count_kernel (K5), or hands
                             packed rows to ld_band_count_packed (K6)
  pack_block_coords   :1115  host numpy
  ld_band_count_sharded :1206  K5/K6 per shard over a device list (K7)
  ld_band_pallas      :1236  wrapper over ld_band_sweep
  ld_band_pallas_packed :1268  wrapper over ld_band_sweep(packed=True)

The scan's resident is gathered from the store's packed rows on the card
by gather_rows_device (ld_gather_rows_kernel, csrc/ld_gather_rows.cu;
its plain twin gather_rows_device_plain), which replaces no TPU kernel:
the JAX scan repacks a cohort's columns and takes the alt counts on the
host, and inflates the bytes with unpack_rows_device.

The launch sites each take a LIST of block coordinates, so one launch
covers a whole triangle, a whole batch of a scan's hit blocks or a whole
count pass, and each has a ``*_plain`` twin:

  ld_triangle_blocks          K1   _tri_kernel_dense, int8 (:259)
                                   (ld_block_kernel<FORM_S8, triangle>)
  ld_triangle_blocks_bf16     K1b  _tri_kernel_dense, bf16 dot (:292)
                                   (ld_block_kernel<FORM_BF16, triangle>)
  ld_triangle_blocks_tf32     K1b  _tri_kernel_dense, f32 dot (:292)
                                   (ld_block_kernel<FORM_TF32, triangle>)
  ld_triangle_blocks_packed   K2   _tri_kernel_packed (:303)
                                   (ld_block_kernel<FORM_BITS, triangle>)
  ld_band_sweep_blocks        K3   _band_sweep_kernel, dense (:747)
                                   (ld_block_kernel<FORM_S8, sweep>)
  ld_band_sweep_blocks_packed K4   _band_sweep_kernel, packed (:693)
                                   (ld_block_kernel<FORM_BITS, sweep>)
  ld_band_count               K5   _band_count_kernel, dense (:909)
  ld_band_count_packed        K6   _band_count_kernel, packed (:949)
  ld_band_count_sharded       K7   ld_band_count_sharded (:1206): K5 or
                                   K6 on each shard's slice of the
                                   block list, each shard on its
                                   device and stream
  ld_stage_blocks             K8   the staged triangle kernel of
                                   scripts/bench_microkernels.py (:76),
                                   K1's kernel at four epilogues

The packed sites take the store's bitpacked uint8 rows (8 haplotypes a
byte, MSB first; padding bits zero).  Their plain versions unpack the
bit-planes of the rows they gather and run the dense plain count and
epilogue, so packed and dense plain results are bit-identical.  The
TPU-only machinery of ld_pallas.py (VMEM budgets and their probes, the
SMEM block cap) has no counterpart; the CUDA kernels tile themselves and
take any number of blocks.

The f32 epilogues here run op by op, each product and sum rounded on its
own; the CUDA kernels are built with -fmad=false to do the same, so the
f32 fallback mask gives the same bits in both passes of a scan.
"""

from __future__ import annotations

import numpy as np
import torch

from ld_tools_tpu_torch.ops import _cuda_build

# ld_band_sweep output menu: name -> dtype (ld_pallas._BAND_OUT_DTYPES).
# "meas" is the threshold measure (fast r^2 when sel == 0, exact-order D'
# when sel == 1); "cab" the raw int32 co-occurrence counts.
BAND_OUT_DTYPES = {
    "meas": torch.float32,
    "r2": torch.float32,
    "dp": torch.float32,
    "cab": torch.int32,
}

# blocks per plain-version chunk: bounds the gathered f32 operands
# (64 x 640 x 5120 x 4 B = 840 MB each at the scan's shapes)
_PLAIN_BLOCKS_PER_CHUNK = 64


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def haplotype_counts_int8(g1: torch.Tensor, g2: torch.Tensor,
                          via=torch.int8) -> torch.Tensor:
    """Exact int32 alt+alt co-occurrence counts ``g1 . g2^T`` over the
    last axis, for {0, 1} operands of any dtype (leading axes batch): the
    plain versions' count, ld_math.haplotype_counts_int8 in JAX.

    The operands pass through ``via`` (int8, or bfloat16 / float32 for
    the K1b plain versions, as the TPU kernel casts them) and the
    product runs in f32, exact here; TF32 would be exact too (0 and 1 are
    exact in it), so the result does not depend on PyTorch's matmul
    precision setting.
    """
    a = g1.to(torch.int8).to(via).to(torch.float32)
    b = g2.to(torch.int8).to(via).to(torch.float32)
    return torch.matmul(a, b.transpose(-1, -2)).to(torch.int32)


def _on_card(*tensors) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (run the plain version); raises for mixed or other devices."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} vs {t.device}")
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"unsupported device {dev}: the kernels run on cuda, "
                     "their plain versions on cpu")


def _f32_inv(n) -> tuple:
    """(n, 1/n) as the f32 values the epilogues use (IEEE f32 division,
    as ``1.0 / n`` on an f32 tensor)."""
    n_f = np.float32(n)
    return float(n_f), float(np.float32(1.0) / n_f)


def _launch(entry: str, dev: torch.device, *args) -> int:
    """Call the library's entry point ``entry`` with ``dev`` the CUDA
    runtime's current device and its current stream as the last argument;
    returns the entry point's CUDA error code.  Without the guard a launch
    for a tensor on a second card would run on whichever card the runtime
    has current."""
    with torch.cuda.device(dev):
        return getattr(_cuda_build.lib(), entry)(
            *args, torch.cuda.current_stream(dev).cuda_stream)


def _check_matrix(g: torch.Tensor, name: str, packed: bool = False) -> None:
    """int8 {0,1} (or, packed, uint8 bytes), 2-D, contiguous, rows a
    multiple of 16 bytes from a 16-byte aligned start: the TMA maps'
    row stride and base."""
    want = torch.uint8 if packed else torch.int8
    if g.dtype != want:
        what = "uint8 bitpacked bytes" if packed else "int8 {0,1}"
        raise TypeError(f"{name} must be {what}, got {g.dtype}")
    if g.dim() != 2 or not g.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 2-D matrix")
    if g.shape[1] % 16 or g.data_ptr() % 16:
        raise ValueError(
            f"{name} rows must be a multiple of 16 bytes from a 16-byte "
            f"aligned start (width {g.shape[1]}); pad the haplotype axis"
        )


# The count kernel's tile (csrc/ld_count_sm90.cu CT_M x CT_N) and the
# largest block side the wgmma kernels take (their row indices bi * block,
# bi < 2^15, stay in int32; the scan's count_block never exceeds it)
COUNT_TILE = (128, 320)
MAX_COUNT_BLOCK = 2048
# The rows of ld_block_kernel's tile (csrc/ld_block_sm90.cu; its columns:
# block_tile_n)
BLOCK_TILE_M = 128


def count_tiles(n_blocks: int, block_m: int, block_n: int) -> int:
    """The length of the count kernel's linear tile walk: every block
    split into ceil(block_m / 128) x ceil(block_n / 320) tiles."""
    tm, tn = COUNT_TILE
    return n_blocks * -(-block_m // tm) * -(-block_n // tn)


def block_tile_n(block_n: int) -> int:
    """The columns of ld_block_kernel's tile for blocks of ``block_n``
    columns: 320 where 320 divides the block, else 256 (csrc/
    ld_block_sm90.cu block_tile_n, the rule this mirrors)."""
    return 320 if block_n % 320 == 0 else 256


def block_tiles(n_blocks: int, block_m: int, block_n: int) -> int:
    """The length of ld_block_kernel's linear tile walk: every block split
    into ceil(block_m / 128) x ceil(block_n / block_tile_n(block_n))
    tiles."""
    tn = block_tile_n(block_n)
    return n_blocks * -(-block_m // BLOCK_TILE_M) * -(-block_n // tn)


def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _persistent_grid(kernel: str, tiles: int, block_m: int, block_n: int,
                     dev: torch.device) -> int:
    """A wgmma kernel's persistent grid, min(SMs, tiles); raises on a
    block side it does not take or a walk past int32."""
    for name, side in (("block_m", block_m), ("block_n", block_n)):
        if not 0 < side <= MAX_COUNT_BLOCK:
            raise ValueError(f"the {kernel} kernel takes {name} in (0, "
                             f"{MAX_COUNT_BLOCK}], got {side}")
    if tiles >= 2**31:
        raise ValueError(f"the block list exceeds the {kernel} kernel's "
                         "int32 tile walk")
    return min(_sm_count(dev), tiles) if tiles else 0


def _count_grid(n_blocks: int, block_m: int, block_n: int,
                dev: torch.device) -> int:
    """The count kernel's persistent grid (:func:`_persistent_grid`)."""
    return _persistent_grid("count", count_tiles(n_blocks, block_m, block_n),
                            block_m, block_n, dev)


def _block_grid(n_blocks: int, block_m: int, block_n: int,
                dev: torch.device) -> int:
    """ld_block_kernel's persistent grid (:func:`_persistent_grid`)."""
    return _persistent_grid("block", block_tiles(n_blocks, block_m, block_n),
                            block_m, block_n, dev)


def _check_rows(g: torch.Tensor, name: str) -> None:
    """The wgmma kernels' TMA maps need rows and at least 16 bytes a row."""
    if g.shape[0] == 0 or g.shape[1] == 0:
        raise ValueError(f"{name} must hold rows of at least 16 bytes for "
                         f"the wgmma kernels, got {tuple(g.shape)}")


def _vec(t: torch.Tensor, n: int, dtype, name: str) -> torch.Tensor:
    """A (n,) or (n, 1) per-row vector as a contiguous (n,) tensor."""
    t = t.reshape(-1)
    if t.shape[0] != n:
        raise ValueError(f"{name} has {t.shape[0]} rows, expected {n}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    return t.contiguous()


# ---- plain PyTorch versions ---------------------------------------------


def _ld_epilogue(c_ab, c1_col, c2_row, inv_n, n, want_dprime=True):
    """Branchless D'/r^2 from f32 counts (ld_pallas._ld_epilogue).

    With ``want_dprime=False`` the D' denominator is skipped and the
    r^2 sentinel becomes ``r2_den == 0 or d == 0``, equivalent over exact
    haplotype counts (see the JAX docstring for the argument).
    """
    p_ab = c_ab * inv_n
    p1 = c1_col * inv_n
    q1 = (n - c1_col) * inv_n
    p2 = c2_row * inv_n
    q2 = (n - c2_row) * inv_n
    d = p_ab - p1 * p2
    r2_den = (p1 * q1) * (p2 * q2)
    zero = torch.zeros((), dtype=d.dtype, device=d.device)
    one = torch.ones((), dtype=d.dtype, device=d.device)
    if want_dprime:
        den_pos = torch.minimum(p1 * q2, q1 * p2)
        den_neg = torch.maximum(-(p1 * p2), -(q1 * q2))
        den = torch.where(d >= 0, den_pos, den_neg)
        den_zero = den == 0.0
        d_prime = torch.where(den_zero, zero, d / torch.where(den_zero, one, den))
        dp_zero = d_prime == 0.0
    else:
        d_prime = None
        dp_zero = (r2_den == 0.0) | (d == 0.0)
    r_square = torch.where(dp_zero, zero,
                           (d * d) / torch.where(dp_zero, one, r2_den))
    return r_square, d_prime


def _ipq_from_counts(c1, n):
    """Per-variant reciprocal 1/(p*q), 0 when monomorphic
    (ld_pallas._ipq_from_counts)."""
    p = c1 / n
    pq = p * (1.0 - p)
    zero = pq == 0.0
    return torch.where(zero, torch.zeros_like(pq),
                       1.0 / torch.where(zero, torch.ones_like(pq), pq))


def _fast_r2(c, c1_col, c2_row, ipq1_col, ipq2_row, inv_n):
    """Divide-free r^2 from f32 counts (ld_pallas._fast_r2)."""
    p1 = c1_col * inv_n
    p2 = c2_row * inv_n
    d = c * inv_n - p1 * p2
    return (d * d) * (ipq1_col * ipq2_row)


def _apply_epilogue(c_ab_i32, n_hap, c1_col, c2_row, ipq1_col, ipq2_row,
                    epilogue, want_dprime):
    """Shared count->LD tile finish (ld_pallas._apply_epilogue); returns
    (r2, dp or None)."""
    n_f, inv_n = _f32_inv(n_hap)
    c = c_ab_i32.to(torch.float32)
    n = torch.tensor(n_f, dtype=torch.float32, device=c.device)
    inv = torch.tensor(inv_n, dtype=torch.float32, device=c.device)
    if epilogue == "fast":
        return _fast_r2(c, c1_col, c2_row, ipq1_col, ipq2_row, inv), None
    return _ld_epilogue(c, c1_col, c2_row, inv, n, want_dprime=want_dprime)


# The margin the scan's threshold tests keep under ``thres``: a test at
# ``thres - KEEP_MARGIN`` drops no cell that rounds to >= thres (the
# argument is in :func:`exact_keep_mask`'s docstring).
KEEP_MARGIN = 5e-4


def exact_keep_mask(cab_i32, c1_col, c2_row, n_hap, thres, sel, len1=None,
                    len2=None):
    """Threshold mask straight from exact integer counts
    (ld_pallas.exact_keep_mask).

    ``c1_col`` / ``c2_row`` are each row's alt count over its own list of
    ``len1`` / ``len2`` haplotypes (both default to ``n_hap``, one
    ploidy); ``cab_i32`` counts alt+alt over their zip, ``n_hap`` =
    min(len1, len2) long (the reference's lengths, ops/exact.py; the
    mixed-ploidy scan's cross-segment rectangles pass unequal ones).
    With nd = n*c_ab - c1*c2:
      r^2 >= t  <=>  nd^2 >= t * (c1*(len1-c1)) * (c2*(len2-c2))
      D'  >= t  <=>  |nd| >= t * M,  M = min(c1*(len2-c2), (len1-c1)*c2)
                     where nd >= 0, else min(c1*c2, (len1-c1)*(len2-c2))
    A cell whose product or M is 0 is kept only when the threshold is
    <= 0.  ``thres`` is taken as f32, like the device scalar in JAX.  The
    integers are int32 while max(len1, len2) <= 46,340 (every product
    below 2^31: the expressions K5/K6 compute, which the scan's two
    passes must agree with bit for bit), int64 past it.

    Why a mask at ``thres - KEEP_MARGIN`` drops no cell the f64 finish
    writes: the finish's p = c/n, q = (len - c)/n make r^2 = nd^2 / (A*B)
    (A = c1*(len1-c1), B = c2*(len2-c2)) and D' = |nd| / M exactly, up to
    a few f64 roundings (D' >= 0 in both branches).  Unequal lengths let
    c2 exceed n, so either may lie far above 1; the test never reads them
    as absolute values, only as the ratio of its two sides.  A cell is
    written when round(x, 4) >= thres, so x >= thres - 5e-5 (less 1e-15
    relative).  nd, A, B and M are exact integers; each side of the f32
    test is rounded at most four times, so a cell fails it only where
    x < t * (1 + 5e-7), t the f32 margin threshold (itself within 6e-8
    of thres - 5e-4, relative): below thres - 5e-5 for any threshold up
    to 500, whatever x.  A or B = 0 (c at 0 or at its list's length)
    makes the finish's denominator 0: the int 0 sentinel in both
    measures, written only when thres <= 0, which makes t <= 0.  nd = 0
    with A*B > 0 gives D' (f64) about 0 and r^2 the int 0: written again
    only for thres <= 0.  So the host's f64 finish decides every kept
    cell, and the mask only drops cells that cannot round to >= thres.
    """
    dev = cab_i32.device
    n = int(n_hap)
    l1 = n if len1 is None else int(len1)
    l2 = n if len2 is None else int(len2)
    t = torch.tensor(float(np.float32(thres)), dtype=torch.float32,
                     device=dev)
    idt = torch.int32 if max(l1, l2) <= 46340 else torch.int64
    c1i = c1_col.to(idt)  # counts are exact in f32
    c2i = c2_row.to(idt)
    nd = n * cab_i32.to(idt) - c1i * c2i
    nd_f = nd.to(torch.float32)
    if sel == 0:
        ab = (c1i * (l1 - c1i)).to(torch.float32) * (
            c2i * (l2 - c2i)
        ).to(torch.float32)
        keep = nd_f * nd_f >= t * ab
        keep &= (ab > 0) | (t <= 0)
    else:
        m_pos = torch.minimum(c1i * (l2 - c2i), (l1 - c1i) * c2i)
        m_neg = torch.minimum(c1i * c2i, (l1 - c1i) * (l2 - c2i))
        m = torch.where(nd >= 0, m_pos, m_neg).to(torch.float32)
        keep = nd_f.abs() >= t * m
        keep &= (m > 0) | (t <= 0)
    return keep


def _triangle_coords(nb: int):
    """Lower-triangle block coords in row-major order."""
    bi, bj = np.tril_indices(nb)
    return bi.astype(np.int32), bj.astype(np.int32)


def pack_rows(G) -> np.ndarray:
    """Bitpack an int8 {0,1} (V, H) matrix to (V, ceil(H/8)) uint8, the
    layout ingest/pack.py writes (np.packbits, MSB-first)."""
    return np.packbits(np.asarray(G, dtype=np.uint8), axis=1)


def unpack_rows_device(gp: torch.Tensor) -> torch.Tensor:
    """(..., B) uint8 bitpacked rows -> (..., 8B) int8 {0,1}, on gp's
    device (leading axes batch).

    MSB-first bit order, matching np.packbits / ingest/pack.py.  Plain
    tensor shifts: one pass over the packed bytes."""
    if gp.dtype != torch.uint8:
        raise TypeError(f"packed rows must be uint8, got {gp.dtype}")
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=gp.device)
    bits = (gp.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(*gp.shape[:-1], gp.shape[-1] * 8).to(torch.int8)


_POPCOUNT8 = torch.tensor([bin(b).count("1") for b in range(256)],
                          dtype=torch.int32)


def popcount_rows(gp: torch.Tensor) -> torch.Tensor:
    """(V,) f32 set-bit counts of (V, B) uint8 bitpacked rows: the alt
    counts of the unpacked rows (padding bits are zero), as JAX takes
    them with lax.population_count."""
    table = _POPCOUNT8.to(gp.device)
    return table[gp.to(torch.int64)].sum(dim=1).to(torch.float32)


def pack_block_coords(bi, bj) -> np.ndarray:
    """bi * 2^16 + bj as int32, the block list the band kernels take.

    The int32 sign bit caps bi at 2^15 (bj gets 16 bits): 2^15 blocks of
    640 rows is a 21M-variant chromosome."""
    bi = np.asarray(bi, dtype=np.int64)
    bj = np.asarray(bj, dtype=np.int64)
    if bi.size and (bi.max() >= 32768 or bj.max() >= 65536
                    or bi.min() < 0 or bj.min() < 0):
        raise ValueError(
            "block coordinates exceed the packed int32 range "
            "(0 <= bi < 2^15, 0 <= bj < 2^16)"
        )
    return (bi * 65536 + bj).astype(np.int32)


def _unpack_coords(cij: torch.Tensor):
    cij = cij.to(torch.int64)
    return cij // 65536, cij % 65536


def _block_index(b: torch.Tensor, size: int, n_rows: int):
    """(rows, valid): row indices of each block (nb, size), clamped into
    range, and which of them exist."""
    rows = b[:, None] * size + torch.arange(size, device=b.device)[None, :]
    return rows.clamp(max=max(n_rows - 1, 0)), rows < n_rows


def _gather_rows(x: torch.Tensor, rows: torch.Tensor, valid: torch.Tensor):
    """x[rows] with non-existent rows zeroed (they read as padding)."""
    out = x[rows]
    shape = valid.shape + (1,) * (out.dim() - valid.dim())
    return out * valid.reshape(shape).to(out.dtype)


def _gather_operand(g, rows, valid, packed):
    """Rows of g gathered per block (nb, size, W); packed bytes come out
    as their unpacked int8 bit-planes (nb, size, 8W)."""
    out = _gather_rows(g, rows, valid)
    return unpack_rows_device(out) if packed else out


def _block_outputs_plain(ga, gb, c1a, c1b, ipqa, ipqb, bi, bj, n_hap, *,
                         outs, sel, block_m, block_n, packed=False):
    """Plain band sweep over one chunk of blocks: {name: (nb, bm, bn)}."""
    ra, va = _block_index(bi, block_m, ga.shape[0])
    rb, vb = _block_index(bj, block_n, gb.shape[0])
    cab = haplotype_counts_int8(_gather_operand(ga, ra, va, packed),
                                _gather_operand(gb, rb, vb, packed))
    c1r = _gather_rows(c1a, ra, va)[:, :, None]
    c1c = _gather_rows(c1b, rb, vb)[:, None, :]
    n_f, inv_n = _f32_inv(n_hap)
    dev = cab.device
    n = torch.tensor(n_f, dtype=torch.float32, device=dev)
    inv = torch.tensor(inv_n, dtype=torch.float32, device=dev)
    c = cab.to(torch.float32)
    r2x = dpx = None
    if ("meas" in outs and sel == 1) or "r2" in outs or "dp" in outs:
        r2x, dpx = _ld_epilogue(c, c1r, c1c, inv, n)
    vals = {"cab": cab, "r2": r2x, "dp": dpx}
    if "meas" in outs:
        vals["meas"] = (
            _fast_r2(c, c1r, c1c, _gather_rows(ipqa, ra, va)[:, :, None],
                     _gather_rows(ipqb, rb, vb)[:, None, :], inv)
            if sel == 0 else dpx
        )
    return {o: vals[o] for o in outs}


def mask_source(exact_mask: bool) -> str:
    """The band output the keep mask reads: the integer counts "cab", or
    the f32 "meas" past the int32-exact bound."""
    return "cab" if exact_mask else "meas"


def block_keep_mask(vals, c1, pos, bi, bj, n_hap, thres, max_dist, *, sel,
                    exact_mask, use_dist, block_m, block_n):
    """The count pass's keep mask (nb, bm, bn) of blocks (bi, bj) of one
    matrix, from their band outputs ``vals[mask_source(exact_mask)]``:
    the threshold (``exact_keep_mask`` on the counts, or the f32 measure),
    strict lower triangle, rows that exist, optional |pos_i - pos_j| <=
    max_dist.  The plain count pass and the scan's hit fetch both build
    their masks here, so the two passes agree by construction."""
    c1 = c1.reshape(-1)
    n_rows = c1.shape[0]
    dev = c1.device
    rows = bi[:, None] * block_m + torch.arange(block_m, device=dev)[None, :]
    cols = bj[:, None] * block_n + torch.arange(block_n, device=dev)[None, :]
    rows_c = rows.clamp(max=n_rows - 1)
    cols_c = cols.clamp(max=n_rows - 1)
    if exact_mask:
        keep = exact_keep_mask(vals["cab"], c1[rows_c][:, :, None],
                               c1[cols_c][:, None, :], n_hap, thres, sel)
    else:
        keep = vals["meas"] >= torch.tensor(
            float(np.float32(thres)), dtype=torch.float32, device=dev)
    keep &= cols[:, None, :] < rows[:, :, None]
    keep &= (rows < n_rows)[:, :, None] & (cols < n_rows)[:, None, :]
    if use_dist:
        dist = (pos[rows_c][:, :, None] - pos[cols_c][:, None, :]).abs()
        keep &= dist <= max_dist
    return keep


def _chunks(n: int):
    for lo in range(0, n, _PLAIN_BLOCKS_PER_CHUNK):
        yield lo, min(lo + _PLAIN_BLOCKS_PER_CHUNK, n)


# ---- launch sites and their plain versions -------------------------------
#
# Each launch site takes padded device tensors and a block list.  For a
# CUDA tensor it launches its kernel and bumps its ``launches``; for a CPU
# tensor it returns its ``*_plain`` twin, which also runs on CUDA tensors
# when called by name (chip_smoke.py holds each kernel against it there).

# the triangle kernels' epilogues, in the order of enum Epilogue in
# csrc/ld_common.cuh: the r^2 sites take the first two, K8 all four
EPILOGUES = ("exact", "fast", "counts", "scale")
# K8's stages, in the order the microkernel bench prints them
STAGES = ("counts", "scale", "fast", "exact")


def _triangle_prep(g_pad, c1, ipq, cij, block_m, block_n, epilogue,
                   want_dprime, packed=False, epilogues=("fast", "exact")):
    if epilogue not in epilogues:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    if epilogue != "exact" and want_dprime:
        raise ValueError(f"epilogue={epilogue!r} computes r^2 only; "
                         "use want_dprime=False")
    if block_m != block_n:
        raise ValueError("the triangle walk needs square blocks")
    _check_matrix(g_pad, "g_pad", packed)
    v = g_pad.shape[0]
    return (_vec(c1, v, torch.float32, "c1"), _vec(ipq, v, torch.float32, "ipq"),
            _vec(cij, cij.numel(), torch.int32, "cij"))


def _triangle_plain(g_pad, c1, ipq, cij, n_haplotypes, *, block_m,
                    block_n, epilogue, want_dprime, packed=False,
                    via=torch.int8, epilogues=("fast", "exact")):
    c1, ipq, cij = _triangle_prep(g_pad, c1, ipq, cij, block_m, block_n,
                                  epilogue, want_dprime, packed, epilogues)
    v = g_pad.shape[0]
    dev = g_pad.device
    r2 = torch.zeros((v, v), dtype=torch.float32, device=dev)
    dp = torch.zeros_like(r2) if want_dprime else None
    bi_all, bj_all = _unpack_coords(cij)
    for lo, hi in _chunks(cij.shape[0]):
        bi, bj = bi_all[lo:hi], bj_all[lo:hi]
        ra, va = _block_index(bi, block_m, v)
        rb, vb = _block_index(bj, block_n, v)
        cab = haplotype_counts_int8(_gather_operand(g_pad, ra, va, packed),
                                    _gather_operand(g_pad, rb, vb, packed),
                                    via)
        c1r = _gather_rows(c1, ra, va)[:, :, None]
        if epilogue == "counts":
            r2b, dpb = cab.to(torch.float32), None
        elif epilogue == "scale":
            r2b, dpb = cab.to(torch.float32) * c1r, None
        else:
            r2b, dpb = _apply_epilogue(
                cab, n_haplotypes, c1r, _gather_rows(c1, rb, vb)[:, None, :],
                _gather_rows(ipq, ra, va)[:, :, None],
                _gather_rows(ipq, rb, vb)[:, None, :], epilogue, want_dprime,
            )
        # write the cells that exist (a block past the matrix edge is cut)
        cells = va[:, :, None] & vb[:, None, :]
        k, r, c = torch.nonzero(cells, as_tuple=True)
        r2[ra[k, r], rb[k, c]] = r2b[k, r, c]
        if dp is not None:
            dp[ra[k, r], rb[k, c]] = dpb[k, r, c]
    return r2, dp


def _triangle_launch(site, form, g_pad, c1, ipq, cij, n_haplotypes, *,
                     block_m, block_n, epilogue, want_dprime, out,
                     epilogues=("fast", "exact")):
    """Launch ld_block_kernel<form, STORE_TRIANGLE> (the wgmma core:
    FORM_S8 K1 / K8, FORM_BITS K2, FORM_BF16 / FORM_TF32 K1b) over the
    blocks ``cij``, one persistent thread block per SM; bumps
    ``site.launches``."""
    c1, ipq, cij = _triangle_prep(g_pad, c1, ipq, cij, block_m, block_n,
                                  epilogue, want_dprime,
                                  form == _cuda_build.FORM_BITS, epilogues)
    v, w = g_pad.shape
    if out is None:
        r2 = torch.zeros((v, v), dtype=torch.float32, device=g_pad.device)
        dp = torch.zeros_like(r2) if want_dprime else None
    else:
        r2, dp = out
        for t in (r2,) + ((dp,) if want_dprime else ()):
            if (t.shape != (v, v) or t.dtype != torch.float32
                    or not t.is_contiguous() or t.device != g_pad.device):
                raise ValueError("out buffers must be contiguous (V, V) "
                                 "f32 on g_pad's device")
        dp = dp if want_dprime else None
    if cij.shape[0]:
        n_f, inv_n = _f32_inv(n_haplotypes)
        args = (g_pad.data_ptr(), c1.data_ptr(), ipq.data_ptr(),
                cij.data_ptr(), cij.shape[0], v, w, block_m, block_n, n_f,
                inv_n, EPILOGUES.index(epilogue), form)
        outs = (r2.data_ptr(), dp.data_ptr() if dp is not None else None)
        _check_rows(g_pad, "g_pad")
        grid = _block_grid(cij.shape[0], block_m, block_n, g_pad.device)
        err = _launch("ldk_block_triangle", g_pad.device, *args, grid, *outs)
        _cuda_build.check(err, f"ld_block_kernel<form {form}, triangle>, "
                          f"epilogue {epilogue}")
        site.launches += 1
    return r2, dp


def ld_triangle_blocks_plain(g_pad, c1, ipq, cij, n_haplotypes, *,
                             block_m, block_n, epilogue="exact",
                             want_dprime=True):
    """Plain version of :func:`ld_triangle_blocks` on g_pad's device."""
    return _triangle_plain(g_pad, c1, ipq, cij, n_haplotypes,
                           block_m=block_m, block_n=block_n,
                           epilogue=epilogue, want_dprime=want_dprime)


def ld_triangle_blocks(g_pad, c1, ipq, cij, n_haplotypes, *, block_m,
                       block_n, epilogue="exact", want_dprime=True,
                       out=None):
    """Launch site of K1, ld_block_kernel<FORM_S8, STORE_TRIANGLE>
    (csrc/ld_block_sm90.cu, wgmma): r^2 (and D') of the listed
    blocks of the (V, V) matrix, 0 elsewhere.  ``cij[k] = bi * 2^16 +
    bj``; ``g_pad`` is int8 {0,1} (V, W) with W a multiple of 16, c1/ipq
    its f32 alt counts and 1/(p*q).  ``out=(r2, dp or None)`` reuses
    (V, V) f32 buffers: only the listed blocks are written, the rest is
    left as it was."""
    kw = dict(block_m=block_m, block_n=block_n, epilogue=epilogue,
              want_dprime=want_dprime)
    if not _on_card(g_pad, c1, ipq, cij):
        return ld_triangle_blocks_plain(g_pad, c1, ipq, cij, n_haplotypes,
                                        **kw)
    return _triangle_launch(ld_triangle_blocks, _cuda_build.FORM_S8, g_pad,
                            c1, ipq, cij, n_haplotypes, out=out, **kw)


ld_triangle_blocks.launches = 0


def ld_triangle_blocks_bf16_plain(g_pad, c1, ipq, cij, n_haplotypes, *,
                                  block_m, block_n, epilogue="exact",
                                  want_dprime=True):
    """Plain version of :func:`ld_triangle_blocks_bf16`: the operands
    cast to bf16, f32 products and sums."""
    return _triangle_plain(g_pad, c1, ipq, cij, n_haplotypes,
                           block_m=block_m, block_n=block_n,
                           epilogue=epilogue, want_dprime=want_dprime,
                           via=torch.bfloat16)


def ld_triangle_blocks_bf16(g_pad, c1, ipq, cij, n_haplotypes, *, block_m,
                            block_n, epilogue="exact", want_dprime=True,
                            out=None):
    """Launch site of ld_block_kernel<FORM_BF16, STORE_TRIANGLE> (K1b,
    the bf16 dot of _tri_kernel_dense; csrc/ld_block_sm90.cu, wgmma):
    :func:`ld_triangle_blocks` with the int8 rows read as they are and
    widened to bf16 inside the kernel, bf16 tensor-core products summed
    in f32.  Counts are exact, so r^2 / D' equal K1's bit for bit."""
    kw = dict(block_m=block_m, block_n=block_n, epilogue=epilogue,
              want_dprime=want_dprime)
    if not _on_card(g_pad, c1, ipq, cij):
        return ld_triangle_blocks_bf16_plain(g_pad, c1, ipq, cij,
                                             n_haplotypes, **kw)
    return _triangle_launch(ld_triangle_blocks_bf16, _cuda_build.FORM_BF16,
                            g_pad, c1, ipq, cij, n_haplotypes, out=out, **kw)


ld_triangle_blocks_bf16.launches = 0


def ld_triangle_blocks_tf32_plain(g_pad, c1, ipq, cij, n_haplotypes, *,
                                  block_m, block_n, epilogue="exact",
                                  want_dprime=True):
    """Plain version of :func:`ld_triangle_blocks_tf32`: the operands
    cast to f32, f32 products and sums."""
    return _triangle_plain(g_pad, c1, ipq, cij, n_haplotypes,
                           block_m=block_m, block_n=block_n,
                           epilogue=epilogue, want_dprime=want_dprime,
                           via=torch.float32)


def ld_triangle_blocks_tf32(g_pad, c1, ipq, cij, n_haplotypes, *, block_m,
                            block_n, epilogue="exact", want_dprime=True,
                            out=None):
    """Launch site of ld_block_kernel<FORM_TF32, STORE_TRIANGLE> (K1b,
    the f32 dot of _tri_kernel_dense; csrc/ld_block_sm90.cu, wgmma):
    :func:`ld_triangle_blocks` with the int8 rows read as they are,
    widened to f32 inside the kernel and multiplied on the TF32 tensor
    cores (int8 values are exact in TF32), summed in f32: K1's r^2 / D'
    bit for bit."""
    kw = dict(block_m=block_m, block_n=block_n, epilogue=epilogue,
              want_dprime=want_dprime)
    if not _on_card(g_pad, c1, ipq, cij):
        return ld_triangle_blocks_tf32_plain(g_pad, c1, ipq, cij,
                                             n_haplotypes, **kw)
    return _triangle_launch(ld_triangle_blocks_tf32, _cuda_build.FORM_TF32,
                            g_pad, c1, ipq, cij, n_haplotypes, out=out, **kw)


ld_triangle_blocks_tf32.launches = 0


def ld_triangle_blocks_packed_plain(gp_pad, c1, ipq, cij, n_haplotypes, *,
                                    block_m, block_n, epilogue="exact",
                                    want_dprime=True):
    """Plain version of :func:`ld_triangle_blocks_packed`: each gathered
    block's bytes unpacked to int8 bit-planes, then the dense plain count
    and epilogue."""
    return _triangle_plain(gp_pad, c1, ipq, cij, n_haplotypes,
                           block_m=block_m, block_n=block_n,
                           epilogue=epilogue, want_dprime=want_dprime,
                           packed=True)


def ld_triangle_blocks_packed(gp_pad, c1, ipq, cij, n_haplotypes, *,
                              block_m, block_n, epilogue="exact",
                              want_dprime=True, out=None):
    """Launch site of ld_block_kernel<FORM_BITS, STORE_TRIANGLE> (K2,
    _tri_kernel_packed; csrc/ld_block_sm90.cu, wgmma):
    :func:`ld_triangle_blocks` over the store's bitpacked uint8 (V, W)
    rows, W bytes a multiple of 16 (128 from ld_triangle_matrix_packed),
    TMA reading exactly W bytes a row and K4's reshaping warps unpacking
    the bit-planes into the s8 stages.  The same counts as K1 on the
    unpacked rows, so the same r^2 / D' bit for bit."""
    kw = dict(block_m=block_m, block_n=block_n, epilogue=epilogue,
              want_dprime=want_dprime)
    if not _on_card(gp_pad, c1, ipq, cij):
        return ld_triangle_blocks_packed_plain(gp_pad, c1, ipq, cij,
                                               n_haplotypes, **kw)
    return _triangle_launch(ld_triangle_blocks_packed,
                            _cuda_build.FORM_BITS, gp_pad, c1, ipq, cij,
                            n_haplotypes, out=out, **kw)


ld_triangle_blocks_packed.launches = 0


def _stage_kw(block, stage):
    if stage not in STAGES:
        raise ValueError(f"unknown stage {stage!r}: use {', '.join(STAGES)}")
    return dict(block_m=block, block_n=block, epilogue=stage,
                want_dprime=False, epilogues=STAGES)


def ld_stage_blocks_plain(g_pad, c1, ipq, cij, n_haplotypes, *, block,
                          stage):
    """Plain version of :func:`ld_stage_blocks`: the triangle's plain walk
    at the stage's epilogue."""
    return _triangle_plain(g_pad, c1, ipq, cij, n_haplotypes,
                           **_stage_kw(block, stage))[0]


def ld_stage_blocks(g_pad, c1, ipq, cij, n_haplotypes, *, block, stage,
                    out=None):
    """Launch site of K8 (the staged triangle kernel of
    scripts/bench_microkernels.py): ld_block_kernel<FORM_S8,
    STORE_TRIANGLE>, K1's own kernel, at one epilogue ``stage`` over the
    listed (bi, bj) blocks of a (V, V) f32 matrix, whole blocks (the cells
    above the diagonal of a diagonal block too):

      counts  float(c_ab)
      scale   c_ab * c1[row]
      fast    the divide-free r^2, d^2 * ipq[row] * ipq[col]
      exact   the exact-order r^2 (no D')

    ``g_pad`` is int8 {0,1} (V, W), W a multiple of 16, c1/ipq its f32
    alt counts and 1/(p*q) (any values: the bench jitters c1), and
    ``n_haplotypes`` the n of the epilogues.  ``out`` reuses a (V, V) f32
    buffer: only the listed blocks are written, the rest is left as it
    was; without it the rest is 0."""
    kw = _stage_kw(block, stage)
    if not _on_card(g_pad, c1, ipq, cij):
        return ld_stage_blocks_plain(g_pad, c1, ipq, cij, n_haplotypes,
                                     block=block, stage=stage)
    return _triangle_launch(ld_stage_blocks, _cuda_build.FORM_S8, g_pad, c1,
                            ipq, cij, n_haplotypes,
                            out=None if out is None else (out, None),
                            **kw)[0]


ld_stage_blocks.launches = 0


def _band_prep(g_rows, g_cols, c1_rows, c1_cols, ipq_rows, ipq_cols, cij,
               outs, sel, packed=False):
    for o in outs:
        if o not in BAND_OUT_DTYPES:
            raise ValueError(f"unknown band output {o!r}")
    if sel not in (0, 1):
        raise ValueError(f"sel must be 0 or 1, got {sel}")
    _check_matrix(g_rows, "g_rows", packed)
    _check_matrix(g_cols, "g_cols", packed)
    if g_rows.shape[1] != g_cols.shape[1]:
        raise ValueError("g_rows and g_cols differ in width")
    vr, va = g_rows.shape[0], g_cols.shape[0]
    return (_vec(c1_rows, vr, torch.float32, "c1_rows"),
            _vec(c1_cols, va, torch.float32, "c1_cols"),
            _vec(ipq_rows, vr, torch.float32, "ipq_rows"),
            _vec(ipq_cols, va, torch.float32, "ipq_cols"),
            _vec(cij, cij.numel(), torch.int32, "cij"))


def _band_sweep_plain(g_rows, g_cols, c1_rows, c1_cols, ipq_rows, ipq_cols,
                      cij, n_haplotypes, *, outs, sel, block_m, block_n,
                      packed):
    c1_rows, c1_cols, ipq_rows, ipq_cols, cij = _band_prep(
        g_rows, g_cols, c1_rows, c1_cols, ipq_rows, ipq_cols, cij, outs,
        sel, packed)
    bi, bj = _unpack_coords(cij)
    parts = [
        _block_outputs_plain(
            g_rows, g_cols, c1_rows, c1_cols, ipq_rows, ipq_cols,
            bi[lo:hi], bj[lo:hi], n_haplotypes, outs=outs, sel=sel,
            block_m=block_m, block_n=block_n, packed=packed,
        )
        for lo, hi in _chunks(cij.shape[0])
    ]
    return {
        o: (torch.cat([p[o] for p in parts]) if parts else
            torch.empty((0, block_m, block_n), dtype=BAND_OUT_DTYPES[o],
                        device=g_rows.device))
        for o in outs
    }


def _band_sweep_launch(site, form, g_rows, g_cols, c1_rows, c1_cols,
                       ipq_rows, ipq_cols, cij, n_haplotypes, *, outs, sel,
                       block_m, block_n):
    """Launch ld_block_kernel<form, STORE_SWEEP> (the wgmma core: FORM_S8
    K3, FORM_BITS K4) over the blocks ``cij``, one persistent thread
    block per SM; bumps ``site.launches``.  The outputs are
    uninitialised: the kernel writes every cell of every listed block,
    past the matrix edge too."""
    c1_rows, c1_cols, ipq_rows, ipq_cols, cij = _band_prep(
        g_rows, g_cols, c1_rows, c1_cols, ipq_rows, ipq_cols, cij, outs,
        sel, form == _cuda_build.FORM_BITS)
    nb = cij.shape[0]
    out = {o: torch.empty((nb, block_m, block_n), dtype=BAND_OUT_DTYPES[o],
                          device=g_rows.device)
           for o in outs}
    if nb == 0:
        return out
    n_f, inv_n = _f32_inv(n_haplotypes)
    ptr = {o: (out[o].data_ptr() if o in out else None)
           for o in BAND_OUT_DTYPES}
    args = (g_rows.data_ptr(), g_cols.data_ptr(), c1_rows.data_ptr(),
            c1_cols.data_ptr(), ipq_rows.data_ptr(), ipq_cols.data_ptr(),
            cij.data_ptr(), nb, g_rows.shape[0], g_cols.shape[0],
            g_rows.shape[1], block_m, block_n, n_f, inv_n, sel, form)
    outs = (ptr["cab"], ptr["r2"], ptr["dp"], ptr["meas"])
    _check_rows(g_rows, "g_rows")
    _check_rows(g_cols, "g_cols")
    grid = _block_grid(nb, block_m, block_n, g_rows.device)
    err = _launch("ldk_block_sweep", g_rows.device, *args, grid, *outs)
    _cuda_build.check(err, f"ld_block_kernel<form {form}, sweep>")
    site.launches += 1
    return out


def ld_band_sweep_blocks_plain(g_rows, g_cols, c1_rows, c1_cols, ipq_rows,
                               ipq_cols, cij, n_haplotypes, *,
                               outs=("meas",), sel=0, block_m=640,
                               block_n=640):
    """Plain version of :func:`ld_band_sweep_blocks` on g_rows' device."""
    return _band_sweep_plain(
        g_rows, g_cols, c1_rows, c1_cols, ipq_rows, ipq_cols, cij,
        n_haplotypes, outs=outs, sel=sel, block_m=block_m, block_n=block_n,
        packed=False)


def ld_band_sweep_blocks(
    g_rows, g_cols, c1_rows, c1_cols, ipq_rows, ipq_cols, cij, n_haplotypes,
    *, outs: tuple = ("meas",), sel: int = 0, block_m: int = 640,
    block_n: int = 640,
):
    """Band sweep over a list of blocks: {name: (n_blocks, bm, bn)}.

    ``cij[k] = bi * 2^16 + bj`` names rows [bi*bm, (bi+1)*bm) of
    ``g_rows`` against rows [bj*bn, (bj+1)*bn) of ``g_cols``; rows past
    a matrix read as zero (monomorphic padding).  ``outs`` is an ordered
    subset of ``BAND_OUT_DTYPES``.  This is the launch site of
    ld_block_kernel<FORM_S8, STORE_SWEEP> (K3, csrc/ld_block_sm90.cu,
    wgmma), the dense branch of _band_sweep_kernel.
    """
    kw = dict(outs=outs, sel=sel, block_m=block_m, block_n=block_n)
    args = (g_rows, g_cols, c1_rows, c1_cols, ipq_rows, ipq_cols, cij)
    if not _on_card(*args):
        return ld_band_sweep_blocks_plain(*args, n_haplotypes, **kw)
    return _band_sweep_launch(ld_band_sweep_blocks, _cuda_build.FORM_S8,
                              *args, n_haplotypes, **kw)


ld_band_sweep_blocks.launches = 0


def ld_band_sweep_blocks_packed_plain(gp_rows, gp_cols, c1_rows, c1_cols,
                                      ipq_rows, ipq_cols, cij,
                                      n_haplotypes, *, outs=("meas",),
                                      sel=0, block_m=640, block_n=640):
    """Plain version of :func:`ld_band_sweep_blocks_packed`: each
    gathered block's bytes unpacked to int8 bit-planes, then the dense
    plain count and epilogue."""
    return _band_sweep_plain(
        gp_rows, gp_cols, c1_rows, c1_cols, ipq_rows, ipq_cols, cij,
        n_haplotypes, outs=outs, sel=sel, block_m=block_m, block_n=block_n,
        packed=True)


def ld_band_sweep_blocks_packed(
    gp_rows, gp_cols, c1_rows, c1_cols, ipq_rows, ipq_cols, cij,
    n_haplotypes, *, outs: tuple = ("meas",), sel: int = 0,
    block_m: int = 640, block_n: int = 640,
):
    """:func:`ld_band_sweep_blocks` over the store's bitpacked uint8 rows
    (W bytes = 8 W haplotypes, W a multiple of 16): the launch site of
    ld_block_kernel<FORM_BITS, STORE_SWEEP> (K4, csrc/ld_block_sm90.cu,
    wgmma), the packed branch of _band_sweep_kernel.  Outputs equal K3's
    on the unpacked rows bit for bit."""
    kw = dict(outs=outs, sel=sel, block_m=block_m, block_n=block_n)
    args = (gp_rows, gp_cols, c1_rows, c1_cols, ipq_rows, ipq_cols, cij)
    if not _on_card(*args):
        return ld_band_sweep_blocks_packed_plain(*args, n_haplotypes, **kw)
    return _band_sweep_launch(ld_band_sweep_blocks_packed,
                              _cuda_build.FORM_BITS, *args, n_haplotypes,
                              **kw)


ld_band_sweep_blocks_packed.launches = 0


def _count_prep(g, c1, ipq, pos, cij, sel, packed=False):
    if sel not in (0, 1):
        raise ValueError(f"sel must be 0 or 1, got {sel}")
    _check_matrix(g, "g_dev", packed)
    v = g.shape[0]
    return (_vec(c1, v, torch.float32, "c1_dev"),
            _vec(ipq, v, torch.float32, "ipq_dev"),
            _vec(pos, v, torch.int32, "pos_dev"),
            _vec(cij, cij.numel(), torch.int32, "cij"))


def _count_plain(g, c1, ipq, pos, cij, n_hap, max_dist, thres, *, sel,
                 exact_mask, use_dist, block_m, block_n, packed):
    c1, ipq, pos, cij = _count_prep(g, c1, ipq, pos, cij, sel, packed)
    nb = cij.shape[0]
    out = torch.zeros((nb,), dtype=torch.int32, device=g.device)
    bi, bj = _unpack_coords(cij)
    for lo, hi in _chunks(nb):
        vals = _block_outputs_plain(
            g, g, c1, c1, ipq, ipq, bi[lo:hi], bj[lo:hi], n_hap,
            outs=(mask_source(exact_mask),), sel=sel, block_m=block_m,
            block_n=block_n, packed=packed,
        )
        keep = block_keep_mask(
            vals, c1, pos, bi[lo:hi], bj[lo:hi], n_hap, thres, max_dist,
            sel=sel, exact_mask=exact_mask, use_dist=use_dist,
            block_m=block_m, block_n=block_n,
        )
        out[lo:hi] = keep.reshape(hi - lo, -1).sum(dim=1).to(torch.int32)
    return out


def _count_launch(site, form, g, c1, ipq, pos, cij, n_hap, max_dist, thres,
                  *, sel, exact_mask, use_dist, block_m, block_n):
    """Launch ld_band_count_kernel<form> over the blocks ``cij``; bumps
    ``site.launches``."""
    c1, ipq, pos, cij = _count_prep(g, c1, ipq, pos, cij, sel,
                                    form == _cuda_build.FORM_BITS)
    nb = cij.shape[0]
    v, w = g.shape
    if w == 0:
        raise ValueError("the count kernel needs rows of at least 16 bytes")
    grid = _count_grid(nb, block_m, block_n, g.device)
    # the kernel adds each tile's count into its block's slot
    out = torch.zeros((nb,), dtype=torch.int32, device=g.device)
    if nb == 0 or v == 0:
        return out
    n_f, inv_n = _f32_inv(n_hap)
    err = _launch(
        "ldk_band_count", g.device, g.data_ptr(), c1.data_ptr(),
        ipq.data_ptr(), pos.data_ptr(), cij.data_ptr(), nb, v, w, block_m,
        block_n, n_hap, n_f, inv_n, thres, max_dist if use_dist else 0, sel,
        int(exact_mask), int(use_dist), form, grid, out.data_ptr(),
    )
    _cuda_build.check(err, f"ld_band_count_kernel (form {form})")
    site.launches += 1
    return out


def ld_band_count_plain(g, c1, ipq, pos, cij, n_hap, max_dist, thres, *,
                        sel, exact_mask, use_dist, block_m=640,
                        block_n=640):
    """Plain version of the count pass (:func:`ld_band_count`) on g's
    device; ``thres`` is taken as f32."""
    return _count_plain(g, c1, ipq, pos, cij, n_hap, max_dist, thres,
                        sel=sel, exact_mask=exact_mask, use_dist=use_dist,
                        block_m=block_m, block_n=block_n, packed=False)


def ld_band_count_packed_plain(gp, c1, ipq, pos, cij, n_hap, max_dist,
                               thres, *, sel, exact_mask, use_dist,
                               block_m=640, block_n=640):
    """Plain version of :func:`ld_band_count_packed`: each gathered
    block's bytes unpacked to int8 bit-planes, then the dense plain count
    and the shared keep mask."""
    return _count_plain(gp, c1, ipq, pos, cij, n_hap, max_dist, thres,
                        sel=sel, exact_mask=exact_mask, use_dist=use_dist,
                        block_m=block_m, block_n=block_n, packed=True)


def _count_params(params_i, params_f):
    n_hap, max_dist = (int(x) for x in params_i)
    return n_hap, max_dist, float(np.float32(float(params_f[0])))


def ld_band_count(
    g_dev,
    c1_dev,
    ipq_dev,
    pos_dev,
    cij,
    params_i,
    params_f,
    *,
    packed: bool,
    sel: int,
    exact_mask: bool,
    use_dist: bool,
    block_m: int = 640,
    block_n: int = 640,
):
    """Per-block hit counts for a list of blocks (ld_pallas.ld_band_count);
    the launch site of ld_band_count_kernel (K5).  ``packed=True`` takes
    the store's bitpacked uint8 rows and hands the call to
    :func:`ld_band_count_packed` (K6).

    ``cij[k] = bi * 2^16 + bj``; block k's count of kept pairs (threshold
    ``params_f[0]`` through ``exact_keep_mask`` or the f32 fallback
    measure, strict lower triangle, optional |pos_i - pos_j| <=
    ``params_i[1]``) lands in slot k of the (len(cij),) int32 result.
    ``params_i = (n_haplotypes, max_dist)`` and ``params_f`` are host
    numbers.
    """
    args = (g_dev, c1_dev, ipq_dev, pos_dev, cij, params_i, params_f)
    kw = dict(sel=sel, exact_mask=exact_mask, use_dist=use_dist,
              block_m=block_m, block_n=block_n)
    if packed:
        return ld_band_count_packed(*args, **kw)
    n_hap, max_dist, thres = _count_params(params_i, params_f)
    if not _on_card(g_dev, c1_dev, ipq_dev, pos_dev, cij):
        return ld_band_count_plain(*args[:5], n_hap, max_dist, thres, **kw)
    return _count_launch(ld_band_count, _cuda_build.FORM_S8, *args[:5],
                         n_hap, max_dist, thres, **kw)


ld_band_count.launches = 0


def ld_band_count_packed(gp_dev, c1_dev, ipq_dev, pos_dev, cij, params_i,
                         params_f, *, sel: int, exact_mask: bool,
                         use_dist: bool, block_m: int = 640,
                         block_n: int = 640):
    """:func:`ld_band_count` over the store's bitpacked uint8 rows (W
    bytes a multiple of 16): the launch site of
    ld_band_count_kernel<FORM_BITS> (K6), the packed branch of
    _band_count_kernel.  Its counts equal K5's on the unpacked rows."""
    n_hap, max_dist, thres = _count_params(params_i, params_f)
    args = (gp_dev, c1_dev, ipq_dev, pos_dev, cij)
    kw = dict(sel=sel, exact_mask=exact_mask, use_dist=use_dist,
              block_m=block_m, block_n=block_n)
    if not _on_card(*args):
        return ld_band_count_packed_plain(*args, n_hap, max_dist, thres,
                                          **kw)
    return _count_launch(ld_band_count_packed, _cuda_build.FORM_BITS, *args,
                         n_hap, max_dist, thres, **kw)


ld_band_count_packed.launches = 0


def _device(d) -> torch.device:
    """``d`` as a torch.device; a bare "cuda" names the current card, so
    that equal devices compare (and hash) equal."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def shard_devices(devices) -> list:
    """A shard list as torch.devices: one device per shard, a device may
    repeat ([cuda:0] * 4 is four shards on one card); every device of one
    kind."""
    devices = [_device(d) for d in devices]
    if not devices:
        raise ValueError("a shard list needs at least one device")
    if len({d.type for d in devices}) != 1:
        raise ValueError(f"shards mix device kinds: {devices}")
    return devices


def shard_slices(n: int, n_shards: int) -> list:
    """Contiguous [lo, hi) slices of n items over n_shards shards, in
    order: ceil(n / n_shards) each, the last ones shorter or empty.  The
    real prefix of each per-device slice of JAX's split
    (ld_stream.py:547-579), whose padding the port does not need: the
    kernels take any number of blocks."""
    loc = -(-n // n_shards)
    return [(min(s * loc, n), min((s + 1) * loc, n)) for s in range(n_shards)]


def shard_replicas(t: torch.Tensor, devices) -> dict:
    """{device: tensor}: one copy of ``t`` on each distinct device of the
    shard list ``devices`` (``t`` itself where it already lies), the form
    in which :func:`ld_band_count_sharded` takes its resident tensors."""
    out = {}
    for d in shard_devices(devices):
        if d not in out:
            out[d] = t if t.device == d else t.to(d)
    return out


def _replica(copies, dev: torch.device) -> torch.Tensor:
    """The copy on ``dev`` of a {device: tensor} map; raises where the map
    has none there: a shard never copies the resident matrix itself."""
    if not isinstance(copies, dict):
        raise TypeError("ld_band_count_sharded takes each resident tensor as "
                        "a {device: tensor} map of per-device copies "
                        "(shard_replicas)")
    t = {_device(d): x for d, x in copies.items()}.get(dev)
    if t is None or t.device != dev:
        where = "none" if t is None else f"it lies on {t.device}"
        raise ValueError(f"no resident copy on the shard's device {dev} "
                         f"({where})")
    return t


# one CUDA stream per (card, shard): the shards of one card overlap
_SHARD_STREAMS = {}


def _shard_stream(dev: torch.device, shard: int):
    key = (dev, shard)
    if key not in _SHARD_STREAMS:
        _SHARD_STREAMS[key] = torch.cuda.Stream(device=dev)
    return _SHARD_STREAMS[key]


def ld_band_count_sharded(devices, g_dev, c1_dev, ipq_dev, pos_dev, cij,
                          params_i, params_f, *, packed: bool, sel: int,
                          exact_mask: bool, use_dist: bool,
                          block_m: int = 640, block_n: int = 640):
    """Per-block hit counts of :func:`ld_band_count` over a list of shards
    (ld_pallas.ld_band_count_sharded, K7: a shard_map of the count kernel
    over a 1-D mesh).

    ``devices`` holds one device per shard and may repeat a device.  The
    block list ``cij`` splits into contiguous slices (:func:`shard_slices`);
    shard s counts its slice on ``devices[s]`` with K5 (or, ``packed``,
    K6) on that device's resident tensors: ``g_dev`` .. ``pos_dev`` are
    {device: tensor} maps holding a copy on every device of the list
    (:func:`shard_replicas`); a missing copy raises, none is made here.
    ``cij`` lies on the shards' kind of device (each shard takes its slice
    to its own card).  On the card each shard launches on its own stream,
    every shard before any is waited for, and each card's current stream
    then waits for its shards.  The (len(cij),) int32 counts come back in
    global block order on ``devices[0]``.  CPU tensors run the plain
    versions.  ``launches`` counts shard launches.
    """
    devices = shard_devices(devices)
    n_hap, max_dist, thres = _count_params(params_i, params_f)
    kw = dict(sel=sel, exact_mask=exact_mask, use_dist=use_dist,
              block_m=block_m, block_n=block_n)
    cij = torch.as_tensor(cij)
    if cij.device.type != devices[0].type:
        raise ValueError(f"the block list lies on {cij.device}, the shards "
                         f"on {devices[0].type}")
    slices = shard_slices(cij.shape[0], len(devices))
    shards = [[_replica(t, dev) for t in (g_dev, c1_dev, ipq_dev, pos_dev)]
              + [cij[lo:hi].to(dev)]
              for dev, (lo, hi) in zip(devices, slices)]
    if not _on_card(*shards[0]):
        plain = ld_band_count_packed_plain if packed else ld_band_count_plain
        return torch.cat([plain(*args, n_hap, max_dist, thres, **kw)
                          for args in shards])
    form = _cuda_build.FORM_BITS if packed else _cuda_build.FORM_S8
    outs, streams = [], []
    for s, (dev, args) in enumerate(zip(devices, shards)):
        with torch.cuda.device(dev):
            cur = torch.cuda.current_stream(dev)
            stream = _shard_stream(dev, s)
            stream.wait_stream(cur)  # the resident tensors and cij are ready
            with torch.cuda.stream(stream):
                out = _count_launch(ld_band_count_sharded, form, *args,
                                    n_hap, max_dist, thres, **kw)
            out.record_stream(cur)  # read on the current stream after the join
        outs.append(out)
        streams.append(stream)
    for dev, stream in zip(devices, streams):
        torch.cuda.current_stream(dev).wait_stream(stream)
    return torch.cat([o.to(devices[0]) for o in outs])


ld_band_count_sharded.launches = 0


# ---- the scan's resident from the store's packed rows ----------------------


def _gather_prep(src, cols, out, counts):
    """Check gather_rows_device's arguments; returns the number of
    columns a row of ``out`` gets (8 per source byte without ``cols``)."""
    if src.dtype != torch.uint8 or src.dim() != 2 or not src.is_contiguous():
        raise TypeError("src must be contiguous 2-D uint8 packed rows")
    n, b = src.shape
    if cols is not None and (cols.dtype != torch.int32 or cols.dim() != 1
                             or not cols.is_contiguous() or not cols.numel()):
        raise TypeError("cols must be a non-empty contiguous 1-D int32 list")
    if out.dtype not in (torch.int8, torch.uint8) or out.dim() != 2 \
            or not out.is_contiguous() or out.shape[0] != n:
        raise ValueError(f"out must be contiguous (n, width) int8 (dense) or "
                         f"uint8 (packed) rows, n = {n}")
    if counts.dtype != torch.int32 or counts.shape != (n,) \
            or not counts.is_contiguous():
        raise ValueError(f"counts must be a contiguous ({n},) int32 vector")
    n_cols = 8 * b if cols is None else cols.numel()
    room = out.shape[1] * (1 if out.dtype == torch.int8 else 8)
    if out.shape[1] % 16 or n_cols > room:
        raise ValueError(f"out rows ({out.shape[1]} bytes) must be a "
                         f"multiple of 16 bytes holding {n_cols} columns")
    return n_cols


def gather_rows_device_plain(src, cols, out, counts):
    """Plain version of :func:`gather_rows_device` on src's device: the
    rows' bits (:func:`unpack_rows_device`), the listed columns, their
    sums, then the padded int8 rows or the bits packed again MSB first."""
    n_cols = _gather_prep(src, cols, out, counts)
    bits = unpack_rows_device(src)
    if cols is not None:
        if int(cols.min()) < 0 or int(cols.max()) >= bits.shape[1]:
            raise ValueError(f"cols must lie in [0, {bits.shape[1]})")
        bits = bits[:, cols.to(torch.int64)]
    counts.copy_(bits.sum(dim=1, dtype=torch.int32))
    out.zero_()
    if out.dtype == torch.int8:
        out[:, :n_cols] = bits
    else:
        n_bytes = -(-n_cols // 8)
        planes = torch.zeros((src.shape[0], n_bytes * 8), dtype=torch.int32,
                             device=src.device)
        planes[:, :n_cols] = bits
        weights = 2 ** torch.arange(7, -1, -1, dtype=torch.int32,
                                    device=src.device)
        out[:, :n_bytes] = (planes.view(-1, n_bytes, 8) * weights).sum(
            dim=2).to(torch.uint8)
    return out, counts


def gather_rows_device(src, cols, out, counts):
    """Rows of the scan's resident, and of the two sides of the mixed
    scan's cross-segment rectangles, from the store's raw packed rows:
    the launch site of ld_gather_rows_kernel (csrc/ld_gather_rows.cu),
    which replaces no TPU kernel (the JAX scan repacks and popcounts on
    the host).

    ``src`` (n, B) uint8 holds the store's rows (8 haplotypes a byte, MSB
    first); ``cols`` a (k,) int32 list of bit columns (a cohort's
    haplotypes, in order) or None for every bit of a row in order.  Row r
    of ``out`` becomes the listed bits of source row r: int8 {0, 1} when
    ``out`` is int8 (the dense resident), packed bytes MSB first when it
    is uint8; past the list every column is 0.  ``counts[r]`` becomes the
    row's alt count over the list.  ``out``'s rows are a multiple of 16
    bytes.  Each column must lie below 8 * B: checked here for CPU
    tensors; on the card the caller checks (a check would wait for the
    card) and a column past the row reads 0.  Returns (out, counts).
    """
    tensors = (src, out, counts) + (() if cols is None else (cols,))
    if not _on_card(*tensors):
        return gather_rows_device_plain(src, cols, out, counts)
    n_cols = _gather_prep(src, cols, out, counts)
    n, b = src.shape
    if n:
        if src.data_ptr() % 16 or out.data_ptr() % 16:
            raise ValueError("src and out must start 16-byte aligned")
        grid = min(-(-n // 8), 16 * _sm_count(src.device))
        err = _launch(
            "ldk_gather_rows", src.device, src.data_ptr(), n, b,
            None if cols is None else cols.data_ptr(), n_cols,
            int(out.dtype == torch.int8), out.shape[1], grid,
            out.data_ptr(), counts.data_ptr())
        _cuda_build.check(err, "ld_gather_rows_kernel")
        gather_rows_device.launches += 1
    return out, counts


gather_rows_device.launches = 0

LAUNCH_SITES = (
    ld_triangle_blocks, ld_triangle_blocks_bf16, ld_triangle_blocks_tf32,
    ld_triangle_blocks_packed, ld_band_sweep_blocks,
    ld_band_sweep_blocks_packed, ld_band_count, ld_band_count_packed,
    ld_band_count_sharded, ld_stage_blocks, gather_rows_device,
)


def reset_launches() -> None:
    """Zero every kernel's launch count."""
    for fn in LAUNCH_SITES:
        fn.launches = 0


# ---- the JAX package's entry points ----------------------------------------


# ld_triangle_matrix's mxu_dtype (the name or the torch dtype) -> its route
_TRIANGLE_SITES = {
    "int8": (torch.int8, ld_triangle_blocks),
    "bfloat16": (torch.bfloat16, ld_triangle_blocks_bf16),
    "float32": (torch.float32, ld_triangle_blocks_tf32),
}


def _triangle_site(mxu_dtype):
    for name, (dt, site) in _TRIANGLE_SITES.items():
        if mxu_dtype in (name, dt):
            return site
    raise ValueError(f"unknown mxu_dtype {mxu_dtype!r}: use "
                     f"{', '.join(_TRIANGLE_SITES)}")


def _triangle_pad(v, block_m, block_n):
    block_m = min(block_m, _round_up(v, 128))
    block_n = min(block_n, _round_up(v, 128))
    return block_m, block_n, _round_up(v, max(block_m, block_n))


def _triangle_run(site, g_pad, c1, n_haplotypes, v, *, block_m, block_n,
                  epilogue, want_dprime):
    dev = g_pad.device
    ipq = _ipq_from_counts(c1, torch.tensor(_f32_inv(n_haplotypes)[0],
                                            dtype=torch.float32, device=dev))
    bi, bj = _triangle_coords(g_pad.shape[0] // block_m)
    cij = torch.from_numpy(pack_block_coords(bi, bj)).to(dev)
    r2, dp = site(g_pad, c1, ipq, cij, n_haplotypes, block_m=block_m,
                  block_n=block_n, epilogue=epilogue,
                  want_dprime=want_dprime)
    return r2[:v, :v], (dp[:v, :v] if dp is not None else None)


def ld_triangle_matrix(
    G,
    n_haplotypes=None,
    *,
    block_m: int = 512,
    block_n: int = 512,
    want_dprime: bool = True,
    mxu_dtype="int8",
    epilogue: str = "exact",
):
    """All-pairs r^2/D' for G (V, H) {0,1}: lower-triangle blocks only
    (ld_pallas.ld_triangle_matrix).

    Returns (r2, d_prime) as (V, V) f32 tensors on G's device; cells of
    blocks above the diagonal are 0 (callers take tril).  ``epilogue=
    "fast"`` (r^2 only) is the divide-free form of the headline
    benchmark.  ``mxu_dtype`` ("int8", "bfloat16" or "float32", or the
    torch dtype) picks the tensor-core route: the int8 count of
    :func:`ld_triangle_blocks` (K1), or the bf16 / tf32 products of
    :func:`ld_triangle_blocks_bf16` / :func:`ld_triangle_blocks_tf32`
    (K1b), which give the same values bit for bit.
    """
    site = _triangle_site(mxu_dtype)
    G = torch.as_tensor(G)
    _on_card(G)
    v, h = G.shape
    if n_haplotypes is None:
        n_haplotypes = h
    block_m, block_n, v_pad = _triangle_pad(v, block_m, block_n)
    g_pad = torch.zeros((v_pad, _round_up(h, 128)), dtype=torch.int8,
                        device=G.device)
    g_pad[:v, :h] = G.to(torch.int8)
    c1 = g_pad.to(torch.float32).sum(dim=1)
    return _triangle_run(site, g_pad, c1, n_haplotypes, v, block_m=block_m,
                         block_n=block_n, epilogue=epilogue,
                         want_dprime=want_dprime)


def ld_triangle_matrix_packed(
    gp,
    n_haplotypes: int,
    *,
    block_m: int = 512,
    block_n: int = 512,
    want_dprime: bool = True,
    epilogue: str = "exact",
    kernel: str = "dense",
):
    """All-pairs r^2/D' straight from the BITPACKED store matrix
    (ld_pallas.ld_triangle_matrix_packed).

    ``gp`` is the (V, ceil(H/8)) uint8 matrix exactly as ingest writes it.
    ``kernel="dense"`` pads the byte width to a multiple of 16, inflates
    the bytes to int8 on the device once (:func:`unpack_rows_device`) and
    runs K1 (:func:`ld_triangle_blocks`); ``kernel="bitplane"`` pads it to
    a multiple of 128 and keeps the bytes packed through K2
    (:func:`ld_triangle_blocks_packed`), 8x less device memory.  c1 comes
    from the bytes' popcounts.  Both give the values of
    :func:`ld_triangle_matrix` on the unpacked rows bit for bit (padding
    bits are zero).
    """
    if kernel not in ("dense", "bitplane"):
        raise ValueError(f"kernel must be 'dense' or 'bitplane', got {kernel!r}")
    gp = torch.as_tensor(gp)
    _on_card(gp)
    if gp.dtype != torch.uint8:
        raise TypeError(f"packed rows must be uint8, got {gp.dtype}")
    v, hp8 = gp.shape
    if hp8 * 8 < n_haplotypes:
        raise ValueError(f"{hp8} bytes cannot hold {n_haplotypes} haplotypes")
    block_m, block_n, v_pad = _triangle_pad(v, block_m, block_n)
    gp_pad = torch.zeros((v_pad, _round_up(hp8, 16 if kernel == "dense"
                                            else 128)),
                         dtype=torch.uint8, device=gp.device)
    gp_pad[:v, :hp8] = gp
    c1 = popcount_rows(gp_pad)
    if kernel == "dense":
        site, g_pad = ld_triangle_blocks, unpack_rows_device(gp_pad)
    else:
        site, g_pad = ld_triangle_blocks_packed, gp_pad
    return _triangle_run(site, g_pad, c1, n_haplotypes, v, block_m=block_m,
                         block_n=block_n, epilogue=epilogue,
                         want_dprime=want_dprime)


def ld_band_sweep(
    g_rows,
    g_cols,
    c1_rows,
    c1_cols,
    ipq_rows,
    ipq_cols,
    n_haplotypes,
    *,
    packed: bool,
    outs: tuple = ("meas",),
    sel: int = 0,
    block_m: int = 256,
    block_n: int = 512,
):
    """Band sweep, rows-block x cols-block grid (ld_pallas.ld_band_sweep):
    {name: (Vr, Va)} over the full grid, through ld_band_sweep_blocks
    (K3) or, for ``packed=True``, ld_band_sweep_blocks_packed (K4).

    Dense inputs are int8 {0,1} pre-padded to block multiples; packed
    inputs are the store's bitpacked uint8 bytes padded to a 128-multiple
    byte width."""
    vr, va = g_rows.shape[0], g_cols.shape[0]
    if vr % block_m or va % block_n:
        raise ValueError(
            f"band sweep needs rows/cols divisible by the block "
            f"({block_m}/{block_n}); got {vr}/{va}"
        )
    nbi, nbj = vr // block_m, va // block_n
    bi, bj = np.meshgrid(np.arange(nbi), np.arange(nbj), indexing="ij")
    cij = torch.from_numpy(pack_block_coords(bi.ravel(), bj.ravel())).to(
        g_rows.device)
    sweep = ld_band_sweep_blocks_packed if packed else ld_band_sweep_blocks
    out = sweep(
        g_rows, g_cols, c1_rows, c1_cols, ipq_rows, ipq_cols, cij,
        n_haplotypes, outs=outs, sel=sel, block_m=block_m, block_n=block_n,
    )
    return {
        o: t.reshape(nbi, nbj, block_m, block_n).permute(0, 2, 1, 3)
        .reshape(vr, va)
        for o, t in out.items()
    }


def _band_ipq(c1, n_haplotypes):
    return _ipq_from_counts(
        c1.to(torch.float32),
        torch.tensor(float(np.float32(n_haplotypes)), dtype=torch.float32,
                     device=c1.device),
    )


def ld_band_pallas(
    G_rows,
    G_all,
    c1_rows,
    c1_all,
    n_haplotypes,
    *,
    block_m: int = 256,
    block_n: int = 512,
):
    """Dense band sweep, rows-block x all columns, exact-order epilogue
    (ld_pallas.ld_band_pallas).  Returns (r2, dp)."""
    if G_rows.dtype != torch.int8 or G_all.dtype != torch.int8:
        raise TypeError(
            "ld_band_pallas requires int8 {0,1} genotype blocks, got "
            f"{G_rows.dtype}/{G_all.dtype}"
        )
    out = ld_band_sweep(
        G_rows, G_all, c1_rows, c1_all,
        _band_ipq(c1_rows, n_haplotypes), _band_ipq(c1_all, n_haplotypes),
        n_haplotypes, packed=False, outs=("r2", "dp"),
        block_m=block_m, block_n=block_n,
    )
    return out["r2"], out["dp"]


def ld_band_pallas_packed(
    gp_rows,
    gp_cols,
    c1_rows,
    c1_all,
    n_haplotypes,
    *,
    block_m: int = 256,
    block_n: int = 512,
):
    """Band sweep over BITPACKED blocks (uint8, 8 haplotypes a byte),
    exact-order epilogue (ld_pallas.ld_band_pallas_packed): the contract
    of :func:`ld_band_pallas` with the bytes kept packed end to end
    through K4.  Shapes are pre-padded to block multiples on the variant
    axes and to a 128-multiple byte width.  Returns (r2, dp)."""
    out = ld_band_sweep(
        gp_rows, gp_cols, c1_rows, c1_all,
        _band_ipq(c1_rows, n_haplotypes), _band_ipq(c1_all, n_haplotypes),
        n_haplotypes, packed=True, outs=("r2", "dp"),
        block_m=block_m, block_n=block_n,
    )
    return out["r2"], out["dp"]
