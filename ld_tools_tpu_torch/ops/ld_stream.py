"""Chromosome-scale streamed all-pairs scan with on-device thresholding.

Counterpart of ld_tools_tpu/ops/ld_stream.py for one device and one
process.  The genotype matrix goes to the device once (``prepare_resident``)
in one of two layouts, chosen as the JAX scan chooses them: the store's
bitpacked bytes inflated to int8 on the device (chr21 scale is 115,200 x
5,120 int8 = 590 MB), or, past ``TPU_LD_DENSE_RESIDENT_BYTES`` of int8
(4 GiB by default: some 839,000 variants of 5,008 haplotypes), kept
packed (a 1.1M-variant chromosome is 713 MB packed, 5.7 GB inflated).
Then:

- pass 1 counts the kept pairs of every ``count_block``-square block of
  the lower triangle with the fused count kernel (``ld_band_count``:
  K5 on int8 rows, K6 on packed bytes): one int32 per block leaves the
  device;
- pass 2 sweeps only the blocks that have hits with the band kernel
  (``ld_band_sweep_blocks`` K3, or ``ld_band_sweep_blocks_packed`` K4)
  in batches, rebuilds the same keep mask
  from its outputs, compacts the survivors with ``torch.nonzero``
  (row-major, like the JAX package's ``_compact_true_positions``) and
  checks every block's pass-2 hits against its pass-1 count;
- exact scans re-finish the hits in f64 on the host from their integer
  counts (``_exact_refilter_counts``), fast scans return the f32 values.

One tiling serves both devices.  The JAX tile path (band x chunk tiles,
bucketed fetches, over-cap sub-tiles) has no counterpart: a block of at
most 2048^2 cells can never exceed the JAX ``cap_per_tile`` (1 << 22),
and ``torch.nonzero`` sizes its own output.  The final lexsort makes the
output order independent of the tiling.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time

import numpy as np
import torch

from ld_tools_tpu_torch.ingest import pack as _pack
from ld_tools_tpu_torch.ops.exact import exact_ld_elementwise, round4
from ld_tools_tpu_torch.ops.ld_kernels import (
    block_keep_mask,
    ld_band_count,
    ld_band_sweep_blocks,
    ld_band_sweep_blocks_packed,
    mask_source,
    pack_block_coords,
    unpack_rows_device,
)
from ld_tools_tpu_torch.utils.device import resolve_device
from ld_tools_tpu_torch.utils.logging import get_logger

log = get_logger("ops.ld_stream")

# n*c_ab and c1*c2 must stay int32-exact for the integer threshold mask:
# n^2 < 2^31 -> n <= 46340 haplotypes (23k samples).  Larger cohorts fall
# back to the f32 epilogue mask.
_EXACT_MASK_MAX_HAP = 46340

# JAX's per-tile hit cap; the largest count_block keeps every block's
# area within it, so the over-cap path needs no counterpart
_CAP_PER_TILE = 1 << 22
_MAX_COUNT_BLOCK = 2048

# pass-2 cells per batch of hit blocks: bounds the device temporaries of
# one batch (an int32 count tile plus its f32 mask intermediates)
_FETCH_CELLS_PER_BATCH = 1 << 26

# the JAX scan's default tiling, which fixes the resident padding
_BAND = 3840
_CHUNK = 7680

# resident layouts (the JAX scan's ``resident`` argument)
_RESIDENT_MODES = ("auto", "dense", "packed")


def dense_resident_limit() -> int:
    """Bytes of inflated int8 above which ``resident="auto"`` keeps a
    packed input packed: $TPU_LD_DENSE_RESIDENT_BYTES, default 4 GiB, the
    JAX scan's knob read the same way."""
    return int(os.environ.get("TPU_LD_DENSE_RESIDENT_BYTES", str(4 << 30)))


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass
class ScanHits:
    """Threshold-surviving pairs from a streamed scan (host arrays).

    ``i``/``j`` index rows of the scanned G with i > j.  With exact=True
    the values are f64 finished in the reference op order and the int-0
    sentinel masks are populated; otherwise they are the device f32 and
    the hit set is the raw device mask, one 4-dp rounding step below
    ``thres``.
    """

    i: np.ndarray
    j: np.ndarray
    r_square: np.ndarray
    d_prime: np.ndarray
    r_square_is_int_zero: np.ndarray = None
    d_prime_is_int_zero: np.ndarray = None
    exact: bool = False
    stats: dict = None  # per-phase seconds and block counts


@dataclasses.dataclass
class Resident:
    """The scan's device state: the padded matrix and its per-row vectors,
    exactly as the JAX scan lays them out
    (ld_tools_tpu/ops/ld_stream.py:1062-1132)."""

    g: torch.Tensor       # (v_pad, w) int8 {0,1}, or uint8 bytes if packed;
                          # padding rows/cols are 0
    c1: torch.Tensor      # (v_pad, 1) f32 alt counts; 0 for padding rows
    ipq: torch.Tensor     # (v_pad, 1) f32 1/(p*q); 0 monomorphic/padding
    pos: torch.Tensor     # (v_pad,) int32; padding rows at -2^30
    c1_full: np.ndarray   # (v,) int64 host alt counts
    packed: bool = False  # g holds the bitpacked bytes (8 haplotypes each)

    @property
    def h_bits(self) -> int:
        """Haplotype columns of g (padding included)."""
        return self.g.shape[1] * (8 if self.packed else 1)


def prepare_resident(G_or_packed, n_haplotypes, pos, device, *,
                     packed: bool = False,
                     resident: str = "auto") -> Resident:
    """Turn the store's host arrays into the scan's device tensors.

    ``G_or_packed`` is int8 (V, H) {0,1}, or with ``packed=True`` the
    store's bitpacked uint8 (V, ceil(H/8)) bytes, which go to the device
    packed.  There they are inflated to int8 when ``resident`` is
    "dense", or "auto" and the inflated matrix (v_pad * w_bytes * 8)
    stays within :func:`dense_resident_limit`; otherwise (and always for
    "packed") they stay packed.  This is the JAX scan's rule
    (ld_stream.py:1108-1127).  Padding follows the JAX scan at its
    default tiling: V_pad = round_up(V, max(band, chunk)) + max(band,
    chunk), the haplotype axis to a multiple of 128 (bytes, when packed).
    """
    if resident not in _RESIDENT_MODES:
        raise ValueError(f"resident must be one of {_RESIDENT_MODES}, "
                         f"got {resident!r}")
    dev = resolve_device(device)
    if packed:
        src = np.ascontiguousarray(G_or_packed, dtype=np.uint8)
        v = src.shape[0]
        c1_full = _pack.popcounts(src)
        w = _round_up(src.shape[1], 128)
    else:
        src = np.asarray(G_or_packed, dtype=np.int8)
        v, h = src.shape
        c1_full = src.astype(np.int64).sum(axis=1)
        w = _round_up(h, 128)
    band = min(_BAND, _round_up(v, 256))
    chunk = min(_CHUNK, _round_up(v, 512))
    v_pad = _round_up(v, max(band, chunk)) + max(band, chunk)
    g_host = np.zeros((v_pad, w), dtype=src.dtype)
    g_host[:v, : src.shape[1]] = src
    c1_host = np.zeros((v_pad, 1), dtype=np.float32)
    c1_host[:v, 0] = c1_full
    p_host = c1_host / np.float32(n_haplotypes)
    pq_host = p_host * (np.float32(1.0) - p_host)
    ipq_host = np.where(
        pq_host == 0.0,
        np.float32(0.0),
        np.float32(1.0) / np.where(pq_host == 0.0, np.float32(1.0), pq_host),
    ).astype(np.float32)
    pos_host = np.full((v_pad,), -(2**30), dtype=np.int32)
    pos_host[:v] = np.asarray(pos, dtype=np.int64)
    g = torch.from_numpy(g_host).to(dev)
    del g_host
    if packed and resident != "packed" and (
            resident == "dense" or v_pad * w * 8 <= dense_resident_limit()):
        # inflate once on the device: the transfer stayed packed
        g = unpack_rows_device(g)
        packed = False
    return Resident(
        g=g,
        c1=torch.from_numpy(c1_host).to(dev),
        ipq=torch.from_numpy(ipq_host).to(dev),
        pos=torch.from_numpy(pos_host).to(dev),
        c1_full=c1_full,
        packed=packed,
    )


# Device-resident scan inputs cached across calls: a repeat scan of the
# same matrix skips host prep and upload.  Keyed by a caller-supplied
# identity (the caller guarantees the bytes behind one key never change)
# plus the input form, the resident layout (the requested one, and for
# "auto" the limit it resolves against) and a hash of ``pos``.  Capacity in entries (default 1: a chromosome-scale resident
# matrix is ~0.6-0.7 GB of device memory).
_RESIDENT_CACHE = {}
_RESIDENT_CACHE_ORDER = []


def _resident_cache_cap() -> int:
    return int(os.environ.get("TPU_LD_RESIDENT_CACHE_ENTRIES", "1"))


def clear_resident_cache() -> None:
    _RESIDENT_CACHE.clear()
    _RESIDENT_CACHE_ORDER.clear()


def _resident_cache_get(key):
    entry = _RESIDENT_CACHE.get(key)
    if entry is not None:
        _RESIDENT_CACHE_ORDER.remove(key)
        _RESIDENT_CACHE_ORDER.append(key)
    return entry


def _resident_cache_put(key, entry) -> None:
    cap = _resident_cache_cap()
    if cap <= 0:
        return
    if key in _RESIDENT_CACHE:
        _RESIDENT_CACHE_ORDER.remove(key)
    _RESIDENT_CACHE[key] = entry
    _RESIDENT_CACHE_ORDER.append(key)
    while len(_RESIDENT_CACHE_ORDER) > cap:
        victim = _RESIDENT_CACHE_ORDER.pop(0)
        del _RESIDENT_CACHE[victim]


def _scan_blocks(v: int, pos: np.ndarray, count_block: int, max_dist):
    """(bi, bj) of every lower-triangle block that can hold a kept pair.

    With a distance window, a block wholly below the diagonal whose
    closest pair (first row, last col; positions ascend) is farther
    apart than ``max_dist`` is pruned on the host."""
    nb = -(-v // count_block)
    bi, bj = np.tril_indices(nb)
    if max_dist is not None:
        row_lo = bi * count_block
        col_hi = bj * count_block + count_block - 1
        below = col_hi < row_lo
        row_s = np.minimum(row_lo, v - 1)
        col_e = np.minimum(col_hi, v - 1)
        far = pos[row_s] - pos[col_e] > max_dist
        keep = ~(below & far)
        bi, bj = bi[keep], bj[keep]
    return bi, bj


def stream_threshold_scan(
    G=None,
    pos=None,
    n_haplotypes=None,
    *,
    G_packed=None,
    measure: str = "r_square",
    thres: float,
    max_dist=None,
    count_block: int = 640,
    exact: bool = True,
    checkpoint_dir=None,
    mesh=None,
    resident: str = "auto",
    multiprocess: bool = False,
    resident_key=None,
    device="cuda",
) -> ScanHits:
    """Scan all lower-triangle pairs of G; keep measure >= thres.

    Input is ``G`` (int8 (V, H) {0,1}) or ``G_packed`` (the store's
    bitpacked uint8 (V, ceil(H/8)) with ``n_haplotypes``).  The device
    filter compares exact scaled integers one 4-dp rounding step below
    ``thres``; ``exact=True`` re-finishes the hits in f64 and re-filters
    on the rounded values (the reference's post-rounding threshold).
    ``device`` is "cuda" (the hand-written kernels) unless the caller asks
    for "cpu" (their plain PyTorch versions).  ``resident`` ("auto",
    "dense" or "packed") picks the device layout of a packed input, as in
    the JAX scan (see :func:`prepare_resident`); the scan's kernels follow
    it (K5/K3 on int8 rows, K6/K4 on packed bytes) and the hits do not
    depend on it.  ``resident_key`` opts the device tensors into a small
    cross-call cache.

    Not ported yet, and refused rather than ignored: ``checkpoint_dir``
    (ROADMAP queue 6), ``mesh`` (queue 8) and ``multiprocess`` (queue 8).
    """
    if checkpoint_dir is not None:
        raise NotImplementedError(
            "scan checkpoints are not ported yet (ROADMAP queue 6)")
    if mesh is not None:
        raise NotImplementedError(
            "mesh-sharded scans are not ported yet (ROADMAP queue 8)")
    if multiprocess:
        raise NotImplementedError(
            "cooperative multi-process scans are not ported yet "
            "(ROADMAP queue 8)")
    if resident not in _RESIDENT_MODES:
        raise ValueError(f"resident must be one of {_RESIDENT_MODES}, "
                         f"got {resident!r}")
    if not 0 < count_block <= _MAX_COUNT_BLOCK:
        raise ValueError(
            f"count_block must be in (0, {_MAX_COUNT_BLOCK}], got {count_block}")
    assert count_block * count_block <= _CAP_PER_TILE
    dev = resolve_device(device)

    stats = {"host_prep_s": 0.0, "upload_s": 0.0, "count_s": 0.0,
             "fetch_s": 0.0, "finish_s": 0.0}
    t0 = time.perf_counter()
    packed = G_packed is not None
    if packed:
        src = np.ascontiguousarray(G_packed, dtype=np.uint8)
        if n_haplotypes is None:
            raise ValueError("G_packed requires n_haplotypes")
        v = src.shape[0]
        h = int(n_haplotypes)
    else:
        src = np.asarray(G, dtype=np.int8)
        v, h = src.shape
        if n_haplotypes is None:
            n_haplotypes = h
    if measure not in ("r_square", "d_prime"):
        raise ValueError(
            f"measure must be 'r_square' or 'd_prime', got {measure!r}")
    if v == 0:
        return _empty_hits(exact, stats)
    if pos is None:
        pos = np.arange(v, dtype=np.int64)
    pos = np.asarray(pos, dtype=np.int64)
    sel = 0 if measure == "r_square" else 1
    margin_thres = float(thres) - 5e-4
    use_dist = max_dist is not None
    if use_dist:
        # the host block pruning assumes ascending positions, and the
        # device filter carries positions as int32 with a -2^30 padding
        # sentinel: violating either would drop or keep the wrong pairs
        if pos.shape[0] != v:
            raise ValueError("pos length must equal the variant count")
        if v and (np.any(np.diff(pos) < 0) or pos[0] < 0
                  or pos[-1] >= 2**30):
            raise ValueError(
                "max_dist scans require ascending positions in "
                "[0, 2^30); sort the variants (the packed store always "
                "is) or drop max_dist"
            )

    cache_key = None
    if resident_key is not None:
        # the layout: "auto" resolves against the limit in force
        layout = (resident, dense_resident_limit() if resident == "auto"
                  else None)
        cache_key = (
            resident_key, packed, v, h, int(n_haplotypes), layout, str(dev),
            hashlib.sha256(np.ascontiguousarray(pos).tobytes()).hexdigest(),
        )
    res = _resident_cache_get(cache_key) if cache_key is not None else None
    stats["resident_hit"] = 1.0 if res is not None else 0.0
    stats["host_prep_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if res is None:
        res = prepare_resident(src, n_haplotypes, pos, dev, packed=packed,
                               resident=resident)
        if cache_key is not None:
            _resident_cache_put(cache_key, res)
    _sync(dev)
    stats["upload_s"] = time.perf_counter() - t0

    n_hap = int(n_haplotypes)
    exact_mask = n_hap <= _EXACT_MASK_MAX_HAP
    want = ("cab",) if exact else ("r2", "dp")
    # the mask source first ("cab" for the integer mask, the f32 "meas"
    # past the int32-exact bound), then whatever else the hits carry home
    mask_src = mask_source(exact_mask)
    outs = (mask_src,) + tuple(x for x in want if x != mask_src)
    # counts are bounded by the haplotype axis (in bits when packed, as
    # at JAX ld_stream.py:1177): int16 halves the per-hit bytes of the
    # exact fetch (downcast after the mask has used int32)
    cab_dtype = torch.int16 if res.h_bits < 32768 else torch.int32
    stats["resident_packed"] = float(res.packed)
    stats["resident_bytes"] = float(res.g.numel() * res.g.element_size())

    # pass 1: one fused count per block
    t0 = time.perf_counter()
    bi_np, bj_np = _scan_blocks(v, pos, count_block, max_dist)
    cij_np = pack_block_coords(bi_np, bj_np)
    counts = ld_band_count(
        res.g, res.c1, res.ipq, res.pos, torch.from_numpy(cij_np).to(dev),
        (n_hap, max_dist if use_dist else 0), (margin_thres,),
        packed=res.packed, sel=sel, exact_mask=exact_mask, use_dist=use_dist,
        block_m=count_block, block_n=count_block,
    ).cpu().numpy().astype(np.int64)
    stats["count_s"] = time.perf_counter() - t0
    stats["blocks"] = int(cij_np.shape[0])

    # pass 2: sweep the hit blocks in batches, compact, check
    t0 = time.perf_counter()
    hit = np.flatnonzero(counts > 0)
    stats["hit_blocks"] = int(hit.size)
    per_batch = max(1, _FETCH_CELLS_PER_BATCH // (count_block * count_block))
    sweep = ld_band_sweep_blocks_packed if res.packed else ld_band_sweep_blocks
    parts = {name: [] for name in ("i", "j") + want}
    n_device_hits = 0
    stats["blocks_checked"] = 0
    for lo in range(0, hit.size, per_batch):
        sel_blocks = hit[lo:lo + per_batch]
        cij = torch.from_numpy(cij_np[sel_blocks]).to(dev)
        vals = sweep(
            res.g, res.g, res.c1, res.c1, res.ipq, res.ipq, cij, n_hap,
            outs=outs, sel=sel, block_m=count_block, block_n=count_block,
        )
        bi = torch.from_numpy(bi_np[sel_blocks].astype(np.int64)).to(dev)
        bj = torch.from_numpy(bj_np[sel_blocks].astype(np.int64)).to(dev)
        keep = block_keep_mask(
            vals, res.c1, res.pos, bi, bj, n_hap, margin_thres, max_dist,
            sel=sel, exact_mask=exact_mask, use_dist=use_dist,
            block_m=count_block, block_n=count_block)
        k, r, c = torch.nonzero(keep, as_tuple=True)
        # both passes apply the same mask to the same integer counts (or
        # the same compiled f32 measure): any disagreement is a fault
        got = torch.bincount(k, minlength=len(sel_blocks)).cpu().numpy()
        if not np.array_equal(got, counts[sel_blocks]):
            bad = np.flatnonzero(got != counts[sel_blocks])
            raise RuntimeError(
                f"pass-2 hits disagree with pass-1 counts in "
                f"{bad.size} block(s), first at block "
                f"({bi_np[sel_blocks][bad[0]]}, {bj_np[sel_blocks][bad[0]]}): "
                f"{got[bad[0]]} vs {counts[sel_blocks][bad[0]]}"
            )
        stats["blocks_checked"] += len(sel_blocks)
        n_device_hits += int(k.shape[0])
        i = bi[k] * count_block + r
        j = bj[k] * count_block + c
        real = (i < v) & (j < v)  # drop padding-row pairs
        parts["i"].append(i[real].cpu().numpy())
        parts["j"].append(j[real].cpu().numpy())
        for name in want:
            x = vals[name][k, r, c][real]
            if name == "cab":
                x = x.to(cab_dtype)
            parts[name].append(x.cpu().numpy())
        del vals, keep
    stats["fetch_s"] = time.perf_counter() - t0
    stats["device_hits"] = n_device_hits

    t0 = time.perf_counter()
    if not parts["i"] or sum(a.size for a in parts["i"]) == 0:
        return _empty_hits(exact, stats)
    arrs = {name: np.concatenate(a) for name, a in parts.items()}
    order = np.lexsort((arrs["j"], arrs["i"]))
    arrs = {name: a[order] for name, a in arrs.items()}
    if not exact:
        result = ScanHits(i=arrs["i"], j=arrs["j"], r_square=arrs["r2"],
                          d_prime=arrs["dp"], exact=False)
    else:
        result = _exact_refilter_counts(
            arrs["cab"], res.c1_full, n_haplotypes, arrs["i"], arrs["j"],
            measure, thres,
        )
    stats["finish_s"] = time.perf_counter() - t0
    result.stats = stats
    log.info("scan phases: %s",
             " ".join(f"{k}={s:.2f}" for k, s in stats.items()))
    return result


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _empty_hits(exact: bool, stats: dict) -> ScanHits:
    z = np.zeros((0,))
    zi = z.astype(np.int64)
    return ScanHits(i=zi, j=zi, r_square=z, d_prime=z,
                    r_square_is_int_zero=z.astype(bool),
                    d_prime_is_int_zero=z.astype(bool), exact=exact,
                    stats=stats)


def _exact_refilter_counts(
    cab, c1_full, n_hap, i, j, measure, thres
) -> ScanHits:
    """Re-finish hits in f64 straight from exact integer counts; filter on
    the rounded values (the reference thresholds post-rounding,
    ld_area.py:248).  Pure elementwise f64 over the hits."""
    exact = exact_ld_elementwise(cab, c1_full[i], c1_full[j], n_hap)
    meas = exact.r_square if measure == "r_square" else exact.d_prime
    int_zero = (
        exact.r_square_is_int_zero
        if measure == "r_square"
        else exact.d_prime_is_int_zero
    )
    rounded = round4(meas)
    rounded[int_zero] = 0.0
    keep = rounded >= thres
    return ScanHits(
        i=i[keep], j=j[keep],
        r_square=exact.r_square[keep], d_prime=exact.d_prime[keep],
        r_square_is_int_zero=exact.r_square_is_int_zero[keep],
        d_prime_is_int_zero=exact.d_prime_is_int_zero[keep],
        exact=True,
    )
