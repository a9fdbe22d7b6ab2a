"""Count engine of the workload tools: the counterpart of
ld_tools_tpu/ops/engine.py.

Exact alt+alt co-occurrence counts of two {0, 1} row blocks, padded to
stable shapes, sent home as integers and finished bit-exactly in f64
(``ops/exact.py``).  The JAX engine counts with a plain XLA int8 dot (no
Pallas kernel), so the card's counts here are the port's
``ld_math.haplotype_counts_int8`` (``torch._int_mm``); on the CPU the
same function runs an int32 product.  Jobs below ``_HOST_COUNTS_MACS``
multiply-accumulates run in host f32 BLAS in both packages (exact below
2^24), so a single ``ld_lite`` pair never touches the card.

The async forms issue each job's upload, product and copy home on a side
stream of the call's own, and ``finalize()`` waits on the call's own
event: ``tools/common.map_files`` runs up to 8 tool threads, so nothing
here keeps a stream or event shared between calls.  Every job counted on
the card adds one to ``count_on_device.launches``.

``rect_candidates_async`` is the port's own (JAX's scan finishes every
cell of a cross-segment rectangle on the host): it takes the two sides
as tensors already on the card, tests the threshold there beside the
counts and sends home only the cells that pass.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from ld_tools_tpu_torch.ops.exact import ExactLD, exact_ld_from_counts
from ld_tools_tpu_torch.ops.ld_kernels import exact_keep_mask
from ld_tools_tpu_torch.ops.ld_math import haplotype_counts_int8
from ld_tools_tpu_torch.utils.device import device_guard, resolve_device

_launch_lock = threading.Lock()


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _downcast_counts(c_ab, hap_axis: int):
    """Counts are bounded by the haplotype axis, so below 32,768 they
    travel home as int16 (half the bytes).  ONE rule shared by every
    count path (``ld_stream``'s ``cab`` too) so their dtypes never drift
    (engine._downcast_counts)."""
    return c_ab.to(torch.int16) if hap_axis < 32768 else c_ab


def count_on_device(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The engine's count of two padded int8 blocks on their device:
    ``torch._int_mm`` on the card, an int32 product on the CPU, downcast
    by :func:`_downcast_counts`.  Bumps ``count_on_device.launches`` for
    a card's job (under a lock: tool threads call this at once)."""
    c_ab = _downcast_counts(haplotype_counts_int8(a, b), a.shape[1])
    if a.device.type == "cuda":
        with _launch_lock:
            count_on_device.launches += 1
    return c_ab


count_on_device.launches = 0


def reset_launches() -> None:
    """Zero the engine's launch count."""
    with _launch_lock:
        count_on_device.launches = 0


def _pad_rows(x: np.ndarray, rows: int) -> np.ndarray:
    if x.shape[0] == rows:
        return x
    out = np.zeros((rows, x.shape[1]), dtype=x.dtype)
    out[: x.shape[0]] = x
    return out


def _pad_cols(x: np.ndarray, cols: int) -> np.ndarray:
    if x.shape[1] == cols:
        return x
    out = np.zeros((x.shape[0], cols), dtype=x.dtype)
    out[:, : x.shape[1]] = x
    return out


# Below this many MACs the counts run on the HOST (f32 BLAS, exact for
# {0,1} sums under 2^24): a single ld_lite pair or a handful of ld_area
# query rows costs microseconds in numpy but would pay a launch, two
# copies and a synchronisation on the card.
_HOST_COUNTS_MACS = 1 << 26


def _pair_counts_host(a: np.ndarray, b: np.ndarray, sums: bool = True):
    """The counts in host f32 BLAS, with each side's row sums unless
    ``sums`` is False."""
    af = np.ascontiguousarray(a, dtype=np.float32)
    bf = np.ascontiguousarray(b, dtype=np.float32)
    c_ab = (af @ bf.T).astype(np.int32)
    if not sums:
        return c_ab
    return c_ab, af.sum(axis=1), bf.sum(axis=1)


def _launch(dev: torch.device, work, after=None):
    """Run ``work()`` on a side stream of this call on the card ``dev``
    (after the event ``after``, where given) and record an event behind
    it.  Returns (its outputs, the stream, the event)."""
    with device_guard(dev):
        stream = torch.cuda.Stream(dev)
        if after is not None:
            stream.wait_event(after)
        with torch.cuda.stream(stream):
            outs = work()
            done = torch.cuda.Event()
            done.record(stream)
    return outs, stream, done


def _issue(dev: torch.device, work, after=None):
    """Run ``work()`` (a tuple of device tensors out) and copy its
    outputs home; on the card all of it on a side stream of this call
    (:func:`_launch`), the copies into pinned buffers.  Returns
    ``wait() -> tuple of host tensors``."""
    if dev.type != "cuda":
        out = work()
        return lambda: out

    def work_home():
        outs = work()
        host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                     for t in outs)
        for h, t in zip(host, outs):
            h.copy_(t, non_blocking=True)
        return host

    host, _, done = _launch(dev, work_home, after)

    def wait():
        done.synchronize()
        return host

    return wait


def pair_counts(a: np.ndarray, b: np.ndarray, row_pad: int = 128,
                hap_pad: int = 512, device="cuda"):
    """Exact co-occurrence + allele counts for two {0,1} blocks.

    Pads the variant axes to multiples of ``row_pad`` and the haplotype
    axis to ``hap_pad`` (zero padding is count-neutral; the true
    haplotype count travels separately).  Returns numpy (c_ab, c1, c2)
    trimmed to the true shape.  Tiny jobs (under ``_HOST_COUNTS_MACS``
    multiply-accumulates) skip the device and run in host BLAS: exact
    either way.
    """
    return pair_counts_async(a, b, row_pad, hap_pad, device)()


def pair_counts_async(a: np.ndarray, b: np.ndarray, row_pad: int = 128,
                      hap_pad: int = 512, device="cuda"):
    """Issue the count job for (a, b) on ``device`` WITHOUT waiting.

    Returns a zero-arg ``finalize() -> (c_ab, c1, c2)`` (numpy, trimmed).
    On the card the upload, the product and the copy home run on a side
    stream of this call, so a caller can issue block k+1's counts before
    finalizing block k: the device work and the transfers of the next
    block overlap the host's exact f64 finish and file writes of the
    current one.  Tiny jobs run eagerly on the host like ``pair_counts``.
    """
    n_hap = a.shape[1]
    if b.shape[1] != n_hap:
        raise ValueError(
            f"haplotype axes differ: {a.shape[1]} vs {b.shape[1]}: "
            "zero-padding the narrower side would silently corrupt "
            "the counts"
        )
    va, vb = a.shape[0], b.shape[0]
    # host path: f32 BLAS partial sums are exact only below 2^24, far
    # past any real cohort, but the guard keeps 'exact either way' honest
    if (va * vb * max(n_hap, 1) < _HOST_COUNTS_MACS
            and n_hap < (1 << 24)):
        out = _pair_counts_host(a, b)
        return lambda: out
    dev = resolve_device(device)
    h = _round_up(max(n_hap, 1), hap_pad)
    ap = _pad_cols(_pad_rows(np.asarray(a, dtype=np.int8),
                             _round_up(max(va, 1), row_pad)), h)
    bp = _pad_cols(_pad_rows(np.asarray(b, dtype=np.int8),
                             _round_up(max(vb, 1), row_pad)), h)

    def work():
        ta = torch.from_numpy(np.ascontiguousarray(ap)).to(dev,
                                                          non_blocking=True)
        tb = torch.from_numpy(np.ascontiguousarray(bp)).to(dev,
                                                          non_blocking=True)
        return (count_on_device(ta, tb), ta.to(torch.float32).sum(dim=1),
                tb.to(torch.float32).sum(dim=1))

    wait = _issue(dev, work)

    def finalize():
        c_ab, c1, c2 = wait()
        return c_ab.numpy()[:va, :vb], c1.numpy()[:va], c2.numpy()[:vb]

    return finalize


def rect_candidates_async(a: torch.Tensor, b: torch.Tensor, c1, c2,
                          n_hap: int, len1: int, len2: int,
                          mask_thres: float, sel: int, pos1=None, pos2=None,
                          max_dist=None):
    """Start one cross-ploidy rectangle's count job with its threshold
    test WITHOUT waiting (the mixed-ploidy scan's rectangles).

    ``a`` (V1, W) and ``b`` (V2, W) are the two sides' int8 {0, 1} rows on
    one device, each zero past its own list of ``len1`` / ``len2``, so
    their product over W is the zip over the first ``n_hap`` = min(len1,
    len2) columns (calc_ld.py:30-33); ``c1`` (V1,) and ``c2`` (V2,) are
    each row's alt count over its own full list, int32 on that device.
    On the card, on the job's side stream (after the work issued so far
    on the current stream, which built the sides): the int32 counts,
    :func:`ld_kernels.exact_keep_mask` at ``mask_thres`` for measure
    ``sel`` (0 r^2, 1 D') with the two lengths and, with ``max_dist``,
    |pos1 - pos2| <= max_dist.  Returns ``finalize() -> (rows, cols,
    c_ab)``: the cells that pass, row-major, as int64 offsets into the
    rectangle with their counts.  ``finalize()`` waits on the job's
    event, then compacts on the card, so no count matrix travels home.
    CPU tensors run the same test at once; below ``_HOST_COUNTS_MACS``
    their counts are a host f32 BLAS product.
    """
    if a.shape[1] != b.shape[1] or a.device != b.device:
        raise ValueError(
            f"the sides must share a width and a device: {a.shape[1]} on "
            f"{a.device} vs {b.shape[1]} on {b.device}")
    dev = a.device
    va, vb, w = a.shape[0], b.shape[0], a.shape[1]

    def test(cab):
        keep = exact_keep_mask(cab, c1[:, None], c2[None, :], n_hap,
                               mask_thres, sel, len1=len1, len2=len2)
        if max_dist is not None:
            p1, p2 = (torch.from_numpy(np.asarray(p, dtype=np.int64)).to(
                dev, non_blocking=True) for p in (pos1, pos2))
            keep &= (p1[:, None] - p2[None, :]).abs() <= int(max_dist)
        return keep

    def compact(cab, keep):
        rows, cols = torch.nonzero(keep, as_tuple=True)
        out = torch.stack((rows, cols, cab[rows, cols].to(torch.int64)))
        out = out.cpu().numpy()
        return out[0], out[1], out[2]

    if dev.type != "cuda":
        if va * vb * max(w, 1) < _HOST_COUNTS_MACS and w < (1 << 24):
            cab = torch.from_numpy(
                _pair_counts_host(a.numpy(), b.numpy(), sums=False))
        else:  # count_on_device's downcast is exact; the mask reads int32
            cab = count_on_device(a, b).to(torch.int32)
        out = compact(cab, test(cab))
        return lambda: out

    def work():
        stream = torch.cuda.current_stream(dev)
        for t in (a, b, c1, c2):  # freed by the caller while in use here
            t.record_stream(stream)
        cab = count_on_device(a, b).to(torch.int32)
        return cab, test(cab)

    with device_guard(dev):
        built = torch.cuda.Event()
        built.record()
    (cab, keep), stream, done = _launch(dev, work, after=built)

    def finalize():
        done.synchronize()
        with device_guard(dev), torch.cuda.stream(stream):
            return compact(cab, keep)

    return finalize


def exact_pair_ld(a: np.ndarray, b: np.ndarray, n_haplotypes=None,
                  device="cuda") -> ExactLD:
    """Counts on ``device``, bit-exact finish on the host."""
    if n_haplotypes is None:
        n_haplotypes = a.shape[1]
    c_ab, c1, c2 = pair_counts(a, b, device=device)
    return exact_ld_from_counts(c_ab, c1, c2, n_haplotypes)


def exact_all_pairs(G: np.ndarray, block: int = 4096,
                    device="cuda") -> ExactLD:
    """All-pairs LD for one chromosome set, streamed in device blocks.

    For V <= block this is a single count job; larger V uploads G once
    (:class:`ResidentCounts`) and streams row-band x column-prefix blocks
    with a two-slot pipeline (block k+1's counts in flight while block
    k's land in the output matrix); the upper half is mirrored on the
    host.  int32 accumulation routes the finish through the native
    one-pass path (ops/exact.py).
    """
    v, h = G.shape
    if v <= block:
        return exact_pair_ld(G, G, device=device)
    resident = ResidentCounts(G, block_pad=block, device=device)
    c_ab = np.empty((v, v), dtype=np.int32)
    starts = list(range(0, v, block))
    pending = None
    for i in starts + [None]:
        fin_prev = pending
        if i is not None:
            r1 = min(i + block, v)
            pending = (i, r1, resident.block_async(i, r1, r1))
        if fin_prev is not None:
            p0, p1, fin = fin_prev
            cb, _, _ = fin()
            c_ab[p0:p1, :p1] = cb
            c_ab[:p1, p0:p1] = cb.T  # mirror (diagonal block overlaps)
    c1_full = resident.row_counts[:v].astype(np.float64)
    return exact_ld_from_counts(c_ab, c1_full, c1_full, h)


@dataclasses.dataclass
class MixedExactLD:
    """Exact LD for row sets spanning ploidy groups (chrX/chrY).

    Unlike ExactLD, the alt-allele frequencies are PAIR-dependent
    matrices: the reference divides each variant's alt count by the pair
    walk length ``htypes_quan = min(len1, len2)`` (calc_ld.py:37-44), so
    a PAR variant's reported frequency changes with the opponent's
    region.  ``own_freq1``/``own_freq2`` are the pair-independent
    own-list frequencies (alt count / own list length) the reference
    uses for the ld_area query-annotation row (ld_area.py:188-189).
    """

    r_square: np.ndarray          # (V1, V2) f64
    d_prime: np.ndarray
    p1: np.ndarray                # (V1, V2) pair-dependent alt freqs
    p2: np.ndarray                # (V1, V2)
    d_prime_is_int_zero: np.ndarray
    r_square_is_int_zero: np.ndarray
    own_freq1: np.ndarray         # (V1,)
    own_freq2: np.ndarray         # (V2,)
    _r2_rounded_cache: object = dataclasses.field(
        default=None, init=False, repr=False, compare=False
    )
    _dp_rounded_cache: object = dataclasses.field(
        default=None, init=False, repr=False, compare=False
    )

    def r_square_rounded(self):
        from ld_tools_tpu_torch.ops.exact import _rounded_object_array

        if self._r2_rounded_cache is None:
            self._r2_rounded_cache = _rounded_object_array(
                self.r_square, self.r_square_is_int_zero
            )
        return self._r2_rounded_cache

    def d_prime_rounded(self):
        from ld_tools_tpu_torch.ops.exact import _rounded_object_array

        if self._dp_rounded_cache is None:
            self._dp_rounded_cache = _rounded_object_array(
                self.d_prime, self.d_prime_is_int_zero
            )
        return self._dp_rounded_cache

    def pair(self, i: int, j: int) -> dict:
        """Reference calc_ld dict for pair (i, j), values AND types."""
        from ld_tools_tpu_torch.ops.exact import _rounded_scalar

        return {
            "r_square": _rounded_scalar(
                self.r_square[i, j], self.r_square_is_int_zero[i, j]
            ),
            "d_prime": _rounded_scalar(
                self.d_prime[i, j], self.d_prime_is_int_zero[i, j]
            ),
            "var_1_alt_freq": round(float(self.p1[i, j]), 4),
            "var_2_alt_freq": round(float(self.p2[i, j]), 4),
        }


def mixed_pair_ld_async(chrom_data, cohort_ploidy, rows1, rows2,
                        device="cuda"):
    """Issue LD for two variant-row sets that may span ploidy groups.

    Rows are partitioned by ploidy-profile id; each (group, group) block
    is one count job over the two profiles' cohort layouts truncated to
    the shorter one (the reference's zip semantics, calc_ld.py:30-33),
    finished bit-exactly with per-side list lengths.  Returns
    ``finalize() -> MixedExactLD``; every block is issued before any is
    awaited.  Each call extracts and uploads its own row sets.
    """
    rows1 = np.asarray(rows1, dtype=np.int64)
    rows2 = np.asarray(rows2, dtype=np.int64)
    g1 = cohort_ploidy.groups_of(rows1)
    g2 = cohort_ploidy.groups_of(rows2)

    def side(rows, groups):
        out = []
        for gid in np.unique(groups):
            idx = np.flatnonzero(groups == gid)
            C = chrom_data.genotype_rows(rows[idx])[
                :, cohort_ploidy.cols_for(gid)
            ]
            out.append((int(gid), idx, C, C.sum(axis=1, dtype=np.int64)))
        return out

    side1 = side(rows1, g1)
    side2 = side(rows2, g2)

    jobs = []
    for gid1, idx1, c_1, full1 in side1:
        n1 = cohort_ploidy.n_alleles(gid1)
        for gid2, idx2, c_2, full2 in side2:
            n2 = cohort_ploidy.n_alleles(gid2)
            m = min(n1, n2)
            fin = pair_counts_async(c_1[:, :m], c_2[:, :m], device=device)
            jobs.append((idx1, idx2, full1, full2, n1, n2, m, fin))

    def finalize() -> MixedExactLD:
        v1, v2 = rows1.shape[0], rows2.shape[0]
        shape = (v1, v2)
        r2 = np.zeros(shape)
        dp = np.zeros(shape)
        p1 = np.zeros(shape)
        p2 = np.zeros(shape)
        r2_iz = np.zeros(shape, dtype=bool)
        dp_iz = np.zeros(shape, dtype=bool)
        own1 = np.zeros(v1)
        own2 = np.zeros(v2)
        for idx1, idx2, full1, full2, n1, n2, m, fin in jobs:
            c_ab, _, _ = fin()
            ex = exact_ld_from_counts(
                c_ab, full1, full2, m, len1=n1, len2=n2
            )
            at = np.ix_(idx1, idx2)
            r2[at] = ex.r_square
            dp[at] = ex.d_prime
            r2_iz[at] = ex.r_square_is_int_zero
            dp_iz[at] = ex.d_prime_is_int_zero
            p1[at] = np.broadcast_to(ex.p1[:, None], c_ab.shape)
            p2[at] = np.broadcast_to(ex.p2[None, :], c_ab.shape)
            own1[idx1] = full1 / float(n1)
            own2[idx2] = full2 / float(n2)
        return MixedExactLD(
            r_square=r2, d_prime=dp, p1=p1, p2=p2,
            d_prime_is_int_zero=dp_iz, r_square_is_int_zero=r2_iz,
            own_freq1=own1, own_freq2=own2,
        )

    return finalize


def mixed_pair_ld(chrom_data, cohort_ploidy, rows1, rows2,
                  device="cuda") -> MixedExactLD:
    return mixed_pair_ld_async(chrom_data, cohort_ploidy, rows1, rows2,
                               device)()


class ResidentCounts:
    """Device-resident G for repeated (row block) x (column prefix) counts.

    G uploads ONCE (padded to ``block_pad`` rows and ``hap_pad``
    haplotypes); each block is two slices of it on the device feeding
    :func:`count_on_device`, issued on a side stream of the call.  The
    allele counts are computed once on the host and sliced.
    """

    def __init__(self, G: np.ndarray, block_pad: int = 2048,
                 hap_pad: int = 512, device="cuda"):
        G = np.ascontiguousarray(G, dtype=np.int8)
        v, h = G.shape
        self._v, self._h = v, h
        self._block_pad = block_pad
        self._dev = resolve_device(device)
        h_p = _round_up(max(h, 1), hap_pad)
        v_p = _round_up(max(v, 1), block_pad)
        gp = np.zeros((v_p, h_p), dtype=np.int8)
        gp[:v, :h] = G
        self._g = torch.from_numpy(gp).to(self._dev)
        # the blocks' side streams start after the upload
        self._ready = None
        if self._dev.type == "cuda":
            with device_guard(self._dev):
                self._ready = torch.cuda.Event()
                self._ready.record()
        # allele counts once on the host: per-block device reductions
        # (and their copies home) buy nothing over slicing this
        self._c1 = G.astype(np.float32).sum(axis=1)

    @property
    def row_counts(self) -> np.ndarray:
        """(V,) f32 per-variant alt-allele counts."""
        return self._c1

    def block_async(self, r0: int, r1: int, c_hi: int):
        """Issue counts for rows [r0, r1) x cols [0, c_hi); returns
        ``finalize() -> (c_ab, c1_rows, c1_cols)`` trimmed numpy.

        ``r0 + rows_pad`` must stay inside the padded matrix (true for
        block_pad-aligned r0), as the JAX engine requires: its
        dynamic_slice would clamp an out-of-range start to the wrong
        rows, where a torch slice would come back short.
        """
        rows_pad = _round_up(max(r1 - r0, 1), self._block_pad)
        cols_pad = _round_up(max(c_hi, 1), self._block_pad)
        if r0 + rows_pad > self._g.shape[0] or r0 < 0:
            raise ValueError(
                f"rows [{r0}, {r0 + rows_pad}) exceed the padded matrix "
                f"({self._g.shape[0]} rows); r0 must be "
                f"block_pad-aligned ({self._block_pad})"
            )
        if c_hi > self._g.shape[0]:
            raise ValueError("c_hi exceeds the matrix")
        g = self._g
        wait = _issue(self._dev, lambda: (
            count_on_device(g[r0:r0 + rows_pad], g[:cols_pad]),),
            after=self._ready)

        def finalize():
            (c_ab,) = wait()
            return (
                c_ab.numpy()[: r1 - r0, :c_hi],
                self._c1[r0:r1],
                self._c1[:c_hi],
            )

        return finalize
