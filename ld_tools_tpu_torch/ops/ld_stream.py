"""Chromosome-scale streamed all-pairs scan with on-device thresholding.

Counterpart of ld_tools_tpu/ops/ld_stream.py.  The genotype matrix goes to
the device once (``prepare_resident``) in one of two layouts, chosen as
the JAX scan chooses them: the store's bitpacked rows (a cohort's columns
of them) gathered to int8 on the device (chr21 scale is 115,200 x 5,120
int8 = 590 MB), or, past
``TPU_LD_DENSE_RESIDENT_BYTES`` of int8 (4 GiB by default: some 839,000
variants of 5,008 haplotypes), kept packed (a 1.1M-variant chromosome is
713 MB packed, 5.7 GB inflated).  The work follows the JAX scan's tiles
(band x chunk, ``max_tiles_per_call`` a batch); inside a batch:

- pass 1 counts the kept pairs of every ``count_block``-square block of
  the lower triangle with the fused count kernel (``ld_band_count``: K5
  on int8 rows, K6 on packed bytes; over a shard list K7,
  ``ld_band_count_sharded``): one int32 per block leaves the device;
- pass 2 sweeps only the blocks that have hits with the band kernel
  (``ld_band_sweep_blocks`` K3, or ``ld_band_sweep_blocks_packed`` K4),
  split over the shards, rebuilds the same keep mask from its outputs,
  compacts the survivors with ``torch.nonzero`` (row-major, like the JAX
  package's ``_compact_true_positions``) and checks every block's pass-2
  hits against its pass-1 count;
- a finished batch's hits may go to a checkpoint file, from which a later
  call resumes; a cooperative scan over a torch.distributed group splits
  the tiles over the processes and gathers the hits at the end;
- exact scans re-finish the hits in f64 on the host from their integer
  counts (``_exact_refilter_counts``), fast scans return the f32 values.

The JAX fetch machinery (bucketed fetches, over-cap sub-tiles) has no
counterpart: a block of at most 2048^2 cells can never exceed the JAX
``cap_per_tile`` (1 << 22), and ``torch.nonzero`` sizes its own output.
The final lexsort makes the output order independent of the tiling, the
shards and the processes.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time

import numpy as np
import torch

from ld_tools_tpu_torch.ops import _cuda_build
from ld_tools_tpu_torch.ops.exact import exact_ld_elementwise, round4
from ld_tools_tpu_torch.ops.ld_kernels import (
    KEEP_MARGIN,
    block_keep_mask,
    gather_rows_device,
    ld_band_count,
    ld_band_count_sharded,
    ld_band_sweep_blocks,
    ld_band_sweep_blocks_packed,
    mask_source,
    pack_block_coords,
    shard_devices,
    shard_slices,
)
from ld_tools_tpu_torch.utils.device import device_guard, resolve_device
from ld_tools_tpu_torch.utils.distributed import (local_device, process_count,
                                                  process_index)
from ld_tools_tpu_torch.utils.logging import get_logger
from ld_tools_tpu_torch.utils.profiling import span

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

# store rows a pinned staging chunk carries to the card (41 MB of a
# 5,008-haplotype store's 626-byte rows)
_STAGE_ROWS = 65536


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
    ``thres``.  ``stats`` holds the phases' seconds, the block counts and
    the resident's layout: ``resident_packed`` (1 packed, 0 int8) and,
    where this scan uploaded it (no resident-cache hit),
    ``resident_dense`` (1 int8, 0 packed; :func:`prepare_resident`).
    """

    i: np.ndarray
    j: np.ndarray
    r_square: np.ndarray
    d_prime: np.ndarray
    r_square_is_int_zero: np.ndarray = None
    d_prime_is_int_zero: np.ndarray = None
    exact: bool = False
    stats: dict = None  # per-phase seconds and block counts

    @classmethod
    def empty(cls, exact: bool, stats: dict = None) -> "ScanHits":
        """No hits, with every array's dtype."""
        z = np.zeros((0,))
        return cls(i=z.astype(np.int64), j=z.astype(np.int64), r_square=z,
                   d_prime=z, r_square_is_int_zero=z.astype(bool),
                   d_prime_is_int_zero=z.astype(bool), exact=exact,
                   stats=stats)


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


def scan_columns(cols, row_bytes: int):
    """A cohort's bit columns as the gather takes them: None (every
    column of the store's rows, in order) for None or for the identity
    over all ``8 * row_bytes`` bits of a row, else the list as int64.  A
    list that stops short of the row's last bit stays a list: the bits
    past it may be haplotypes the cohort leaves out.  Raises on a column
    outside the row."""
    if cols is None:
        return None
    cols = np.asarray(cols, dtype=np.int64).reshape(-1)
    if cols.size == 0:
        raise ValueError("cols must name at least one column")
    if cols.min() < 0 or cols.max() >= 8 * row_bytes:
        raise ValueError(f"cols must lie in [0, {8 * row_bytes})")
    if cols.size == 8 * row_bytes and np.array_equal(
            cols, np.arange(cols.size)):
        return None
    return cols


def _cols_sha(cols):
    return (None if cols is None
            else hashlib.sha256(cols.tobytes()).hexdigest())


def prepare_resident(G_or_packed, n_haplotypes, pos, device, *,
                     packed: bool = False, cols=None, resident: str = "auto",
                     band: int = _BAND, chunk: int = _CHUNK,
                     stats: dict = None) -> Resident:
    """Turn the store's host arrays into the scan's device tensors.

    ``G_or_packed`` is int8 (V, H) {0,1}, or with ``packed=True`` the
    store's bitpacked uint8 (V, B) rows as they lie on disk (a memory map
    does), with ``cols`` the cohort's bit columns (None: every bit of a
    row in order, the bits past ``n_haplotypes`` being the store's zero
    padding; with a list, ``n_haplotypes`` is its length).  Packed rows are
    gathered into the resident on the device
    (:func:`ld_kernels.gather_rows_device`): int8 {0,1} when
    ``resident`` is "dense", or "auto" and the int8 matrix (v_pad *
    w_bytes * 8) stays within :func:`dense_resident_limit`; otherwise
    (and always for "packed") packed bytes.  This is the JAX scan's rule
    (ld_stream.py:1108-1127).  Padding follows the JAX scan at the tiling
    ``band`` x ``chunk`` (clamped as the scan clamps it): V_pad =
    round_up(V, max(band, chunk)) + max(band, chunk), the haplotype axis
    to a multiple of 128 (bytes, when packed); padding rows and columns
    are 0.

    The host's one pass over packed rows is a copy of each
    ``_STAGE_ROWS``-row chunk into one of two pinned buffers; each chunk
    goes over on the current stream and the gather writes its rows of the
    resident and their alt counts, which come home as ``c1_full``.
    ``stats`` gets the host part (those copies; the per-row vectors) as
    ``upload_host_s``, the transfers, launches and the wait for the
    counts as ``upload_copy_s``, the gather's own time as
    ``gather_rows_s``
    (two CUDA events around each launch, summed; the host clock on the
    CPU), ``resident_gather`` (1: built from packed rows by the gather; 0:
    an int8 host array came in) and the layout as ``resident_dense`` (1
    int8, 0 packed).
    """
    if resident not in _RESIDENT_MODES:
        raise ValueError(f"resident must be one of {_RESIDENT_MODES}, "
                         f"got {resident!r}")
    stats = {} if stats is None else stats
    dev = resolve_device(device)
    if packed:
        g, c1_full = _gather_resident(G_or_packed, cols, dev, resident,
                                      band, chunk, stats)
    else:
        if cols is not None:
            raise ValueError("cols selects bit columns of packed rows")
        with span("scan.upload_host", stats, "upload_host_s"):
            src = np.asarray(G_or_packed, dtype=np.int8)
            v, h = src.shape
            c1_full = src.astype(np.int64).sum(axis=1)
            v_pad = _padded_rows(v, band, chunk)
            g_host = np.zeros((v_pad, _round_up(h, 128)), dtype=np.int8)
            g_host[:v, :h] = src
        with span("scan.upload_copy", stats, "upload_copy_s"):
            g = torch.from_numpy(g_host).to(dev)
        del g_host
        stats["resident_gather"] = 0.0
    v, v_pad = c1_full.shape[0], g.shape[0]
    with span("scan.upload_host", stats, "upload_host_s"):
        c1_host = np.zeros((v_pad, 1), dtype=np.float32)
        c1_host[:v, 0] = c1_full
        p_host = c1_host / np.float32(n_haplotypes)
        pq_host = p_host * (np.float32(1.0) - p_host)
        ipq_host = np.where(
            pq_host == 0.0,
            np.float32(0.0),
            np.float32(1.0) / np.where(pq_host == 0.0, np.float32(1.0),
                                       pq_host),
        ).astype(np.float32)
        pos_host = np.full((v_pad,), -(2**30), dtype=np.int32)
        pos_host[:v] = np.asarray(pos, dtype=np.int64)
    with span("scan.upload_copy", stats, "upload_copy_s"):
        packed = g.dtype == torch.uint8
        stats["resident_dense"] = float(not packed)
        return Resident(
            g=g,
            c1=torch.from_numpy(c1_host).to(dev),
            ipq=torch.from_numpy(ipq_host).to(dev),
            pos=torch.from_numpy(pos_host).to(dev),
            c1_full=c1_full,
            packed=packed,
        )


def _padded_rows(v: int, band: int, chunk: int) -> int:
    """The resident's rows: V padded as the JAX scan pads it at the
    tiling band x chunk, clamped as the scan clamps it."""
    band = min(band, _round_up(v, 256))
    chunk = min(chunk, _round_up(v, 512))
    return _round_up(v, max(band, chunk)) + max(band, chunk)


def _gather_resident(src, cols, dev, resident, band, chunk, stats):
    """:func:`prepare_resident` for packed rows: (g, c1_full)."""
    src = np.asarray(src, dtype=np.uint8)
    if not src.flags.c_contiguous:
        src = np.ascontiguousarray(src)
    v, b = src.shape
    cols = scan_columns(cols, b)
    n_cols = 8 * b if cols is None else cols.size
    w = _round_up(-(-n_cols // 8), 128)
    v_pad = _padded_rows(v, band, chunk)
    dense = resident != "packed" and (
        resident == "dense" or v_pad * w * 8 <= dense_resident_limit())
    g = torch.empty((v_pad, w * 8 if dense else w),
                    dtype=torch.int8 if dense else torch.uint8, device=dev)
    g[v:].zero_()
    counts = torch.empty((v,), dtype=torch.int32, device=dev)
    cols_dev = (None if cols is None
                else torch.from_numpy(cols.astype(np.int32)).to(dev))
    rows = max(1, min(_STAGE_ROWS, v))
    on_card = dev.type == "cuda"
    if on_card:
        # two pinned staging buffers and their device twins: the host
        # fills one while the other's copy runs; a buffer is filled again
        # once the copy that read it has finished (``freed``), a device
        # twin once the stream's earlier gather has read it
        stage = [torch.empty((rows * b,), dtype=torch.uint8,
                             pin_memory=True) for _ in range(2)]
        landing = [torch.empty((rows * b,), dtype=torch.uint8, device=dev)
                   for _ in range(2)]
        freed = [None, None]
        stream = torch.cuda.current_stream(dev)
        timed = []
        _cuda_build.lib()  # built (a checkout's first scan) before any event
    gather_rows_s = 0.0
    for k, r0 in enumerate(range(0, v, rows)):
        n = min(rows, v - r0)
        out, cnt = g[r0:r0 + n], counts[r0:r0 + n]
        if not on_card:
            t0 = time.perf_counter()
            gather_rows_device(torch.from_numpy(np.array(src[r0:r0 + n])),
                               cols_dev, out, cnt)
            gather_rows_s += time.perf_counter() - t0
            continue
        slot = k % 2
        if freed[slot] is not None:
            freed[slot].synchronize()
        with span("scan.upload_host", stats, "upload_host_s"):
            np.copyto(stage[slot][:n * b].numpy().reshape(n, b),
                      src[r0:r0 + n])
        with span("scan.upload_copy", stats, "upload_copy_s"):
            rows_dev = landing[slot][:n * b].view(n, b)
            rows_dev.copy_(stage[slot][:n * b].view(n, b), non_blocking=True)
            freed[slot] = torch.cuda.Event()
            freed[slot].record(stream)
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record(stream)
            gather_rows_device(rows_dev, cols_dev, out, cnt)
            events[1].record(stream)
            timed.append(events)
    with span("scan.upload_copy", stats, "upload_copy_s"):
        c1_full = counts.cpu().numpy().astype(np.int64)
    if on_card:
        gather_rows_s = sum(a.elapsed_time(z) for a, z in timed) / 1e3
    stats["gather_rows_s"] = stats.get("gather_rows_s", 0.0) + gather_rows_s
    stats["resident_gather"] = 1.0
    return g, c1_full


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
    apart than ``max_dist`` is pruned on the host.  Positions ascend, so
    a block row keeps one run of columns, from the first whose last
    position lies within ``max_dist`` of the row's first up to the
    diagonal, and the lists are built from those runs: time and memory
    follow the kept blocks, not every block pair."""
    nb = -(-v // count_block)
    if max_dist is None:
        return np.tril_indices(nb)
    rows = np.arange(nb)
    # block bj < bi lies wholly below the diagonal: its last column is
    # bj * count_block + count_block - 1 < v
    col_last = pos[rows[:-1] * count_block + count_block - 1]
    first = np.minimum(np.searchsorted(
        col_last, pos[rows * count_block] - max_dist, side="left"), rows)
    return _runs(rows, first, rows + 1)


def _runs(rows, start, stop):
    """(row, col) of the runs ``start[k] <= col < stop[k]`` of each row
    ``rows[k]``, row by row."""
    n = stop - start
    row = np.repeat(rows, n)
    return row, np.arange(row.size) - np.repeat(np.cumsum(n) - n - start, n)


def _scan_tiles(v, pos, band, chunk, bi, bj, count_block, max_dist):
    """The scan's tiles and the tile of each block.

    Tiles are the JAX scan's ``band`` x ``chunk`` tiles in its order (row
    bands, then column chunks up to the diagonal) with its whole-tile
    distance pruning (ld_stream.py:1139-1152).  A block belongs to the
    tile that holds its top-left cell.  A tile the pruning drops is kept
    all the same when it holds a block that can hold a kept pair, which
    happens only when ``count_block`` does not divide the tiling.
    As in :func:`_scan_blocks`, a row band keeps one run of chunks up to
    the diagonal (the pruned ones, wholly left of the band, come first),
    so the tiles cost what is kept.
    Returns (tiles: [(r0, c0)], home: each block's index into tiles)."""
    n_r, n_c = -(-v // band), -(-v // chunk)
    r0 = np.arange(n_r) * band
    # a band's chunks are c0 < r0 + nr; its first r0 // chunk lie wholly
    # left of it, where the window may prune them
    stop = -(-np.minimum(r0 + band, v) // chunk)
    first = np.zeros(n_r, dtype=np.int64)
    if max_dist is not None:
        col_last = pos[np.arange(v // chunk) * chunk + chunk - 1]
        first = np.minimum(np.searchsorted(
            col_last, pos[r0] - max_dist, side="left"), r0 // chunk)
    tr = bi.astype(np.int64) * count_block // band
    tc = bj.astype(np.int64) * count_block // chunk
    # tile keys ascend in the scan's order
    key = tr * n_c + tc
    run_r, run_c = _runs(np.arange(n_r), first, stop)
    keys = run_r * n_c + run_c
    kept = np.unique(key[tc < first[tr]])  # the has-a-block exception
    if kept.size:
        keys = np.union1d(keys, kept)
    tiles = list(zip((keys // n_c * band).tolist(),
                     (keys % n_c * chunk).tolist()))
    return tiles, np.searchsorted(keys, key)


def _replicate(res: Resident, devices) -> dict:
    """{device: Resident}: one resident copy per distinct device."""
    out = {}
    for d in devices:
        if d not in out:
            out[d] = res if res.g.device == d else dataclasses.replace(
                res, g=res.g.to(d), c1=res.c1.to(d), ipq=res.ipq.to(d),
                pos=res.pos.to(d))
    return out


def _scan_devices(mesh, device) -> list:
    """The scan's shard devices: ``mesh`` (one device per shard, a device
    may repeat) or the one ``device``; each resolved, so a card that is
    not there raises."""
    devices = [device] if mesh is None else list(mesh)
    return shard_devices([resolve_device(d) for d in devices])


def scan_mesh(n_devices=None, device="cuda") -> list:
    """The shard list of this process's local devices for a sharded scan
    (ld_stream.scan_mesh): every visible card, or under a multi-process
    launcher this process's card (``cuda:(LOCAL_RANK % device_count)``).
    ``n_devices`` takes the first n of them, as JAX's
    ``local_devices()[:n]``: ``scan_mesh(4)`` on one card is that one
    card, and a caller that wants n shards on one card passes
    ``[cuda:0] * n`` itself.  On the CPU it is n CPU shards (default 1),
    the counterpart of the n virtual CPU devices JAX's tests run on.
    Local on purpose, as in JAX: each process shards its own tiles over
    its own cards and the hits of a cooperative scan meet on the host."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * (1 if n_devices is None else int(n_devices))
    own = local_device(dev)
    if own is not None:
        local = [own]
    else:
        local = [torch.device("cuda", k)
                 for k in range(torch.cuda.device_count())]
    return local if n_devices is None else local[:int(n_devices)]


def _allgather_hits(arrs: dict, want) -> dict:
    """Concatenate every process's hit arrays over the torch.distributed
    group (ld_stream._allgather_hits): the sizes first, then each array
    padded to the largest, then trimmed per process.  gloo gathers no
    int16, so every array travels as its bytes and gets its dtype back;
    a hit-less process sends arrays of the same dtypes (the ``cab`` rule)."""
    import torch.distributed as dist

    world = dist.get_world_size()
    n_local = torch.tensor([arrs["i"].shape[0]], dtype=torch.int64)
    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(sizes, n_local)
    sizes = [int(x) for x in sizes]
    cap = max(sizes)
    if cap == 0:
        return arrs
    out = {}
    for name in ("i", "j") + tuple(want):
        a = arrs[name]
        pad = np.zeros((cap,), dtype=a.dtype)
        pad[:a.shape[0]] = a
        buf = torch.from_numpy(pad.view(np.uint8))
        bufs = [torch.empty_like(buf) for _ in range(world)]
        dist.all_gather(bufs, buf)
        out[name] = np.concatenate([
            b.numpy().view(a.dtype)[:n] for b, n in zip(bufs, sizes)])
    return out


def _empty_arrays(want, cab_np) -> dict:
    out = {"i": np.zeros((0,), dtype=np.int64),
           "j": np.zeros((0,), dtype=np.int64)}
    for name in want:
        out[name] = np.zeros((0,), dtype=cab_np if name == "cab"
                             else np.float32)
    return out


def stream_threshold_scan(
    G=None,
    pos=None,
    n_haplotypes=None,
    *,
    G_packed=None,
    cols=None,
    measure: str = "r_square",
    thres: float,
    max_dist=None,
    band: int = _BAND,
    chunk: int = _CHUNK,
    count_block: int = 640,
    max_tiles_per_call: int = 512,
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
    bitpacked uint8 (V, ceil(H/8)) rows) with ``n_haplotypes``, or with
    ``cols``, a cohort's bit columns of those rows (``n_haplotypes``
    defaults to their number), which the upload gathers on the device
    (:func:`prepare_resident`).  The device
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

    The work goes in the JAX scan's order: ``band`` x ``chunk`` tiles,
    ``max_tiles_per_call`` tiles a batch, each block of the count tiling
    in the tile of its top-left cell.  Every batch's count pass is
    launched before any is read.  ``band`` and ``chunk`` keep the JAX
    scan's keywords and defaults so that tests can shrink the tiling as
    the JAX tests do; the tool and its CLI leave them at the defaults.

    ``mesh`` (a sequence of devices, one per shard, a device may repeat;
    see :func:`scan_mesh`) shards each batch: the count pass runs K7
    (:func:`ld_band_count_sharded`) over contiguous slices of the batch's
    blocks, and the hit blocks split contiguously over the shards for
    pass 2.  Each distinct device holds one resident copy; the mesh then
    takes the place of ``device``.  ``multiprocess=True`` under an
    initialised torch.distributed group takes this process's strided
    share of the tiles (``tiles[rank::world]``) and gathers every
    process's hits at the end, so every process returns the identical
    full hit set; all processes must make the call.  ``checkpoint_dir``
    keeps each finished batch's hits in ``scan_{fp}_batch{k}.npz`` (``fp``
    fingerprints the inputs, the tiling and the process's share, not the
    mesh) and a later call with the same fingerprint loads them instead
    of scanning the batch again.  The hits depend on none of these.

    ``ScanHits.stats`` holds each phase's seconds, each phase a span
    (``utils.profiling.span``, named ``scan.<phase>``): ``host_prep_s``,
    ``upload_s`` (its parts ``upload_host_s`` and ``upload_copy_s``; the
    resident's gather ``gather_rows_s`` and ``resident_gather``, where
    this scan uploaded: :func:`prepare_resident`),
    ``plan_s``, ``count_s`` (pass 1's launches and the waits for its
    counts), ``fetch_s`` (pass 2), ``finish_s`` (``gather_s`` inside it for
    a cooperative scan), and the work's counts (``resident_bytes``,
    ``blocks``, ``hit_blocks``, ``device_hits``, ...).  ``pass1_device_s``
    is pass 1's device time between two CUDA events on the stream the
    count kernels launch on; it is left out on the CPU, over a shard list
    of more than one shard, and when every batch resumed from a
    checkpoint.
    """
    if resident not in _RESIDENT_MODES:
        raise ValueError(f"resident must be one of {_RESIDENT_MODES}, "
                         f"got {resident!r}")
    if not 0 < count_block <= _MAX_COUNT_BLOCK:
        raise ValueError(
            f"count_block must be in (0, {_MAX_COUNT_BLOCK}], got {count_block}")
    if max_tiles_per_call < 1:
        raise ValueError("max_tiles_per_call must be at least 1")
    assert count_block * count_block <= _CAP_PER_TILE
    devices = _scan_devices(mesh, device)
    dev = devices[0]
    n_shards = len(devices)

    stats = {"host_prep_s": 0.0, "upload_s": 0.0, "upload_host_s": 0.0,
             "upload_copy_s": 0.0, "plan_s": 0.0, "count_s": 0.0,
             "fetch_s": 0.0, "finish_s": 0.0, "shards": n_shards}
    with span("scan.host_prep", stats, "host_prep_s"):
        packed = G_packed is not None
        if packed:
            src = np.ascontiguousarray(G_packed, dtype=np.uint8)
            cols = scan_columns(cols, src.shape[1])
            if cols is not None:
                if n_haplotypes is None:
                    n_haplotypes = cols.size
                elif int(n_haplotypes) != cols.size:
                    raise ValueError(f"n_haplotypes {n_haplotypes} is not "
                                     f"the {cols.size} columns of cols")
            if n_haplotypes is None:
                raise ValueError("G_packed requires n_haplotypes")
            v = src.shape[0]
            h = int(n_haplotypes)
        else:
            if cols is not None:
                raise ValueError("cols selects bit columns of G_packed")
            src = np.asarray(G, dtype=np.int8)
            v, h = src.shape
            if n_haplotypes is None:
                n_haplotypes = h
        if measure not in ("r_square", "d_prime"):
            raise ValueError(
                f"measure must be 'r_square' or 'd_prime', got {measure!r}")
        if v == 0:
            return ScanHits.empty(exact, stats)
        if pos is None:
            pos = np.arange(v, dtype=np.int64)
        pos = np.asarray(pos, dtype=np.int64)
        band = min(band, _round_up(v, 256))
        chunk = min(chunk, _round_up(v, 512))
        sel = 0 if measure == "r_square" else 1
        margin_thres = float(thres) - KEEP_MARGIN
        use_dist = max_dist is not None
        if use_dist:
            # the host block pruning assumes ascending positions, and the
            # device filter carries positions as int32 with a -2^30
            # padding sentinel: violating either would drop or keep the
            # wrong pairs
            if pos.shape[0] != v:
                raise ValueError("pos length must equal the variant count")
            if v and (np.any(np.diff(pos) < 0) or pos[0] < 0
                      or pos[-1] >= 2**30):
                raise ValueError(
                    "max_dist scans require ascending positions in "
                    "[0, 2^30); sort the variants (the packed store always "
                    "is) or drop max_dist"
                )
        pos_sha = (None if resident_key is None and checkpoint_dir is None
                   else hashlib.sha256(
                       np.ascontiguousarray(pos).tobytes()).hexdigest())

        cache_key = None
        if resident_key is not None:
            # the layout: "auto" resolves against the limit in force
            layout = (resident, dense_resident_limit() if resident == "auto"
                      else None)
            cache_key = (
                resident_key, packed, v, h, int(n_haplotypes), band, chunk,
                layout, tuple(str(d) for d in dict.fromkeys(devices)),
                pos_sha, _cols_sha(cols),
            )
        res = (_resident_cache_get(cache_key) if cache_key is not None
               else None)
        stats["resident_hit"] = 1.0 if res is not None else 0.0
    with span("scan.upload", stats, "upload_s"):
        fresh = res is None
        if fresh:
            res = prepare_resident(
                src, n_haplotypes, pos, dev, packed=packed, cols=cols,
                resident=resident, band=band, chunk=chunk, stats=stats)
        with span("scan.upload_copy", stats, "upload_copy_s"):
            if fresh:
                res = _replicate(res, devices)
            for d in res:
                _sync(d)
        if fresh and cache_key is not None:
            _resident_cache_put(cache_key, res)
    main = res[dev]

    n_hap = int(n_haplotypes)
    exact_mask = n_hap <= _EXACT_MASK_MAX_HAP
    want = ("cab",) if exact else ("r2", "dp")
    # the mask source first ("cab" for the integer mask, the f32 "meas"
    # past the int32-exact bound), then whatever else the hits carry home
    mask_src = mask_source(exact_mask)
    outs = (mask_src,) + tuple(x for x in want if x != mask_src)
    # counts are bounded by the haplotype axis (in bits when packed, as
    # at JAX ld_stream.py:1177): int16 halves the per-hit bytes of the
    # exact fetch (downcast after the mask has used int32).  Empty
    # batches use the same rule: a cooperative scan gathers them.
    cab_dtype = torch.int16 if main.h_bits < 32768 else torch.int32
    cab_np = np.int16 if cab_dtype == torch.int16 else np.int32
    stats["resident_packed"] = float(main.packed)
    stats["resident_bytes"] = float(main.g.numel() * main.g.element_size())

    with span("scan.plan", stats, "plan_s"):
        bi_np, bj_np = _scan_blocks(v, pos, count_block, max_dist)
        tiles, home = _scan_tiles(v, pos, band, chunk, bi_np, bj_np,
                                  count_block, max_dist)
        n_proc, proc_idx = ((process_count(), process_index())
                            if multiprocess else (1, 0))
        # this process's tiles are tiles[proc_idx::n_proc],
        # max_tiles_per_call of them a batch
        mine = home % n_proc == proc_idx
        batch_of = home // n_proc // max_tiles_per_call
        n_my_tiles = len(range(proc_idx, len(tiles), n_proc))
        n_batches = -(-n_my_tiles // max_tiles_per_call)
        stats["batches"] = n_batches

        ckpt = None
        if checkpoint_dir is not None:
            os.makedirs(checkpoint_dir, exist_ok=True)
            # what JAX's fingerprint hashes (ld_stream.py:1197-1204), a tag
            # of the port's own and the rest of its tiling; (n_proc,
            # proc_idx) make a cooperative scan's files per process, and
            # a cohort's column list, where one was given, its cohort's
            fp = hashlib.sha256(repr((
                "torch-v1", want, v, h, n_hap, measure, thres, max_dist,
                band, chunk, count_block, max_tiles_per_call, pos_sha,
                n_proc, proc_idx,
            ) + (() if cols is None else (_cols_sha(cols),))
            ).encode()).hexdigest()[:16]

            def ckpt(k):
                return os.path.join(checkpoint_dir,
                                    f"scan_{fp}_batch{k}.npz")

    # pass 1: every batch's count pass launched before any is read (the
    # block lists go up in one copy: a copy from pageable host memory
    # would wait for the kernels queued before it)
    with span("scan.count", stats, "count_s"):
        live = [k for k in range(n_batches)
                if ckpt is None or not os.path.exists(ckpt(k))]
        blocks = {k: np.flatnonzero(mine & (batch_of == k)) for k in live}
        order = np.concatenate([blocks[k] for k in live]) if live else \
            np.zeros((0,), dtype=np.int64)
        cij_all = pack_block_coords(bi_np[order], bj_np[order])
        cij_dev = torch.from_numpy(cij_all).to(dev)
        params = dict(params_i=(n_hap, max_dist if use_dist else 0),
                      params_f=(margin_thres,), packed=main.packed, sel=sel,
                      exact_mask=exact_mask, use_dist=use_dist,
                      block_m=count_block, block_n=count_block)
        # pass 1's device time: two events on the stream the count kernels
        # launch on, read once pass 2 has waited for the counts; the
        # kernels' library is loaded (in a checkout's first scan, built)
        # before the first, so that the stream does not idle between them
        pass1 = None
        if dev.type == "cuda" and n_shards == 1 and live:
            _cuda_build.lib()
            stream = torch.cuda.current_stream(dev)
            pass1 = (torch.cuda.Event(enable_timing=True),
                     torch.cuda.Event(enable_timing=True))
            pass1[0].record(stream)
        counted = {}
        shard_blocks = [0] * n_shards
        lo = 0
        for k in live:
            cij = cij_dev[lo:lo + blocks[k].size]
            lo += blocks[k].size
            if n_shards == 1:
                counted[k] = ld_band_count(main.g, main.c1, main.ipq,
                                           main.pos, cij, **params)
            else:
                counted[k] = ld_band_count_sharded(
                    devices, *({d: getattr(r, f) for d, r in res.items()}
                               for f in ("g", "c1", "ipq", "pos")), cij,
                    **params)
            for s, (a, b) in enumerate(shard_slices(blocks[k].size,
                                                    n_shards)):
                shard_blocks[s] += b - a
        if pass1 is not None:
            pass1[1].record(stream)
    stats["blocks"] = int(order.size)
    stats["shard_blocks"] = shard_blocks
    stats["batches_resumed"] = n_batches - len(live)

    # pass 2, batch by batch: sweep the hit blocks, compact, check
    per_batch = max(1, _FETCH_CELLS_PER_BATCH // (count_block * count_block))
    sweep = ld_band_sweep_blocks_packed if main.packed else ld_band_sweep_blocks
    hits = {name: [] for name in ("i", "j") + want}
    stats.update(hit_blocks=0, blocks_checked=0, device_hits=0,
                 shard_hit_blocks=[0] * n_shards)
    for k in range(n_batches):
        if k not in counted:
            saved = np.load(ckpt(k))
            for name in hits:
                hits[name].append(saved[name])
            log.info("resumed batch %d from %s", k, ckpt(k))
            continue
        with span("scan.count", stats, "count_s"):
            counts = counted.pop(k).cpu().numpy().astype(np.int64)
        with span("scan.fetch", stats, "fetch_s"):
            hit = blocks[k][counts > 0]
            hit_counts = counts[counts > 0]
            stats["hit_blocks"] += int(hit.size)
            parts = {name: [] for name in hits}
            for s, (a, b) in enumerate(shard_slices(hit.size, n_shards)):
                stats["shard_hit_blocks"][s] += b - a
                r = res[devices[s]]
                with device_guard(devices[s]):
                    for lo in range(a, b, per_batch):
                        hi = min(lo + per_batch, b)
                        _fetch_blocks(
                            r, sweep, bi_np[hit[lo:hi]], bj_np[hit[lo:hi]],
                            hit_counts[lo:hi], parts, stats, v=v,
                            n_hap=n_hap, outs=outs, want=want,
                            cab_dtype=cab_dtype, margin_thres=margin_thres,
                            max_dist=max_dist, sel=sel,
                            exact_mask=exact_mask, use_dist=use_dist,
                            count_block=count_block)
            cat = ({name: np.concatenate(a) for name, a in parts.items()}
                   if parts["i"] else _empty_arrays(want, cab_np))
            if ckpt is not None:
                path = ckpt(k)
                tmp = path + ".tmp"
                with open(tmp, "wb") as fh:
                    np.savez(fh, **cat)
                os.replace(tmp, path)
            for name in hits:
                hits[name].append(cat[name])
    if pass1 is not None:
        stats["pass1_device_s"] = pass1[0].elapsed_time(pass1[1]) / 1e3

    with span("scan.finish", stats, "finish_s"):
        arrs = ({name: np.concatenate(a) for name, a in hits.items()}
                if hits["i"] else _empty_arrays(want, cab_np))
        if n_proc > 1:
            # every process joins the gather (a collective), hit-less ones
            # too
            with span("scan.gather", stats, "gather_s"):
                arrs = _allgather_hits(arrs, want)
        if arrs["i"].size == 0:
            return ScanHits.empty(exact, stats)
        order = np.lexsort((arrs["j"], arrs["i"]))
        arrs = {name: a[order] for name, a in arrs.items()}
        if not exact:
            result = ScanHits(i=arrs["i"], j=arrs["j"], r_square=arrs["r2"],
                              d_prime=arrs["dp"], exact=False)
        else:
            result = _exact_refilter_counts(
                arrs["cab"], main.c1_full[arrs["i"]],
                main.c1_full[arrs["j"]], n_haplotypes, arrs["i"], arrs["j"],
                measure, thres)
    result.stats = stats
    log.info("scan phases: %s", " ".join(f"{k}={_fmt(x)}"
                                          for k, x in stats.items()))
    return result


def _fmt(x) -> str:
    """A stats value for the one-line phase log: seconds to 0.01, lists
    without spaces."""
    if isinstance(x, float):
        return f"{x:.2f}"
    if isinstance(x, list):
        return ",".join(map(str, x))
    return str(x)


def _fetch_blocks(r, sweep, bi_np, bj_np, counts, parts, stats, *, v, n_hap,
                  outs, want, cab_dtype, margin_thres, max_dist, sel,
                  exact_mask, use_dist, count_block):
    """Pass 2 over one batch of hit blocks on one shard's resident copy
    ``r``: sweep, the count pass's keep mask, compaction (row-major, like
    the JAX package's ``_compact_true_positions``), then each block's hits
    against its pass-1 count; appends the hits to ``parts``."""
    dev = r.g.device
    cij = torch.from_numpy(pack_block_coords(bi_np, bj_np)).to(dev)
    vals = sweep(r.g, r.g, r.c1, r.c1, r.ipq, r.ipq, cij, n_hap, outs=outs,
                 sel=sel, block_m=count_block, block_n=count_block)
    bi = torch.from_numpy(bi_np.astype(np.int64)).to(dev)
    bj = torch.from_numpy(bj_np.astype(np.int64)).to(dev)
    keep = block_keep_mask(
        vals, r.c1, r.pos, bi, bj, n_hap, margin_thres, max_dist, sel=sel,
        exact_mask=exact_mask, use_dist=use_dist, block_m=count_block,
        block_n=count_block)
    k, row, col = torch.nonzero(keep, as_tuple=True)
    # both passes apply the same mask to the same integer counts (or the
    # same compiled f32 measure): any disagreement is a fault
    got = torch.bincount(k, minlength=len(bi_np)).cpu().numpy()
    if not np.array_equal(got, counts):
        bad = np.flatnonzero(got != counts)
        raise RuntimeError(
            f"pass-2 hits disagree with pass-1 counts in {bad.size} "
            f"block(s), first at block ({bi_np[bad[0]]}, {bj_np[bad[0]]}): "
            f"{got[bad[0]]} vs {counts[bad[0]]}"
        )
    stats["blocks_checked"] += len(bi_np)
    stats["device_hits"] += int(k.shape[0])
    i = bi[k] * count_block + row
    j = bj[k] * count_block + col
    real = (i < v) & (j < v)  # drop padding-row pairs
    parts["i"].append(i[real].cpu().numpy())
    parts["j"].append(j[real].cpu().numpy())
    for name in want:
        x = vals[name][k, row, col][real]
        if name == "cab":
            x = x.to(cab_dtype)
        parts[name].append(x.cpu().numpy())


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _exact_refilter_counts(cab, c1, c2, n_hap, i, j, measure, thres,
                           len1=None, len2=None) -> ScanHits:
    """Finish pairs (i, j) in f64 from their integer counts: ``cab`` each
    pair's count, ``c1`` / ``c2`` its two alt counts, over lists of
    ``len1`` / ``len2`` where they differ from ``n_hap`` (a cross-ploidy
    pair, :func:`exact.exact_ld_elementwise`); keep those whose value,
    rounded as the reference rounds it with the int-0 sentinels, is
    ``>= thres`` (the reference thresholds post-rounding, ld_area.py:248).
    Pure elementwise f64 over the pairs, in their order."""
    exact = exact_ld_elementwise(cab, c1, c2, n_hap, len1=len1, len2=len2)
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
