"""A chromosome's scan over its ploidy segments: one sorted, finished hit
set from the store's packed rows.

A segment is a maximal run of rows of one ploidy profile, with that
profile's bit columns of the store's rows.  A chromosome of one profile
is one segment over all its rows: one streamed scan
(:func:`ld_stream.stream_threshold_scan`).  A mixed-ploidy chromosome
(chrX, chrY) scans each segment's triangle the same way, then sweeps
every cross-segment rectangle (i from the later segment, j from the
earlier one) in blocks of rows through the engine's counts and threshold
test with each side's own list length (the reference's zip truncation,
calc_ld.py:30-33); only the cells that pass are finished in f64.  Both
sides of a rectangle are gathered on the device from the store's packed
rows with their segment's columns, as the segments' residents are.  The
parts meet in one merge, sorted by (i, j): every part is sorted already,
so only the rows a rectangle touched are sorted again, by row alone.

The streamed scan, its f64 finish and the row gather are looked up
through their modules at each call, so that whatever wraps them there (a
trace's spans, a fault injection) sees every call.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ld_tools_tpu_torch.ops import engine, ld_kernels, ld_stream
from ld_tools_tpu_torch.ops.ld_kernels import KEEP_MARGIN
from ld_tools_tpu_torch.ops.ld_stream import ScanHits
from ld_tools_tpu_torch.utils.device import resolve_device
from ld_tools_tpu_torch.utils.distributed import process_count, process_index
from ld_tools_tpu_torch.utils.logging import get_logger
from ld_tools_tpu_torch.utils.profiling import span

log = get_logger("ops.segment_scan")

# rows of a rectangle's block; each block meets the earlier segment in
# column chunks four blocks tall
_RECT_ROWS = 2048

_FIELDS = ("i", "j", "r_square", "d_prime", "r_square_is_int_zero",
           "d_prime_is_int_zero")


@dataclasses.dataclass(frozen=True)
class Segment:
    """Rows ``[start, stop)`` of one ploidy profile: ``cols`` the
    profile's bit columns of the store's rows (None: the store's full
    layout, read zero-copy) and ``n_alleles`` their number."""

    start: int
    stop: int
    cols: object
    n_alleles: int


def scan_segments(packed, pos, segments, *, measure, thres,
                  max_dist=None, checkpoint_dir=None, mesh=None,
                  multiprocess=False, resident_key=None,
                  device="cuda") -> ScanHits:
    """Scan a chromosome's store rows ``packed`` (V, B) at positions
    ``pos`` over its ``segments`` (:class:`Segment`, in row order, covering
    every row).  The other arguments are
    :func:`ld_stream.stream_threshold_scan`'s.  Returns the exact hits,
    sorted by (i, j), with i > j indexing the chromosome's rows.

    One segment is one streamed scan, its stats as they are.  Several add
    up the segment scans' numeric stats (phases, blocks;
    ``resident_packed`` counts the packed segments, ``resident_dense`` the
    int8 ones, ``resident_gather`` the gathered ones) and report
    ``segments``, ``rects``, ``repack_s`` (building the rectangles' sides:
    staging, upload, gather and their counts home), ``merge_s`` (with the
    counters ``merge_hits`` and ``merge_sorted_hits``, :func:`_merge`) and
    the rectangles' ``rect_dispatch_s`` and ``rect_finish_s``, with its parts
    ``rect_wait_s`` (the engine's candidates arriving) and
    ``rect_exact_s`` (their f64 finish), and the counters ``rect_cells``
    (cells the rectangles' counts covered), ``rect_candidates`` (cells the
    engine's threshold test passed) and ``rect_gather_rows`` (rows the
    sides gathered on the device).  Each segment's scan logs one line
    (its rows, alleles, resident layout, columns and hits).  Each
    segment checkpoints on its own (fingerprinted by its content); the
    rectangles recompute on resume."""
    pos = np.asarray(pos)

    def scan(seg, key):
        return ld_stream.stream_threshold_scan(
            G_packed=packed[seg.start:seg.stop], cols=seg.cols,
            n_haplotypes=seg.n_alleles, pos=pos[seg.start:seg.stop],
            measure=measure, thres=thres, max_dist=max_dist, exact=True,
            checkpoint_dir=checkpoint_dir, mesh=mesh,
            multiprocess=multiprocess, resident_key=key, device=device)

    if len(segments) == 1:
        return scan(segments[0], resident_key)

    stats = {"repack_s": 0.0}
    parts = []
    for seg in segments:
        if seg.stop - seg.start < 2:
            continue
        hits = scan(seg, None if resident_key is None
                    else tuple(resident_key) + ("seg", seg.start, seg.stop))
        for k, v in hits.stats.items():
            if isinstance(v, (int, float)):  # phases and counts: summed
                stats[k] = stats.get(k, 0) + v
        log.info(
            "segment rows %d-%d: %d rows, %d alleles, resident %s, columns "
            "%s, %d hits", seg.start, seg.stop, seg.stop - seg.start,
            seg.n_alleles,
            "packed" if hits.stats.get("resident_packed") else "int8",
            "full layout" if seg.cols is None else "gathered", len(hits.i))
        parts.append(dataclasses.replace(hits, i=hits.i + seg.start,
                                         j=hits.j + seg.start))
    n_proc, proc_idx = ((process_count(), process_index()) if multiprocess
                        else (1, 0))
    rects, touched = _rectangle_hits(packed, pos, segments, measure, thres,
                                     max_dist, n_proc, proc_idx, device,
                                     stats)
    stats["segments"] = len(segments)

    with span("scanx.merge", stats, "merge_s"):
        if n_proc > 1:
            # the rectangles' strided hits meet in one collective, which
            # every process joins, hit-less ones included, and are sorted
            # as one part; the segment scans' hits are already the same
            # on every process
            mine = _concat(rects)
            rects = [_lexsorted(ld_stream._allgather_hits(
                {f: getattr(mine, f) for f in _FIELDS}, _FIELDS[2:]))]
        out = _merge(parts, rects, touched, stats)
    if stats["rects"]:
        log.info(
            "cross-segment rectangles: %d blocks, dispatch %.2fs "
            "(overlapped), finish %.2fs; rect_candidates %d of "
            "rect_cells %d; rect_gather_rows %d; merge %.2fs, "
            "merge_sorted_hits %d of merge_hits %d", stats["rects"],
            stats["rect_dispatch_s"], stats["rect_finish_s"],
            stats["rect_candidates"], stats["rect_cells"],
            stats["rect_gather_rows"], stats["merge_s"],
            stats["merge_sorted_hits"], stats["merge_hits"])
    return out


def _concat(parts) -> ScanHits:
    """Hit parts as one ScanHits, in the parts' order."""
    if not parts:
        return ScanHits.empty(True)
    return ScanHits(exact=True, **{
        f: np.concatenate([getattr(p, f) for p in parts]) for f in _FIELDS})


def _lexsorted(cols) -> ScanHits:
    """Hit arrays ``cols`` (by field) as one ScanHits sorted by (i, j)."""
    order = np.lexsort((cols["j"], cols["i"]))
    return ScanHits(exact=True, **{f: cols[f][order] for f in _FIELDS})


def _merge(segs, rects, touched, stats) -> ScanHits:
    """Finished hit parts as one ScanHits, sorted by (i, j).

    ``segs`` are the segments' parts in row order, each sorted by (i, j)
    over rows of its own.  ``rects`` are the rectangles' parts in their
    job order: each sorted by (i, j), its rows inside ``touched``
    (ascending disjoint row ranges [lo, hi): each later segment's rows
    within reach of an earlier one), and where two parts hold one row,
    the later part's columns come after the earlier one's (a row block's
    column chunks, in column order).  Hits outside the touched ranges keep
    their places.  Inside each range the rectangles' hits, then the
    segments', are sorted by i alone, stably: the sort merges their
    sorted runs, and within a row the rectangles' columns, all in earlier
    segments, come before the segment's own.  So the work is one copy of
    every hit plus a sort of the touched rows' runs.  Counts
    ``merge_hits`` and ``merge_sorted_hits`` in ``stats``."""
    stats.update(merge_hits=0, merge_sorted_hits=0)
    if not segs and not rects:
        return ScanHits.empty(True, stats)
    edges = np.asarray(touched, dtype=np.int64).reshape(-1)
    n_t = edges.size // 2

    def cut(p):  # piece 2t of a part lies before range t, 2t + 1 inside it
        return [0, *np.searchsorted(p.i, edges).tolist(), len(p.i)]

    seg_cuts = [cut(p) for p in segs]
    in_range = [[] for _ in range(n_t)]  # (part, start, stop) of each range
    for p in rects:
        c = cut(p)
        if any(c[2 * t + 1] > c[2 * t] for t in range(n_t + 1)):
            raise ValueError("a rectangle's hit lies outside the touched rows")
        for t in range(n_t):
            in_range[t].append((p, c[2 * t + 1], c[2 * t + 2]))
    parts = [*segs, *rects]
    out = {f: np.empty(sum(len(p.i) for p in parts), dtype=np.result_type(
        *[getattr(p, f) for p in parts])) for f in _FIELDS}
    at = n_sorted = 0
    for t in range(n_t + 1):
        for p, c in zip(segs, seg_cuts):
            a, b = c[2 * t], c[2 * t + 1]
            for f in _FIELDS:
                out[f][at:at + b - a] = getattr(p, f)[a:b]
            at += b - a
        if t == n_t:
            break
        mix = in_range[t] + [(p, c[2 * t + 1], c[2 * t + 2])
                             for p, c in zip(segs, seg_cuts)]
        order = np.argsort(np.concatenate([p.i[a:b] for p, a, b in mix]),
                           kind="stable")
        for f in _FIELDS:  # the indices are in range: "clip" takes into
            # ``out`` directly, where "raise" would buffer a copy
            np.take(np.concatenate([getattr(p, f)[a:b] for p, a, b in mix]),
                    order, out=out[f][at:at + order.size], mode="clip")
        at += order.size
        n_sorted += order.size
    stats.update(merge_hits=at, merge_sorted_hits=n_sorted)
    return ScanHits(exact=True, stats=stats, **out)


def _rectangle_hits(packed, pos, segments, measure, thres, max_dist,
                    n_proc, proc_idx, device, stats) -> tuple:
    """The finished hit parts of this process's cross-segment rectangles,
    restricted to the ``max_dist`` corner, and the rows they may touch:
    for each later segment [its first row, its last clipped row + 1), the
    same on every process.

    Loop order is later segment -> row block -> earlier segment.  Each
    side's rows come from :func:`_side_rows`, gathered on ``device`` from
    the store's packed rows: each row block of the later segment once,
    and each earlier segment once per later one, from its clipped first
    row on.  Every side is as wide as a store row's bits (rounded up to
    16) and zero past its own list, so the product of two sides is their
    zip over the shorter list (the reference's truncation,
    calc_ld.py:30-33).  Two-slot pipeline: pulling job k+1 from the
    generator launches its counts and threshold test while job k's
    candidates are finished in f64 on the host; the engine launches on a
    side stream, so the card works between rectangles.  Under a
    cooperative scan the jobs stride across the ``n_proc`` processes."""
    sel = 0 if measure == "r_square" else 1
    mask_thres = float(thres) - KEEP_MARGIN
    dev = resolve_device(device)
    width = -(-8 * packed.shape[1] // 16) * 16
    seg_cols = {}

    def side(si, r0, r1):
        seg = segments[si]
        if si not in seg_cols:
            seg_cols[si] = (None if seg.cols is None else torch.from_numpy(
                np.asarray(seg.cols, dtype=np.int32)).to(dev))
        return _side_rows(packed, r0, r1, seg_cols[si], width, dev, stats)

    def jobs():
        job_idx = 0
        for bi in range(1, len(segments)):
            seg_i = segments[bi]
            B0, B1, n_i = seg_i.start, seg_i.stop, seg_i.n_alleles
            # distance-clipped bounds per earlier segment (positions
            # ascend): j rows must reach within max_dist of the first i
            # row, and i rows within max_dist of the last j row
            clipped = []
            b1_max = B0
            for ai in range(bi):
                A0, A1 = segments[ai].start, segments[ai].stop
                a0, a1, b1 = A0, A1, B1
                if max_dist is not None:
                    a0 = A0 + int(np.searchsorted(pos[A0:A1],
                                                  pos[B0] - max_dist))
                    b1 = B0 + int(np.searchsorted(
                        pos[B0:B1], pos[A1 - 1] + max_dist, side="right"))
                    if a0 >= a1 or B0 >= b1:
                        continue
                clipped.append((ai, a0, a1, b1))
                b1_max = max(b1_max, b1)
            if b1_max > B0:
                touched.append((B0, b1_max))
            earlier = {}
            for r0 in range(B0, b1_max, _RECT_ROWS):
                r1_max = min(r0 + _RECT_ROWS, b1_max)
                Ci, ci, ci_home = side(bi, r0, r1_max)
                for ai, a0, a1, b1 in clipped:
                    if r0 >= b1:
                        continue
                    r1 = min(r1_max, b1)
                    n_j = segments[ai].n_alleles
                    m = min(n_i, n_j)
                    if ai not in earlier:
                        earlier[ai] = side(ai, a0, a1)
                    Cj, cj, cj_home = earlier[ai]
                    for c0 in range(a0, a1, 4 * _RECT_ROWS):
                        c1_stop = min(c0 + 4 * _RECT_ROWS, a1)
                        if max_dist is not None and (
                                pos[c1_stop - 1] < pos[r0] - max_dist):
                            continue
                        job_idx += 1
                        if (job_idx - 1) % n_proc != proc_idx:
                            continue  # another process owns this one
                        j0, j1 = c0 - a0, c1_stop - a0
                        fin = engine.rect_candidates_async(
                            Ci[:r1 - r0], Cj[j0:j1], ci[:r1 - r0], cj[j0:j1],
                            m, n_i, n_j, mask_thres, sel, pos1=pos[r0:r1],
                            pos2=pos[c0:c1_stop], max_dist=max_dist)
                        yield (r0, r1, c0, c1_stop, n_i, n_j, m,
                               ci_home[:r1 - r0], cj_home[j0:j1], fin)

    parts = []
    touched = []

    def finish(job):
        r0, r1, c0, c1_stop, n_i, n_j, m, c1_rows, c1_cols, fin = job
        with span("engine.wait", stats, "rect_wait_s"):
            rows, cols, c_ab = fin()
        stats["rect_cells"] += (r1 - r0) * (c1_stop - c0)
        stats["rect_candidates"] += int(rows.size)
        if rows.size:
            with span("scanx.rect_exact", stats, "rect_exact_s"):
                parts.append(ld_stream._exact_refilter_counts(
                    c_ab, c1_rows[rows], c1_cols[cols], m, rows + r0,
                    cols + c0, measure, thres, len1=n_i, len2=n_j))

    stats.update(rect_dispatch_s=0.0, rect_finish_s=0.0, rect_wait_s=0.0,
                 rect_exact_s=0.0, rects=0, rect_cells=0, rect_candidates=0,
                 rect_gather_rows=0)
    pending = None
    it = jobs()
    while True:
        with span("scanx.rect_dispatch", stats, "rect_dispatch_s"):
            job = next(it, None)
        if pending is not None:
            with span("scanx.rect_finish", stats, "rect_finish_s"):
                finish(pending)
            stats["rects"] += 1
        if job is None:
            break
        pending = job
    return parts, touched


def _side_rows(packed, r0, r1, cols, width, dev, stats):
    """Rows ``[r0, r1)`` of the store's packed rows as one side of the
    rectangles: staged (in pinned memory on the card) and uploaded once,
    then gathered on ``dev`` by :func:`ld_kernels.gather_rows_device`
    with the segment's bit columns ``cols`` (an int32 tensor on ``dev``,
    or None for the full layout) into int8 {0, 1} rows ``width`` wide,
    zero past the list.  Returns (the rows, their alt counts over the
    list on ``dev``, the same counts home as int64, in one small copy).
    Timed as ``repack_s`` (span ``scanx.repack``: what replaced the
    host's column repack), counted in ``rect_gather_rows``."""
    with span("scanx.repack", stats, "repack_s"):
        src = packed[r0:r1]
        stage = torch.empty(src.shape, dtype=torch.uint8,
                            pin_memory=dev.type == "cuda")
        np.copyto(stage.numpy(), src)
        rows = torch.empty((r1 - r0, width), dtype=torch.int8, device=dev)
        counts = torch.empty((r1 - r0,), dtype=torch.int32, device=dev)
        ld_kernels.gather_rows_device(stage.to(dev, non_blocking=True), cols,
                                      rows, counts)
        home = counts.cpu().numpy().astype(np.int64)
    stats["rect_gather_rows"] += r1 - r0
    return rows, counts, home
