"""ld_scan: whole-chromosome all-pairs LD threshold scan (port of
ld_tools_tpu/tools/scan.py).

Streams all lower-triangle pairs of a chromosome through the count and
band kernels, keeps pairs with LD >= threshold (optionally within a
distance window), and writes them as a pair-list TSV byte-identical to
the JAX tool's.  ``-d`` shards each chromosome's scan over local devices,
``-k`` makes it resumable, and under a torch.distributed launcher the
processes either scan one chromosome together (process 0 writes) or
split the chromosomes between them.
"""

from __future__ import annotations

import dataclasses
import os

from ld_tools_tpu_torch.io.writers import makedirs, ucsc_header_line
from ld_tools_tpu_torch.ops.exact import format_rounded
from ld_tools_tpu_torch.tools.common import DataConfig
from ld_tools_tpu_torch.utils.device import engine_device
from ld_tools_tpu_torch.utils.logging import get_logger
from ld_tools_tpu_torch.utils.profiling import SPANNED, maybe_trace, span

log = get_logger("tools.scan")


@dataclasses.dataclass(frozen=True)
class ScanConfig:
    chroms: tuple  # () = all packed chromosomes
    trg_dir_path: str
    ld_measure: str
    ld_low_thres: float
    max_dist: object  # int or None
    device: str = "cuda"
    checkpoint_dir: object = None
    n_devices: object = None  # None = 1; "all" or int = shard the tiles

    @staticmethod
    def from_args(args):
        chroms = tuple(
            c for c in args.chroms.split(",") if c and c.lower() != "all"
        )
        return ScanConfig(
            chroms=chroms,
            trg_dir_path=os.path.normpath(args.trg_dir_path),
            ld_measure=args.ld_measure,
            ld_low_thres=args.ld_low_thres,
            max_dist=args.max_dist,
            device=engine_device(getattr(args, "engine", "cuda")),
            checkpoint_dir=getattr(args, "checkpoint_dir", None),
            n_devices=getattr(args, "devices", None),
        )

    def mesh(self):
        """The shard list of ``-d`` (:func:`scan_mesh`: the first N local
        cards, at most the cards there are; "all" every local card; on
        the CPU, N CPU shards), or None where that is one shard, as in
        JAX: on one card ``-d 4`` and ``-d all`` run the one-device scan,
        and under a launcher each process has its one card."""
        if self.n_devices is None:
            return None
        from ld_tools_tpu_torch.ops.ld_stream import scan_mesh

        n = None if self.n_devices == "all" else int(self.n_devices)
        mesh = scan_mesh(n, device=self.device)
        return mesh if len(mesh) > 1 else None


@dataclasses.dataclass
class ScanReport:
    """What one chromosome's scan wrote, with its phase stats: the scan
    driver's (``ScanHits.stats``; a mixed-ploidy chromosome's summed over
    its segments, with its rectangles'), and the tool's own: ``open_s``
    (store open, cohort layout, any column repack), ``write_s`` (the TSV)
    with its parts ``format_s`` (the measures' strings) and ``emit_s``
    (the gathers, columns and lines, written), ``tsv_bytes``, and
    ``spanned_s``, the seconds of the scan that a program span names."""

    chrom: str
    path: str
    n_hits: int
    stats: dict


def _resident_key(data: DataConfig, cd, extra=()):
    """Cache identity for the scan's device-resident inputs: store path +
    gt.npy mtime (the bytes' identity) + chromosome + cohort fingerprint."""
    import hashlib

    from ld_tools_tpu_torch.ingest import pack

    gt_path = os.path.join(
        pack.chrom_dir(data.intgen_dir_path, cd.chrom), "gt.npy"
    )
    try:
        mtime = os.path.getmtime(gt_path)
    except OSError:
        mtime = None
    cohort_fp = hashlib.sha256(
        "\n".join(data.sample_names).encode()
    ).hexdigest()[:16]
    return (
        os.path.abspath(data.intgen_dir_path), cd.chrom, mtime, cohort_fp,
    ) + tuple(extra)


def _scan_mixed_chromosome(data, cd, cp, config: ScanConfig,
                           multiprocess: bool = False):
    """Mixed-ploidy (chrX) scan (tools/scan.py _scan_mixed_chromosome):
    segment the variant axis into maximal runs of one ploidy profile,
    scan each run's triangle with its own live-column layout
    (stream_threshold_scan: K5/K3 or K6/K4, over ``-d``'s shards where
    given), and sweep the cross-run rectangles in blocks of 2,048 rows
    through the engine's counts and the f64 finish (reference
    zip-truncation semantics, calc_ld.py:30-33).  Hits are merged and
    sorted by (i, j).  The stats hold the segment scans' numeric stats
    summed (phases, blocks; ``resident_packed`` counts the packed
    segments), ``segments``, ``rects``, ``repack_s`` (every column
    repack), ``merge_s`` and the rectangles' ``rect_dispatch_s`` and
    ``rect_finish_s``, with its parts ``rect_wait_s`` (the engine's counts
    arriving) and ``rect_exact_s`` (their f64 finish).
    """
    import numpy as np

    from ld_tools_tpu_torch.ingest import pack
    from ld_tools_tpu_torch.ops.engine import pair_counts_async
    from ld_tools_tpu_torch.ops.exact import exact_ld_from_counts, round4
    from ld_tools_tpu_torch.ops.ld_stream import ScanHits, stream_threshold_scan
    from ld_tools_tpu_torch.utils.distributed import (process_count,
                                                      process_index)

    pos = np.asarray(cd.pos)
    pgroup = cp.groups_of(np.arange(cd.n_variants))
    cuts = np.flatnonzero(np.diff(pgroup)) + 1
    starts = np.concatenate([[0], cuts]).astype(np.int64)
    stops = np.concatenate([cuts, [cd.n_variants]]).astype(np.int64)
    segs = list(zip(starts, stops))
    log.info("chr%s spans %d ploidy segments; scanning per segment",
             cd.chrom, len(segs))

    parts = []
    stats = {"repack_s": 0.0}

    def compact_seg(s0, s1, gid):
        with span("scanx.repack", stats, "repack_s"):
            return pack.pack_columns(
                np.ascontiguousarray(cd.packed[s0:s1]),
                cp.cols_for(gid), cd.n_haplotypes,
            )

    for s0, s1 in segs:
        if s1 - s0 < 2:
            continue
        gid = int(pgroup[s0])
        hits = stream_threshold_scan(
            G_packed=compact_seg(s0, s1, gid),
            n_haplotypes=cp.n_alleles(gid),
            pos=pos[s0:s1],
            measure=config.ld_measure,
            thres=config.ld_low_thres,
            max_dist=config.max_dist,
            exact=True,
            # per-segment checkpoints (fingerprinted by segment content);
            # the cross-segment rectangles recompute on resume
            checkpoint_dir=config.checkpoint_dir,
            mesh=config.mesh(),
            multiprocess=multiprocess,
            resident_key=_resident_key(
                data, cd, extra=("seg", int(s0), int(s1), gid)
            ),
            device=config.device,
        )
        for k, v in (hits.stats or {}).items():
            if isinstance(v, (int, float)):  # phases and counts: summed
                stats[k] = stats.get(k, 0) + v
        parts.append((hits.i + s0, hits.j + s0, hits.r_square,
                      hits.d_prime, hits.r_square_is_int_zero,
                      hits.d_prime_is_int_zero))

    # cross-segment rectangles (i from the later segment, j from the
    # earlier one, preserving i > j), restricted to the max_dist corner.
    # Two-slot pipeline: pulling job k+1 from the generator ISSUES its
    # counts (and does its host-side unpackbits repacking) while job k's
    # exact f64 finish and threshold filter run on the host; the engine
    # issues on a side stream, so the card works between rectangles.
    # Loop order is bi -> row block -> earlier segment: each row block
    # unpacks ONCE, and each earlier segment's packed cohort matrix is
    # built once and cached.  Under a cooperative multiprocess scan the
    # rectangle jobs stride across processes (the segment scans above
    # already split their tiles) and the strided hit parts meet in one
    # allgather.
    block = 2048
    n_proc = 1
    proc_idx = 0
    if multiprocess:
        n_proc = process_count()
        proc_idx = process_index()
    rect_parts = []
    pos32 = pos.astype(np.int32) if config.max_dist is not None else None

    cj_cache = {}

    def seg_packed(ai, gid_j):
        if ai not in cj_cache:
            A0, A1 = segs[ai]
            with span("scanx.repack", stats, "repack_s"):
                cj_cache[ai] = pack.pack_columns(
                    np.ascontiguousarray(cd.packed[A0:A1]),
                    cp.cols_for(gid_j), cd.n_haplotypes,
                )
        return cj_cache[ai]

    def rect_jobs():
        job_idx = 0
        for bi in range(1, len(segs)):
            B0, B1 = segs[bi]
            gid_i = int(pgroup[B0])
            n_i = cp.n_alleles(gid_i)
            # distance-clipped bounds per earlier segment (positions
            # ascend): j rows must reach within max_dist of the first i
            # row, and i rows within max_dist of the last j row
            ai_infos = []
            b1_max = B0
            for ai in range(bi):
                A0, A1 = segs[ai]
                gid_j = int(pgroup[A0])
                n_j = cp.n_alleles(gid_j)
                a0, a1, b1 = A0, A1, B1
                if config.max_dist is not None:
                    a0 = A0 + int(np.searchsorted(
                        pos[A0:A1], pos[B0] - config.max_dist
                    ))
                    b1 = B0 + int(np.searchsorted(
                        pos[B0:B1], pos[A1 - 1] + config.max_dist,
                        side="right"
                    ))
                    if a0 >= a1 or B0 >= b1:
                        continue
                ai_infos.append((ai, gid_j, n_j, a0, a1, b1, A0))
                b1_max = max(b1_max, b1)
            for r0 in range(B0, b1_max, block):
                r1_max = min(r0 + block, b1_max)
                with span("scanx.repack", stats, "repack_s"):
                    Ci_packed = pack.pack_columns(
                        np.ascontiguousarray(cd.packed[r0:r1_max]),
                        cp.cols_for(gid_i), cd.n_haplotypes,
                    )
                Ci = np.unpackbits(Ci_packed, axis=1,
                                   count=n_i).astype(np.int8)
                c1_rows_full = Ci.sum(axis=1, dtype=np.int64)
                for (ai, gid_j, n_j, a0, a1, b1, A0) in ai_infos:
                    if r0 >= b1:
                        continue
                    r1 = min(r1_max, b1)
                    m = min(n_i, n_j)
                    Cj_full = seg_packed(ai, gid_j)
                    for c0 in range(a0, a1, 4 * block):
                        c1_stop = min(c0 + 4 * block, a1)
                        if config.max_dist is not None and (
                            pos[c1_stop - 1] < pos[r0] - config.max_dist
                        ):
                            continue
                        job_idx += 1
                        if (job_idx - 1) % n_proc != proc_idx:
                            continue  # another process owns this one
                        Cj = np.unpackbits(
                            Cj_full[c0 - A0:c1_stop - A0], axis=1,
                            count=n_j,
                        ).astype(np.int8)
                        fin = pair_counts_async(
                            Ci[: r1 - r0, :m], Cj[:, :m],
                            device=config.device,
                        )
                        yield (r0, r1, c0, c1_stop, n_i, n_j, m,
                               c1_rows_full[: r1 - r0],
                               Cj.sum(axis=1, dtype=np.int64), fin)

    def finish_rect(job):
        r0, r1, c0, c1_stop, n_i, n_j, m, c1_rows, c1_cols, fin = job
        with span("engine.wait", rect_stats, "rect_wait_s"):
            c_ab, _, _ = fin()
        with span("scanx.rect_exact", rect_stats, "rect_exact_s"):
            ex = exact_ld_from_counts(
                c_ab, c1_rows, c1_cols, m, len1=n_i, len2=n_j,
            )
        meas = (
            ex.r_square
            if config.ld_measure == "r_square"
            else ex.d_prime
        )
        int_zero = (
            ex.r_square_is_int_zero
            if config.ld_measure == "r_square"
            else ex.d_prime_is_int_zero
        )
        rounded = round4(meas)
        rounded[int_zero] = 0.0
        keep = rounded >= config.ld_low_thres
        if config.max_dist is not None:
            # int32 + in-place abs: the int64 broadcast difference alone
            # was ~270 MB of transients per rectangle
            dist = pos32[r0:r1, None] - pos32[None, c0:c1_stop]
            np.abs(dist, out=dist)
            keep &= dist <= config.max_dist
        ii, jj = np.nonzero(keep)
        if ii.size == 0:
            return
        rect_parts.append((
            (ii + r0).astype(np.int64),
            (jj + c0).astype(np.int64),
            ex.r_square[keep], ex.d_prime[keep],
            ex.r_square_is_int_zero[keep],
            ex.d_prime_is_int_zero[keep],
        ))

    # two-slot drive: pulling job k+1 issues it (and does its host
    # repacking) while job k's finish runs; dispatch_s happens under the
    # device's work
    rect_stats = {"rect_dispatch_s": 0.0, "rect_finish_s": 0.0,
                  "rect_wait_s": 0.0, "rect_exact_s": 0.0, "rects": 0}
    pending = None
    it = rect_jobs()
    while True:
        with span("scanx.rect_dispatch", rect_stats, "rect_dispatch_s"):
            job = next(it, None)
        if pending is not None:
            with span("scanx.rect_finish", rect_stats, "rect_finish_s"):
                finish_rect(pending)
            rect_stats["rects"] += 1
        if job is None:
            break
        pending = job
    if rect_stats["rects"]:
        log.info(
            "cross-segment rectangles: %d blocks, dispatch %.2fs "
            "(overlapped), finish %.2fs",
            rect_stats["rects"], rect_stats["rect_dispatch_s"],
            rect_stats["rect_finish_s"],
        )
    stats.update(rect_stats, segments=len(segs))

    with span("scanx.merge", stats, "merge_s"):
        if n_proc > 1:
            # merge the strided rectangle hits (every process joins the
            # collective, hit-less ones included, with the same dtypes); the
            # segment-scan parts above are already identical on every process
            from ld_tools_tpu_torch.ops.ld_stream import _allgather_hits

            names = ("i", "j", "r2", "dp", "r2_iz", "dp_iz")
            if rect_parts:
                arrs = {
                    name: np.concatenate([p[k] for p in rect_parts])
                    for k, name in enumerate(names)
                }
            else:
                arrs = {
                    "i": np.zeros(0, np.int64), "j": np.zeros(0, np.int64),
                    "r2": np.zeros(0), "dp": np.zeros(0),
                    "r2_iz": np.zeros(0, bool), "dp_iz": np.zeros(0, bool),
                }
            g = _allgather_hits(arrs, ("r2", "dp", "r2_iz", "dp_iz"))
            parts.append((g["i"], g["j"], g["r2"], g["dp"], g["r2_iz"],
                          g["dp_iz"]))
        else:
            parts.extend(rect_parts)

        if parts:
            i = np.concatenate([p[0] for p in parts])
            j = np.concatenate([p[1] for p in parts])
            r2 = np.concatenate([p[2] for p in parts])
            dp = np.concatenate([p[3] for p in parts])
            r2_iz = np.concatenate([p[4] for p in parts])
            dp_iz = np.concatenate([p[5] for p in parts])
            order = np.lexsort((j, i))
            return ScanHits(
                i=i[order], j=j[order], r_square=r2[order], d_prime=dp[order],
                r_square_is_int_zero=r2_iz[order],
                d_prime_is_int_zero=dp_iz[order], exact=True, stats=stats,
            )
        z = np.zeros(0)
        return ScanHits(
            i=np.zeros(0, np.int64), j=np.zeros(0, np.int64),
            r_square=z, d_prime=z,
            r_square_is_int_zero=np.zeros(0, bool),
            d_prime_is_int_zero=np.zeros(0, bool), exact=True, stats=stats,
        )


def scan_chromosome(data: DataConfig, config: ScanConfig, chrom: str,
                    multiprocess: bool = False,
                    write: bool = True) -> ScanReport:
    """Scan one chromosome and write its TSV.

    ``multiprocess=True`` (a torch.distributed group scanning ONE
    chromosome together) splits the tiles over the processes inside
    stream_threshold_scan; every process holds the merged hits and only
    the one with ``write`` writes them (the others report no path)."""
    import time

    import numpy as np

    from ld_tools_tpu_torch.ingest import pack
    from ld_tools_tpu_torch.ops.ld_stream import stream_threshold_scan

    t_start = time.time()
    stats = {}
    with span("scan.chromosome", stats, SPANNED):
        with span("scan.open", stats, "open_s"):
            cd = data.store().chrom(chrom)
            cp = cd.cohort_ploidy(data.sample_names)
            chrom_groups = (
                np.zeros(1, dtype=np.int16)
                if cp.trivial
                else np.unique(cd.pgroup)
            )
            mixed = chrom_groups.size > 1
            if not mixed:
                # single ploidy profile: the scan consumes the profile's
                # live bit columns directly (full-diploid-cohort runs are
                # zero-copy; subsets and haploid profiles repack their bit
                # columns once)
                gid = int(chrom_groups[0]) if chrom_groups.size else 0
                cols = cp.cols_for(gid)
                if cols.size == cd.n_haplotypes and np.array_equal(
                    cols, np.arange(cd.n_haplotypes)
                ):
                    gp, n_hap = cd.packed, cd.n_haplotypes
                else:
                    gp = pack.pack_columns(cd.packed, cols, cd.n_haplotypes)
                    n_hap = cols.size
        if mixed:
            hits = _scan_mixed_chromosome(data, cd, cp, config,
                                          multiprocess=multiprocess)
        else:
            log.info(
                "scanning chr%s: %d variants x %d haplotypes (bitpacked), "
                "%s >= %s%s on %s",
                chrom, gp.shape[0], n_hap, config.ld_measure,
                config.ld_low_thres,
                f", dist <= {config.max_dist}" if config.max_dist else "",
                config.device,
            )
            hits = stream_threshold_scan(
                G_packed=gp,
                n_haplotypes=n_hap,
                pos=cd.pos,
                measure=config.ld_measure,
                thres=config.ld_low_thres,
                max_dist=config.max_dist,
                exact=True,
                checkpoint_dir=config.checkpoint_dir,
                mesh=config.mesh(),
                multiprocess=multiprocess,
                resident_key=_resident_key(data, cd),
                device=config.device,
            )
        stats.update(hits.stats or {})
        if not write:
            return ScanReport(chrom=chrom, path=None,
                              n_hits=int(len(hits.i)), stats=stats)
        with span("scan.write", stats, "write_s"):
            makedirs(config.trg_dir_path)
            name = (
                f"ld_scan_chr{chrom}_{config.ld_measure[0]}_"
                f"{config.ld_low_thres}.tsv"
            )
            path = os.path.join(config.trg_dir_path, name)
            meta_keys = ["chr", "gends", "pops", f"{config.ld_measure}_thres",
                         "max_dist"]
            meta_vals = [chrom, data.gend_names, data.pop_names,
                         config.ld_low_thres, config.max_dist]
            rsid = cd.rsid
            pos = cd.pos
            with span("scan.format", stats, "format_s"):
                r2_s = format_rounded(hits.r_square,
                                      hits.r_square_is_int_zero)
                dp_s = format_rounded(hits.d_prime, hits.d_prime_is_int_zero)
            with span("scan.emit", stats, "emit_s"):
                # column-wise assembly (the .tolist() conversions and the
                # joins run at C speed): chromosome-scale scans emit
                # millions of hit lines
                ia = hits.i.astype(np.int64)
                jb = hits.j.astype(np.int64)
                pa = pos[ia].astype(np.int64)
                pb = pos[jb].astype(np.int64)
                rows = zip(
                    pa.tolist(), np.asarray(rsid)[ia].tolist(),
                    pb.tolist(), np.asarray(rsid)[jb].tolist(),
                    (pa - pb).tolist(), r2_s.tolist(), dp_s.tolist(),
                )
                with open(path, "w") as fh:
                    fh.write(ucsc_header_line(meta_keys, meta_vals) + "\n")
                    fh.write("#hg38_pos_1\trsID_1\thg38_pos_2\trsID_2\tdist"
                             "\tr2\tD'\n")
                    for pa_k, ra, pb_k, rb, d, r2k, dpk in rows:
                        fh.write(f"{pa_k}\t{ra}\t{pb_k}\t{rb}\t{d}\t{r2k}"
                                 f"\t{dpk}\n")
        stats["tsv_bytes"] = os.path.getsize(path)
        n_pairs = cd.n_variants * (cd.n_variants - 1) / 2
        elapsed = time.time() - t_start
        log.info(
            "chr%s: %d/%d pairs above threshold (%.1fs, %.2f Gpairs/s; open "
            "%.2fs, write %.2fs: format %.2fs, emit %.2fs) -> %s",
            chrom, len(hits.i), int(n_pairs), elapsed,
            n_pairs / max(elapsed, 1e-9) / 1e9, stats["open_s"],
            stats["write_s"], stats["format_s"], stats["emit_s"], path,
        )
        return ScanReport(chrom=chrom, path=path, n_hits=int(len(hits.i)),
                          stats=stats)


def run(args) -> list:
    """Scan every requested chromosome of this process; returns one
    ScanReport each."""
    import datetime

    from ld_tools_tpu_torch.parallel.batch import chromosomes_for_this_process
    from ld_tools_tpu_torch.utils.device import resolve_device
    from ld_tools_tpu_torch.utils.distributed import (
        initialize_if_needed, local_device, process_count, process_index)

    config = ScanConfig.from_args(args)
    resolve_device(config.device)  # no card for -E cuda: fail before prep
    own = local_device(config.device)
    if own is not None:  # one card per process under a launcher
        config = dataclasses.replace(config, device=str(own))
    data = DataConfig.resolve(
        args.intgen_dir_path,
        args.skip_intgen_data_ver,
        args.gend_names,
        args.pop_names,
    )
    chroms = list(config.chroms) or data.store().chroms()
    # join the launcher's group; then a group pointed at ONE chromosome
    # scans it together (tiles split, hits gathered, process 0 writes),
    # and otherwise each process takes whole chromosomes
    initialize_if_needed()
    coop = process_count() > 1 and len(chroms) == 1
    if not coop:
        chroms = chromosomes_for_this_process(chroms)
    print("\nWhole-chromosome LD scan")
    reports = []
    with maybe_trace():
        t0 = datetime.datetime.now()
        for chrom in chroms:
            reports.append(scan_chromosome(
                data, config, chrom, multiprocess=coop,
                write=not coop or process_index() == 0))
    print(f"\tcomputation time: {datetime.datetime.now() - t0}")
    return reports
