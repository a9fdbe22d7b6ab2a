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

from ld_tools_tpu_torch.io.scan_tsv import write_scan_tsv
from ld_tools_tpu_torch.io.writers import makedirs, ucsc_header_line
# not called here since io/scan_tsv writes the TSV; still bound, because
# the benchmark's traced runs look it up by this name (ldbench/tracing)
from ld_tools_tpu_torch.ops.exact import format_rounded  # noqa: F401
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
    (store open, cohort layout), ``write_s`` (the TSV,
    :func:`io.scan_tsv.write_scan_tsv`) with its parts ``format_s`` (the
    measures' 4-place integers) and ``emit_s`` (the lines rendered and
    written), ``tsv_bytes``, ``tsv_native`` (1 where the native writer
    wrote the file; else ``tsv_plain_reason`` says why not), and
    ``spanned_s``, the seconds of the scan that a program span names.
    A chromosome of one ploidy profile also reports its cohort:
    ``cohort_repack_s`` (the gather of a subset's bit columns on the
    device, the scan's ``gather_rows_s``, inside ``upload_s``; 0 where the
    cohort is the store's full layout, read zero-copy),
    ``cohort_haplotypes`` (the haplotypes scanned) and ``repack_rows``
    (the rows gathered to the subset's columns: V, or 0 zero-copy)."""

    chrom: str
    path: str
    n_hits: int
    stats: dict


def _resident_key(data: DataConfig, cd):
    """Cache identity for the scan's device-resident inputs: store path +
    the packed rows' file mtime (the bytes' identity) + chromosome +
    cohort fingerprint."""
    import hashlib

    try:
        mtime = os.path.getmtime(cd.packed.filename)
    except OSError:
        mtime = None
    cohort_fp = hashlib.sha256(
        "\n".join(data.sample_names).encode()
    ).hexdigest()[:16]
    return (
        os.path.abspath(data.intgen_dir_path), cd.chrom, mtime, cohort_fp,
    )


def ploidy_segments(cd, sample_names) -> list:
    """The chromosome's maximal runs of one ploidy profile for a cohort, as
    the segment scan takes them (:class:`ops.segment_scan.Segment`):
    each run's rows, its profile's live bit columns and their number.  The
    columns are None where they are the store's full layout (the full
    diploid cohort, read zero-copy); a subset's or a haploid profile's are
    gathered on the device as the rows are uploaded.  One profile is one
    segment over every row."""
    import numpy as np

    from ld_tools_tpu_torch.ops.segment_scan import Segment

    cp = cd.cohort_ploidy(sample_names)
    groups = cp.groups_of(np.arange(cd.n_variants))
    bounds = [0, *(np.flatnonzero(np.diff(groups)) + 1).tolist(),
              cd.n_variants]
    segments = []
    for s0, s1 in zip(bounds[:-1], bounds[1:]):
        cols = cp.cols_for(int(groups[s0]) if s1 > s0 else 0)
        full = cols.size == cd.n_haplotypes and np.array_equal(
            cols, np.arange(cd.n_haplotypes))
        segments.append(Segment(s0, s1, None if full else cols,
                                int(cols.size)))
    return segments


def scan_chromosome(data: DataConfig, config: ScanConfig, chrom: str,
                    multiprocess: bool = False,
                    write: bool = True) -> ScanReport:
    """Scan one chromosome and write its TSV.

    ``multiprocess=True`` (a torch.distributed group scanning ONE
    chromosome together) splits the tiles over the processes inside
    stream_threshold_scan; every process holds the merged hits and only
    the one with ``write`` writes them (the others report no path)."""
    import time

    from ld_tools_tpu_torch.ops.segment_scan import scan_segments

    t_start = time.time()
    stats = {}
    with span("scan.chromosome", stats, SPANNED):
        with span("scan.open", stats, "open_s"):
            cd = data.store().chrom(chrom)
            segments = ploidy_segments(cd, data.sample_names)
        log.info(
            "scanning chr%s: %d variants in %d ploidy segment(s) of %s "
            "haplotypes (bitpacked), %s >= %s%s on %s",
            chrom, cd.n_variants, len(segments),
            ",".join(str(s.n_alleles) for s in segments), config.ld_measure,
            config.ld_low_thres,
            f", dist <= {config.max_dist}" if config.max_dist else "",
            config.device,
        )
        hits = scan_segments(
            cd.packed, cd.pos, segments,
            measure=config.ld_measure,
            thres=config.ld_low_thres,
            max_dist=config.max_dist,
            checkpoint_dir=config.checkpoint_dir,
            mesh=config.mesh(),
            multiprocess=multiprocess,
            resident_key=_resident_key(data, cd),
            device=config.device,
        )
        stats.update(hits.stats)
        if len(segments) == 1:  # one ploidy profile: its cohort
            (seg,) = segments
            stats.update(
                repack_rows=0 if seg.cols is None else cd.n_variants,
                cohort_haplotypes=seg.n_alleles,
                cohort_repack_s=(0.0 if seg.cols is None
                                 else stats.get("gather_rows_s", 0.0)))
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
            write_scan_tsv(
                path,
                [ucsc_header_line(meta_keys, meta_vals),
                 "#hg38_pos_1\trsID_1\thg38_pos_2\trsID_2\tdist\tr2\tD'"],
                cd.pos, cd.rsid, hits.i, hits.j,
                hits.r_square, hits.r_square_is_int_zero,
                hits.d_prime, hits.d_prime_is_int_zero, stats)
        stats["tsv_bytes"] = os.path.getsize(path)
        n_pairs = cd.n_variants * (cd.n_variants - 1) / 2
        elapsed = time.time() - t_start
        cohort = ""
        if "cohort_haplotypes" in stats:  # one ploidy profile
            cohort = (
                f"; cohort_haplotypes {stats['cohort_haplotypes']}, "
                f"repack_rows {stats['repack_rows']} "
                f"({stats['cohort_repack_s']:.4f}s), "
                + (f"resident_dense {stats['resident_dense']:.0f}, "
                   f"resident_gather {stats['resident_gather']:.0f}"
                   if "resident_dense" in stats else "resident cached")
            )
        elif "resident_gather" in stats:  # summed over the segments
            cohort = f"; resident_gather {stats['resident_gather']:.0f}"
        log.info(
            "chr%s: %d/%d pairs above threshold (%.1fs, %.2f Gpairs/s; open "
            "%.2fs, write %.2fs: format %.2fs, emit %.2fs; blocks %d, "
            "batches %d, tsv_bytes %d, tsv_native %d%s%s) -> %s",
            chrom, len(hits.i), int(n_pairs), elapsed,
            n_pairs / max(elapsed, 1e-9) / 1e9, stats["open_s"],
            stats["write_s"], stats["format_s"], stats["emit_s"],
            stats.get("blocks", 0), stats.get("batches", 0),
            stats["tsv_bytes"], stats["tsv_native"],
            (f" ({stats['tsv_plain_reason']})"
             if "tsv_plain_reason" in stats else ""), cohort, path,
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
