"""ld_scan: whole-chromosome all-pairs LD threshold scan (port of
ld_tools_tpu/tools/scan.py).

Streams all lower-triangle pairs of a chromosome through the count and
band kernels, keeps pairs with LD >= threshold (optionally within a
distance window), and writes them as a pair-list TSV byte-identical to
the JAX tool's.  One process scans every requested chromosome.
"""

from __future__ import annotations

import dataclasses
import os

from ld_tools_tpu_torch.io.writers import makedirs, ucsc_header_line
from ld_tools_tpu_torch.ops.exact import format_rounded
from ld_tools_tpu_torch.tools.common import DataConfig
from ld_tools_tpu_torch.utils.logging import get_logger
from ld_tools_tpu_torch.utils.profiling import maybe_trace

log = get_logger("tools.scan")

# -E choice -> torch device: the hand-written kernels on the card, or
# their plain PyTorch versions on the CPU
ENGINE_DEVICES = {"cuda": "cuda", "torch": "cpu"}


@dataclasses.dataclass(frozen=True)
class ScanConfig:
    chroms: tuple  # () = all packed chromosomes
    trg_dir_path: str
    ld_measure: str
    ld_low_thres: float
    max_dist: object  # int or None
    device: str = "cuda"

    @staticmethod
    def from_args(args):
        if getattr(args, "checkpoint_dir", None) is not None:
            raise NotImplementedError(
                "-k/--checkpoint-dir: scan checkpoints are not ported yet "
                "(ROADMAP queue 6)")
        if getattr(args, "devices", None) is not None:
            raise NotImplementedError(
                "-d/--devices: multi-device scans are not ported yet "
                "(ROADMAP queue 8)")
        chroms = tuple(
            c for c in args.chroms.split(",") if c and c.lower() != "all"
        )
        engine = getattr(args, "engine", "cuda")
        if engine not in ENGINE_DEVICES:
            raise ValueError(f"engine must be one of {sorted(ENGINE_DEVICES)}, "
                             f"got {engine!r}")
        return ScanConfig(
            chroms=chroms,
            trg_dir_path=os.path.normpath(args.trg_dir_path),
            ld_measure=args.ld_measure,
            ld_low_thres=args.ld_low_thres,
            max_dist=args.max_dist,
            device=ENGINE_DEVICES[engine],
        )


@dataclasses.dataclass
class ScanReport:
    """What one chromosome's scan wrote, with the scan's phase stats and
    the seconds spent writing the TSV (``write_s``)."""

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


def _scan_mixed_chromosome(data, cd, cp, config: ScanConfig):
    """Mixed-ploidy (chrX) scan.  Its cross-segment rectangles need the
    engine of ld_tools_tpu/ops/engine.py, which is not ported yet."""
    raise NotImplementedError(
        f"chr{cd.chrom} mixes ploidy profiles; mixed-ploidy scans need "
        "ops/engine.py, not ported yet (ROADMAP queue 5)"
    )


def scan_chromosome(data: DataConfig, config: ScanConfig,
                    chrom: str) -> ScanReport:
    """Scan one chromosome and write its TSV."""
    import time

    import numpy as np

    from ld_tools_tpu_torch.ingest import pack
    from ld_tools_tpu_torch.ops.ld_stream import stream_threshold_scan

    t_start = time.time()
    cd = data.store().chrom(chrom)
    cp = cd.cohort_ploidy(data.sample_names)
    chrom_groups = (
        np.zeros(1, dtype=np.int16)
        if cp.trivial
        else np.unique(cd.pgroup)
    )
    if chrom_groups.size > 1:
        _scan_mixed_chromosome(data, cd, cp, config)
    # single ploidy profile: the scan consumes the profile's live bit
    # columns directly (full-diploid-cohort runs are zero-copy; subsets
    # and haploid profiles repack their bit columns once)
    gid = int(chrom_groups[0]) if chrom_groups.size else 0
    cols = cp.cols_for(gid)
    if cols.size == cd.n_haplotypes and np.array_equal(
        cols, np.arange(cd.n_haplotypes)
    ):
        gp, n_hap = cd.packed, cd.n_haplotypes
    else:
        gp = pack.pack_columns(cd.packed, cols, cd.n_haplotypes)
        n_hap = cols.size
    log.info(
        "scanning chr%s: %d variants x %d haplotypes (bitpacked), "
        "%s >= %s%s on %s",
        chrom, gp.shape[0], n_hap, config.ld_measure, config.ld_low_thres,
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
        resident_key=_resident_key(data, cd),
        device=config.device,
    )
    t_write = time.perf_counter()
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
    r2_s = format_rounded(hits.r_square, hits.r_square_is_int_zero)
    dp_s = format_rounded(hits.d_prime, hits.d_prime_is_int_zero)
    # column-wise assembly (the .tolist() conversions and the joins run at
    # C speed): chromosome-scale scans emit millions of hit lines
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
        fh.write("#hg38_pos_1\trsID_1\thg38_pos_2\trsID_2\tdist\tr2\tD'\n")
        for pa_k, ra, pb_k, rb, d, r2k, dpk in rows:
            fh.write(f"{pa_k}\t{ra}\t{pb_k}\t{rb}\t{d}\t{r2k}\t{dpk}\n")
    stats = dict(hits.stats or {})
    stats["write_s"] = time.perf_counter() - t_write
    n_pairs = cd.n_variants * (cd.n_variants - 1) / 2
    elapsed = time.time() - t_start
    log.info(
        "chr%s: %d/%d pairs above threshold (%.1fs, %.2f Gpairs/s) -> %s",
        chrom, len(hits.i), int(n_pairs), elapsed,
        n_pairs / max(elapsed, 1e-9) / 1e9, path,
    )
    return ScanReport(chrom=chrom, path=path, n_hits=int(len(hits.i)),
                      stats=stats)


def run(args) -> list:
    """Scan every requested chromosome; returns one ScanReport each."""
    import datetime

    from ld_tools_tpu_torch.utils.device import resolve_device

    config = ScanConfig.from_args(args)
    resolve_device(config.device)  # no card for -E cuda: fail before prep
    data = DataConfig.resolve(
        args.intgen_dir_path,
        args.skip_intgen_data_ver,
        args.gend_names,
        args.pop_names,
    )
    chroms = list(config.chroms) or data.store().chroms()
    print("\nWhole-chromosome LD scan")
    reports = []
    with maybe_trace():
        t0 = datetime.datetime.now()
        for chrom in chroms:
            reports.append(scan_chromosome(data, config, chrom))
    print(f"\tcomputation time: {datetime.datetime.now() - t0}")
    return reports
