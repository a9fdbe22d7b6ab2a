"""ld_area: LD-threshold neighborhood search around query variants (port
of ld_tools_tpu/tools/area.py).

The reference re-fetches and re-gathers genotypes per opponent variant
and calls the Python LD kernel per pair inside a window scan
(ld_area.py:215-249).  Here each chromosome's cohort matrix is sliced
once from the packed store; all query variants are batched into the
engine's count jobs (ops/engine.py: the card for ``-E cuda``, the CPU
for ``-E torch``) against their windows, thresholds are applied to the
bit-exact rounded values on the host, and the per-query result files are
written in the reference's exact formats (TSV/JSON/rsids with UCSC-style
headers, query-variant annotation row, no file when no hits —
ld_area.py:82-292), byte-identical to the JAX tool's.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time

import numpy as np

from ld_tools_tpu_torch.ingest import create_src_dict
from ld_tools_tpu_torch.io.writers import AreaResultWriter, makedirs
from ld_tools_tpu_torch.ops.engine import mixed_pair_ld_async, pair_counts_async
from ld_tools_tpu_torch.ops.exact import measures_rounded_block_both
from ld_tools_tpu_torch.tools.common import DataConfig
from ld_tools_tpu_torch.utils.device import engine_device, resolve_device
from ld_tools_tpu_torch.utils.logging import get_logger
from ld_tools_tpu_torch.utils.profiling import maybe_trace

log = get_logger("tools.area")

# Per-count-job cell budget: queries are grouped (sorted by window
# start) so that each group's (queries x union-of-windows) count matmul
# stays under this many cells — compute scales with the flank windows the
# tool actually reports on, never with whole-chromosome size.
_DENSE_CELL_LIMIT = 16_000_000


class _UniformFreqs:
    """p1/p2 carrier matching MixedExactLD's attribute shape contract
    for the uniform path (1-D pair-independent frequencies)."""

    def __init__(self, p1, p2):
        self.p1 = p1
        self.p2 = p2


@dataclasses.dataclass(frozen=True)
class AreaConfig:
    src_dir_path: str
    trg_top_dir_path: str
    meta_lines_quan: int
    flank_size: int
    ld_thres_measure: str
    ld_low_thres: float
    trg_file_type: str
    device: str = "cuda"

    @staticmethod
    def from_args(args):
        src = os.path.normpath(args.src_dir_path)
        trg = (
            src
            if args.trg_top_dir_path is None
            else os.path.normpath(args.trg_top_dir_path)
        )
        if args.trg_file_type not in ("tsv", "json", "rsids"):
            # fail before any device compute or file creation (the CLI
            # restricts choices; programmatic callers get the same check)
            raise ValueError(
                f"trg_file_type must be tsv/json/rsids, got "
                f"{args.trg_file_type!r}"
            )
        return AreaConfig(
            src_dir_path=src,
            trg_top_dir_path=trg,
            meta_lines_quan=args.meta_lines_quan,
            flank_size=args.flank_size,
            ld_thres_measure=args.ld_thres_measure,
            ld_low_thres=args.ld_low_thres,
            trg_file_type=args.trg_file_type,
            device=engine_device(getattr(args, "engine", "cuda")),
        )


class AreaRunner:
    """Per-source-file neighborhood search (the reference's PrepSingleProc
    analogue, ld_area.py:16-60 — config frozen once, then reused).

    ``stats`` sums the phases over every file's thread: ``groups`` (count
    jobs), ``dispatch_s`` (host unpack, upload and issue of a group's
    counts), ``count_wait_s`` (waiting on them; on a mixed-ploidy
    chromosome also their f64 finish), ``finish_s`` (the uniform f64
    finish) and ``write_s`` (the per-query files)."""

    def __init__(self, data: DataConfig, config: AreaConfig):
        self.data = data
        self.config = config
        self._store = data.store()
        self.stats = dict(groups=0, dispatch_s=0.0, count_wait_s=0.0,
                          finish_s=0.0, write_s=0.0)
        self._stats_lock = threading.Lock()

    def _add(self, **phases) -> None:
        with self._stats_lock:
            for k, v in phases.items():
                self.stats[k] += v

    def process_file(self, src_file_name: str) -> int:
        """Run the search for one source table; returns number of result
        files written."""
        cfg = self.config
        data_by_chrs = create_src_dict(
            cfg.src_dir_path,
            src_file_name,
            cfg.meta_lines_quan,
            self.data.intgen_convdb_path,
        )
        src_file_base = src_file_name.rsplit(".", maxsplit=1)[0]
        trg_dir_path = os.path.join(
            cfg.trg_top_dir_path, f"{src_file_base}_in_LD"
        )
        ext = cfg.trg_file_type if cfg.trg_file_type in ("tsv", "json") else "txt"
        meta_keys = [
            "chr",
            "gends",
            "pops",
            "each_flank",
            f"{cfg.ld_thres_measure}_thres",
        ]
        written = 0
        for chrom in data_by_chrs:
            chr_dir_path = os.path.join(trg_dir_path, chrom)
            makedirs(chr_dir_path)
            meta_vals = [
                chrom,
                self.data.gend_names,
                self.data.pop_names,
                cfg.flank_size,
                cfg.ld_low_thres,
            ]
            written += self._process_chrom(
                chrom,
                data_by_chrs[chrom],
                chr_dir_path,
                ext,
                meta_keys,
                meta_vals,
            )
        return written

    def _process_chrom(
        self, chrom, var_rows, chr_dir_path, ext, meta_keys, meta_vals
    ) -> int:
        cfg = self.config
        cd = self._store.chrom(chrom)
        cp = cd.cohort_ploidy(self.data.sample_names)
        chrom_groups = (
            np.zeros(1, dtype=np.int16)
            if cp.trivial
            else np.unique(cd.pgroup)
        )
        mixed = chrom_groups.size > 1
        cols = None
        if not mixed:
            # single ploidy profile (autosomes; also all-haploid chrY):
            # each group fetches ONLY its window rows below — memory is
            # O(flank windows), never O(chromosome) (the full unpacked
            # chr1 cohort matrix is ~30 GB)
            gid = int(chrom_groups[0]) if chrom_groups.size else 0
            cols = cp.cols_for(gid)
            n_hap = int(cols.shape[0])
        pos = cd.pos
        rsid = cd.rsid
        ref_ann = cd.annotation("ref")
        alt_ann = cd.annotation("alt")
        vt_ann = cd.annotation("vt")

        # Resolve query rows BY (position, rsID) — conversion.db can
        # carry one rsID at two positions, and first-match row_of would
        # collapse both queries onto one window.  Unknown-at-position
        # rsIDs are skipped with a warning (the reference would crash
        # with UnboundLocalError here — ld_area.py:158, quirk not
        # replicated).
        queries = []
        for q_pos, q_rsid in var_rows:
            row = cd.row_at(q_rsid, q_pos)
            if row is None:
                log.warning("query %s not present in packed chr%s; skipped",
                            q_rsid, chrom)
                continue
            queries.append(row)
        if not queries:
            return 0

        q_rows = np.asarray(queries, dtype=np.int64)
        windows = []
        for row in q_rows:
            q_pos = int(pos[row])
            low = max(q_pos - cfg.flank_size, 0)
            high = q_pos + cfg.flank_size
            windows.append(cd.window(low, high))

        # Window-true grouping: queries sort by window start and pack
        # greedily into groups whose (group x union-of-windows) cell count
        # fits _DENSE_CELL_LIMIT.  Each group is ONE device count matmul
        # against only the column slice its windows cover — at chr scale
        # with 100 kb flanks this is ~50x fewer MACs than a
        # whole-chromosome product, and the host f64 finish shrinks the
        # same way.  (The reference re-fetches the window from the VCF per
        # query, ld_area.py:215-217; the window semantics here are
        # identical, via store.window's tabix-parity searchsorted.)
        order = sorted(range(len(q_rows)), key=lambda qi: windows[qi][0])
        groups = []  # (query indices, col_start, col_stop)
        cur, cur_start, cur_stop = [], 0, 0
        for qi in order:
            s, t = windows[qi]
            new_start = s if not cur else min(cur_start, s)
            new_stop = t if not cur else max(cur_stop, t)
            cells = (len(cur) + 1) * max(new_stop - new_start, 1)
            if cur and cells > _DENSE_CELL_LIMIT:
                groups.append((cur, cur_start, cur_stop))
                cur, cur_start, cur_stop = [qi], s, t
            else:
                cur, cur_start, cur_stop = cur + [qi], new_start, new_stop
        if cur:
            groups.append((cur, cur_start, cur_stop))

        written = 0
        # two-slot pipeline: group k+1's counts are issued (on the card,
        # on a side stream of the job) before group k's exact f64 finish
        # and per-query file writes run on the host
        def dispatch(qis, s, t):
            if mixed:
                return mixed_pair_ld_async(
                    cd, cp, q_rows[qis], np.arange(s, t), cfg.device
                )
            return pair_counts_async(
                cd.genotype_rows(q_rows[qis])[:, cols],
                cd.genotype_rows(np.arange(s, t))[:, cols],
                device=cfg.device,
            )

        def timed_dispatch(*group):
            t0 = time.perf_counter()
            fin = dispatch(*group)
            self._add(groups=1, dispatch_s=time.perf_counter() - t0)
            return fin

        pending = None
        if groups:
            pending = timed_dispatch(*groups[0])
        for gi, (qis, c_start, c_stop) in enumerate(groups):
            grp = q_rows[qis]
            t0 = time.perf_counter()
            finished = pending()
            self._add(count_wait_s=time.perf_counter() - t0)
            if gi + 1 < len(groups):
                pending = timed_dispatch(*groups[gi + 1])
            t0 = time.perf_counter()
            if mixed:
                exacts = finished
                r2_all = exacts.r_square_rounded()
                dp_all = exacts.d_prime_rounded()
                iz_pack = None
            else:
                # rounded f64 + sentinel masks: boxing the full group
                # matrix into Python objects (r?_rounded) cost ~1 GB and
                # seconds per 16M-cell group; only the few hit cells
                # ever need the int-0 object form
                c_ab, c1q, c1cols = finished
                exacts = _UniformFreqs(
                    np.asarray(c1q, np.float64) / float(n_hap),
                    np.asarray(c1cols, np.float64) / float(n_hap),
                )
                r2_all, r2_iz, dp_all, dp_iz = (
                    measures_rounded_block_both(c_ab, c1q, c1cols, n_hap)
                )
                iz_pack = (r2_iz, dp_iz)
            t1 = time.perf_counter()
            written += self._write_group(
                qis, grp, windows, c_start, exacts, r2_all, dp_all,
                iz_pack, chrom, pos, rsid, ref_ann, alt_ann, vt_ann,
                chr_dir_path, ext, meta_keys, meta_vals,
            )
            self._add(finish_s=t1 - t0, write_s=time.perf_counter() - t1)
        return written

    def _write_group(
        self, qis, grp, windows, c_start, exacts, r2_all, dp_all,
        iz_pack, chrom, pos, rsid, ref_ann, alt_ann, vt_ann,
        chr_dir_path, ext, meta_keys, meta_vals,
    ) -> int:
        cfg = self.config
        written = 0
        for gi, qi in enumerate(qis):
            row = grp[gi]
            q_pos = int(pos[row])
            q_rsid = str(rsid[row])
            start, stop = windows[qi]
            r2_win = r2_all[gi, start - c_start : stop - c_start]
            dp_win = dp_all[gi, start - c_start : stop - c_start]
            if iz_pack is not None:
                r2_iz_win = iz_pack[0][gi, start - c_start : stop - c_start]
                dp_iz_win = iz_pack[1][gi, start - c_start : stop - c_start]
            if exacts.p2.ndim == 2:
                # mixed-ploidy chromosome: opponent freqs are pair-
                # dependent (reference divides by htypes_quan of the
                # pair, calc_ld.py:37-44), but the query annotation row
                # uses the query's OWN list length (ld_area.py:188-189)
                p2_win = exacts.p2[gi, start - c_start : stop - c_start]
                p_q = exacts.own_freq1[gi]
            else:
                p2_win = exacts.p2[start - c_start : stop - c_start]
                p_q = exacts.p1[gi]

            query_alt_freq = round(float(p_q), 4)
            query_ann = [
                q_pos,
                q_rsid,
                str(ref_ann[row]),
                str(alt_ann[row]),
                str(vt_ann[row]),
                query_alt_freq,
            ] + ["quer"] * 3
            trg_file_name = (
                f"{q_rsid}_chr{chrom}_{cfg.ld_thres_measure[0]}_"
                f"{str(cfg.ld_low_thres)}.{ext}"
            )
            writer = AreaResultWriter(
                os.path.join(chr_dir_path, trg_file_name),
                cfg.trg_file_type,
                meta_keys,
                meta_vals,
                query_ann,
            )
            measure_win = (
                r2_win if cfg.ld_thres_measure == "r_square" else dp_win
            )
            for k in range(stop - start):
                o_row = start + k
                o_rsid = str(rsid[o_row])
                if o_rsid == q_rsid:
                    continue
                if measure_win[k] < cfg.ld_low_thres:
                    continue
                if iz_pack is None:
                    r2_val, dp_val = r2_win[k], dp_win[k]
                else:
                    # int-0 sentinel objectified ONLY for written cells
                    r2_val = 0 if r2_iz_win[k] else float(r2_win[k])
                    dp_val = 0 if dp_iz_win[k] else float(dp_win[k])
                writer.add_opponent(
                    [
                        int(pos[o_row]),
                        o_rsid,
                        str(ref_ann[o_row]),
                        str(alt_ann[o_row]),
                        str(vt_ann[o_row]),
                        round(float(p2_win[k]), 4),
                        r2_val,
                        dp_val,
                        int(pos[o_row]) - q_pos,
                    ]
                )
            if writer.flush():
                written += 1
        return written


def run(args, stats: dict = None) -> int:
    """CLI entry: process every file in the source directory; ``stats``,
    where given, receives the runner's phase sums (:class:`AreaRunner`).

    Honors -p/--max-proc-quan like the reference's process pool
    (ld_area.py:324-339), as a thread pool: each file's count jobs run on
    side streams of their own, while each file's host-side stages (input
    parsing, exact f64 finish, formatting, writes) overlap other files'
    device work (tools/common.map_files).  Returns total result files
    written.
    """
    import datetime

    from ld_tools_tpu_torch.tools.common import map_files

    config = AreaConfig.from_args(args)
    resolve_device(config.device)  # no card for -E cuda: fail before prep
    data = DataConfig.resolve(
        args.intgen_dir_path,
        args.skip_intgen_data_ver,
        args.gend_names,
        args.pop_names,
    )
    runner = AreaRunner(data, config)
    src_file_names = [
        name
        for name in sorted(os.listdir(config.src_dir_path))
        if os.path.isfile(os.path.join(config.src_dir_path, name))
    ]

    print("\nSelecting variants in LD and in window")
    with maybe_trace():
        t0 = datetime.datetime.now()
        total = sum(map_files(
            runner.process_file, src_file_names,
            getattr(args, "max_proc_quan", 1),
        ))
    print(f"\tcomputation time: {datetime.datetime.now() - t0}")
    if stats is not None:
        stats.update(runner.stats)
    return total
