"""ld_triangle: all-pairs LD matrices as heatmaps and/or TSV tables (port
of ld_tools_tpu/tools/triangle.py).

The reference runs an O(n^2) Python pair loop that re-fetches BOTH
variants' genotypes from the VCF for every cell (ld_triangle.py:133-230,
the dominant cost).  Here the whole lower triangle comes from the
engine's blocked count jobs over the chromosome's cohort matrix
(ops/engine.py: the card for ``-E cuda``, the CPU for ``-E torch``),
finished bit-exactly on the host; rendering (heatmap HTML/JSON,
double-header TSV) preserves the reference's output layout
(ld_triangle.py:236-360), byte-identical to the JAX tool's.

Three routes, as in the JAX tool: the per-cell object path up to
``heatmap._HOVER_CELLS_MAX`` variants, the streamed table (``-o table``)
and the streamed columnar heatmap past the cap.  The streamed functions
are attached to :class:`TriangleRunner` after their definition and take
any ``self`` with ``config`` and ``data`` (the bench suite drives them
with a bare namespace); ``phase_stats`` sums their phases.
"""

from __future__ import annotations

import dataclasses
import os
import threading

import numpy as np

from ld_tools_tpu_torch.ingest import create_src_dict
from ld_tools_tpu_torch.io import heatmap as heatmap_io
from ld_tools_tpu_torch.io.writers import makedirs, write_triangle_tsv
from ld_tools_tpu_torch.ops.engine import exact_all_pairs, mixed_pair_ld
from ld_tools_tpu_torch.tools.common import DataConfig, variant_annotations
from ld_tools_tpu_torch.utils.device import engine_device, resolve_device
from ld_tools_tpu_torch.utils.logging import get_logger
from ld_tools_tpu_torch.utils.profiling import maybe_trace, span

log = get_logger("tools.triangle")


@dataclasses.dataclass(frozen=True)
class TriangleConfig:
    src_dir_path: str
    trg_top_dir_path: str
    meta_lines_quan: int
    ld_measure: str
    ld_low_thres: object  # float or None (None = no filter)
    matrix_type: str
    heatmap_json: bool
    disp_letters: bool
    color_pal: str
    font_size: object
    square_shape: bool
    dont_disp_footer: bool
    device: str = "cuda"

    @staticmethod
    def from_args(args):
        src = os.path.normpath(args.src_dir_path)
        trg = (
            src
            if args.trg_top_dir_path is None
            else os.path.normpath(args.trg_top_dir_path)
        )
        return TriangleConfig(
            src_dir_path=src,
            trg_top_dir_path=trg,
            meta_lines_quan=args.meta_lines_quan,
            ld_measure=args.ld_measure,
            ld_low_thres=args.ld_low_thres,
            matrix_type=args.matrix_type,
            heatmap_json=args.heatmap_json,
            disp_letters=args.disp_letters,
            color_pal=args.color_pal,
            font_size=args.font_size,
            square_shape=args.square_shape,
            dont_disp_footer=args.dont_disp_footer,
            device=engine_device(getattr(args, "engine", "cuda")),
        )


FOOTER_TEXT = """
made by ld_triangle from tpu-ld (a TPU-native rework of
<a href="https://github.com/PlatonB/ld-tools">ld-tools</a>) ░
see README.md for documentation
"""


def _title_text(cfg, data, chrom) -> str:
    """Heatmap title block (reference ld_triangle.py:310-316) — one
    home for the layout, shared by both heatmap functions (a free
    function: the bench suite drives them with a bare-namespace
    runner stand-in)."""
    return (
        f"\ndefines color: {cfg.ld_measure} ░\n"
        f"LD threshold: {cfg.ld_low_thres} ░\n"
        f"chromosome: {chrom} ░\n"
        f"genders: {', '.join(data.gend_names)} ░\n"
        f"populations: {', '.join(data.pop_names)}\n"
    )


# the phases TriangleRunner.stats sums over every file's thread
PHASES = ("dispatch_s", "count_wait_s", "finish_s", "encode_s", "figure_s",
          "write_s")


class TriangleRunner:
    """Per-source-file matrix maker (the reference's PrepSingleProc
    analogue, ld_triangle.py:3-50).

    ``stats`` sums each matrix's phases over every file's thread:
    ``dispatch_s`` (issue of the engine's count jobs), ``finish_s`` (the
    counts' wait and the f64 finish; on the per-cell path the whole
    count), ``count_wait_s`` (the part of ``finish_s`` spent waiting on
    the engine's counts, on a mixed-ploidy chromosome with their f64
    finish), ``encode_s`` (cell values, hover strings, quantized
    triangles and pooling), ``figure_s`` (the figure's build and its
    HTML/JSON files) and ``write_s`` (TSV rows); ``matrices`` counts the
    matrices built."""

    def __init__(self, data: DataConfig, config: TriangleConfig):
        self.data = data
        self.config = config
        self._store = data.store()
        self.stats = dict.fromkeys(PHASES, 0.0)
        self.stats["matrices"] = 0
        self._stats_lock = threading.Lock()

    def _add(self, phases: dict) -> None:
        with self._stats_lock:
            for k, v in phases.items():
                self.stats[k] += v
            self.stats["matrices"] += 1

    def process_file(self, src_file_name: str) -> int:
        """Build matrices for one source table; returns matrix count."""
        cfg = self.config
        data_by_chrs = create_src_dict(
            cfg.src_dir_path,
            src_file_name,
            cfg.meta_lines_quan,
            self.data.intgen_convdb_path,
        )
        src_file_base = src_file_name.rsplit(".", maxsplit=1)[0]
        trg_dir_path = os.path.join(
            cfg.trg_top_dir_path, f"{src_file_base}_LD_matr"
        )
        built = 0
        for chrom in data_by_chrs:
            if len(data_by_chrs[chrom]) < 2:
                continue
            # _build_matrix reports whether anything was written (it
            # bails when < 2 rsIDs resolve in the packed store) and
            # creates the target dir itself — no overstated counts, no
            # empty directories left behind
            if self._build_matrix(
                chrom, data_by_chrs[chrom], src_file_base, trg_dir_path
            ):
                built += 1
        return built

    def _build_matrix(self, chrom, var_rows, src_file_base, trg_dir_path):
        cfg = self.config
        cd = self._store.chrom(chrom)

        # Sort by position (reference ld_triangle.py:88-92) and resolve
        # store rows; unresolvable rsIDs are skipped with a warning (the
        # reference would crash with UnboundLocalError, ld_triangle.py:165).
        var_rows = sorted(var_rows, key=lambda row: row[0])
        rows, poss_srtd, rs_ids_srtd = [], [], []
        for q_pos, q_rsid in var_rows:
            # by (position, rsID): one rsID can occur at two positions
            row = cd.row_at(q_rsid, q_pos)
            if row is None:
                log.warning("%s not present in packed chr%s; skipped",
                            q_rsid, chrom)
                continue
            rows.append(row)
            poss_srtd.append(q_pos)
            rs_ids_srtd.append(q_rsid)
        vars_quan = len(rows)
        if vars_quan < 2:
            return False
        makedirs(trg_dir_path)

        cp = cd.cohort_ploidy(self.data.sample_names)
        row_groups = cp.groups_of(rows)
        mixed = np.unique(row_groups).size > 1
        if mixed:
            # chrX sets straddling the PAR boundary: the grouped engine
            # partitions rows by ploidy profile (tools/area.py-style)
            G = None
            mixed_ctx = (cd, cp, np.asarray(rows, dtype=np.int64))
        else:
            gid = int(row_groups[0]) if len(rows) else 0
            G = cd.genotype_rows(rows)[:, cp.cols_for(gid)]
            mixed_ctx = None

        phases = dict.fromkeys(PHASES, 0.0)
        if cfg.matrix_type == "table":
            # Table-only runs stream row blocks through the device and
            # never materialize the square f64/object matrices — the path
            # that scales to 10k+ variant TSVs (BASELINE metric #2).
            self._write_table_streamed(
                G, chrom, rs_ids_srtd, poss_srtd, src_file_base,
                trg_dir_path, mixed_ctx=mixed_ctx, phase_stats=phases,
            )
            self._add(phases)
            return True

        if vars_quan > heatmap_io._HOVER_CELLS_MAX:
            # Columnar hover payload: per-cell strings are O(n^2) x ~200
            # bytes (a 10k figure would be ~10 GB); past the reference's
            # own practical render cap (~500x500, README.md:74) hover
            # data ships as int16 triangle buffers + O(n) variant arrays,
            # assembled client-side (io/heatmap.py).  Streams row blocks,
            # never materializing the square f64 matrices.
            # '-o both' writes the TSV inside the SAME streamed block
            # loop (the rounded measure blocks are already in hand) —
            # a separate table pass would re-dispatch every device
            # count block and double the dominant stage
            self._build_heatmap_columnar(
                cd, chrom, rows, rs_ids_srtd, poss_srtd, G, mixed_ctx,
                src_file_base, trg_dir_path,
                also_table=(cfg.matrix_type == "both"), phase_stats=phases,
            )
            self._add(phases)
            return True

        with span("triangle.finish", phases, "finish_s"):
            exact = (
                mixed_pair_ld(cd, cp, mixed_ctx[2], mixed_ctx[2], cfg.device)
                if mixed
                else exact_all_pairs(G, device=cfg.device)
            )
        with span("triangle.encode", phases, "encode_s"):
            measure_vals = (
                exact.r_square_rounded()
                if cfg.ld_measure == "r_square"
                else exact.d_prime_rounded()
            )

            need_info = cfg.matrix_type in ("heatmap", "both")
            ld_two_dim = [[0 for _ in range(vars_quan)]
                          for _ in range(vars_quan)]
            info_two_dim = (
                self._hovertext_matrix(exact, cd, rows, rs_ids_srtd,
                                       poss_srtd)
                if need_info
                else None
            )

            for row_index in range(vars_quan):
                row_vals = measure_vals[row_index]
                ld_row = ld_two_dim[row_index]
                for col_index in range(row_index):
                    val = row_vals[col_index]
                    if (cfg.ld_low_thres is not None
                            and val < cfg.ld_low_thres):
                        # sub-threshold cells stay 0 but keep hovertext
                        continue
                    ld_row[col_index] = val

        with span("triangle.figure", phases, "figure_s"):
            trg_file_base = (f"{src_file_base}_chr{chrom}_"
                             f"{cfg.ld_measure[0]}")
            if cfg.matrix_type in ("heatmap", "both"):
                title = _title_text(cfg, self.data, chrom)
                figure = heatmap_io.build_figure(
                    ld_two_dim,
                    info_two_dim,
                    rs_ids_srtd,
                    disp_letters=cfg.disp_letters,
                    color_pal=cfg.color_pal,
                    font_size=cfg.font_size,
                    square_shape=cfg.square_shape,
                    title_text=title,
                    footer_text=None if cfg.dont_disp_footer else FOOTER_TEXT,
                )
                if cfg.heatmap_json:
                    heatmap_io.write_json(
                        os.path.join(trg_dir_path, trg_file_base + ".json"),
                        figure,
                    )
                heatmap_io.write_html(
                    os.path.join(trg_dir_path, trg_file_base + ".html"),
                    figure,
                    cfg.disp_letters,
                )
        with span("triangle.write", phases, "write_s"):
            if cfg.matrix_type in ("table", "both"):
                write_triangle_tsv(
                    os.path.join(trg_dir_path, trg_file_base + ".tsv"),
                    cfg.ld_measure,
                    chrom,
                    self.data.pop_names,
                    self.data.gend_names,
                    rs_ids_srtd,
                    poss_srtd,
                    ld_two_dim,
                )
        self._add(phases)
        return True


def run(args, stats: dict = None) -> int:
    """CLI entry: build matrices for every file in the source directory;
    ``stats``, where given, receives the runner's phase sums
    (:class:`TriangleRunner`).

    Honors -p/--max-proc-quan like the reference's process pool
    (ld_triangle.py:394-408), as a thread pool: each file's count jobs
    run on side streams of their own, while each file's host-side stages
    overlap other files' device work (tools/common.map_files).
    """
    import datetime

    from ld_tools_tpu_torch.tools.common import map_files

    config = TriangleConfig.from_args(args)
    resolve_device(config.device)  # no card for -E cuda: fail before prep
    data = DataConfig.resolve(
        args.intgen_dir_path,
        args.skip_intgen_data_ver,
        args.gend_names,
        args.pop_names,
    )
    runner = TriangleRunner(data, config)
    src_file_names = [
        name
        for name in sorted(os.listdir(config.src_dir_path))
        if os.path.isfile(os.path.join(config.src_dir_path, name))
    ]

    print("\nLD matrix(-es) creation")
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


def _hovertext_matrix(self, exact, cd, rows, rs_ids_srtd, poss_srtd):
    """Lower-triangle hovertext blocks (reference ld_triangle.py:201-213),
    byte-identical to the per-cell f-string but built from precomputed
    per-variant fragments + vectorized value strings — the O(n^2) Python
    formatting loop was the dominant host cost on 1k+ heatmaps."""
    import numpy as np

    from ld_tools_tpu_torch.ops.exact import format_rounded

    n = len(rs_ids_srtd)
    ann = [variant_annotations(cd, r) for r in rows]
    mixed = exact.p1.ndim == 2
    if not mixed:
        freqs = [round(float(v), 4) for v in exact.p1]
        x_frq = [f"{rs_ids_srtd[k]}.alt_freq: {freqs[k]}<br>\n" for k in range(n)]
        y_frq = [f"{rs_ids_srtd[k]}.alt_freq: {freqs[k]}\n" for k in range(n)]
    poss_arr = np.asarray(poss_srtd, dtype=np.int64)
    # per-variant fragments; x = column variant, y = row variant
    x_pos = [f"{rs_ids_srtd[k]}.hg38_pos: {poss_srtd[k]}<br>\n" for k in range(n)]
    y_pos = [f"{rs_ids_srtd[k]}.hg38_pos: {poss_srtd[k]}<br><br>\n" for k in range(n)]
    x_all = [f"{rs_ids_srtd[k]}.alleles: {ann[k][0]}<br>\n" for k in range(n)]
    y_all = [f"{rs_ids_srtd[k]}.alleles: {ann[k][0]}<br><br>\n" for k in range(n)]
    x_typ = [f"{rs_ids_srtd[k]}.type: {ann[k][1]}<br>\n" for k in range(n)]
    y_typ = [f"{rs_ids_srtd[k]}.type: {ann[k][1]}<br><br>\n" for k in range(n)]

    info = [[0] * n for _ in range(n)]
    join = "".join
    for i in range(1, n):
        r2_s = format_rounded(
            exact.r_square[i, :i], exact.r_square_is_int_zero[i, :i]
        )
        dp_s = format_rounded(
            exact.d_prime[i, :i], exact.d_prime_is_int_zero[i, :i]
        )
        dist_s = list(map(str, np.abs(poss_arr[:i] - poss_arr[i]).tolist()))
        if mixed:
            # pair-dependent freqs on mixed-ploidy chromosomes: the
            # reference divides each side's alt count by the pair's
            # htypes_quan (calc_ld.py:37-44), so the hover freq of a
            # variant varies with its opponent's ploidy region
            p2_s = format_rounded(exact.p2[i, :i])
            p1_s = format_rounded(exact.p1[i, :i])
            x_frq_row = [
                f"{rs_ids_srtd[j]}.alt_freq: {p2_s[j]}<br>\n"
                for j in range(i)
            ]
            y_frq_row = [
                f"{rs_ids_srtd[i]}.alt_freq: {p1_s[j]}\n" for j in range(i)
            ]
        yp, ya, yt = y_pos[i], y_all[i], y_typ[i]
        row = info[i]
        for j in range(i):
            xf = x_frq_row[j] if mixed else x_frq[j]
            yf = y_frq_row[j] if mixed else y_frq[i]
            row[j] = join((
                "\nr2: ", r2_s[j], "<br>\nD': ", dp_s[j],
                "<br>\nabs_dist: ", dist_s[j], "<br><br>\n",
                x_pos[j], yp, x_all[j], ya, x_typ[j], yt, xf, yf,
            ))
    return info


def _write_table_streamed(
    self, G, chrom, rs_ids_srtd, poss_srtd, src_file_base, trg_dir_path,
    row_block: int = 2048, mixed_ctx=None, phase_stats=None,
):
    """Streamed triangle TSV: row blocks of counts -> exact f64 finish ->
    vectorized cell strings -> write.

    Peak memory is O(row_block x V): a 10k-variant table (10^8 cells,
    BASELINE metric #2) never materializes the square f64/object
    matrices.  Cell semantics match the reference (ld_triangle.py:114,
    :223-230): cells above/on the diagonal, below-threshold cells, and
    monomorphic int-0 sentinels all print '0'; everything else prints
    str(round(v, 4)).

    ``mixed_ctx`` = (chrom_data, cohort_ploidy, rows) switches each
    block to the grouped mixed-ploidy engine (chrX sets straddling the
    PAR boundary) with identical streaming structure.

    ``phase_stats`` (a dict, optional) accumulates per-phase seconds
    (dispatch_s / finish_s / write_s, and count_wait_s: the part of
    finish_s spent waiting on the engine) so benchmark rows can attribute
    wall time structurally instead of in prose notes.  The count jobs run
    on ``self.config.device``.
    """
    import os
    import numpy as np

    from ld_tools_tpu_torch.ops.engine import (
        mixed_pair_ld_async,
        pair_counts_async,
    )
    from ld_tools_tpu_torch.ops.exact import (
        format_rounded,
        measure_rounded_block,
        round4,
    )

    cfg = self.config
    dev = cfg.device
    ps = phase_stats if phase_stats is not None else {}
    for key in ("dispatch_s", "count_wait_s", "finish_s", "write_s"):
        ps.setdefault(key, 0.0)

    def wait(fin):
        with span("engine.wait", ps, "count_wait_s"):
            return fin()

    n = len(rs_ids_srtd)
    trg_file_base = f"{src_file_base}_chr{chrom}_{cfg.ld_measure[0]}"
    path = os.path.join(trg_dir_path, trg_file_base + ".tsv")
    tab = "\t"
    poss_str = [str(p) for p in poss_srtd]
    starts = list(range(0, n, row_block))

    if mixed_ctx is not None:
        cd, cp, rows_arr = mixed_ctx

        def dispatch(r0, r1):
            return mixed_pair_ld_async(cd, cp, rows_arr[r0:r1],
                                       rows_arr[:r1], dev)

        def finish(fin):
            exact = wait(fin)
            vals = (
                exact.r_square
                if cfg.ld_measure == "r_square"
                else exact.d_prime
            )
            iz = (
                exact.r_square_is_int_zero
                if cfg.ld_measure == "r_square"
                else exact.d_prime_is_int_zero
            )
            rounded = round4(vals)
            rounded[iz] = 0.0
            return rounded, iz
    else:
        n_hap = G.shape[1]
        if n > 2 * row_block:
            # large matrices: upload G ONCE and slice blocks on device —
            # per-block pair_counts_async would re-upload the growing
            # column prefix every call (~n^2/2 bytes through the
            # host<->device link; 166 MB at 10k variants)
            from ld_tools_tpu_torch.ops.engine import ResidentCounts

            resident = ResidentCounts(G, block_pad=row_block, device=dev)

            def dispatch(r0, r1):
                return resident.block_async(r0, r1, r1)
        else:

            def dispatch(r0, r1):
                return pair_counts_async(G[r0:r1], G[:r1], device=dev)

        def finish(fin):
            # one measure only, rounded in the same native pass — half
            # the finish cost of computing both measures + a round pass
            c_ab, c1r, c1c = wait(fin)
            return measure_rounded_block(
                c_ab, c1r, c1c, n_hap, cfg.ld_measure
            )

    # two-slot pipeline: block k+1's counts are issued (on the card, on a
    # side stream of the job) while block k's exact finish + cell
    # formatting + write run on the host
    with span("triangle.dispatch", ps, "dispatch_s"):
        pending = dispatch(0, min(row_block, n))
    from ld_tools_tpu_torch.io.writers import write_triangle_header

    with open(path, "w") as fh:
        write_triangle_header(
            fh, cfg.ld_measure, chrom, self.data.pop_names,
            self.data.gend_names, rs_ids_srtd, poss_str,
        )
        for bi, r0 in enumerate(starts):
            r1 = min(r0 + row_block, n)
            # columns beyond the block's last row are all '0' (strict
            # lower triangle) — never computed
            fin = pending
            if bi + 1 < len(starts):
                nr0 = starts[bi + 1]
                nr1 = min(nr0 + row_block, n)
                with span("triangle.dispatch", ps, "dispatch_s"):
                    pending = dispatch(nr0, nr1)
            with span("triangle.finish", ps, "finish_s"):
                rounded, int_zero = finish(fin)
            with span("triangle.write", ps, "write_s"):
                for k in range(r1 - r0):
                    r = r0 + k
                    cells = format_rounded(
                        rounded[k, :r], int_zero[k, :r], assume_rounded=True
                    )
                    if cfg.ld_low_thres is not None:
                        cells = np.where(
                            rounded[k, :r] >= cfg.ld_low_thres, cells, "0"
                        )
                    fh.write(
                        rs_ids_srtd[r] + "\t" + poss_str[r] + "\t"
                        + "\t".join(cells.tolist() + ["0"] * (n - r)) + "\n"
                    )


TriangleRunner._hovertext_matrix = _hovertext_matrix
TriangleRunner._write_table_streamed = _write_table_streamed


def _build_heatmap_columnar(
    self, cd, chrom, rows, rs_ids_srtd, poss_srtd, G, mixed_ctx,
    src_file_base, trg_dir_path, row_block: int = 2048, phase_stats=None,
    also_table: bool = False,
):
    """Streamed columnar-figure heatmap for > _HOVER_CELLS_MAX variants.

    Row blocks of counts finish bit-exactly on the host and quantize to
    int16 triangle buffers (io/heatmap.encode_q_rows) while the next
    block's device counts are in flight; peak memory is O(row_block x V).
    Uniform-ploidy chromosomes ship O(n) per-variant frequencies; mixed
    (chrX) ones ship pair-dependent frequency triangles (the reference
    divides by the pair's htypes_quan, calc_ld.py:37-44).  The count jobs
    run on ``self.config.device``; ``phase_stats`` accumulates
    dispatch_s, count_wait_s (part of finish_s), finish_s, encode_s,
    figure_s and, with ``also_table``, write_s.
    """
    import numpy as np

    from ld_tools_tpu_torch.ops.engine import (
        mixed_pair_ld_async,
        pair_counts_async,
    )
    from ld_tools_tpu_torch.ops.exact import (
        measures_rounded_block_both,
        round4,
    )

    cfg = self.config
    dev = cfg.device
    ps = phase_stats if phase_stats is not None else {}
    for key in ("dispatch_s", "count_wait_s", "finish_s", "encode_s",
                "figure_s", "write_s"):
        ps.setdefault(key, 0.0)

    def wait(fin):
        with span("engine.wait", ps, "count_wait_s"):
            return fin()

    n = len(rs_ids_srtd)
    mixed = mixed_ctx is not None
    if mixed:
        _, cp, rows_arr = mixed_ctx

        def dispatch(r0, r1):
            return mixed_pair_ld_async(cd, cp, rows_arr[r0:r1],
                                       rows_arr[:r1], dev)

        def finish(fin):
            exact = wait(fin)
            return (
                round4(exact.r_square), exact.r_square_is_int_zero,
                round4(exact.d_prime), exact.d_prime_is_int_zero,
                round4(exact.p1), round4(exact.p2),
            )
    else:
        n_hap = G.shape[1]
        if n > 2 * row_block:
            # upload G once, slice blocks on device (see
            # _write_table_streamed for the transfer arithmetic)
            from ld_tools_tpu_torch.ops.engine import ResidentCounts

            resident = ResidentCounts(G, block_pad=row_block, device=dev)

            def dispatch(r0, r1):
                return resident.block_async(r0, r1, r1)
        else:

            def dispatch(r0, r1):
                return pair_counts_async(G[r0:r1], G[:r1], device=dev)

        def finish(fin):
            # one fused native pass emits BOTH measures rounded — half
            # the per-cell finish work of two single-measure passes
            c_ab, c1r, c1c = wait(fin)
            r2r, r2iz, dpr, dpiz = measures_rounded_block_both(
                c_ab, c1r, c1c, n_hap
            )
            return r2r, r2iz, dpr, dpiz, None, None

    # uniform values live in [-1, 1] (int16 codes); mixed cross-profile
    # pairs follow the reference's unbounded zip-truncation math -> int32
    qdtype = "i4" if mixed else "i2"
    no_iz = None
    r2_parts, dp_parts, f1_parts, f2_parts = [], [], [], []
    starts = list(range(0, n, row_block))
    # very large uniform figures pool to an overview HTML (the full
    # columnar payload for 10k variants is a ~267 MB page); the -j JSON
    # keeps full resolution either way
    overview = (
        not mixed
        and n > heatmap_io._OVERVIEW_MIN
        and os.environ.get("TPU_LD_HEATMAP_FULL") != "1"
    )
    pooled = None
    if overview:
        pool_f, pool_p = heatmap_io.pool_shape(n)
        pooled = np.full((pool_p, pool_p), -1, dtype=np.int64)
    trg_file_base = f"{src_file_base}_chr{chrom}_{cfg.ld_measure[0]}"
    table_fh = None
    if also_table:
        # '-o both': the TSV rows come out of the SAME streamed blocks
        # (the rounded measure is already in hand) — a second device
        # pass would double the dominant stage
        from ld_tools_tpu_torch.io.writers import write_triangle_header
        from ld_tools_tpu_torch.ops.exact import format_rounded

        poss_str = [str(p) for p in poss_srtd]
        table_fh = open(
            os.path.join(trg_dir_path, trg_file_base + ".tsv"), "w"
        )
        write_triangle_header(
            table_fh, cfg.ld_measure, chrom, self.data.pop_names,
            self.data.gend_names, rs_ids_srtd, poss_str,
        )
    with span("triangle.dispatch", ps, "dispatch_s"):
        pending = dispatch(0, min(row_block, n))
    for bi, r0 in enumerate(starts):
        r1 = min(r0 + row_block, n)
        fin = pending
        if bi + 1 < len(starts):
            with span("triangle.dispatch", ps, "dispatch_s"):
                pending = dispatch(starts[bi + 1],
                                   min(starts[bi + 1] + row_block, n))
        with span("triangle.finish", ps, "finish_s"):
            r2r, r2iz, dpr, dpiz, p1r, p2r = finish(fin)
        if table_fh is not None:
            with span("triangle.write", ps, "write_s"):
                mr = r2r if cfg.ld_measure == "r_square" else dpr
                mz = r2iz if cfg.ld_measure == "r_square" else dpiz
                for k in range(r1 - r0):
                    r = r0 + k
                    cells = format_rounded(mr[k, :r], mz[k, :r],
                                           assume_rounded=True)
                    if cfg.ld_low_thres is not None:
                        cells = np.where(
                            mr[k, :r] >= cfg.ld_low_thres, cells, "0"
                        )
                    table_fh.write(
                        rs_ids_srtd[r] + "\t" + poss_str[r] + "\t"
                        + "\t".join(cells.tolist() + ["0"] * (n - r)) + "\n"
                    )
        with span("triangle.encode", ps, "encode_s"):
            r2_parts.append(heatmap_io.encode_q_rows(
                r2r, r2iz, r0, r1, qdtype=qdtype,
            ))
            dp_parts.append(heatmap_io.encode_q_rows(
                dpr, dpiz, r0, r1, qdtype=qdtype,
            ))
            if overview:
                cm = r2r if cfg.ld_measure == "r_square" else dpr
                cz = r2iz if cfg.ld_measure == "r_square" else dpiz
                heatmap_io.pool_rows_composite(pooled, cm, cz, r0, r1,
                                               pool_f)
        if mixed:
            if no_iz is None or no_iz.shape[0] < r1 - r0:
                no_iz = np.zeros((r1 - r0, n), dtype=bool)
            f1_parts.append(heatmap_io.encode_q_rows(
                p1r, no_iz, r0, r1, qdtype=qdtype
            ))
            f2_parts.append(heatmap_io.encode_q_rows(
                p2r, no_iz, r0, r1, qdtype=qdtype
            ))

    with span("triangle.figure", ps, "figure_s"):
        ann = [variant_annotations(cd, r) for r in rows]
        freq_q = None
        if not mixed:
            c1 = G.astype(np.int64).sum(axis=1)
            freq_q = np.rint(
                round4(c1 / float(G.shape[1])) * 1e4
            ).astype(np.int64)
        title = _title_text(cfg, self.data, chrom)
        if table_fh is not None:
            table_fh.close()
        r2_all = b"".join(r2_parts)
        dp_all = b"".join(dp_parts)
        if cfg.heatmap_json or not overview:
            # the full-resolution columnar figure: the HTML payload below
            # _OVERVIEW_MIN variants, and always the -j JSON debug dump
            figure = heatmap_io.build_figure_columnar(
                n=n,
                rs_ids=rs_ids_srtd,
                positions=poss_srtd,
                alleles=[a[0] for a in ann],
                types=[a[1] for a in ann],
                measure=cfg.ld_measure,
                thres=cfg.ld_low_thres,
                r2_q=r2_all,
                dp_q=dp_all,
                color_pal=cfg.color_pal,
                title_text=title,
                footer_text=None if cfg.dont_disp_footer else FOOTER_TEXT,
                square_shape=cfg.square_shape,
                freq_q=freq_q,
                freq1_q=b"".join(f1_parts) if mixed else None,
                freq2_q=b"".join(f2_parts) if mixed else None,
                qdtype=qdtype,
            )
            if cfg.heatmap_json:
                heatmap_io.write_json(
                    os.path.join(trg_dir_path, trg_file_base + ".json"), figure
                )
        if overview:
            figure = heatmap_io.build_figure_overview(
                n=n,
                rs_ids=rs_ids_srtd,
                positions=poss_srtd,
                alleles=[a[0] for a in ann],
                types=[a[1] for a in ann],
                measure=cfg.ld_measure,
                thres=cfg.ld_low_thres,
                pooled=pooled,
                r2_q=r2_all,
                dp_q=dp_all,
                color_pal=cfg.color_pal,
                title_text=title,
                footer_text=None if cfg.dont_disp_footer else FOOTER_TEXT,
                square_shape=cfg.square_shape,
                freq_q=freq_q,
            )
        heatmap_io.write_html(
            os.path.join(trg_dir_path, trg_file_base + ".html"),
            figure,
            cfg.disp_letters,
        )


TriangleRunner._build_heatmap_columnar = _build_heatmap_columnar
