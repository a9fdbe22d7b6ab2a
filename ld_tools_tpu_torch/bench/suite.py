"""Benchmark suite: the BASELINE configs, with a JSON artifact (the
counterpart of scripts/bench_suite.py).

    python -m ld_tools_tpu_torch.bench.suite [--configs 0,4,5]
        [--out FILE.json] [--device cuda|cpu]

Each config prints one labelled line and adds rows to the artifact
(``--out``); the headline metric stays in ``python -m
ld_tools_tpu_torch.bench``.

Configs:
0.  ingest: the native BGZF scanner (the port's ``ingest.native``),
    single vs multi-thread.
1.  ld_lite: one pair on a synthetic 100-variant x 2,504-sample store,
    cold and warm, without the table's render (one pair is below the
    engine's host cutoff: its counts run on the host whatever the
    device).
2.  ld_triangle: the 500 variants of a synthetic 2,504-sample store, the
    EUR samples, heatmap and table (``-o both``: the per-cell hover path),
    4 source-file threads, cold and warm, with the runner's phases.
3.  ld_area: r^2 >= 0.8 around 50 query rsIDs (every 100th of 5,000
    variants) with 250 kb flanks on one chromosome, 4 source-file
    threads, cold and warm; the count jobs go through the engine on the
    device (ops/engine.py).
4.  chr21 scale: a 102,400 x 5,008 streamed threshold scan (r^2 >= 0.8),
    cold and warm (resident cache), without (4) and with (4b) the exact
    f64 finish.
4c. chr2 scale: the same scan at 204,800 variants, exact.
5.  multi-chromosome batch: 8 chromosomes of 8,192 variants through
    ``ld_triangle_matrix_packed`` (fast r^2), round-robin over the
    processes of a ``torch.distributed`` group (one process: all 8).
6.  BASELINE metric #2: a 10,000-variant x 5,008-haplotype ld_triangle
    table (``TriangleRunner._write_table_streamed``: the engine's counts
    over ``ResidentCounts``, the f64 finish, the streamed TSV), cold and
    warm, with its phases; then (6b) the per-cell hover strings of its
    first 2,000 variants, a microbenchmark of the formatting the tool
    routes past 500 variants to the columnar path.
6c. the 10,000-variant columnar heatmap
    (``TriangleRunner._build_heatmap_columnar``, the pooled overview HTML
    and the full-resolution JSON), cold and warm, with its phases.

0gb. GB-scale ingest: a >= 1 GiB BGZF fixture of 2,504 samples
    (``$TPU_LD_GB_FIXTURE`` names a path to generate it into once and
    reuse), the native scanner (``ingest/_vcfpack_ctypes.scan_packed``) in
    a fresh child process at 1, 2 and all threads: wall, VCF-text MB/s,
    variants/s and peak RSS.  Host only: the card plays no part.
wg. Whole genome: 6 chromosomes, 5 GiB of BGZF at 2,504 samples (a
    correlated cycle of 4,096 rows, so that identical rows lie farther
    apart than the window), the port's ``prep_intgen_data``, its re-run
    (a no-op), then the ``ld_scan`` tool (``tools/scan.run``) over every
    chromosome with a 100 kb window and r^2 >= 0.8, on the suite's device,
    with the scans' phases and kernel launches.  ``$TPU_LD_WG_SCALE``
    ("chroms,GiB") shrinks the fixture; ``$TPU_LD_WG_DIR`` names a
    directory to make the fixture, its store and the TSVs in and keep
    (otherwise a temporary directory, removed at the end).  The fixture's
    generation is outside every timed row.

Sizes are the module constants below, so a test can shrink them.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

from ld_tools_tpu_torch.bench import common
from ld_tools_tpu_torch.utils.device import resolve_device

CONFIG0_SAMPLES = 2504
CONFIG0_VARIANTS = 6000
CONFIG1_SAMPLES = 2504
CONFIG1_VARIANTS = 100
CONFIG2_SAMPLES = 2504
CONFIG2_VARIANTS = 500
CONFIG3_SAMPLES = 2504
CONFIG3_VARIANTS = 5000
CONFIG3_QUERIES = 50
CONFIG3_FLANK = 250_000
CONFIG4_VARIANTS = 102_400
CONFIG4C_VARIANTS = 204_800
CONFIG5_CHROMS = 8
CONFIG5_VARIANTS = 8192
CONFIG6_VARIANTS = 10_000
CONFIG6B_VARIANTS = 2000
CONFIG6C_VARIANTS = 10_000
SCAN_RUN = 64  # rows per run of identical base rows in the scan data
GB_SAMPLES = 2504
GB_TARGET_BYTES = 1 << 30
WG_SAMPLES = 2504
WG_CHROMS = 6
WG_GIB = 5
WG_BASE_ROWS = 4096     # x 50 bp = 204.8 kb between identical rows
WG_MAX_DIST = 100_000   # ld_area's default flank


class Recorder:
    """The artifact's rows.  (config, run_idx) is a unique key: repeated
    runs of one config number themselves."""

    def __init__(self):
        self.rows = []
        self._runs = {}

    def record(self, name, seconds, **extra):
        idx = self._runs.get(name, 0)
        self._runs[name] = idx + 1
        row = {"config": name, "run_idx": idx,
               "seconds": round(seconds, 3), **extra}
        self.rows.append(row)
        return row


def config0(rec, dev):
    """Ingest: native BGZF scanner throughput (single vs multi-thread)."""
    from ld_tools_tpu_torch.ingest import native, synth

    rng = np.random.default_rng(0)
    n_samples, n_var = CONFIG0_SAMPLES, CONFIG0_VARIANTS
    G = synth.correlated_haplotypes(rng, n_var, 2 * n_samples)
    names = [f"S{i:05d}" for i in range(n_samples)]
    with tempfile.TemporaryDirectory(prefix="tpu_ld_ingest_bench_") as d:
        path = os.path.join(d, "1.vcf.gz")
        synth.write_vcf(path, "1", names, G)
        text_bytes = n_var * (2 * n_samples * 2 + 60)
        for n_threads in (1, os.cpu_count() or 1):
            best = float("inf")
            for _ in range(2):
                t0 = time.perf_counter()
                out = native.scan_vcf_packed(path, n_threads=n_threads)
                best = min(best, time.perf_counter() - t0)
                if out is None:
                    raise RuntimeError("config0: the native scanner could "
                                       "not be built or loaded")
            mbps = text_bytes / best / 1e6
            print(f"config0 ingest nt={n_threads}: {best:.2f}s, "
                  f"{mbps:.0f} MB/s VCF text, {n_var / best:.0f} variants/s")
            rec.record("0_ingest", best, n_threads=n_threads,
                       mb_per_s=round(mbps, 1),
                       variants_per_s=round(n_var / best, 1))


def _env(n_samples, chrom_variant_counts, seed):
    """A synthetic prepared data directory (the port's ingest): returns
    (its path, {chrom: {rsid: pos}})."""
    from ld_tools_tpu_torch.ingest import prep, synth

    d = tempfile.mkdtemp(prefix="tpu_ld_bench_")
    rs = synth.generate_dataset(
        d, n_samples=n_samples, chrom_variant_counts=chrom_variant_counts,
        seed=seed)
    prep.prep_intgen_data(d)
    return d, rs


def _engine(dev) -> str:
    """The tools' -E choice for ``dev``."""
    return "cuda" if dev.type == "cuda" else "torch"


def config1(rec, dev):
    """ld_lite: one pair, cold and warm (scripts/bench_suite.py config1):
    the query, without the table's render (tabulate, which the card's
    machine may lack)."""
    from ld_tools_tpu_torch.tools import lite

    d, rs = _env(CONFIG1_SAMPLES, {"1": CONFIG1_VARIANTS}, seed=1)
    rsids = list(rs["1"])
    args = types.SimpleNamespace(
        rs_id_1=rsids[CONFIG1_VARIANTS // 10],
        rs_id_2=rsids[CONFIG1_VARIANTS * 6 // 10], intgen_dir_path=d,
        skip_intgen_data_ver=True, gend_names="both", pop_names="all",
        engine=_engine(dev),
    )
    try:
        for label in ("1_ld_lite_pair", "1b_ld_lite_pair_warm"):
            t0 = time.perf_counter()
            lite.pair_query(args)
            dt = time.perf_counter() - t0
            print(f"config{label[:2].rstrip('_')} ld_lite pair: {dt:.3f}s")
            rec.record(label, dt, device=dev.type)
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _rounded(phases: dict) -> dict:
    return {k: round(v, 3) if isinstance(v, float) else v
            for k, v in phases.items()}


def config2(rec, dev):
    """ld_triangle: 500 variants, EUR, -o both (scripts/bench_suite.py
    config2); each run's files are written anew."""
    from ld_tools_tpu_torch.ops import engine
    from ld_tools_tpu_torch.tools import triangle

    d, rs = _env(CONFIG2_SAMPLES, {"2": CONFIG2_VARIANTS}, seed=2)
    src = tempfile.mkdtemp(prefix="tpu_ld_bench_src_")
    with open(os.path.join(src, "q.txt"), "w") as fh:
        fh.write("\n".join(rs["2"]) + "\n")
    args = types.SimpleNamespace(
        src_dir_path=src, intgen_dir_path=d, trg_top_dir_path=src,
        meta_lines_quan=0, skip_intgen_data_ver=True, gend_names="both",
        pop_names="EUR", ld_measure="r_square", ld_low_thres=None,
        matrix_type="both", heatmap_json=False, disp_letters=False,
        color_pal="greens", font_size=None, square_shape=False,
        dont_disp_footer=False, max_proc_quan=4, engine=_engine(dev),
    )
    try:
        for label in ("2_ld_triangle_500_eur", "2b_ld_triangle_500_eur_warm"):
            before = engine.count_on_device.launches
            stats = {}
            t0 = time.perf_counter()
            matrices = triangle.run(args, stats)
            dt = time.perf_counter() - t0
            jobs = engine.count_on_device.launches - before
            print(f"config{label}: {dt:.3f}s, {matrices} matrices, {jobs} "
                  f"engine launches, phases={_rounded(stats)}")
            rec.record(label, dt, matrices=matrices, engine_launches=jobs,
                       device=dev.type, phases=_rounded(stats))
    finally:
        shutil.rmtree(d, ignore_errors=True)
        shutil.rmtree(src, ignore_errors=True)


def config3(rec, dev):
    """ld_area: 50 queries, 250 kb flanks (scripts/bench_suite.py
    config3); each run's files are written anew."""
    from ld_tools_tpu_torch.ops import engine
    from ld_tools_tpu_torch.tools import area

    d, rs = _env(CONFIG3_SAMPLES, {"3": CONFIG3_VARIANTS}, seed=3)
    src = tempfile.mkdtemp(prefix="tpu_ld_bench_src_")
    with open(os.path.join(src, "q.txt"), "w") as fh:
        fh.write("\n".join(list(rs["3"])[::100][:CONFIG3_QUERIES]) + "\n")
    args = types.SimpleNamespace(
        src_dir_path=src, intgen_dir_path=d, trg_top_dir_path=src,
        meta_lines_quan=0, skip_intgen_data_ver=True, gend_names="both",
        pop_names="all", flank_size=CONFIG3_FLANK,
        ld_thres_measure="r_square", ld_low_thres=0.8, trg_file_type="tsv",
        max_proc_quan=4, engine=_engine(dev),
    )
    try:
        for warm in (False, True):
            before = engine.count_on_device.launches
            t0 = time.perf_counter()
            files = area.run(args)
            dt = time.perf_counter() - t0
            label = "3_ld_area_50q_250kb" + ("_warm" if warm else "")
            jobs = engine.count_on_device.launches - before
            print(f"config{label}: {dt:.3f}s, {files} files, {jobs} engine "
                  "launches")
            rec.record(label, dt, files=files, engine_launches=jobs,
                       device=dev.type)
    finally:
        shutil.rmtree(d, ignore_errors=True)
        shutil.rmtree(src, ignore_errors=True)


def _scan_dataset(V, pos_span, seed):
    """One synthetic correlated chromosome for the scan configs (shared
    by 4 and 4c): runs of SCAN_RUN identical rows + 2 % flip noise, as
    the store's bitpacked bytes, and unique sorted positions.  The same
    random stream as the JAX suite's, drawn in row chunks so the flip
    draw never needs V x 5,008 doubles at once."""
    H = common.N_HAP
    rng = np.random.default_rng(seed)
    base = (
        rng.random((V // SCAN_RUN, H))
        < rng.uniform(0.05, 0.95, size=(V // SCAN_RUN, 1))
    ).astype(np.int8)
    G = np.repeat(base, SCAN_RUN, axis=0)
    for lo in range(0, G.shape[0], 8192):
        hi = min(lo + 8192, G.shape[0])
        G[lo:hi] ^= (rng.random((hi - lo, H)) < 0.02).astype(np.int8)
    pos = np.sort(rng.choice(pos_span, size=V, replace=False)).astype(
        np.int64)
    return np.packbits(G.astype(np.uint8), axis=1), H, pos


def _jittered_thres(base: float, run_idx: int) -> float:
    """A tiny per-run threshold offset (the JAX suite's), so a warm rerun
    never replays the cold run's exact inputs.  It does move the hit set:
    the exact finish compares the 4-place rounded r^2 with the threshold,
    so every pair whose r^2 rounds to exactly 0.8000 is a hit at run 0
    and not at a later run.  Runs of one config answer slightly different
    thresholds, and their hit counts differ by those pairs."""
    return base + run_idx * 2e-7


def _scan(gp, H, pos, run_no, exact, key, dev):
    from ld_tools_tpu_torch.ops.ld_stream import stream_threshold_scan

    t0 = time.perf_counter()
    hits = stream_threshold_scan(
        G_packed=gp, n_haplotypes=H, pos=pos, measure="r_square",
        thres=_jittered_thres(0.8, run_no), exact=exact,
        # the resident cache, as the ld_scan tool: warm scans (and the
        # exact rerun of the same matrix) skip the upload
        resident_key=key, device=dev)
    return hits, time.perf_counter() - t0


def config4(rec, dev):
    V = CONFIG4_VARIANTS
    gp, H, pos = _scan_dataset(V, 46_000_000, seed=4)
    pairs = V * (V - 1) / 2
    run_no = 0
    for tag, exact in (("4_chr21_scan_100k", False),
                       ("4b_chr21_scan_100k_exact", True)):
        for warm in (False, True):
            hits, dt = _scan(gp, H, pos, run_no, exact, ("bench4", V, H), dev)
            run_no += 1
            gpps = pairs / dt / 1e9
            label = tag + ("_warm" if warm else "")
            phases = {k: round(s, 2) if isinstance(s, float) else s
                      for k, s in (hits.stats or {}).items()}
            print(f"config{label}: {dt:.1f}s, {gpps:.1f} Gpairs/s, "
                  f"{len(hits.i)} hits, phases={phases}")
            rec.record(label, dt, gpairs_per_s=round(gpps, 2),
                       hits=int(len(hits.i)), device=dev.type, phases=phases)


def config4c(rec, dev):
    """chr2-scale scan (204,800 variants): amortizes the per-scan
    constants of config 4."""
    V = CONFIG4C_VARIANTS
    gp, H, pos = _scan_dataset(V, 240_000_000, seed=42)
    pairs = V * (V - 1) / 2
    for run_no, warm in enumerate((False, True)):
        hits, dt = _scan(gp, H, pos, run_no, True, ("bench4c", V, H), dev)
        label = "4c_chr2_scan_200k" + ("_warm" if warm else "")
        phases = {k: round(s, 2) if isinstance(s, float) else s
                  for k, s in (hits.stats or {}).items()}
        count_rate = pairs / max(hits.stats["count_s"], 1e-9) / 1e9
        print(f"config{label}: {dt:.1f}s, {pairs / dt / 1e9:.1f} Gpairs/s "
              f"end-to-end, count phase {count_rate:.1f} Gpairs/s, "
              f"{len(hits.i)} hits, phases={phases}")
        rec.record(label, dt, gpairs_per_s=round(pairs / dt / 1e9, 2),
                   count_gpairs_per_s=round(count_rate, 1),
                   hits=len(hits.i), device=dev.type, phases=phases)


def config5(rec, dev):
    from ld_tools_tpu_torch.ops.ld_kernels import ld_triangle_matrix_packed
    from ld_tools_tpu_torch.parallel.batch import chromosomes_for_this_process

    rng = np.random.default_rng(5)
    chroms = [str(c) for c in range(1, CONFIG5_CHROMS + 1)]
    mine = chromosomes_for_this_process(chroms)
    V, H = CONFIG5_VARIANTS, common.N_HAP
    # per-chromosome packed store bytes (the tool's wire format),
    # distinct data per chromosome
    base = (rng.random((V, H)) < 0.3).astype(np.uint8)
    packed_by_chrom = [np.packbits(np.roll(base, k * 17, axis=0), axis=1)
                       for k in range(len(mine))]

    def triangle(gp):
        # the default kernel="dense": one unpack on the card, then K1
        # (ld_pallas.ld_triangle_matrix_packed's default too)
        return ld_triangle_matrix_packed(
            torch.from_numpy(gp).to(dev), H, want_dprime=False,
            epilogue="fast")

    triangle(packed_by_chrom[0])  # first-call costs outside the timing
    common.sync(dev)
    t0 = time.perf_counter()
    total_pairs = 0
    for gp in packed_by_chrom:
        triangle(gp)
        common.sync(dev)
        total_pairs += V * (V + 1) / 2
    dt = time.perf_counter() - t0
    gpps = total_pairs / dt / 1e9
    print(f"config5 {CONFIG5_CHROMS}-chromosome batch ({len(mine)} in this "
          f"process): {dt:.1f}s, {gpps:.1f} Gpairs/s")
    rec.record("5_batch_8chrom", dt, gpairs_per_s=round(gpps, 2),
               chroms_on_host=len(mine), device=dev.type)


def _triangle_self(dev, mtype, heatmap_json):
    """The bare ``self`` the suite hands TriangleRunner's streamed
    functions (scripts/bench_suite.py config6 / config6c): a config on
    ``dev`` and the data's population and gender labels."""
    from ld_tools_tpu_torch.tools.triangle import TriangleConfig

    cfg = TriangleConfig(
        src_dir_path=".", trg_top_dir_path=".", meta_lines_quan=0,
        ld_measure="r_square", ld_low_thres=None, matrix_type=mtype,
        heatmap_json=heatmap_json, disp_letters=False, color_pal="greens",
        font_size=None, square_shape=False, dont_disp_footer=False,
        device=str(dev),
    )
    return types.SimpleNamespace(
        config=cfg,
        data=types.SimpleNamespace(pop_names=("ALL",),
                                   gend_names=("male", "female")),
    )


class _Annotations:
    """The chromosome stand-in of configs 6b and 6c: every annotation
    column one array, built once so that it costs no timed phase."""

    def __init__(self, n):
        self._ann = np.asarray(["A"] * n)

    def annotation(self, name):
        return self._ann


def _triangle_data(seed, V):
    """(G, rsIDs, positions) of configs 6 and 6c: V rows of 5,008
    haplotypes, each with its own allele frequency in [0.05, 0.95]."""
    rng = np.random.default_rng(seed)
    G = (rng.random((V, common.N_HAP))
         < rng.uniform(0.05, 0.95, (V, 1))).astype(np.int8)
    return G, [f"rs{i}" for i in range(V)], list(range(10_000, 10_000 + V))


def config6(rec, dev):
    """BASELINE metric #2 (scripts/bench_suite.py config6): the 10k table,
    then the 2,000-variant per-cell hover microbenchmark."""
    from ld_tools_tpu_torch.ops import engine
    from ld_tools_tpu_torch.ops.engine import exact_all_pairs
    from ld_tools_tpu_torch.tools.triangle import TriangleRunner

    V = CONFIG6_VARIANTS
    G, rs, poss = _triangle_data(6, V)
    self = _triangle_self(dev, "table", False)
    out_dir = tempfile.mkdtemp(prefix="tpu_ld_tri10k_")
    try:
        # first-call costs (the card's context, the product's setup)
        # outside the timed region: one small block
        w = min(256, V)
        TriangleRunner._write_table_streamed(
            self, G[:w], "0", rs[:w], poss[:w], "warm", out_dir)
        for label in ("6_triangle_10k_table", "6_triangle_10k_table_warm"):
            phases = {}
            before = engine.count_on_device.launches
            t0 = time.perf_counter()
            TriangleRunner._write_table_streamed(
                self, G, "21", rs, poss, "bench10k", out_dir,
                phase_stats=phases)
            dt = time.perf_counter() - t0
            jobs = engine.count_on_device.launches - before
            size_mb = os.path.getsize(
                os.path.join(out_dir, "bench10k_chr21_r.tsv")) / 1e6
            print(f"config{label}: {dt:.1f}s ({V * V / dt / 1e6:.0f} "
                  f"Mcells/s, {size_mb:.0f} MB TSV), {jobs} engine "
                  f"launches, phases={_rounded(phases)}")
            rec.record(label, dt, mcells_per_s=round(V * V / dt / 1e6, 1),
                       tsv_mb=round(size_mb, 1), engine_launches=jobs,
                       device=dev.type, phases=_rounded(phases))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)

    # the per-cell hover strings at 2,000 variants: the tool routes past
    # 500 variants to the columnar payload (config 6c), so this row times
    # the per-cell formatting itself, not a configuration a user reaches
    V2 = min(CONFIG6B_VARIANTS, V)
    cd = _Annotations(V2)
    for label in ("6b_hover_percell_2000_microbench",
                  "6b_hover_percell_2000_microbench_warm"):
        before = engine.count_on_device.launches
        t0 = time.perf_counter()
        exact = exact_all_pairs(G[:V2], device=str(dev))
        t_count = time.perf_counter() - t0
        info = TriangleRunner._hovertext_matrix(
            self, exact, cd, list(range(V2)), rs[:V2], poss[:V2])
        dt = time.perf_counter() - t0
        jobs = engine.count_on_device.launches - before
        phases = {"exact_s": round(t_count, 3),
                  "hover_format_s": round(dt - t_count, 3)}
        print(f"config{label}: {dt:.1f}s ({V2 * V2 / 2 / dt / 1e6:.1f} "
              f"Mcells/s), {jobs} engine launches, phases={phases}")
        rec.record(label, dt, mcells_per_s=round(V2 * V2 / 2 / dt / 1e6, 1),
                   engine_launches=jobs, device=dev.type, phases=phases)
        del info


def config6c(rec, dev):
    """The 10k columnar heatmap (scripts/bench_suite.py config6c): int16
    value triangles and O(n) strings from streamed row blocks."""
    from ld_tools_tpu_torch.ops import engine
    from ld_tools_tpu_torch.tools.triangle import TriangleRunner

    V = CONFIG6C_VARIANTS
    G, rs, poss = _triangle_data(66, V)
    self = _triangle_self(dev, "heatmap", True)
    cd = _Annotations(V)
    out_dir = tempfile.mkdtemp(prefix="tpu_ld_hm10k_")
    try:
        w = min(600, V)
        TriangleRunner._build_heatmap_columnar(
            self, cd, "0", list(range(w)), rs[:w], poss[:w], G[:w], None,
            "warm", out_dir)
        for label in ("6c_heatmap_columnar_10k",
                      "6c_heatmap_columnar_10k_warm"):
            phases = {}
            before = engine.count_on_device.launches
            t0 = time.perf_counter()
            TriangleRunner._build_heatmap_columnar(
                self, cd, "21", list(range(V)), rs, poss, G, None, "hm10k",
                out_dir, phase_stats=phases)
            dt = time.perf_counter() - t0
            jobs = engine.count_on_device.launches - before
            html_mb = os.path.getsize(
                os.path.join(out_dir, "hm10k_chr21_r.html")) / 1e6
            print(f"config{label}: {dt:.1f}s, {html_mb:.0f} MB HTML "
                  f"({V * V / 2 / dt / 1e6:.0f} Mcells/s), {jobs} engine "
                  f"launches, phases={_rounded(phases)}")
            rec.record(label, dt, html_mb=round(html_mb, 1),
                       mcells_per_s=round(V * V / 2 / dt / 1e6, 1),
                       engine_launches=jobs, device=dev.type,
                       phases=_rounded(phases))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def _write_gb_fixture(path, chrom, n_samples, target_bytes, rng,
                      level=1, rs_base=0, n_base=256, correlated=False):
    """Stream-generate a BGZF VCF of about ``target_bytes`` compressed for
    one chromosome (scripts/bench_suite._write_gb_fixture on the port's
    ``ingest.synth``); returns (n_variants, text_bytes).  Level 1: the
    scanner inflates either way, and the generation stays off the timed
    rows.

    Genotype rows cycle through ``n_base`` pre-encoded lines, so variants
    ``n_base`` apart are identical (r^2 = 1).  The whole-genome scan
    takes ``correlated=True`` with a cycle longer than its window: the
    pairs in a window then carry the base block's LD decay
    (synth.correlated_haplotypes) and no duplicate rows."""
    from ld_tools_tpu_torch.ingest import synth

    if correlated:
        base = synth.correlated_haplotypes(rng, n_base, 2 * n_samples)
    else:
        base = (
            rng.random((n_base, 2 * n_samples))
            < rng.uniform(0.05, 0.95, (n_base, 1))
        ).astype(np.int8)
    gt_lines = [synth._genotype_line_bytes(base[k]) for k in range(n_base)]
    v = 0
    text_bytes = 0
    with open(path, "wb") as raw:
        w = synth.BgzfWriter(raw, level=level)
        w.write(b"##fileformat=VCFv4.1\n")
        w.write(
            b"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
            + "\t".join(f"S{i:05d}" for i in range(n_samples)).encode()
            + b"\n"
        )
        cpfx = f"{chrom}\t".encode()
        while raw.tell() < target_bytes:
            for _ in range(n_base):
                v += 1
                line = (
                    cpfx + f"{v * 50}\trs{rs_base + v}\tA\tG\t100\tPASS\t"
                    f"VT=SNP\tGT\t".encode()
                    + gt_lines[v % n_base] + b"\n"
                )
                w.write(line)
                text_bytes += len(line)
        w.close()
    return v, text_bytes


# the child of config 0gb: one scan in a fresh process, so that its peak
# RSS is the scan's own.  A thread samples the resident set
# (/proc/self/statm) every 5 ms while the scan runs in native code:
# ru_maxrss would carry over the parent's peak through fork and exec.
_GB_CHILD = """\
import json, os, sys, threading, time
from ld_tools_tpu_torch.ingest import _vcfpack_ctypes as nat
page = os.sysconf("SC_PAGE_SIZE")
def rss():
    with open("/proc/self/statm") as fh:
        return int(fh.read().split()[1]) * page
peak = [rss()]
done = threading.Event()
def sample():
    while not done.wait(0.005):
        peak[0] = max(peak[0], rss())
th = threading.Thread(target=sample)
th.start()
t0 = time.perf_counter()
out = nat.scan_packed(sys.argv[1], n_threads=int(sys.argv[2]))
dt = time.perf_counter() - t0
done.set()
th.join()
peak[0] = max(peak[0], rss())
print(json.dumps({"s": dt, "rss_mb": peak[0] / 2**20, "v": int(out[0].shape[0]),
                  "packed_mb": out[0].nbytes / 1e6}))
"""


def config0gb(rec, dev):
    """GB-scale ingest (scripts/bench_suite.config0gb): the native scanner
    over a >= 1 GiB BGZF fixture in a fresh child process per thread
    count, with its wall, VCF-text MB/s and peak RSS.  Host only."""
    from ld_tools_tpu_torch.ingest import _vcfpack_ctypes

    _vcfpack_ctypes._load()  # built before the timed children start
    reuse = os.environ.get("TPU_LD_GB_FIXTURE")
    tmp = None if reuse else tempfile.mkdtemp(prefix="tpu_ld_gb_")
    try:
        path = reuse or os.path.join(tmp, "1.vcf.gz")
        if reuse and os.path.exists(reuse) and os.path.exists(
                reuse + ".meta.json"):
            with open(reuse + ".meta.json") as fh:
                fix_meta = json.load(fh)
            v, text_bytes = fix_meta["v"], fix_meta["text_bytes"]
        else:
            # with $TPU_LD_GB_FIXTURE, generated into the named path for
            # the next run to reuse
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            t0 = time.perf_counter()
            v, text_bytes = _write_gb_fixture(
                path, "1", GB_SAMPLES, GB_TARGET_BYTES,
                np.random.default_rng(0))
            gen_s = time.perf_counter() - t0
            with open(path + ".meta.json", "w") as fh:
                json.dump({"v": v, "text_bytes": text_bytes}, fh)
            print(f"config0gb fixture: {os.path.getsize(path) / 2**30:.2f} "
                  f"GiB BGZF, {v} variants, {text_bytes / 2**30:.1f} GiB "
                  f"text, generated in {gen_s:.0f}s")
        size_gb = os.path.getsize(path) / 2**30
        repo = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ, PYTHONPATH=repo)
        for n_threads in sorted({1, 2, os.cpu_count() or 1}):
            proc = subprocess.run(
                [sys.executable, "-c", _GB_CHILD, path, str(n_threads)],
                capture_output=True, text=True, timeout=3600, env=env)
            if proc.returncode != 0:
                raise RuntimeError(f"config0gb: the scan at {n_threads} "
                                   f"threads failed:\n{proc.stderr[-2000:]}")
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            mbps = text_bytes / res["s"] / 1e6
            print(f"config0gb ingest nt={n_threads}: {res['s']:.1f}s, "
                  f"{mbps:.0f} MB/s VCF text, {res['v'] / res['s']:.0f} "
                  f"variants/s, peak RSS {res['rss_mb']:.0f} MB (packed "
                  f"output {res['packed_mb']:.0f} MB)")
            rec.record("0gb_ingest", res["s"], n_threads=n_threads,
                       bgzf_gib=round(size_gb, 2), mb_per_s=round(mbps, 1),
                       variants=res["v"],
                       variants_per_s=round(res["v"] / res["s"], 1),
                       peak_rss_mb=round(res["rss_mb"], 1),
                       packed_mb=round(res["packed_mb"], 1))
    finally:
        if tmp:
            shutil.rmtree(tmp, ignore_errors=True)


# the scan reports' phases summed over the chromosomes of config wg
WG_PHASES = ("host_prep_s", "upload_s", "count_s", "fetch_s", "finish_s",
             "write_s", "blocks", "hit_blocks")


def _wg_fixture(d, n_chroms, total_gib, scaled):
    """Config wg's BGZF files and panel in ``d``; returns (variants, text
    bytes, BGZF GiB)."""
    from ld_tools_tpu_torch.ingest import synth

    per_chrom = int(total_gib * (1 << 30)) // n_chroms + (
        (1 << 20) if scaled else (64 << 20))
    total_v = total_text = 0
    for k in range(n_chroms):
        chrom = str(k + 1)
        v, tb = _write_gb_fixture(
            os.path.join(d, f"{chrom}.vcf.gz"), chrom, WG_SAMPLES, per_chrom,
            np.random.default_rng(100 + k), rs_base=k * 50_000_000,
            n_base=WG_BASE_ROWS, correlated=True)
        total_v += v
        total_text += tb
    synth.write_panel(
        os.path.join(d, "samples.txt"),
        [(f"S{i:05d}", "GBR", "EUR", "male" if i % 2 else "female")
         for i in range(WG_SAMPLES)])
    size_gb = sum(os.path.getsize(os.path.join(d, f"{c + 1}.vcf.gz"))
                  for c in range(n_chroms)) / 2**30
    return total_v, total_text, size_gb


def config_wg(rec, dev):
    """Whole-genome prep and scan (scripts/bench_suite.config_wg): the
    fixture through ``prep_intgen_data`` in one call, the re-prep, then
    the ld_scan tool over every chromosome (100 kb window, r^2 >= 0.8) on
    the suite's device."""
    from ld_tools_tpu_torch.ingest import HaplotypeStore, prep_intgen_data
    from ld_tools_tpu_torch.tools import scan as scan_tool

    n_chroms, total_gib = WG_CHROMS, WG_GIB
    scale = os.environ.get("TPU_LD_WG_SCALE")
    if scale:
        c, g = scale.split(",")
        n_chroms, total_gib = int(c), float(g)
    keep = os.environ.get("TPU_LD_WG_DIR")
    if keep:
        os.makedirs(keep, exist_ok=True)
    d = tempfile.mkdtemp(prefix="tpu_ld_wg_", dir=keep or None)
    try:
        t0 = time.perf_counter()
        total_v, total_text, size_gb = _wg_fixture(d, n_chroms, total_gib,
                                                   bool(scale))
        print(f"config_wg fixture: {n_chroms} chromosomes, {size_gb:.2f} GiB "
              f"BGZF, {total_v} variants, {total_text / 2**30:.1f} GiB text, "
              f"generated in {time.perf_counter() - t0:.0f}s")
        t0 = time.perf_counter()
        prep_intgen_data(d)
        prep_s = time.perf_counter() - t0
        print(f"config_wg prep: {prep_s:.1f}s end-to-end "
              f"({total_text / prep_s / 1e6:.0f} MB/s text, "
              f"{total_v / prep_s:.0f} variants/s)")
        rec.record("wg_prep_5gb", prep_s, n_chroms=n_chroms,
                   bgzf_gib=round(size_gb, 2),
                   text_gib=round(total_text / 2**30, 2), variants=total_v,
                   mb_per_s=round(total_text / prep_s / 1e6, 1),
                   variants_per_s=round(total_v / prep_s, 1))
        # prep on a complete store is a no-op
        t0 = time.perf_counter()
        prep_intgen_data(d)
        rerun_s = time.perf_counter() - t0
        print(f"config_wg re-prep (a no-op): {rerun_s:.2f}s")
        rec.record("wg_prep_5gb_rerun", rerun_s)

        max_dist = WG_MAX_DIST
        scan_args = types.SimpleNamespace(
            intgen_dir_path=d, skip_intgen_data_ver=True, gend_names="both",
            pop_names="all", chroms="all",
            trg_dir_path=os.path.join(d, "scan_out"), ld_measure="r_square",
            ld_low_thres=0.8, max_dist=max_dist, checkpoint_dir=None,
            engine=_engine(dev), devices=None)
        store = HaplotypeStore(d)
        pairs_in_window = 0
        for c in store.chroms():
            p = np.asarray(store.chrom(c).pos)
            # for each i, the count of j < i with pos_i - pos_j <= max_dist
            lo = np.searchsorted(p, p - max_dist, side="left")
            pairs_in_window += int((np.arange(p.shape[0]) - lo).sum())
        if dev.type == "cuda":
            # the kernels' first-use build (nvcc, about 20 s) stays out of
            # the timed scan, as the native scanner's stays out of 0gb's
            from ld_tools_tpu_torch.ops import _cuda_build

            _cuda_build.lib()
        before = common.launch_counts()
        t0 = time.perf_counter()
        reports = scan_tool.run(scan_args)
        scan_s = time.perf_counter() - t0
        launches = common.launches_since(before)
        hits = sum(r.n_hits for r in reports)
        phases = {k: round(sum(r.stats.get(k, 0) for r in reports), 3)
                  for k in WG_PHASES}
        chroms = {r.chrom: {"hits": r.n_hits, "resident_packed":
                            bool(r.stats.get("resident_packed"))}
                  for r in reports}
        print(f"config_wg scan: {scan_s:.1f}s for "
              f"{pairs_in_window / 1e9:.2f} Gpairs in-window across "
              f"{n_chroms} chromosomes, {hits} hits (r^2 >= 0.8, window "
              f"{max_dist / 1000:.0f} kb), launches {launches}, "
              f"phases={phases}")
        rec.record("wg_scan_100kb", scan_s, n_chroms=n_chroms,
                   variants=total_v, max_dist=max_dist,
                   pairs_in_window=pairs_in_window, hits=hits,
                   gpairs_per_s=round(pairs_in_window / scan_s / 1e9, 3),
                   device=dev.type, phases=phases, launches=launches,
                   chroms=chroms)
        rec.record("wg_e2e_prep_plus_scan", prep_s + scan_s)
    finally:
        if not keep:
            shutil.rmtree(d, ignore_errors=True)


CONFIGS = {
    "0": config0,
    "1": config1,
    "2": config2,
    "3": config3,
    "4": config4,
    "4c": config4c,
    "5": config5,
    "6": config6,
    "6c": config6c,
    "0gb": config0gb,
    "wg": config_wg,
}


def _code_rev():
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], capture_output=True,
            text=True, cwd=os.path.dirname(os.path.abspath(__file__)),
        ).stdout.strip() or None
    except OSError:
        return None


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(
        prog="python -m ld_tools_tpu_torch.bench.suite",
        description="The benchmark suite's ported configs.")
    ap.add_argument("--configs", default="0,4,5",
                    help=f"comma list of configs ({', '.join(CONFIGS)}; "
                         "default 0,4,5)")
    ap.add_argument("--out", default=None, help="write the JSON artifact here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    keys = [c.strip() for c in args.configs.split(",")]
    for key in keys:
        if key not in CONFIGS:
            ap.error(f"unknown config {key!r}; valid: {', '.join(CONFIGS)}")
    dev = resolve_device(args.device)
    meta = {
        "device": common.describe_device(dev),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "code_rev": _code_rev(),
        "started_unix": round(time.time(), 1),
    }
    print(f"bench_suite {meta['device']}")
    rec = Recorder()
    for key in keys:
        CONFIGS[key](rec, dev)
    from ld_tools_tpu_torch.ops.engine import count_on_device

    common.log_launches(engine=count_on_device.launches)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"meta": meta, "results": rec.rows}, fh, indent=1)
        print(f"wrote {args.out}")
    return rec.rows


if __name__ == "__main__":
    main()
