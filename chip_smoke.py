#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (ld_tools_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on any failure:

1. device   the card's name and power limit (nvidia-smi);
2. build    nvcc compiles every csrc/*.cu for sm_90a (every instance) and
            prints ptxas's registers, shared memory and spills; cuobjdump
            -sass must show warpgroup MMAs (GMMA) and no IMMA or HMMA
            (warp-level MMAs) in every wgmma instance: both of the count
            kernel (K5, K6) and the twelve of the block kernel (K1 / K8,
            K2, K1b in bf16 and in tf32, K3 and K4, each at tiles 320 and
            256 wide);
3. kernels  each kernel against its plain PyTorch version on the card, at
            the shapes the scan and the headline sweep give it (640-row
            blocks, W = 5,120 int8 haplotypes or 640 packed bytes, a ragged
            row count, monomorphic rows): the block kernel's triangle on
            int8 rows (K1) and in bf16 and tf32 (K1b), bit for bit, also
            at blocks of 200, 512, 1,000 and 1,024, K1b also at widths of
            16 and 5,008 haplotypes and on signed int8 rows; its triangle
            on the packed bytes (K2), bit for bit, at the same blocks; the
            block kernel's band sweeps, dense (K3) and packed
            (K4), bit for bit, also at blocks of 1,000 and with rows and
            columns from matrices of different row counts; the fused count
            pass (K5) and its bit-plane form (K6), in both mask modes, both
            measures, with and without the distance window, also at a
            count block (1,000) that the count kernel's 128 x 320 tile does
            not divide.  Every bit-plane and K1b output must equal its int8
            twin's bit for bit (K2 = K1, K1b = K1, K4 = K3, K6 = K5).
            Pass-1 counts against pass-2 hits in both mask modes and both
            resident layouts.  The resident's gather from the store's
            packed rows (ld_gather_rows_kernel, which replaces no TPU
            kernel) against its plain version, byte for byte: the full
            panel and a 970-haplotype cohort, each into the int8 and the
            packed layout, on a full 65,536-row staging chunk and a
            partial one, directly and through prepare_resident; its
            launches on the 1.1 M -w 1000000 scan's path (one a chunk);
            timed at 1,105,920 rows beside its byte bound.  Per kernel its
            time, the plain version's,
            the least time the card could take and their ratio (the
            roofline share), and torch._int_mm over the same int8 block
            products as a yardstick the port never calls (for K1b also
            torch.matmul in bf16 and in TF32 over the same blocks);
4. scan     the ld_scan tool (ld_tools_tpu_torch.ld_scan.main, what
            ``python -m ld_tools_tpu_torch.ld_scan`` runs) on a chr21-scale
            store of 102,400 variants x 5,008 haplotypes written by the
            port's own ingest: without and with -w 1000000 (the int8
            resident layout: K5, K3), then again without a window under
            TPU_LD_DENSE_RESIDENT_BYTES=0 (the packed layout: K6, K4; the
            TSV must be byte-identical).  Then the slice at full size: a
            store of 1,105,920 variants (the record count of a 1000 Genomes
            chromosome VCF) scanned with -w 1000000 at the default limit,
            where ``auto`` keeps the bytes packed.  The launch counts are
            read around each run and every run's hits are held against an
            f64 recount of sampled hits and pairs; every run's TSV must
            come from the native writer (``tsv_native`` 1, also in the
            parity phase's -E cuda and -E torch runs, whose bytes must be
            equal).  K4's launches in that
            run are recorded and timed inside it, then replayed beside
            their plain versions and torch._int_mm;
   area     ld_area (``ld_tools_tpu_torch.ld_area.main``) on the chr21
            store: 1,000 query rsIDs (every 100th row) in 4 source files,
            -p 4 (four threads issue the engine's counts at once), the
            defaults (flank 100 kb, r^2 >= 0.8, TSV); the engine's launch
            count must rise (its counts ran on the card: torch._int_mm in
            ops/engine.py) and sampled queries' files must equal a
            recount with the port's plain versions;
   triangle ld_triangle (``ld_tools_tpu_torch.ld_triangle.main``) on the
            chr21 store: 500 and 2,000 rsIDs with -o both -j on -p 3
            threads (the per-cell hover path and the columnar heatmap),
            then 10,000 with -o table (the streamed table over
            ResidentCounts, 5 row blocks); the engine must have counted on
            the card; every row of the 500-row table and 200 sampled rows
            of each larger one must equal an f64 recount from the store;
   sharded  K7 (``ld_band_count_sharded``: K5's or K6's kernel once per
            shard, each shard on its own stream) over the explicit shard
            list [cuda:0] * 4 against its plain version on the ragged rows
            (both forms, with and without the window), against the
            unsharded K5 on the chr21 blocks (also over ``scan_mesh()``,
            which is [cuda:0] on one card, as ``scan_mesh(4)`` is) and K6
            on the 1.1 M store's -w 1000000 blocks, bit for bit, timed
            beside them; the scan over [cuda:0] * 4 in both layouts
            against the one-device scan (hits, values, sentinels; only K7
            and K3/K4 launched); the ld_scan tool with ``-d 4`` on one
            card, which runs the one-device scan (K5 and K3, no K7) as
            the JAX tool does on one chip, beside ``-d 1`` and the tool
            over the explicit list [cuda:0] * 4 (K7), each TSV
            byte-identical to the single-process TSV; the ld_scan tool as two
            processes of a gloo group on the card (``-d 2 -k``: one card
            each, so the one-device scan, K5 and K3 only), then again
            resuming every batch (no launch), rank 0's TSV
            byte-identical to the single-process TSV both times; and the
            replicated, ring and trapezoid sweeps at 10,240 x 5,008 over
            [cuda:0] * 4, each equal to the one-device sweep, its r^2
            within 2e-5 of the f64 finish at 4,000 sampled pairs and of
            K1's exact r^2; then the ring and the trapezoid across two
            gloo processes on the card (this script's ``--sweep-worker``
            role; ``make_mesh(devices=[cuda:0, cuda:0])`` in each, four
            shards over the group), each process's row bands equal to its
            one-device sweep with torch.equal;
   entry    the entry points of ``ld_tools_tpu_torch.entry``:
            entry()'s LD step on the card within 1e-6 of the CPU's;
            with fewer than 4 cards, make_mesh(4) and dryrun_multichip(4)
            must raise ValueError (as JAX's make_mesh raises and its dry
            run asserts 4 devices); then dryrun_multichip(4,
            devices=[cuda:0] * 4), four shards on one card;
   mixed    ld_scan on a chrX store of the chr21 row count (102,400
            variants x 2,504 samples, males haploid outside the PAR bands:
            three ploidy segments) with -w 1000000 in both resident
            layouts: K5/K3 (int8) or K6/K4 (packed) on the segments, the
            engine on the cross-segment rectangles, the same TSV bytes,
            sampled hits inside and across the segments and pairs across
            the boundaries against a recount on the card; then
            ld_triangle on that store: 300 and 1,000 rsIDs straddling the
            first PAR bound, -o both (the grouped engine on the per-cell
            path; the columnar heatmap with int32 codes), sampled rows
            against the recount;
5. parity   a 10,240-variant store: the -E cuda TSVs of both layouts must
            be byte-identical to the -E torch TSV (plain versions, CPU);
            so must ld_area's files in each file type, the scan of a
            10,240-variant chrX store, and ld_lite on an autosome pair
            and a chrX pair across the PAR boundary (its table where
            tabulate is installed, else its values); and ld_triangle's
            files of the chr21 (500 and 2,000 rsIDs) and chrX runs;
6. bench    the port's measurement entry points, each as ``python -m``
            must exit 0: the headline sweep (``ld_tools_tpu_torch.bench``,
            one JSON line with bench.py's metric and keys), the K8 stage
            split (``bench.microkernels``: K8's launches on its path), the
            fast triangle variants (``bench.kernels --only fast``) and
            suite configs 5, 1 (ld_lite), 3 (ld_area), 2, 6 and 6c
            (ld_triangle: the 500-variant tool run, the 10,000-variant
            table with the 2,000-variant hover microbenchmark, the
            10,000-variant columnar heatmap; the engine's counts on the
            card in each) with their artifact.  Each reports its own launch
            counts, and each must have launched its kernels and no other;
7. measure  the measurement scripts, each as ``python -m``: the kernel
            smoke artifact (``bench.smoke``: the JAX smoke suite's 17
            configurations of K1-K6 against numpy oracles, every one ok,
            launches from K1-K6 only), the scaling model
            (``bench.scaling_model``: dispatch, H2D, D2H and K5's rate,
            each finite and positive), the sharded-scan scaling at chr21
            scale (``bench.scaling``: 1, 2, 4 and 8 shards on the card,
            each row's ``cards`` the distinct cards under its shards,
            equal hits; K5 and K3, K7 past one shard) and suite config wg
            at 2 chromosomes and 0.5 GiB of BGZF (2,504 samples: prep, the
            re-prep a no-op, the ld_scan tool with K5 and K3; each
            chromosome's TSV against an f64 recount of sampled hits and
            pairs).

K8 (the staged triangle kernel, ``ld_stage_blocks``: K1's kernel at four
epilogues) is held against its plain version bit for bit at every stage
in phase 3, at V = 10,240 with 512-row blocks and on the ragged rows, and
timed there (the stage split).  So are K1, K1b and K2 at the 512- and
1,024-row blocks that ``bench.kernels --only fast`` launches, and at
200- and 1,000-row blocks, which their tile does not divide.

It ends with a JSON line of the build time, the scans' phases and launch
counts, ld_area's, ld_triangle's and the chrX scan's phases, the sweeps',
the entry points', the headline and the measurement scripts' records, a ``kernels`` JSON line, the
nvidia-smi line and, last, the device JSON line.  It needs the repository around it and a CUDA card.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

# H100 SXM data sheet, dense tensor-core peaks and HBM3 rate
H100_INT8_OPS = 1979e12
H100_BF16_FLOPS = 989e12
H100_TF32_FLOPS = 495e12
H100_HBM_BYTES = 3.35e12
# chr21 scale: scripts/bench_suite.py, config 4b_chr21_scan_100k_exact
N_VARIANTS = 102_400
N_HAP = 5008
W_DENSE = 5120   # haplotypes padded to 128
W_PACKED = 640   # the 626 packed bytes padded to 128
BLOCK = 640
# a count block that the count kernel's 128 x 320 tile does not divide
UNTIDY_BLOCK = 1000
# the slice at full size: 144 x 7,680 variants, the record count of a
# 1000 Genomes phase-3 chromosome VCF (chr21: about 1.1 M), in runs of 8
# correlated rows (about 2.3 M hits, near the 102,400-variant store's)
N_VARIANTS_FULL = 1_105_920
RUN_FULL = 8
SPAN = 46_000_000  # positions over 46 Mb, as chr21's
N_TRIANGLE = 10_240  # the headline triangle sweep of bench.py
N_RAGGED = 10_000    # the ragged check slice: its last block is partial
N_PARITY = 10_240    # the -E cuda / -E torch store
LIMIT = "TPU_LD_DENSE_RESIDENT_BYTES"
COUNT_SOURCE = "ld_tools_tpu_torch/csrc/ld_count_sm90.cu"  # K5, K6 (K7)
# K1, K8, K2, K1b, K3, K4
BLOCK_SOURCE = "ld_tools_tpu_torch/csrc/ld_block_sm90.cu"
# the wgmma instances of ld_block_sm90.cu (K8: K1's at four epilogues)
K1 = "ld_block_kernel<FORM_S8,STORE_TRIANGLE>"
K1B_BF16 = "ld_block_kernel<FORM_BF16,STORE_TRIANGLE>"
K1B_TF32 = "ld_block_kernel<FORM_TF32,STORE_TRIANGLE>"
K3 = "ld_block_kernel<FORM_S8,STORE_SWEEP>"
K4 = "ld_block_kernel<FORM_BITS,STORE_SWEEP>"
K2 = "ld_block_kernel<FORM_BITS,STORE_TRIANGLE>"
PALLAS = "ld_tools_tpu/ops/ld_pallas.py"
# the resident's gather from the store's packed rows (replaces no TPU
# kernel): csrc/ld_gather_rows.cu through ops/ld_kernels.gather_rows_device
GATHER = "ld_gather_rows_kernel"
GATHER_SOURCE = "ld_tools_tpu_torch/csrc/ld_gather_rows.cu"
# a population cohort of the panel, as the 1000 Genomes EUR panel: 485
# samples, 970 haplotypes
N_COHORT_SAMPLES = 485
# K8's stages (ops/ld_kernels.STAGES) and block (bench_microkernels.py's)
STAGES = ("counts", "scale", "fast", "exact")
STAGE_BLOCK = 512
# the triangle routes beside the 640-row blocks: K1, K1b and K2 at the
# blocks ``bench.kernels --only fast`` launches (512, 1,024) and at sides
# their tile does not divide (200, 1,000: 128-row tiles, 256 columns wide)
UNTIDY_BLOCKS = (200, UNTIDY_BLOCK)
OTHER_BLOCKS = tuple((name, block) for name in (K1, K1B_BF16, K1B_TF32, K2)
                     for block in (512, 1024) + UNTIDY_BLOCKS)
# K1b at widths of the haplotype axis that its stage (64 bf16 or 32 f32
# haplotypes) does not divide: one 16-byte chunk, and the panel's 5,008
K1B_WIDTHS = (16, N_HAP)


def _stage_kernel(stage):
    """K8 at one stage: K1's kernel with epilogue EPI_<STAGE>."""
    return f"{K1}/EPI_{stage.upper()}"


# kernel name -> (its tag in ROADMAP.md, the TPU kernel it replaces)
KERNELS = {
    K1: ("K1", f"{PALLAS}:259"),
    K1B_BF16: ("K1b", f"{PALLAS}:292"),
    K1B_TF32: ("K1b", f"{PALLAS}:292"),
    K2: ("K2", f"{PALLAS}:303"),
    K3: ("K3", f"{PALLAS}:747"),
    K4: ("K4", f"{PALLAS}:693"),
    "ld_band_count_kernel": ("K5", f"{PALLAS}:909"),
    "ld_band_count_kernel<FORM_BITS>": ("K6", f"{PALLAS}:949"),
    "ld_band_count_sharded": ("K7", f"{PALLAS}:1206"),
    **{_stage_kernel(s): ("K8", "scripts/bench_microkernels.py:76")
       for s in STAGES},
}
# launch site (ops/ld_kernels.py) -> the kernel it launches
KERNEL_OF_SITE = {
    "ld_triangle_blocks": K1,
    "ld_triangle_blocks_bf16": K1B_BF16,
    "ld_triangle_blocks_tf32": K1B_TF32,
    "ld_triangle_blocks_packed": K2,
    "ld_band_sweep_blocks": K3,
    "ld_band_sweep_blocks_packed": K4,
    "ld_band_count": "ld_band_count_kernel",
    "ld_band_count_packed": "ld_band_count_kernel<FORM_BITS>",
    # K7: K5's (or K6's) kernel launched once per shard
    "ld_band_count_sharded": "ld_band_count_sharded",
    "ld_stage_blocks": f"{K1}/EPI_*",  # one of the four
    "gather_rows_device": GATHER,
}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps, warmup=1):
    """Mean device milliseconds per call of ``fn`` over ``reps`` calls,
    between CUDA events, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def int_mm_rows(g, nb, block):
    """torch._int_mm over the lower-triangle block rows of ``g``: the
    yardstick of the int8 counts, one call per block row (never called by
    the port)."""
    import torch

    for k in range(nb):
        torch._int_mm(g[k * block:(k + 1) * block], g[:(k + 1) * block].t())


def matmul_rows(g, nb, block):
    """torch.matmul over the same block rows as :func:`int_mm_rows`, in
    ``g``'s float type: K1b's yardstick (never called by the port)."""
    import torch

    for k in range(nb):
        torch.matmul(g[k * block:(k + 1) * block], g[:(k + 1) * block].t())


def float_yardsticks(g, nb, block):
    """(bf16 ms, TF32 ms) of :func:`matmul_rows` on the int8 rows ``g``
    cast to bf16, and to f32 with TF32 products allowed (the setting is
    restored afterwards)."""
    import torch

    gb = g.to(torch.bfloat16)
    bf16 = cuda_ms(lambda: matmul_rows(gb, nb, block), reps=5)
    del gb
    gf = g.to(torch.float32)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = cuda_ms(lambda: matmul_rows(gf, nb, block), reps=5)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    return bf16, tf32


def bound(ops, nbytes, peak=H100_INT8_OPS):
    """(ms, "operations" or "bytes"): the larger of the tensor-core time at
    ``peak`` and the HBM time, at the card's published rates."""
    t_ops = ops / peak * 1e3
    t_bytes = nbytes / H100_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def scan_dataset(v, seed, run=64):
    """After scripts/bench_suite.py:_scan_dataset: runs of ``run``
    identical rows (allele frequency uniform in [0.05, 0.95]) with 2 %
    flip noise, unique positions over 46 Mb; the store's packed bytes.
    Made on the card in row chunks, so a chromosome-scale store never
    needs its int8 matrix (5.5 GB at 1.1 M variants) on the host."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    dev = torch.device("cuda")
    weights = 2 ** torch.arange(7, -1, -1, device=dev, dtype=torch.int32)
    gp = np.empty((v, N_HAP // 8), dtype=np.uint8)
    rows = (65_536 // run) * run
    for lo in range(0, v, rows):
        n = min(rows, v - lo)
        n_runs = -(-n // run)
        freq = 0.05 + 0.9 * torch.rand((n_runs, 1), generator=gen, device=dev)
        base = torch.rand((n_runs, N_HAP), generator=gen, device=dev) < freq
        G = base.repeat_interleave(run, dim=0)[:n]
        G ^= torch.rand((n, N_HAP), generator=gen, device=dev) < 0.02
        bits = G.view(n, N_HAP // 8, 8).to(torch.int32)
        gp[lo:lo + n] = (bits * weights).sum(dim=2).to(torch.uint8).cpu().numpy()
        del freq, base, G, bits
    rng = np.random.default_rng(seed)
    pos = np.sort(rng.choice(SPAN, size=v, replace=False)).astype(np.int64)
    return gp, pos


def store_panel(seed):
    """The sample panel of a store written with ``seed``: N_HAP / 2
    samples (name, population, superpopulation, gender)."""
    from ld_tools_tpu_torch.ingest import synth

    return synth.make_panel(N_HAP // 2, np.random.default_rng(seed))


def write_store(d, chrom, gp, pos, seed, pgroup=None, ploidy_profiles=None):
    """A prepared-looking data directory: samples.txt + the packed store
    (the port's ingest copies), so prep builds conversion.db offline.
    ``pgroup`` and ``ploidy_profiles`` make a mixed-ploidy chromosome."""
    from ld_tools_tpu_torch.ingest import pack, synth

    panel = store_panel(seed)
    os.makedirs(d, exist_ok=True)
    synth.write_panel(os.path.join(d, "samples.txt"), panel)
    v = gp.shape[0]
    pack.write_chrom(
        d, chrom, pos=pos, rsid=[f"rs{100_000 + i}" for i in range(v)],
        ref=["A"] * v, alt=["G"] * v, vt=["SNP"] * v,
        samples=[row[0] for row in panel], genotypes_packed=gp,
        n_haplotypes=N_HAP, pgroup=pgroup, ploidy_profiles=ploidy_profiles,
    )


def rsid_of(row):
    """The rsID :func:`write_store` gives a row."""
    return f"rs{100_000 + int(row)}"


def chrx_bounds(v):
    """The rows [lo, hi) outside the PAR bands of a chrX store of ``v``
    rows (ingest/synth.make_chrx_layout's bounds 0.25 and 0.75, moved by
    half a run of 64 so that a run of correlated rows straddles each
    segment boundary)."""
    return v // 4 + 32, 3 * v // 4 + 32


def chrx_dataset(v, seed):
    """A chrX-like store after ingest/synth.make_chrx_layout: the rows of
    :func:`scan_dataset` with every male haploid outside the PAR bands
    (:func:`chrx_bounds`; his second haplotype column zeroed), as ploidy
    profile 1 (profile 0: all diploid).  The reference pairs a PAR row's
    list with a non-PAR row's by zip truncation (calc_ld.py:30-33), so
    the haploid half of each straddling run carries, in its profile's
    columns, the leading alleles of the neighbouring diploid row: those
    pairs are in LD across the boundary.  Returns (gp, pos, pgroup,
    ploidy_profiles)."""
    gp, pos = scan_dataset(v, seed)
    male = np.array([row[3] == "male" for row in store_panel(seed)])
    lo, hi = chrx_bounds(v)
    profiles = np.full((2, N_HAP // 2), 2, dtype=np.uint8)
    profiles[1, male] = 1
    pgroup = np.zeros(v, dtype=np.int16)
    pgroup[lo:hi] = 1
    live = np.ones(N_HAP, dtype=bool)
    live[2 * np.flatnonzero(male) + 1] = False
    gp[lo:hi] &= np.packbits(live.astype(np.uint8))
    cols = np.flatnonzero(live)
    for rows, src in ((range(lo, lo + 32), lo - 1), (range(hi - 32, hi), hi)):
        full = np.zeros(N_HAP, dtype=np.uint8)
        full[cols] = np.unpackbits(gp[src], count=N_HAP)[:cols.size]
        gp[list(rows)] = np.packbits(full)
    return gp, pos, pgroup, profiles


def read_tsv(path, pos):
    """(i, j, r2 strings, D' strings) of a scan TSV, rows mapped back to
    variant indices through the (unique, ascending) positions."""
    with open(path) as fh:
        lines = [ln.rstrip("\n").split("\t") for ln in fh
                 if not ln.startswith("#")]
    if not lines:
        z = np.zeros(0, np.int64)
        return z, z, np.zeros(0, str), np.zeros(0, str)
    cols = list(zip(*lines))
    i = np.searchsorted(pos, np.asarray(cols[0], dtype=np.int64))
    j = np.searchsorted(pos, np.asarray(cols[2], dtype=np.int64))
    return i, j, np.asarray(cols[5]), np.asarray(cols[6])


def _packed_rows(G):
    """int8 (V, 5,008) rows -> the (V, 640) bytes the packed kernels take."""
    gp = np.zeros((G.shape[0], W_PACKED), dtype=np.uint8)
    gp[:, :N_HAP // 8] = np.packbits(G.astype(np.uint8), axis=1)
    return gp


# ---- phases ----------------------------------------------------------------


def phase_device():
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"device: {name} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} card(s))")
    log(f"nvidia-smi: {smi}")
    return name, smi


def phase_build():
    from ld_tools_tpu_torch.ops import _cuda_build

    info = _cuda_build.build(force=True, verbose=True)
    _cuda_build.lib()
    log(f"build: nvcc {info['seconds']:.1f}s -> {_cuda_build.LIB}")
    # ptxas names each kernel (mangled) before its resource lines: keep
    # the kernel's name and template arguments beside them
    kernel, ptxas = "?", {}
    for ln in info["log"].splitlines():
        if "Compiling entry function" in ln:
            kernel = _instance(ln) or "?"
        elif "registers" in ln or "spill" in ln:
            log(f"  ptxas {kernel}: {ln.strip()}")
            ptxas.setdefault(kernel, []).append(
                ln.split(":", 1)[-1].strip() if "registers" in ln
                else ln.strip())
    sass = check_wgmma_sass(_cuda_build.LIB)
    return dict(seconds=info["seconds"], ptxas=ptxas, sass=sass)


def _instance(line):
    """``ld_..._kernel<a,b,...>`` (the template's int arguments) of the
    mangled kernel name on ``line``, or None."""
    m = re.search(r"\d(ld_[a-z_]+?_kernel)I((?:Li\d+E)+)E", line)
    if not m:
        return None
    return f"{m.group(1)}<{','.join(re.findall(r'Li(\d+)E', m.group(2)))}>"


def _cuobjdump():
    """cuobjdump from the CUDA toolkit, else the one Triton ships."""
    cands = [os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "cuobjdump"),
             "/usr/local/cuda/bin/cuobjdump", shutil.which("cuobjdump") or ""]
    try:
        import triton

        cands.append(os.path.join(os.path.dirname(triton.__file__), "backends",
                                  "nvidia", "bin", "cuobjdump"))
    except ImportError:
        pass
    for cand in cands:
        if cand and os.path.isfile(cand):
            return cand
    raise SmokeFailure("cuobjdump not found in the CUDA toolkit ($CUDA_HOME/"
                       "bin, /usr/local/cuda/bin, PATH) nor under triton/"
                       "backends/nvidia/bin: cannot check the count kernel's "
                       "SASS")


# the wgmma instances (template arguments: form, and for ld_block_kernel
# the store and the tile width): K5, K6; K1 / K8, K2, K3, K4, K1b bf16 and
# K1b tf32 at both widths
WGMMA_INSTANCES = (
    "ld_band_count_kernel<0>", "ld_band_count_kernel<1>",
    "ld_block_kernel<0,0,320>", "ld_block_kernel<0,0,256>",
    "ld_block_kernel<1,0,320>", "ld_block_kernel<1,0,256>",
    "ld_block_kernel<0,1,320>", "ld_block_kernel<0,1,256>",
    "ld_block_kernel<1,1,320>", "ld_block_kernel<1,1,256>",
    "ld_block_kernel<2,0,320>", "ld_block_kernel<2,0,256>",
    "ld_block_kernel<3,0,320>", "ld_block_kernel<3,0,256>",
)
# the SASS of the tensor-core paths: warpgroup MMAs (IGMMA, HGMMA) and
# the warp-level integer and float MMAs
SASS_MMA = ("GMMA", "IMMA", "HMMA")


def check_wgmma_sass(lib):
    """Every instance of the count kernel (K5 <0>, K6 <1>) and of the
    block kernel (K1 / K8 <0,0,TN>, K2 <1,0,TN>, K3 <0,1,TN>, K4
    <1,1,TN>, K1b <2,0,TN> and <3,0,TN>) runs warpgroup MMAs: its SASS
    holds GMMA instructions and no IMMA or HMMA (warp-level MMAs, s8 or
    bf16 / tf32)."""
    sass = subprocess.run([_cuobjdump(), "-sass", lib], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    ops, fn = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            fn = _instance(ln)
            if fn:
                ops[fn] = dict.fromkeys(SASS_MMA, 0)
        elif fn:
            for op in ops[fn]:
                ops[fn][op] += len(re.findall(rf"\b\w*{op}\b", ln))
    for inst in WGMMA_INSTANCES:
        n = ops.get(inst)
        check(n is not None, f"no SASS for {inst} in {lib}")
        counts = ", ".join(f"{n[op]} {op}" for op in SASS_MMA)
        check(n["GMMA"] > 0 and n["IMMA"] == 0 and n["HMMA"] == 0,
              f"{inst} SASS: {counts} instructions")
        log(f"  sass {inst}: {counts}")
    return {inst: ops[inst] for inst in WGMMA_INSTANCES}


def _check_rows(gp_host, pos, n_rows):
    """A ragged (n_rows) slice of the chromosome with monomorphic (all 0,
    all 1) and near-monomorphic rows, as the scan's device tensors in both
    layouts: (G, int8 resident, packed resident)."""
    from ld_tools_tpu_torch.ops.ld_stream import prepare_resident

    G = np.unpackbits(gp_host[:n_rows], axis=1, count=N_HAP).astype(np.int8)
    G[5] = 0
    G[6] = 1
    G[7] = 0
    G[7, 11] = 1
    G[8] = 1
    G[8, 13] = 0
    G[n_rows - 1] = 0  # in the partial last block
    res = prepare_resident(G, N_HAP, pos[:n_rows], "cuda")
    resp = prepare_resident(np.packbits(G.astype(np.uint8), axis=1), N_HAP,
                            pos[:n_rows], "cuda", packed=True,
                            resident="packed")
    check(not res.packed and resp.packed, "resident layouts")
    check(resp.g.shape[1] == W_PACKED, f"packed width {resp.g.shape[1]}")
    return G, res, resp


def _triangle_routes():
    """name -> (launch site, plain version, packed rows?, tensor-core peak)."""
    from ld_tools_tpu_torch.ops import ld_kernels as lk

    return {
        K1: (lk.ld_triangle_blocks, lk.ld_triangle_blocks_plain, False,
             H100_INT8_OPS),
        K1B_BF16: (lk.ld_triangle_blocks_bf16,
                   lk.ld_triangle_blocks_bf16_plain, False, H100_BF16_FLOPS),
        K1B_TF32: (lk.ld_triangle_blocks_tf32,
                   lk.ld_triangle_blocks_tf32_plain, False, H100_TF32_FLOPS),
        K2: (lk.ld_triangle_blocks_packed,
             lk.ld_triangle_blocks_packed_plain, True, H100_INT8_OPS),
    }


def _check_triangle(name, g, gq, c1, ipq, cij, what, block=BLOCK):
    """A triangle route against its plain version on the ``block``-row
    blocks ``cij``, fast and exact epilogues, D' on and off, and against
    K1 (its int8 twin), each bit for bit; the largest abs error against
    the plain version.  ``g`` holds the int8 rows, ``gq`` the same rows
    packed."""
    import torch

    from ld_tools_tpu_torch.ops import ld_kernels as lk

    site, plain, packed, _ = _triangle_routes()[name]
    rows = gq if packed else g
    err = 0.0
    for epi, want_dp in (("fast", False), ("exact", True), ("exact", False)):
        kw = dict(epilogue=epi, want_dprime=want_dp, block_m=block,
                  block_n=block)
        got = site(rows, c1, ipq, cij, N_HAP, **kw)
        ref = plain(rows, c1, ipq, cij, N_HAP, **kw)
        twin = (got if site is lk.ld_triangle_blocks
                else lk.ld_triangle_blocks(g, c1, ipq, cij, N_HAP, **kw))
        torch.cuda.synchronize()
        for a, b, t in zip(got, ref, twin):
            if b is None:
                check(a is None, f"{name} returned D' it was not asked for")
                continue
            e = float((a - b).abs().max())
            err = max(err, e)
            tag = f"{name} {what} block {block} {epi}/dp={want_dp}"
            check(e <= 1e-6, f"{tag}: max abs err {e}")
            check(torch.equal(a, b),
                  f"{tag}: differs from the plain version in "
                  f"{int((a != b).sum())} cells")
            check(torch.equal(a, t), f"{tag}: differs from K1")
        del got, ref, twin
    return err


def triangle_host():
    """The headline sweep's rows (bench.py) on the host: V = 10,240 random
    int8 (V, 5,008) rows, allele frequencies uniform in [0.05, 0.95],
    with monomorphic and near-monomorphic ones."""
    rng = np.random.default_rng(0)
    v1 = N_TRIANGLE
    freqs = rng.uniform(0.05, 0.95, size=(v1, 1))
    G1 = (rng.random((v1, N_HAP)) < freqs).astype(np.int8)
    G1[1] = 0
    G1[2] = 1
    G1[3] = 0
    G1[3, 9] = 1
    return G1


def triangle_rows():
    """The rows of :func:`triangle_host` as int8 (V, 5,120) and packed
    (V, 640) tensors on the card."""
    import torch

    G1 = triangle_host()
    v1 = G1.shape[0]
    g1 = torch.zeros((v1, W_DENSE), dtype=torch.int8, device="cuda")
    g1[:, :N_HAP] = torch.from_numpy(G1).to("cuda")
    return g1, torch.from_numpy(_packed_rows(G1)).to("cuda")


def phase_triangles(results, g1, gq1):
    """K1, K1b and K2 at the headline sweep (bench.py) on the rows of
    :func:`triangle_rows`, fast epilogue; each route's own entry point is
    its path.  Then K1 and K2 at the other blocks of ``bench.kernels``."""
    import torch

    from ld_tools_tpu_torch.ops import ld_kernels as lk

    dev = torch.device("cuda")
    v1 = g1.shape[0]
    c1 = g1.to(torch.float32).sum(dim=1)
    ipq = lk._ipq_from_counts(c1, torch.tensor(float(N_HAP), device=dev))
    bi, bj = lk._triangle_coords(v1 // BLOCK)
    cij1 = torch.from_numpy(lk.pack_block_coords(bi, bj)).to(dev)
    n1 = len(bi)
    fast = dict(epilogue="fast", want_dprime=False, block_m=BLOCK,
                block_n=BLOCK)

    mm1 = cuda_ms(lambda: int_mm_rows(g1, v1 // BLOCK, BLOCK), reps=5)
    # K1b's own yardsticks: the same block products in its operand types
    mm_bf16, mm_tf32 = float_yardsticks(g1, v1 // BLOCK, BLOCK)
    yardsticks = {K1B_BF16: ("bf16", mm_bf16), K1B_TF32: ("tf32", mm_tf32)}
    out = (torch.empty((v1, v1), dtype=torch.float32, device=dev), None)
    G1_dev = g1[:, :N_HAP].contiguous()
    gp1_dev = gq1[:, :N_HAP // 8].contiguous()
    # each route's entry point: (its name, the call)
    paths = {
        K1: ("ld_triangle_matrix", lambda: (
            lk.ld_triangle_matrix(G1_dev, N_HAP, **fast))),
        K1B_BF16: (
            "ld_triangle_matrix(mxu_dtype=bfloat16)",
            lambda: lk.ld_triangle_matrix(G1_dev, N_HAP,
                                          mxu_dtype="bfloat16", **fast)),
        K1B_TF32: (
            "ld_triangle_matrix(mxu_dtype=float32)",
            lambda: lk.ld_triangle_matrix(G1_dev, N_HAP,
                                          mxu_dtype="float32", **fast)),
        K2: (
            "ld_triangle_matrix_packed(kernel=bitplane)",
            lambda: lk.ld_triangle_matrix_packed(gp1_dev, N_HAP,
                                                 kernel="bitplane", **fast)),
    }
    r2_k1 = None
    for name, (site, plain, packed, peak) in _triangle_routes().items():
        rows = gq1 if packed else g1
        err = _check_triangle(name, g1, gq1, c1, ipq, cij1, f"V={v1}")
        ms = cuda_ms(lambda: site(rows, c1, ipq, cij1, N_HAP, out=out,
                                  **fast), reps=20)
        plain_ms = cuda_ms(lambda: plain(rows, c1, ipq, cij1, N_HAP, **fast),
                           reps=2)
        b = bound(2 * n1 * BLOCK * BLOCK * N_HAP,
                  v1 * rows.shape[1] + 8 * v1 + 4 * n1
                  + 4 * n1 * BLOCK * BLOCK, peak)
        # the route's own path: launch counts read around it
        entry, call = paths[name]
        lk.reset_launches()
        r2, _ = call()
        torch.cuda.synchronize()
        launches = site.launches
        others = sum(s.launches for s in lk.LAUNCH_SITES if s is not site)
        check(torch.isfinite(r2).all(), f"{name} path: non-finite r^2")
        check(launches == 1 and others == 0,
              f"{name} path launched {launches} times ({others} others)")
        if r2_k1 is None:
            r2_k1 = r2
        else:
            check(torch.equal(r2, r2_k1), f"{name} path differs from K1's")
        del r2
        results[name] = dict(
            launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=b[0], bound_by=b[1], library_ms=None, int_mm_ms=mm1,
            path=f"triangle sweep, V={v1} ({entry})",
            shape=f"{n1} blocks of {BLOCK}x{BLOCK}, W={rows.shape[1]} "
                  f"{'bytes' if packed else 'int8'}, fast epilogue")
        note = ""
        if name in yardsticks:
            kind, mm = yardsticks[name]
            results[name]["extra"] = {f"matmul_{kind}_ms": mm}
            note = f", torch.matmul {kind} {mm:.3f} ms ({ms / mm:.2f}x it)"
        log(f"{KERNELS[name][0]} {name}: {ms:.3f} ms, plain {plain_ms:.3f} "
            f"ms, bound {b[0]:.3f} ms ({b[1]}), torch._int_mm {mm1:.3f} ms"
            f"{note}, max abs err {err:.3g}")
    # K1b's widening on the stage's critical path: the same blocks on rows
    # of -1, 0, 1 and 2 take its general path (2.75 operations a value in
    # bf16, 2.25 in tf32) in place of the 0/1 one (1 in bf16)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    g_any = torch.randint(-1, 3, g1.shape, generator=gen, device=dev,
                          dtype=torch.int32).to(torch.int8)
    for name in (K1B_BF16, K1B_TF32):
        site = _triangle_routes()[name][0]
        ms = cuda_ms(lambda: site(g_any, c1, ipq, cij1, N_HAP, out=out,
                                  **fast), reps=20)
        results[name]["extra"]["general_widen_ms"] = ms
        log(f"K1b {name} on rows of -1..2 (the general widening): {ms:.3f} "
            f"ms against {results[name]['ms']:.3f} on 0/1 rows")
    del out, r2_k1, g_any
    for name, block in OTHER_BLOCKS:
        bi, bj = lk._triangle_coords(-(-v1 // block))
        cij = torch.from_numpy(lk.pack_block_coords(bi, bj)).to(dev)
        e = _check_triangle(name, g1, gq1, c1, ipq, cij, f"V={v1}", block)
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], e)
    log(f"K1, K1b and K2 at blocks 512, 1024, {UNTIDY_BLOCKS}: equal the "
        f"plain versions and K1 (V={v1})")
    check_k1b_widths(g1[:N_RAGGED])
    torch.cuda.empty_cache()


def check_k1b_widths(g):
    """K1b (both forms) at haplotype widths its stage does not divide
    (K1B_WIDTHS: the last stage of 64 bf16 or 32 f32 haplotypes reads past
    W, where TMA fills zeros), on ragged rows at 640- and 200-row blocks,
    every epilogue; then on signed int8 rows (the widening's path for
    values other than 0 and 1; W = 512 keeps every sum below 2^24):
    equal to the plain version and to K1, bit for bit (compared as int32
    bits, so that the NaN the exact epilogue makes of such counts
    compares too)."""
    import torch

    from ld_tools_tpu_torch.ops import ld_kernels as lk

    dev = g.device
    v = g.shape[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    signed = torch.randint(-128, 128, (v, 512), generator=gen, device=dev,
                           dtype=torch.int32).to(torch.int8)
    cases = [(g[:, :w].contiguous(), f"W={w}") for w in K1B_WIDTHS]
    cases.append((signed, "signed int8, W=512"))
    for gw, what in cases:
        w = gw.shape[1]
        cw = gw.to(torch.float32).sum(dim=1)
        ipq = lk._ipq_from_counts(cw, torch.tensor(float(w), device=dev))
        for block in (BLOCK, 200):
            bi, bj = lk._triangle_coords(-(-v // block))
            cij = torch.from_numpy(lk.pack_block_coords(bi, bj)).to(dev)
            for epi, want_dp in (("fast", False), ("exact", True)):
                kw = dict(epilogue=epi, want_dprime=want_dp, block_m=block,
                          block_n=block)
                twin = lk.ld_triangle_blocks(gw, cw, ipq, cij, w, **kw)
                for name in (K1B_BF16, K1B_TF32):
                    site, plain, _, _ = _triangle_routes()[name]
                    got = site(gw, cw, ipq, cij, w, **kw)
                    ref = plain(gw, cw, ipq, cij, w, **kw)
                    tag = f"{name} {what} block {block} {epi}/dp={want_dp}"
                    for a, b, t in zip(got, ref, twin):
                        if b is None:
                            continue
                        a, b, t = (x.view(torch.int32) for x in (a, b, t))
                        check(torch.equal(a, b), f"{tag}: differs from the "
                              f"plain version in {int((a != b).sum())} cells")
                        check(torch.equal(a, t), f"{tag}: differs from K1")
    log(f"K1b at widths {K1B_WIDTHS} and on signed int8 rows: equals the "
        f"plain versions and K1 ({v} ragged rows, blocks {BLOCK} and 200)")


def _check_stage(stage, g, c1, ipq, cij, what):
    """K8 at one stage against its plain version on the blocks ``cij``, bit
    for bit; the largest abs error (0)."""
    import torch

    from ld_tools_tpu_torch.ops import ld_kernels as lk

    kw = dict(block=STAGE_BLOCK, stage=stage)
    got = lk.ld_stage_blocks(g, c1, ipq, cij, N_HAP, **kw)
    ref = lk.ld_stage_blocks_plain(g, c1, ipq, cij, N_HAP, **kw)
    torch.cuda.synchronize()
    e = float((got - ref).abs().max())
    check(torch.equal(got, ref), f"K8 {stage} {what}: differs in "
          f"{int((got != ref).sum())} cells (max abs err {e})")
    return e


def phase_stage(results, g):
    """K8 at the microkernel bench's shape: the rows of
    :func:`triangle_rows` (V = 10,240 x W = 5,120), 512-row blocks, alt
    counts jittered as the bench jitters them; every stage against its
    plain version, then timed against its bound and torch._int_mm over the
    same block rows."""
    import torch

    from ld_tools_tpu_torch.ops import ld_kernels as lk

    dev = torch.device("cuda")
    v = g.shape[0]
    c1 = g.to(torch.float32).sum(dim=1) * (1.0 + 3e-7)
    ipq = lk._ipq_from_counts(c1, torch.tensor(float(N_HAP), device=dev))
    bi, bj = lk._triangle_coords(v // STAGE_BLOCK)
    cij = torch.from_numpy(lk.pack_block_coords(bi, bj)).to(dev)
    nb = len(bi)
    cells = nb * STAGE_BLOCK * STAGE_BLOCK
    mm = cuda_ms(lambda: int_mm_rows(g, v // STAGE_BLOCK, STAGE_BLOCK),
                 reps=5)
    b = bound(2 * cells * N_HAP, v * W_DENSE + 8 * v + 4 * nb + 4 * cells)
    out = torch.empty((v, v), dtype=torch.float32, device=dev)
    for stage in STAGES:
        kw = dict(block=STAGE_BLOCK, stage=stage)
        err = _check_stage(stage, g, c1, ipq, cij, f"V={v}")
        ms = cuda_ms(lambda: lk.ld_stage_blocks(g, c1, ipq, cij, N_HAP,
                                                out=out, **kw), reps=20)
        plain_ms = cuda_ms(lambda: lk.ld_stage_blocks_plain(
            g, c1, ipq, cij, N_HAP, **kw), reps=2)
        name = _stage_kernel(stage)
        results[name] = dict(
            launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=b[0], bound_by=b[1], library_ms=None, int_mm_ms=mm,
            path="python -m ld_tools_tpu_torch.bench.microkernels",
            shape=f"{nb} blocks of {STAGE_BLOCK}x{STAGE_BLOCK}, "
                  f"W={W_DENSE} int8, V={v}")
        log(f"K8 {name}: {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
            f"{b[0]:.3f} ms ({b[1]}), torch._int_mm {mm:.3f} ms, max abs "
            f"err {err:.3g}")
    t = {stage: results[_stage_kernel(stage)]["ms"] for stage in STAGES}
    log(f"K8 split: count and store {t['counts']:.3f} ms, the multiply "
        f"{t['scale'] - t['counts']:+.3f}, the fast r^2 "
        f"{t['fast'] - t['counts']:+.3f}, the exact r^2 over the fast "
        f"{t['exact'] - t['fast']:+.3f} ms")
    del out
    torch.cuda.empty_cache()


def phase_ragged(gp_host, pos, results):
    """Every kernel on a ragged slice with monomorphic rows, every mode,
    against its plain version and its int8 twin; pass-1 counts against
    pass-2 hits in both mask modes and both layouts."""
    import torch

    from ld_tools_tpu_torch.ops import ld_kernels as lk
    from ld_tools_tpu_torch.ops import ld_stream as ls

    dev = torch.device("cuda")
    n_rows = N_RAGGED
    Gc, rc, rq = _check_rows(gp_host, pos, n_rows)
    g, gq = rc.g[:n_rows], rq.g[:n_rows]
    c1r, ipqr, posr = rc.c1[:n_rows], rc.ipq[:n_rows], rc.pos[:n_rows]
    nbc = -(-n_rows // BLOCK)
    bi, bj = np.tril_indices(nbc)
    cij = torch.from_numpy(lk.pack_block_coords(bi, bj)).to(dev)
    thres = 0.8 - 5e-4
    for exact_mask in (True, False):
        for sel in (0, 1):
            for use_dist in (False, True):
                kw = dict(sel=sel, exact_mask=exact_mask, use_dist=use_dist,
                          block_m=BLOCK, block_n=BLOCK)
                what = (f"exact_mask={exact_mask} sel={sel} "
                        f"dist={use_dist}")
                args = (c1r, ipqr, posr, cij, (N_HAP, 1_000_000), (thres,))
                got5 = lk.ld_band_count(g, *args, packed=False, **kw)
                got6 = lk.ld_band_count(gq, *args, packed=True, **kw)
                pargs = (c1r, ipqr, posr, cij, N_HAP, 1_000_000, thres)
                ref5 = lk.ld_band_count_plain(g, *pargs, **kw)
                ref6 = lk.ld_band_count_packed_plain(gq, *pargs, **kw)
                check(torch.equal(got5, ref5), f"K5 {what}: counts differ "
                      f"in {int((got5 != ref5).sum())} blocks")
                check(torch.equal(got6, ref6), f"K6 {what}: counts differ "
                      f"in {int((got6 != ref6).sum())} blocks")
                check(torch.equal(got6, got5), f"K6 {what}: differs from K5")
                check(int(got5.sum()) > 0, f"K5 {what} kept nothing")
    log("K5, K6: every mode equals the plain versions; K6 = K5 bit for bit "
        f"({n_rows} ragged rows)")
    # a count block the 128 x 320 tile does not divide: the cells past
    # each logical block are never counted
    nbu = -(-n_rows // UNTIDY_BLOCK)
    biu, bju = np.tril_indices(nbu)
    ciju = torch.from_numpy(lk.pack_block_coords(biu, bju)).to(dev)
    for exact_mask in (True, False):
        for sel in (0, 1):
            kw = dict(sel=sel, exact_mask=exact_mask, use_dist=True,
                      block_m=UNTIDY_BLOCK, block_n=UNTIDY_BLOCK)
            what = f"block {UNTIDY_BLOCK} exact_mask={exact_mask} sel={sel}"
            args = (c1r, ipqr, posr, ciju, (N_HAP, 1_000_000), (thres,))
            got5 = lk.ld_band_count(g, *args, packed=False, **kw)
            got6 = lk.ld_band_count(gq, *args, packed=True, **kw)
            ref = lk.ld_band_count_plain(g, c1r, ipqr, posr, ciju, N_HAP,
                                         1_000_000, thres, **kw)
            check(torch.equal(got5, ref), f"K5 {what}: counts differ in "
                  f"{int((got5 != ref).sum())} blocks")
            check(torch.equal(got6, ref), f"K6 {what}: counts differ in "
                  f"{int((got6 != ref).sum())} blocks")
            check(int(ref.sum()) > 0, f"K5 {what} kept nothing")
    log(f"K5, K6 at count block {UNTIDY_BLOCK} (the tile does not divide "
        f"it): both mask modes and measures equal the plain version "
        f"({n_rows} ragged rows)")
    # the triangle routes on the same rows: the last block row is partial
    for name in _triangle_routes():
        e = _check_triangle(name, g, gq, c1r, ipqr, cij, f"V={n_rows}")
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], e)
    for name, block in OTHER_BLOCKS:
        bib, bjb = np.tril_indices(-(-n_rows // block))
        cijb = torch.from_numpy(lk.pack_block_coords(bib, bjb)).to(dev)
        e = _check_triangle(name, g, gq, c1r, ipqr, cijb, f"V={n_rows}",
                            block)
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], e)
    # K8 at the microkernel bench's 512-row blocks: the last is partial
    bi8, bj8 = np.tril_indices(-(-n_rows // STAGE_BLOCK))
    cij8 = torch.from_numpy(lk.pack_block_coords(bi8, bj8)).to(dev)
    for stage in STAGES:
        r = results[_stage_kernel(stage)]
        e = _check_stage(stage, g, c1r, ipqr, cij8, f"V={n_rows}")
        r["max_abs_err"] = max(r["max_abs_err"], e)
    log(f"K8: every stage equals the plain version ({n_rows} ragged rows, "
        f"{STAGE_BLOCK}-row blocks)")
    err = {K3: 0.0, K4: 0.0}
    # rows and columns from one matrix, then (the dense sweep's two maps)
    # rows from a shorter one: the blocks past its edge read zeros
    n_short = n_rows - 1357
    for block, blocks in ((BLOCK, cij), (UNTIDY_BLOCK, ciju)):
        # the last blocks hold the ragged edge: the sweeps write their
        # cells past it
        hit = torch.cat([blocks[:20], blocks[-20:]])
        for outs, sel, n_a in ((("cab",), 0, n_rows),
                               (("cab", "r2", "dp", "meas"), 0, n_rows),
                               (("meas",), 1, n_rows),
                               (("cab", "r2", "dp", "meas"), 1, n_short)):
            kw = dict(outs=outs, sel=sel, block_m=block, block_n=block)
            vecs = (c1r[:n_a], c1r, ipqr[:n_a], ipqr, hit, N_HAP)
            ga, gqa = g[:n_a], gq[:n_a]
            got3 = lk.ld_band_sweep_blocks(ga, g, *vecs, **kw)
            got4 = lk.ld_band_sweep_blocks_packed(gqa, gq, *vecs, **kw)
            ref3 = lk.ld_band_sweep_blocks_plain(ga, g, *vecs, **kw)
            ref4 = lk.ld_band_sweep_blocks_packed_plain(gqa, gq, *vecs, **kw)
            for name, got, ref in ((K3, got3, ref3), (K4, got4, ref4)):
                for o in outs:
                    what = (f"{name} block {block} {o} sel={sel} "
                            f"rows {n_a}")
                    e = float((got[o] - ref[o]).abs().max())
                    err[name] = max(err[name], e)
                    check(torch.equal(got[o], ref[o]),
                          f"{what}: differs from the plain version in "
                          f"{int((got[o] != ref[o]).sum())} cells (max abs "
                          f"err {e})")
            for o in outs:
                check(torch.equal(got4[o], got3[o]),
                      f"K4 {o} block {block} rows {n_a} differs from K3")
    for name, e in err.items():
        results[name] = dict(max_abs_err=e)
    log(f"K3, K4 at blocks {BLOCK} and {UNTIDY_BLOCK}, rows of {n_rows} and "
        f"{n_short}: every output equals the plain versions and K4 = K3, "
        "bit for bit")
    # pass-1 counts against pass-2 hits, both mask modes, both layouts
    gpc = np.packbits(Gc.astype(np.uint8), axis=1)
    for max_hap in (ls._EXACT_MASK_MAX_HAP, 0):
        saved = ls._EXACT_MASK_MAX_HAP
        ls._EXACT_MASK_MAX_HAP = max_hap
        try:
            for measure in ("r_square", "d_prime"):
                kw = dict(pos=pos[:n_rows], measure=measure, thres=0.8,
                          max_dist=1_000_000, device="cuda")
                hits = {
                    "dense": ls.stream_threshold_scan(Gc, **kw),
                    "packed": ls.stream_threshold_scan(
                        G_packed=gpc, n_haplotypes=N_HAP, resident="packed",
                        **kw),
                }
                for layout, h in hits.items():
                    st = h.stats
                    check(st["resident_packed"] == float(layout == "packed"),
                          f"{layout} scan ran the other layout")
                    check(st["blocks_checked"] == st["hit_blocks"] > 0,
                          f"{layout}: pass 2 checked {st['blocks_checked']} "
                          f"of {st['hit_blocks']} hit blocks")
                a, b = hits["dense"], hits["packed"]
                check(np.array_equal(a.i, b.i) and np.array_equal(a.j, b.j)
                      and np.array_equal(a.r_square, b.r_square)
                      and np.array_equal(a.d_prime, b.d_prime),
                      f"{measure}: the layouts' hits differ")
        finally:
            ls._EXACT_MASK_MAX_HAP = saved
    log(f"pass-1 counts == pass-2 hits per block: integer and f32 masks, "
        f"r^2 and D', int8 and packed layouts ({n_rows} ragged rows)")
    del rc, rq, g, gq
    torch.cuda.empty_cache()


def phase_scan_shapes(gp_host, pos, results):
    """K5/K6 over the chromosome's count pass and K3/K4 over its batch of
    hit blocks, both layouts of the same store: times and bounds."""
    import torch

    from ld_tools_tpu_torch.ops import ld_kernels as lk
    from ld_tools_tpu_torch.ops import ld_stream as ls

    dev = torch.device("cuda")
    rd = ls.prepare_resident(gp_host, N_HAP, pos, "cuda", packed=True)
    rp = ls.prepare_resident(gp_host, N_HAP, pos, "cuda", packed=True,
                             resident="packed")
    check(not rd.packed and rp.packed, "auto must inflate at chr21 scale")
    v = gp_host.shape[0]
    bi, bj = ls._scan_blocks(v, pos, BLOCK, None)
    cij = torch.from_numpy(lk.pack_block_coords(bi, bj)).to(dev)
    thres = 0.8 - 5e-4
    kw5 = dict(sel=0, exact_mask=True, use_dist=False, block_m=BLOCK,
               block_n=BLOCK)
    nb5 = len(bi)

    mm5 = cuda_ms(lambda: int_mm_rows(rd.g, -(-v // BLOCK), BLOCK), reps=1)
    counts = {}
    for name, res in (("ld_band_count_kernel", rd),
                      ("ld_band_count_kernel<FORM_BITS>", rp)):
        args = (res.g, res.c1, res.ipq, res.pos, cij)

        def count():
            return lk.ld_band_count(*args, (N_HAP, 0), (thres,),
                                    packed=res.packed, **kw5)

        plain = (lk.ld_band_count_packed_plain if res.packed
                 else lk.ld_band_count_plain)
        counts[name] = count()
        ref = plain(*args, N_HAP, 0, thres, **kw5)
        check(torch.equal(counts[name], ref),
              f"{name} main-path counts differ from plain")
        del ref
        ms = cuda_ms(count, reps=3)
        plain_ms = cuda_ms(lambda: plain(*args, N_HAP, 0, thres, **kw5),
                           reps=1, warmup=0)
        b = _count_bound(bi, bj, v, res.g.shape[1])
        results[name] = dict(
            max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b[0],
            bound_by=b[1], library_ms=None, int_mm_ms=mm5,
            path="ld_scan (pass 1)",
            shape=f"{nb5} blocks of {BLOCK}x{BLOCK}, W={res.g.shape[1]} "
                  f"{'bytes' if res.packed else 'int8'}, integer mask")
        log(f"{KERNELS[name][0]} {name}: {ms:.3f} ms, plain {plain_ms:.3f} "
            f"ms, bound {b[0]:.3f} ms ({b[1]}), roofline share "
            f"{b[0] / ms:.3f}, torch._int_mm {mm5:.3f} ms ({nb5} blocks; "
            f"{ms / mm5:.2f}x it)")
    check(torch.equal(counts["ld_band_count_kernel"],
                      counts["ld_band_count_kernel<FORM_BITS>"]),
          "K6 main-path counts differ from K5's")

    hit_idx = torch.nonzero(counts["ld_band_count_kernel"] > 0).reshape(-1)
    per_batch = ls._FETCH_CELLS_PER_BATCH // (BLOCK * BLOCK)
    hit_cij = cij[hit_idx[:per_batch]].contiguous()
    nb3 = hit_cij.shape[0]
    check(nb3 > 0, "the main path has no hit blocks")
    hb = hit_cij.to(torch.int64).cpu().numpy()

    def int_mm_blocks():
        for code in hb:
            r, c = (code >> 16) * BLOCK, (code & 0xFFFF) * BLOCK
            torch._int_mm(rd.g[r:r + BLOCK], rd.g[c:c + BLOCK].t())

    mm3 = cuda_ms(int_mm_blocks, reps=3)
    rows3 = len(set((hb >> 16).tolist()) | set((hb & 0xFFFF).tolist()))
    kw3 = dict(outs=("cab",), sel=0, block_m=BLOCK, block_n=BLOCK)
    cab = {}
    for name, res, site, plain in (
            (K3, rd, lk.ld_band_sweep_blocks,
             lk.ld_band_sweep_blocks_plain),
            (K4, rp,
             lk.ld_band_sweep_blocks_packed,
             lk.ld_band_sweep_blocks_packed_plain)):
        args3 = (res.g, res.g, res.c1, res.c1, res.ipq, res.ipq, hit_cij,
                 N_HAP)
        cab[name] = site(*args3, **kw3)["cab"]
        ref = plain(*args3, **kw3)
        check(torch.equal(cab[name], ref["cab"]),
              f"{name} main-path cab differs")
        del ref
        ms = cuda_ms(lambda: site(*args3, **kw3), reps=5)
        plain_ms = cuda_ms(lambda: plain(*args3, **kw3), reps=1)
        b = bound(2 * nb3 * BLOCK * BLOCK * N_HAP,
                  rows3 * BLOCK * (res.g.shape[1] + 8) + 4 * nb3
                  + 4 * nb3 * BLOCK * BLOCK)
        results[name].update(
            ms=ms, plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1],
            library_ms=None, int_mm_ms=mm3, path="ld_scan (pass 2)",
            shape=f"{nb3} hit blocks of {BLOCK}x{BLOCK}, "
                  f"W={res.g.shape[1]} {'bytes' if res.packed else 'int8'}, "
                  "outs=cab")
        log(f"{KERNELS[name][0]} {name}: {ms:.3f} ms, plain {plain_ms:.3f} "
            f"ms, bound {b[0]:.3f} ms ({b[1]}), torch._int_mm {mm3:.3f} ms "
            f"({nb3} blocks), max abs err {results[name]['max_abs_err']:.3g}")
    check(torch.equal(cab[K3], cab[K4]), "K4 main-path cab differs from K3's")
    del rd, rp, cab, counts
    torch.cuda.empty_cache()


def phase_gather(gp_host):
    """The resident's gather (``gather_rows_device``) against its plain
    version on the card, byte for byte and count for count: the full panel
    (every column, a padded copy) and a cohort of 970 haplotypes, each
    into the int8 and the packed resident, over the scan's own staging
    chunks: a full one of 65,536 rows (the grid full, each warp walking
    some 4 rows through its shared-memory slice) and a partial last one of
    4,321, rows of 626 bytes (every row start off 16 bytes) with all-0 and
    all-1 rows; then through ``prepare_resident`` over the same 69,857
    rows (two chunks) against the CPU's resident, field by field.  Then
    each timed at the full chromosome's 1,105,920 rows in one launch
    beside its byte bound and its plain version; returns those records."""
    import torch

    from ld_tools_tpu_torch.ops import ld_kernels as lk
    from ld_tools_tpu_torch.ops import ld_stream as ls

    dev = torch.device("cuda")
    rng = np.random.default_rng(19)
    samples = np.sort(rng.choice(N_HAP // 2, N_COHORT_SAMPLES, replace=False))
    cohort = np.stack([2 * samples, 2 * samples + 1], axis=1).ravel()
    stage = ls._STAGE_ROWS
    v = stage + 4321
    raw = np.ascontiguousarray(
        np.tile(gp_host, (-(-v // gp_host.shape[0]), 1))[:v])
    raw[3] = 0
    raw[stage + 4] = np.packbits(np.ones(N_HAP, dtype=np.uint8))
    src = torch.from_numpy(raw).to(dev)
    chunks = ((0, stage), (stage, v))
    lists = {"full panel": None, "cohort": cohort}
    for name, cols in lists.items():
        cols_dev = (None if cols is None
                    else torch.from_numpy(cols.astype(np.int32)).to(dev))
        n_cols = N_HAP if cols is None else cols.size
        w = 128 * -(-n_cols // 1024)
        for dense in (True, False):
            layout = "int8" if dense else "packed"
            dtype = torch.int8 if dense else torch.uint8
            for r0, r1 in chunks:
                rows = src[r0:r1]
                shape = (r1 - r0, 8 * w if dense else w)
                got = (torch.full(shape, 0x5A, dtype=dtype, device=dev),
                       torch.full(shape[:1], -1, dtype=torch.int32,
                                  device=dev))
                want = (torch.empty(shape, dtype=dtype, device=dev),
                        torch.empty(shape[:1], dtype=torch.int32, device=dev))
                lk.gather_rows_device(rows, cols_dev, *got)
                lk.gather_rows_device_plain(rows, cols_dev, *want)
                torch.cuda.synchronize()
                check(torch.equal(got[0], want[0])
                      and torch.equal(got[1], want[1]),
                      f"{GATHER} ({name}, {layout}, rows {r0}:{r1}) differs "
                      "from its plain version")
                if r0 == stage:
                    check(int(got[1][4]) == n_cols, f"{GATHER} ({name}): "
                          f"the all-1 row counts {int(got[1][4])}")
                del got, want
        saved = os.environ.get(LIMIT)
        try:
            for limit in (None, "0"):
                if limit is not None:
                    os.environ[LIMIT] = limit
                lk.reset_launches()
                res = ls.prepare_resident(raw, n_cols, np.arange(v), "cuda",
                                          packed=True, cols=cols)
                torch.cuda.synchronize()
                ref = ls.prepare_resident(raw, n_cols, np.arange(v), "cpu",
                                          packed=True, cols=cols)
                check(lk.gather_rows_device.launches == len(chunks),
                      f"prepare_resident ({name}) launched the gather "
                      f"{lk.gather_rows_device.launches} times, not "
                      f"{len(chunks)}")
                check(res.packed == ref.packed == (limit == "0")
                      and all(torch.equal(getattr(res, f).cpu(),
                                          getattr(ref, f))
                              for f in ("g", "c1", "ipq", "pos"))
                      and np.array_equal(res.c1_full, ref.c1_full),
                      f"prepare_resident ({name}, limit {limit}) on the "
                      "card differs from the CPU's")
                del res, ref
        finally:
            if saved is None:
                os.environ.pop(LIMIT, None)
            else:
                os.environ[LIMIT] = saved
    del src
    torch.cuda.empty_cache()
    log(f"{GATHER}: equal to its plain version (full panel and a "
        f"{cohort.size}-haplotype cohort, int8 and packed, a {stage}-row "
        f"chunk and a {v - stage}-row one; prepare_resident over {v} rows "
        "against the CPU's)")

    # the full chromosome in one launch: chr21 as the full panel packed
    # (the layout past the int8 limit), and in the cohort int8
    reps = -(-N_VARIANTS_FULL // gp_host.shape[0])
    full = torch.from_numpy(gp_host).to(dev).repeat(reps, 1)[:N_VARIANTS_FULL]
    v, b = full.shape
    out = {}
    for name, cols, dense in (("full panel, packed", None, False),
                              ("cohort, int8", cohort, True)):
        cols_dev = (None if cols is None
                    else torch.from_numpy(cols.astype(np.int32)).to(dev))
        n_cols = N_HAP if cols is None else cols.size
        w = 128 * -(-n_cols // 1024)
        width = 8 * w if dense else w
        dst = torch.empty((v, width), dtype=torch.int8 if dense
                          else torch.uint8, device=dev)
        cnt = torch.empty((v,), dtype=torch.int32, device=dev)
        ms = cuda_ms(lambda: lk.gather_rows_device(full, cols_dev, dst, cnt),
                     reps=20)
        plain_ms = cuda_ms(lambda: lk.gather_rows_device_plain(
            full[:65_536], cols_dev, dst[:65_536], cnt[:65_536]), reps=3
        ) * v / 65_536
        nbytes = v * b + v * width + 4 * v
        b_ms, by = bound(0, nbytes)
        out[name] = dict(kernel=GATHER, source=GATHER_SOURCE, rows=v,
                         src_bytes=b, out_width=width, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                         bytes=nbytes, roofline_share=b_ms / ms)
        log(f"{GATHER} ({name}, {v} rows of {b} bytes to {width}): "
            f"{ms:.3f} ms, bound {b_ms:.3f} ms ({by}, {nbytes / 1e9:.3f} GB),"
            f" share {b_ms / ms:.2f}; plain {plain_ms:.1f} ms (from 65,536 "
            "rows)")
        del dst, cnt
    del full
    torch.cuda.empty_cache()
    return out


def _recorded(module, name):
    """Replace the launch site ``module.name`` by a wrapper that records
    each call's arguments and CUDA events around it (on the current
    stream); returns (the site, the list of (args, kwargs, start, end)).
    The caller restores the site."""
    import torch

    site = getattr(module, name)
    calls = []

    def recording(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = site(*args, **kwargs)
        end.record()
        calls.append((args, kwargs, start, end))
        return out

    setattr(module, name, recording)
    return site, calls


def _int8_rows(gp, rows=65_536):
    """The int8 rows of a packed resident matrix, unpacked in row chunks
    (the yardstick's operand; the port never unpacks a packed resident)."""
    import torch

    from ld_tools_tpu_torch.ops import ld_kernels as lk

    g = torch.empty((gp.shape[0], gp.shape[1] * 8), dtype=torch.int8,
                    device=gp.device)
    for lo in range(0, gp.shape[0], rows):
        g[lo:lo + rows] = lk.unpack_rows_device(gp[lo:lo + rows])
    return g


def time_scan_sweeps(site, calls, results):
    """K4 over the launches the 1.1 M scan made (``calls``, recorded by
    :func:`_recorded`): their device time inside the scan, then the same
    launches replayed, their plain versions and torch._int_mm over the same
    block products, against the bound of their blocks."""
    import torch

    from ld_tools_tpu_torch.ops import ld_kernels as lk

    torch.cuda.synchronize()
    in_scan = sum(a.elapsed_time(b) for _, _, a, b in calls)
    launches = [(args, kw) for args, kw, _, _ in calls]
    g = launches[0][0][0]
    check(all(args[0] is g and args[1] is g for args, _ in launches),
          "the scan's sweeps read more than one resident matrix")
    cij = torch.cat([args[6] for args, _ in launches])
    nb = cij.shape[0]
    ms = cuda_ms(lambda: [site(*a, **k) for a, k in launches], reps=3)
    plain_ms = cuda_ms(lambda: [lk.ld_band_sweep_blocks_packed_plain(*a, **k)
                                for a, k in launches], reps=1, warmup=0)
    for args, kw in launches[:2]:
        got, ref = site(*args, **kw), lk.ld_band_sweep_blocks_packed_plain(
            *args, **kw)
        for o in got:
            check(torch.equal(got[o], ref[o]),
                  f"K4 on the 1.1 M scan's blocks: {o} differs from plain")
    g8 = _int8_rows(g)
    hb = cij.to(torch.int64).cpu().numpy()

    def int_mm_blocks():
        for code in hb:
            r, c = (code >> 16) * BLOCK, (code & 0xFFFF) * BLOCK
            torch._int_mm(g8[r:r + BLOCK], g8[c:c + BLOCK].t())

    mm = cuda_ms(int_mm_blocks, reps=1)
    del g8
    torch.cuda.empty_cache()
    rows = len(set((hb >> 16).tolist()) | set((hb & 0xFFFF).tolist()))
    b = bound(2 * nb * BLOCK * BLOCK * N_HAP,
              rows * BLOCK * (g.shape[1] + 8) + 4 * nb
              + 4 * nb * BLOCK * BLOCK)
    results[K4].setdefault("extra", {}).update(
        scan_1p1m_launches=len(launches), scan_1p1m_blocks=nb,
        scan_1p1m_ms_in_scan=in_scan, scan_1p1m_ms=ms,
        scan_1p1m_plain_ms=plain_ms, scan_1p1m_int_mm_ms=mm,
        scan_1p1m_bound_ms=b[0], scan_1p1m_bound_by=b[1])
    log(f"K4 {K4} over the 1.1 M scan's {len(launches)} launches ({nb} hit "
        f"blocks): {in_scan:.3f} ms inside the scan, {ms:.3f} ms replayed, "
        f"plain {plain_ms:.3f} ms, bound {b[0]:.3f} ms ({b[1]}), roofline "
        f"share {b[0] / ms:.3f}, torch._int_mm {mm:.3f} ms ({nb} calls)")


def _run_scan(data_dir, out_dir, extra=(), chrom="21"):
    from ld_tools_tpu_torch import ld_scan
    from ld_tools_tpu_torch.ops import engine
    from ld_tools_tpu_torch.ops import ld_kernels as lk

    argv = ["-C", chrom, "-D", data_dir, "-t", out_dir, "-z", "0.8",
            "-E", "cuda", *extra]
    lk.reset_launches()
    engine.reset_launches()
    t0 = time.perf_counter()
    (report,) = ld_scan.main(argv)
    secs = time.perf_counter() - t0
    return report, secs, _launches()


def _log_scan(tag, report, secs, launches):
    st = report.stats
    phases = ("host_prep_s", "upload_s", "count_s", "fetch_s", "finish_s",
              "write_s")
    # the rest: data prep checks, the store's load, the cohort columns
    st["rest_s"] = secs - sum(st[k] for k in phases)
    ran = {KERNELS.get(k, (k,))[0]: n for k, n in launches.items() if n}
    log(f"scan ({tag}): {report.n_hits} hits in {secs:.2f}s; phases "
        + " ".join(f"{k}={st[k]:.3f}" for k in phases + ("rest_s",))
        + f"; blocks {st['blocks']}, hit blocks {st['hit_blocks']}, "
        f"resident {'packed' if st['resident_packed'] else 'int8'} "
        f"{st['resident_bytes'] / 1e6:.1f} MB, resident hit "
        f"{st['resident_hit']:.0f}; tsv_native {st['tsv_native']}, "
        f"write {st['write_s']:.3f}s (format {st['format_s']:.3f}s, emit "
        f"{st['emit_s']:.3f}s); launches {ran}")
    check(st["blocks_checked"] == st["hit_blocks"],
          "pass 2 did not check every hit block against pass 1")
    check(st["tsv_native"] == 1, f"scan ({tag}): the TSV took the plain "
          f"path ({st.get('tsv_plain_reason')}), not the native writer")


# the count and sweep kernels of each resident layout (packed or not)
LAYOUT_KERNELS = {False: ("ld_band_count_kernel", K3),
                  True: ("ld_band_count_kernel<FORM_BITS>", K4)}


def _check_layout_launches(tag, launches, packed):
    """The run launched the count and sweep kernels of its layout only."""
    for mine, other in zip(LAYOUT_KERNELS[packed], LAYOUT_KERNELS[not packed]):
        check(launches[mine] > 0, f"scan ({tag}) never launched {mine}")
        check(launches[other] == 0,
              f"scan ({tag}) launched {other} {launches[other]} times")


def _recount(gp, i, j, c1=None):
    """f64 exact r^2 / D' strings and rounded r^2 for pairs (i, j), from
    popcounts of the packed genotypes (the port's exact finisher); ``c1``,
    where given, is ``pack.popcounts(gp)`` computed once."""
    from ld_tools_tpu_torch.ingest import pack
    from ld_tools_tpu_torch.ops.exact import (exact_ld_elementwise,
                                              format_rounded, round4)

    if c1 is None:
        c1 = pack.popcounts(gp)
    cab = pack.popcounts(np.bitwise_and(gp[i], gp[j]))
    ex = exact_ld_elementwise(cab, c1[i], c1[j], N_HAP)
    r2_round = round4(ex.r_square)
    r2_round[ex.r_square_is_int_zero] = 0.0
    return (format_rounded(ex.r_square, ex.r_square_is_int_zero),
            format_rounded(ex.d_prime, ex.d_prime_is_int_zero), r2_round)


def _check_hits(tag, path, gp, pos, run, max_dist, seed):
    """A scan TSV against an f64 recount: plausible count, i > j, no
    duplicates, sampled hits' strings, and sampled pairs (inside a run,
    nearby, anywhere) are hits exactly when their rounded f64 r^2 >= 0.8
    (and they lie in the window).  Returns the TSV's columns."""
    v = gp.shape[0]
    i, j, r2s, dps = read_tsv(path, pos)
    # every pair inside a run of identical base rows is a candidate;
    # nothing else can reach r^2 = 0.8
    within = (v // run) * run * (run - 1) // 2
    check(0.2 * within <= len(i) <= within,
          f"{tag}: {len(i)} hits is implausible for {within} correlated pairs")
    check(bool(np.all(i > j)), f"{tag}: hits must have i > j")
    key = np.sort(i * v + j)
    check(bool(np.all(np.diff(key) > 0)), f"{tag}: duplicate hits")
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(i), size=min(3000, len(i)), replace=False)
    want_r2, want_dp, _ = _recount(gp, i[pick], j[pick])
    check(np.array_equal(want_r2, r2s[pick]), f"{tag}: sampled hit r^2")
    check(np.array_equal(want_dp, dps[pick]), f"{tag}: sampled hit D'")
    a = rng.integers(1, v, size=9000)
    b = np.concatenate([
        a[:3000] - rng.integers(1, run, size=3000),
        a[3000:6000] - rng.integers(1, 256, size=3000),
        rng.integers(0, v, size=3000),
    ])
    ok = (b >= 0) & (b < a)
    a, b = a[ok], b[ok]
    _, _, r2_round = _recount(gp, a, b)
    want = r2_round >= 0.8
    if max_dist is not None:
        want &= np.abs(pos[a] - pos[b]) <= max_dist
    is_hit = np.isin(a * v + b, key)
    check(np.array_equal(is_hit, want),
          f"{tag}: sampled pairs: {int((is_hit != want).sum())} of {len(a)} "
          "disagree with the f64 recount")
    log(f"scan check ({tag}): {len(pick)} hits and {len(a)} pairs "
        f"({int(is_hit.sum())} hits among them) agree with the f64 recount")
    return i, j, r2s, dps


def phase_scan(work, gp, pos, results):
    """The chr21-scale store in both layouts, then the slice at full size."""
    v = gp.shape[0]
    data = os.path.join(work, "chr21")
    write_store(data, "21", gp, pos, seed=21)
    runs = {}
    for tag, extra in (("full", ()), ("window", ("-w", "1000000"))):
        report, secs, launches = _run_scan(
            data, os.path.join(work, f"out_{tag}"), extra)
        _log_scan(tag, report, secs, launches)
        check(report.stats["resident_packed"] == 0.0,
              f"scan ({tag}): auto must inflate at chr21 scale")
        _check_layout_launches(tag, launches, packed=False)
        runs[tag] = (report, secs, launches)
    for name in ("ld_band_count_kernel", K3):
        results[name]["launches"] = runs["full"][2][name]

    i, j, r2s, dps = _check_hits("full", runs["full"][0].path, gp, pos, 64,
                                 None, seed=1)
    wi, wj, wr2, wdp = read_tsv(runs["window"][0].path, pos)
    near = np.abs(pos[i] - pos[j]) <= 1_000_000
    check(np.array_equal(wi, i[near]) and np.array_equal(wj, j[near])
          and np.array_equal(wr2, r2s[near]) and np.array_equal(wdp, dps[near]),
          "the -w 1000000 hits are not the full hits within 1 Mb")
    log(f"scan check: -w 1000000 gives exactly the {len(wi)} full-scan hits "
        f"within 1 Mb")

    # (a) the same store under the packed layout: the same bytes out
    os.environ[LIMIT] = "0"
    try:
        report, secs, launches = _run_scan(data, os.path.join(work, "out_pk"))
    finally:
        del os.environ[LIMIT]
    _log_scan("full, packed", report, secs, launches)
    check(report.stats["resident_packed"] == 1.0,
          f"{LIMIT}=0 must keep the bytes packed")
    _check_layout_launches("full, packed", launches, packed=True)
    with open(report.path, "rb") as fa, open(runs["full"][0].path, "rb") as fb:
        check(fa.read() == fb.read(),
              "the packed layout's TSV differs from the int8 layout's")
    log("scan check: the packed layout's TSV is byte-identical to the int8 "
        "layout's")
    runs["full_packed"] = (report, secs, launches)

    # (b) the slice at full size, at the default limit
    t0 = time.perf_counter()
    gpf, posf = scan_dataset(N_VARIANTS_FULL, seed=22, run=RUN_FULL)
    data = os.path.join(work, "chr_full")
    write_store(data, "21", gpf, posf, seed=22)
    setup_s = time.perf_counter() - t0
    log(f"data: {gpf.shape[0]} variants x {N_HAP} haplotypes, runs of "
        f"{RUN_FULL}, made and written in {setup_s:.1f}s")
    check(LIMIT not in os.environ, f"{LIMIT} must be unset (default 4 GiB)")
    from ld_tools_tpu_torch.ops import ld_stream

    site, calls = _recorded(ld_stream, "ld_band_sweep_blocks_packed")
    try:
        report, secs, launches = _run_scan(
            data, os.path.join(work, "out_full"), ("-w", "1000000"))
    finally:
        ld_stream.ld_band_sweep_blocks_packed = site
    _log_scan("1.1M, window", report, secs, launches)
    check(len(calls) == launches[K4], f"recorded {len(calls)} of "
          f"{launches[K4]} K4 launches")
    st = report.stats
    check(st["resident_packed"] == 1.0,
          "auto must keep a 1.1M-variant chromosome packed")
    # v_pad: V (a multiple of the 7,680-row chunk) and one chunk more
    check(st["resident_bytes"] == (N_VARIANTS_FULL + 7680) * W_PACKED,
          f"resident bytes {st['resident_bytes']}")
    _check_layout_launches("1.1M, window", launches, packed=True)
    # the resident built by the gather, one launch a staging chunk
    chunks = -(-N_VARIANTS_FULL // ld_stream._STAGE_ROWS)
    check(launches[GATHER] == chunks and st["resident_gather"] == 1.0,
          f"the 1.1M scan launched {GATHER} {launches[GATHER]} times, not "
          f"{chunks} (resident_gather {st.get('resident_gather')})")
    results[GATHER] = dict(launches=launches[GATHER], path=(
        f"prepare_resident, launches from the {N_VARIANTS_FULL}-variant "
        "-w 1000000 scan"))
    for name in ("ld_band_count_kernel<FORM_BITS>",
                 K4):
        results[name]["launches"] = launches[name]
        results[name]["path"] += (f", launches from the {N_VARIANTS_FULL}-"
                                  "variant -w 1000000 scan")
    _check_hits("1.1M, window", report.path, gpf, posf, RUN_FULL, 1_000_000,
                seed=2)
    time_scan_sweeps(site, calls, results)
    del calls
    runs["full_size_window"] = (report, secs, launches)
    shutil.rmtree(data, ignore_errors=True)
    summary = {tag: dict(hits=r.n_hits, seconds=s, stats=r.stats,
                         launches={KERNELS.get(k, ("-",))[0] + " " + k: n
                                   for k, n in l.items() if n})
               for tag, (r, s, l) in runs.items()}
    # the stores the sharded phase takes on: the chr21 store on disk with
    # its single-process TSV, and the full-size chromosome's arrays
    # (out_full now holds the 1.1 M TSV: the packed layout's chr21 TSV is
    # the int8 one byte for byte)
    return summary, dict(chr21=os.path.join(work, "chr21"),
                         chr21_tsv=runs["full_packed"][0].path,
                         full=(gpf, posf))


def _count_bound(bi, bj, v, width):
    """The least time of a count pass over the blocks (bi, bj): 2
    operations a haplotype over the cells below the diagonal the blocks
    hold, at the int8 peak, or their rows' bytes read once (padded width,
    c1, ipq and pos) and one int32 a block written, at the HBM rate."""
    nb = len(bi)
    diag = int((bi == bj).sum())
    cells = (nb - diag) * BLOCK * BLOCK + diag * BLOCK * (BLOCK - 1) // 2
    rows = -(-v // BLOCK) * BLOCK
    return bound(2 * cells * N_HAP, rows * (width + 12) + 8 * nb)


def _same_hits(a, b):
    return all(np.array_equal(getattr(a, k), getattr(b, k))
               for k in ("i", "j", "r_square", "d_prime",
                         "r_square_is_int_zero", "d_prime_is_int_zero"))


def _launches():
    from ld_tools_tpu_torch.ops import ld_kernels as lk

    return {KERNEL_OF_SITE[fn.__name__]: fn.launches
            for fn in lk.LAUNCH_SITES}


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _run_pair(args, timeout=300):
    """``python args`` (``-m ld_tools_tpu_torch.ld_scan ...``, or this
    script in a worker role) as ranks 0 and 1 of a gloo group on this card
    (torchrun's variables), from the repository root; both must exit 0
    and print one launch report.  Returns each rank's (stderr, launch
    report, stdout) and the wall seconds.  Kills both if either fails or
    hangs."""
    here = os.path.dirname(os.path.abspath(__file__))
    port = str(_free_port())
    procs = []
    t0 = time.perf_counter()
    try:
        for rank in range(2):
            env = dict(os.environ, PYTHONPATH=here, MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=port, WORLD_SIZE="2", RANK=str(rank),
                       LOCAL_RANK=str(rank), TPU_LD_DIST_TIMEOUT_S="240")
            procs.append(subprocess.Popen(
                [sys.executable, *args], cwd=here, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    secs = time.perf_counter() - t0
    res = []
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"{args[:2]} rank {rank} exited "
              f"{p.returncode}:\n{err[-3000:]}")
        reports = [json.loads(ln) for ln in err.splitlines()
                   if ln.startswith('{"launches"')]
        check(len(reports) == 1, f"rank {rank} printed {len(reports)} "
              "launch reports")
        res.append((err, reports[0]["launches"], out))
    return res, secs


# shards of the one card in the sharded phase; the sweeps' tolerance
# against the f64 finish (f32 r^2 from exact counts: |error| <= 2 r dd /
# sqrt(p1 q1 p2 q2) with dd <= 1.2e-7, about 5e-6 for allele frequencies
# in [0.05, 0.95]; 4x margin)
SHARDS = 4
SWEEP_TOL = 2e-5


def phase_sharded(work, stores, gp, pos, results):
    """K7 over [cuda:0] * 4 against its plain version (ragged rows, both
    forms) and against the unsharded K5 (chr21) and K6 (1.1 M, -w
    1000000), timed beside them; the sharded scan in both layouts against
    the one-device scan; the tool with -d 1, -d 4 and [cuda:0] * 4
    (:func:`tool_d_runs`); the cooperative tool run by two processes on
    the card, and its resume, against the single-process TSV; the three
    all-pairs sweeps against their one-device run, the f64 finish and
    K1."""
    import torch

    from ld_tools_tpu_torch.ops import ld_kernels as lk
    from ld_tools_tpu_torch.ops import ld_stream as ls
    from ld_tools_tpu_torch.ops.exact import exact_ld_elementwise
    from ld_tools_tpu_torch.parallel import (all_pairs_replicated,
                                             all_pairs_ring,
                                             all_pairs_trapezoid)

    dev = torch.device("cuda", 0)
    mesh = [dev] * SHARDS
    thres = 0.8 - 5e-4
    kw = dict(sel=0, exact_mask=True, block_m=BLOCK, block_n=BLOCK)
    summary = {}

    # K7 against its plain version on the ragged rows, both forms
    _, rc, rq = _check_rows(gp, pos, N_RAGGED)
    bi, bj = np.tril_indices(-(-N_RAGGED // BLOCK))
    cij = torch.from_numpy(lk.pack_block_coords(bi, bj)).to(dev)
    for res, plain in ((rc, lk.ld_band_count_plain),
                       (rq, lk.ld_band_count_packed_plain)):
        rows = tuple(t[:N_RAGGED] for t in (res.g, res.c1, res.ipq, res.pos))
        copies = tuple(lk.shard_replicas(t, mesh) for t in rows)
        for use_dist in (False, True):
            got = lk.ld_band_count_sharded(
                mesh, *copies, cij, (N_HAP, 1_000_000), (thres,),
                packed=res.packed, use_dist=use_dist, **kw)
            ref = plain(*rows, cij, N_HAP, 1_000_000, thres,
                        use_dist=use_dist, **kw)
            check(torch.equal(got, ref), f"K7 (packed={res.packed}, dist="
                  f"{use_dist}) differs from the plain version in "
                  f"{int((got != ref).sum())} blocks")
    del rc, rq
    log(f"K7: {SHARDS} shards on one card equal the plain versions, both "
        f"forms, with and without the window ({N_RAGGED} ragged rows)")

    # K7, dense form, at chr21 scale against K5
    v = gp.shape[0]
    rd = ls.prepare_resident(gp, N_HAP, pos, "cuda", packed=True)
    bi, bj = ls._scan_blocks(v, pos, BLOCK, None)
    cij = torch.from_numpy(lk.pack_block_coords(bi, bj)).to(dev)
    rows = (rd.g, rd.c1, rd.ipq, rd.pos)
    params = (cij, (N_HAP, 0), (thres,))

    def k5():
        return lk.ld_band_count(*rows, *params, packed=False, use_dist=False,
                                **kw)

    def k7(m, copies):
        return lk.ld_band_count_sharded(m, *copies, *params, packed=False,
                                        use_dist=False, **kw)

    # scan_mesh(n) takes at most the cards there are (JAX's
    # local_devices()[:n]): on one card it is [cuda:0], whatever n
    local = ls.scan_mesh()
    check(ls.scan_mesh(SHARDS) == local[:SHARDS]
          and (torch.cuda.device_count() > 1 or local == [dev]),
          f"scan_mesh({SHARDS}) is {ls.scan_mesh(SHARDS)}, scan_mesh() "
          f"{local} on {torch.cuda.device_count()} card(s)")
    want = k5()
    for m in (mesh, local):
        copies = tuple(lk.shard_replicas(t, m) for t in rows)
        check(torch.equal(k7(m, copies), want),
              f"K7 over {len(m)} shard(s) differs from K5 (chr21)")
    copies = tuple(lk.shard_replicas(t, mesh) for t in rows)
    ms5 = cuda_ms(k5, reps=3)
    ms7 = cuda_ms(lambda: k7(mesh, copies), reps=3)
    ms5 = (ms5 + cuda_ms(k5, reps=3)) / 2
    b = _count_bound(bi, bj, v, W_DENSE)
    mm7 = cuda_ms(lambda: int_mm_rows(rd.g, -(-v // BLOCK), BLOCK), reps=1)
    log(f"K7 ld_band_count_sharded, {SHARDS} shards on one card: "
        f"{ms7:.3f} ms (roofline share {b[0] / ms7:.3f}), K5 unsharded "
        f"{ms5:.3f} ms ({b[0] / ms5:.3f}), bound {b[0]:.3f} ms ({b[1]}), "
        f"torch._int_mm {mm7:.3f} ms ({len(bi)} blocks, chr21, int8)")
    del rd, want, cij, rows, params, copies
    torch.cuda.empty_cache()

    # K7, packed form, at 1.1 M variants with the window against K6
    gpf, posf = stores["full"]
    rp = ls.prepare_resident(gpf, N_HAP, posf, "cuda", packed=True)
    check(rp.packed, "auto must keep the 1.1M-variant store packed")
    bif, bjf = ls._scan_blocks(gpf.shape[0], posf, BLOCK, 1_000_000)
    cij = torch.from_numpy(lk.pack_block_coords(bif, bjf)).to(dev)
    rows = (rp.g, rp.c1, rp.ipq, rp.pos)
    params = (cij, (N_HAP, 1_000_000), (thres,))
    copies = tuple(lk.shard_replicas(t, mesh) for t in rows)

    def k6():
        return lk.ld_band_count(*rows, *params, packed=True, use_dist=True,
                                **kw)

    def k7p():
        return lk.ld_band_count_sharded(mesh, *copies, *params, packed=True,
                                        use_dist=True, **kw)

    check(torch.equal(k7p(), k6()), "K7 differs from K6 (1.1 M, window)")
    ms6 = cuda_ms(k6, reps=3)
    ms7p = cuda_ms(k7p, reps=3)
    ms6 = (ms6 + cuda_ms(k6, reps=3)) / 2
    bp = _count_bound(bif, bjf, gpf.shape[0], W_PACKED)
    log(f"K7 ld_band_count_sharded (packed), {SHARDS} shards: {ms7p:.3f} ms "
        f"(roofline share {bp[0] / ms7p:.3f}), K6 unsharded {ms6:.3f} ms "
        f"({bp[0] / ms6:.3f}), bound {bp[0]:.3f} ms ({bp[1]}) "
        f"({len(bif)} blocks, 1.1 M variants, -w 1000000)")
    del rp, cij, rows, params, copies
    torch.cuda.empty_cache()

    # the sharded scan against the one-device scan, both layouts
    k7_launches = 0
    for layout, extra in (("int8", {}), ("packed", {"resident": "packed"})):
        skw = dict(G_packed=gp, n_haplotypes=N_HAP, pos=pos, thres=0.8,
                   device="cuda", **extra)
        runs = {}
        for tag, m in (("one", None), ("sharded", mesh)):
            lk.reset_launches()
            t0 = time.perf_counter()
            hits = ls.stream_threshold_scan(mesh=m, **skw)
            torch.cuda.synchronize()
            runs[tag] = (hits, time.perf_counter() - t0, _launches())
        one, shard = runs["one"][0], runs["sharded"][0]
        check(_same_hits(one, shard) and len(one.i) > 0,
              f"the sharded scan ({layout}) differs from the one-device scan")
        st = shard.stats
        check(st["shards"] == SHARDS
              and st["blocks_checked"] == st["hit_blocks"] > 0,
              f"sharded scan ({layout}) stats {st}")
        sweep = K4 if layout == "packed" else K3
        _only_launched(f"the sharded scan ({layout})", runs["sharded"][2],
                       {"ld_band_count_sharded", sweep, GATHER})
        if layout == "int8":
            k7_launches = runs["sharded"][2]["ld_band_count_sharded"]
        summary[f"scan_{layout}"] = {
            tag: dict(hits=len(h.i), seconds=secs, stats=h.stats)
            for tag, (h, secs, _) in runs.items()}
        log(f"sharded scan ({layout}): {len(shard.i)} hits, the one-device "
            f"scan's; {runs['sharded'][1]:.2f}s against "
            f"{runs['one'][1]:.2f}s; shard blocks {st['shard_blocks']}, "
            f"hit blocks {st['shard_hit_blocks']}")
    results["ld_band_count_sharded"] = dict(
        launches=k7_launches, max_abs_err=0.0, ms=ms7,
        plain_ms=results["ld_band_count_kernel"]["plain_ms"],
        bound_ms=b[0], bound_by=b[1], library_ms=None,
        int_mm_ms=mm7,
        path=f"stream_threshold_scan(mesh=[cuda:0]*{SHARDS}), chr21, int8 "
             "layout (launches); plain_ms: the plain count over the "
             "unsharded list, timed in the scan-shapes phase",
        shape=f"{len(bi)} blocks of {BLOCK}x{BLOCK} over {SHARDS} shards on "
              f"one card, W={W_DENSE} int8, integer mask",
        extra=dict(k5_ms=ms5, k5_roofline_share=b[0] / ms5,
                   packed_ms=ms7p, packed_k6_ms=ms6,
                   packed_k6_roofline_share=bp[0] / ms6,
                   packed_bound_ms=bp[0], packed_bound_by=bp[1],
                   packed_shape=f"{len(bif)} blocks, 1.1 M variants packed "
                                "(W=640 bytes), -w 1000000"))

    with open(stores["chr21_tsv"], "rb") as fh:
        solo = fh.read()
    summary["tool_d"] = tool_d_runs(work, stores["chr21"], solo)

    # the cooperative tool on the card, then its resume
    ckpt = os.path.join(work, "coop_ckpt")
    for tag in ("cooperative", "resume"):
        out = os.path.join(work, f"coop_{tag}")
        ranks, secs = _run_pair(["-m", "ld_tools_tpu_torch.ld_scan", "-C",
                                 "21", "-D", stores["chr21"], "-t", out,
                                 "-z", "0.8", "-f", "-E", "cuda", "-d", "2",
                                 "-k", ckpt])
        (name,) = os.listdir(out)  # rank 0 alone writes
        with open(os.path.join(out, name), "rb") as fh:
            check(fh.read() == solo, f"the {tag} run's TSV differs from the "
                  "single-process TSV")
        phases = []
        for rank, (err, launches, _) in enumerate(ranks):
            # the scan's own phase line (ops/ld_stream.py logs it)
            (line,) = [ln for ln in err.splitlines() if "scan phases: " in ln]
            phases.append(dict(kv.split("=", 1) for kv in
                               line.split("scan phases: ", 1)[1].split()))
            if tag == "cooperative":
                # -d 2 under a launcher: each process has its one card,
                # so the one-device scan (JAX's with one chip a process)
                _only_launched(f"cooperative rank {rank}", launches,
                               {"ld_band_count", "ld_band_sweep_blocks",
                                "gather_rows_device"})
            else:
                # the resident is still gathered; nothing is counted
                check(not any(n for k, n in launches.items()
                              if k != "gather_rows_device")
                      and "resumed batch" in err,
                      f"resume rank {rank} launched {launches}")
        summary[tag] = dict(seconds=secs, launches=[r[1] for r in ranks],
                            phases=phases)
        log(f"{tag} ld_scan (2 processes, gloo, -d 2 -k, one card each, "
            f"the one-device scan): {secs:.2f}s; rank 0's TSV is the "
            "single-process TSV")

    # the all-pairs sweeps against their one-device run
    G = triangle_host()
    t0 = time.perf_counter()
    one_r2, one_dp = all_pairs_replicated(G, mesh=[dev])
    torch.cuda.synchronize()
    sweeps = {"one": time.perf_counter() - t0}
    for name, fn in (("replicated", all_pairs_replicated),
                     ("ring", all_pairs_ring),
                     ("trapezoid", all_pairs_trapezoid)):
        t0 = time.perf_counter()
        r2, dp = fn(G, mesh=mesh)
        torch.cuda.synchronize()
        sweeps[name] = time.perf_counter() - t0
        if name == "trapezoid":
            ok = (torch.equal(r2, torch.tril(one_r2))
                  and torch.equal(dp + 0.0, torch.tril(one_dp))
                  and not bool(torch.triu(r2, 1).any()))
        else:
            ok = torch.equal(r2, one_r2) and torch.equal(dp, one_dp)
        check(ok, f"the {name} sweep over {SHARDS} shards differs from the "
              "one-device sweep")
        del r2, dp
    v1 = G.shape[0]
    rng = np.random.default_rng(9)
    a = rng.integers(1, v1, size=4000)
    bb = (a * rng.random(4000)).astype(np.int64)
    gpk = np.packbits(G.astype(np.uint8), axis=1)
    from ld_tools_tpu_torch.ingest import pack

    c1 = pack.popcounts(gpk)
    cab = pack.popcounts(np.bitwise_and(gpk[a], gpk[bb]))
    ex = exact_ld_elementwise(cab, c1[a], c1[bb], N_HAP)
    got = one_r2[torch.from_numpy(a).to(dev),
                 torch.from_numpy(bb).to(dev)].cpu().numpy()
    err = float(np.abs(got - ex.r_square).max())
    check(err <= SWEEP_TOL, f"sweep r^2 vs the f64 finish: max abs err {err}")
    r2_k1, _ = lk.ld_triangle_matrix(torch.from_numpy(G).to(dev), N_HAP,
                                     epilogue="exact", want_dprime=False)
    err_k1 = float((torch.tril(one_r2) - torch.tril(r2_k1)).abs().max())
    check(err_k1 <= SWEEP_TOL, f"sweep r^2 vs K1: max abs err {err_k1}")
    summary["sweeps"] = dict(seconds=sweeps, f64_max_abs_err=err,
                             k1_max_abs_err=err_k1, tol=SWEEP_TOL)
    log(f"sweeps ({v1} x {N_HAP}, {SHARDS} shards on one card): "
        + ", ".join(f"{k} {t:.3f}s" for k, t in sweeps.items())
        + f"; each equals the one-device sweep; r^2 within {err:.3g} of the "
          f"f64 finish (4,000 pairs) and {err_k1:.3g} of K1 (tolerance "
          f"{SWEEP_TOL})")
    del one_r2, one_dp, r2_k1
    torch.cuda.empty_cache()
    summary["sweeps_two_processes"] = sweeps_two_processes(v1)
    return summary


def tool_d_runs(work, data, solo):
    """The ld_scan tool on the chr21 store with ``-d 1``, ``-d 4`` and the
    explicit list [cuda:0] * 4 (``ScanConfig.mesh`` replaced: the tool's
    CLI takes a count).  ``-d 4`` takes at most the cards there are: on
    one card the one-device scan, K5 and K3 with no K7, as the JAX tool
    on one chip; the list runs K7's four shards queued on one card.
    Every TSV must be the single-process TSV."""
    import torch

    from ld_tools_tpu_torch.ops import ld_stream as ls
    from ld_tools_tpu_torch.tools.scan import ScanConfig

    listed = [torch.device("cuda", 0)] * SHARDS
    tags = {"-d 1": 1, f"-d {SHARDS}": len(ls.scan_mesh(SHARDS)),
            f"[cuda:0] * {SHARDS}": SHARDS}
    runs = {}
    mesh_of = ScanConfig.mesh
    for k, tag in enumerate(tags):
        out = os.path.join(work, f"out_d{k}")
        if tag.startswith("["):
            ScanConfig.mesh = lambda self: listed
        try:
            report, secs, launches = _run_scan(
                data, out, ("-d", tag[3:]) if tag.startswith("-d") else ())
        finally:
            ScanConfig.mesh = mesh_of
        _log_scan(tag, report, secs, launches)
        st = report.stats
        check(st["shards"] == tags[tag], f"ld_scan {tag} on "
              f"{torch.cuda.device_count()} card(s) ran {st['shards']} "
              "shard(s)")
        count = ("ld_band_count_sharded" if tags[tag] > 1
                 else "ld_band_count_kernel")
        # the resident's gather where the scan uploaded (not on a hit of
        # the resident cache, which the same shard layout reuses)
        upload = {GATHER} if not st["resident_hit"] else set()
        _only_launched(f"ld_scan {tag}", launches, {count, K3} | upload)
        with open(report.path, "rb") as fh:
            check(fh.read() == solo, f"the ld_scan {tag} TSV differs from "
                  "the single-process TSV")
        shutil.rmtree(out, ignore_errors=True)
        runs[tag] = dict(seconds=secs, count_s=st["count_s"],
                         fetch_s=st["fetch_s"], write_s=st["write_s"],
                         shards=st["shards"], resident_hit=st["resident_hit"],
                         launches={n: v for n, v in launches.items() if v})
    log(f"ld_scan on {torch.cuda.device_count()} card(s): " + "; ".join(
        f"{tag} {r['shards']:.0f} shard(s), launches {r['launches']}, "
        f"count_s {r['count_s']:.4f}, wall {r['seconds']:.2f} s"
        for tag, r in runs.items()) + "; every TSV the single-process TSV")
    return runs


def sweep_worker():
    """One rank of the sweeps across processes (``chip_smoke.py
    --sweep-worker``, started by :func:`sweeps_two_processes`): two local
    shards on this process's card (``make_mesh(devices=[own, own])``),
    four over the gloo group; the ring's
    and the trapezoid's bands on the headline's rows against this
    process's one-device sweep, with torch.equal.  Prints one JSON line
    and the launch report."""
    import torch

    from ld_tools_tpu_torch.bench.common import log_launches
    from ld_tools_tpu_torch.parallel import (all_pairs_ring,
                                             all_pairs_trapezoid, make_mesh)
    from ld_tools_tpu_torch.parallel.sweep import ProcessMesh
    from ld_tools_tpu_torch.utils.distributed import (initialize_if_needed,
                                                      local_device,
                                                      process_index)

    check(initialize_if_needed(), "the sweep worker joined no group")
    own = local_device("cuda")
    mesh = make_mesh(devices=[own, own])  # two shards on one card: asked
    check(isinstance(mesh, ProcessMesh) and len(mesh) == 4,
          f"the mesh over two processes is {mesh}")
    G = triangle_host()
    out = dict(rank=process_index(), owners=list(mesh.owners),
               devices=list(mesh.devices), sweeps={})
    for name, fn in (("ring", all_pairs_ring),
                     ("trapezoid", all_pairs_trapezoid)):
        one_r2, one_dp = fn(G, mesh=[own])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r2s, dps = fn(G, mesh=mesh)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        equal = all(b.rows == c.rows and torch.equal(b.data, one_r2[b.rows])
                    and torch.equal(c.data, one_dp[c.rows])
                    for b, c in zip(r2s, dps))
        out["sweeps"][name] = dict(
            seconds=secs, equal=equal,
            rows=[[b.rows.start, b.rows.stop] for b in r2s])
        del one_r2, one_dp, r2s, dps
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    log_launches()


def sweeps_two_processes(v):
    """The ring and the trapezoid across two gloo processes on this card
    (each with local shards [cuda:0, cuda:0]: four shards over the group,
    a block crossing the process boundary at every step): each rank's
    bands must equal its one-device sweep, and the ranks' bands must
    cover the v rows once."""
    here = os.path.abspath(__file__)
    ranks, secs = _run_pair([here, "--sweep-worker"])
    outs = [json.loads(out.strip().splitlines()[-1]) for _, _, out in ranks]
    summary = {"wall_s": secs}
    for name in ("ring", "trapezoid"):
        for r in outs:
            check(r["owners"] == [0, 0, 1, 1] and r["sweeps"][name]["equal"],
                  f"the {name} sweep over two processes: rank {r['rank']}'s "
                  "bands differ from the one-device sweep")
        rows = sorted(tuple(b) for r in outs for b in r["sweeps"][name]["rows"])
        check(rows[0][0] == 0 and rows[-1][1] == v and all(
            a[1] == b[0] for a, b in zip(rows, rows[1:])),
            f"the {name} sweep's bands over two processes: {rows}")
        summary[name] = [r["sweeps"][name]["seconds"] for r in outs]
    log(f"sweeps across two processes ({v} x {N_HAP}, 4 shards: [cuda:0, "
        f"cuda:0] in each, gloo between them): ring "
        f"{max(summary['ring']):.3f}s, trapezoid "
        f"{max(summary['trapezoid']):.3f}s (the slower rank), {secs:.1f}s "
        "with the processes' start; every band equals the one-device "
        "sweep")
    return summary


def phase_entry():
    """The entry points of ld_tools_tpu_torch.entry on the card: entry()'s
    LD step against the same step on the CPU (r^2 and D' within 1e-6);
    with fewer than 4 cards, make_mesh(4) and dryrun_multichip(4) must
    raise ValueError (JAX's make_mesh raises, its dry run asserts 4
    devices); then dryrun_multichip(4, devices=[cuda:0] * 4)."""
    import torch

    from ld_tools_tpu_torch.entry import dryrun_multichip, entry
    from ld_tools_tpu_torch.parallel import make_mesh

    fn, args = entry()
    check(args[0].is_cuda, "entry() did not put its rows on the card")
    got = fn(*args)
    torch.cuda.synchronize()
    fn_cpu, args_cpu = entry("cpu")
    want = fn_cpu(*args_cpu)
    errs = [float((g.cpu() - w).abs().max()) for g, w in zip(got, want)]
    check(max(errs) <= 1e-6, f"entry(): the card's r^2 / D' differ from the "
          f"CPU's by {errs}")
    cards = torch.cuda.device_count()
    raised = []
    if cards < SHARDS:
        for name, call in (("make_mesh", make_mesh),
                           ("dryrun_multichip", dryrun_multichip)):
            try:
                call(SHARDS)
            except ValueError as exc:
                raised.append(f"{name}({SHARDS}): {exc}")
            else:
                check(False, f"{name}({SHARDS}) on {cards} card(s) did not "
                      "raise")
    devices = [torch.device("cuda", 0)] * SHARDS
    mesh = make_mesh(devices=devices)
    check(mesh == devices, f"make_mesh(devices={devices}) is {mesh}")
    t0 = time.perf_counter()
    dryrun_multichip(SHARDS, devices=devices)
    secs = time.perf_counter() - t0
    log(f"entry: ld_step on 1,024 x 5,120 on the card, r^2 / D' within "
        f"{errs[0]:.3g} / {errs[1]:.3g} of the CPU's; on {cards} card(s) "
        + ("; ".join(raised) or "nothing raised") + f"; dryrun_multichip("
        f"{SHARDS}, devices=[cuda:0] * {SHARDS}) passed in {secs:.2f}s, "
        f"its {SHARDS} shards sharing one card")
    return dict(max_abs_err=errs, raised=raised, dryrun_s=secs)


# ---- the engine's tools: ld_area and the mixed-ploidy scan ----------------

AREA_FILES = 4        # ld_area's source files, run on -p 4 threads
AREA_QUERIES = 1000   # every 100th row of the chr21 store
AREA_FLANK = 100_000  # ld_area's default flank


def _area_sources(src, v, n_queries, n_files):
    """``n_queries`` query rsIDs (every 100th row of a store of ``v``
    rows) split into ``n_files`` contiguous source files; their rows."""
    rows = np.arange(0, v, 100)[:n_queries]
    os.makedirs(src, exist_ok=True)
    for k, part in enumerate(np.array_split(rows, n_files)):
        with open(os.path.join(src, f"q{k}.txt"), "w") as fh:
            fh.write("\n".join(rsid_of(r) for r in part) + "\n")
    return rows


def _tree(top):
    """{relative path: bytes} of every file under ``top``."""
    out = {}
    for dirpath, _, files in os.walk(top):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, top)] = fh.read()
    return out


def _check_area_files(out, gp, pos, rows, seed):
    """Sampled queries' files against a recount of each query's window
    with the port's plain versions (the engine's counts on the CPU, the
    f64 finish): the opponents with rounded r^2 >= 0.8 and their r^2 and
    D' strings, or no file where there are none."""
    from ld_tools_tpu_torch.ops import engine
    from ld_tools_tpu_torch.ops.exact import (exact_ld_from_counts,
                                              format_rounded, round4)

    rng = np.random.default_rng(seed)
    files = np.array_split(rows, AREA_FILES)
    n_checked = n_hits = 0
    for k, part in enumerate(files):
        for r in rng.choice(part, size=6, replace=False):
            q_pos = int(pos[r])
            start = int(np.searchsorted(pos, max(q_pos - AREA_FLANK, 0),
                                        side="right"))
            stop = int(np.searchsorted(pos, q_pos + AREA_FLANK,
                                       side="right"))
            opp = np.array([o for o in range(start, stop) if o != r])
            A = np.unpackbits(gp[[r]], axis=1, count=N_HAP).astype(np.int8)
            B = np.unpackbits(gp[opp], axis=1, count=N_HAP).astype(np.int8)
            c_ab, c1, c2 = engine.pair_counts(A, B, device="cpu")
            ex = exact_ld_from_counts(c_ab, c1, c2, N_HAP)
            r2 = ex.r_square[0]
            r2_round = round4(r2)
            r2_round[ex.r_square_is_int_zero[0]] = 0.0
            keep = r2_round >= 0.8
            want = {rsid_of(o): (a, b) for o, a, b in zip(
                opp[keep],
                format_rounded(r2[keep], ex.r_square_is_int_zero[0][keep]),
                format_rounded(ex.d_prime[0][keep],
                               ex.d_prime_is_int_zero[0][keep]))}
            path = os.path.join(out, f"q{k}_in_LD", "21",
                                f"{rsid_of(r)}_chr21_r_0.8.tsv")
            if not want:
                check(not os.path.exists(path), f"ld_area: {path} has no "
                      "hits in the recount but was written")
                continue
            with open(path) as fh:
                lines = fh.read().splitlines()
            check(lines[2].split("\t")[1] == rsid_of(r),
                  f"ld_area: {path}: query row {lines[2]!r}")
            got = {f[1]: (f[6], f[7])
                   for f in (ln.split("\t") for ln in lines[3:])}
            check(got == want, f"ld_area: {path}: {len(got)} opponents, the "
                  f"recount has {len(want)} (or their values differ)")
            n_checked += 1
            n_hits += len(want)
    check(n_checked > 0, "ld_area: no sampled query has hits")
    return n_checked, n_hits


def phase_area(work, data, gp, pos):
    """ld_area at chr21 scale: 1,000 queries over 4 source files on the
    chr21 store, -p 4 (four threads issue the engine's counts at once),
    the defaults (flank 100 kb, r^2 >= 0.8, TSV).  The engine's count
    jobs must have run on the card (its launch count read around the
    run), no kernel of ops/ld_kernels launched, and sampled queries'
    files must equal a recount."""
    from ld_tools_tpu_torch import ld_area
    from ld_tools_tpu_torch.ops import engine
    from ld_tools_tpu_torch.ops import ld_kernels as lk

    src = os.path.join(work, "area_src")
    out = os.path.join(work, "area_out")
    rows = _area_sources(src, gp.shape[0], AREA_QUERIES, AREA_FILES)
    lk.reset_launches()
    engine.reset_launches()
    stats = {}
    t0 = time.perf_counter()
    n_files = ld_area.main(["-S", src, "-D", data, "-t", out, "-p",
                            str(AREA_FILES), "-E", "cuda"], stats)
    wall = time.perf_counter() - t0
    launches = engine.count_on_device.launches
    kernels = sum(_launches().values())
    check(launches > 0, "ld_area never counted on the card")
    check(kernels == 0, f"ld_area launched {kernels} kernels")
    check(n_files > 0, "ld_area wrote no file")
    n_checked, n_hits = _check_area_files(out, gp, pos, rows, seed=8)
    log(f"ld_area (chr21, {len(rows)} queries in {AREA_FILES} files, -p "
        f"{AREA_FILES}): {n_files} files in {wall:.2f}s; groups "
        f"{stats['groups']}, engine launches {launches}; count: dispatch "
        f"{stats['dispatch_s']:.3f}s + wait {stats['count_wait_s']:.3f}s, "
        f"finish {stats['finish_s']:.3f}s, write {stats['write_s']:.3f}s "
        "(summed over the threads)")
    log(f"ld_area check: {n_checked} sampled queries' files ({n_hits} "
        "opponents) equal the recount")
    shutil.rmtree(out, ignore_errors=True)
    return dict(wall_s=wall, files=n_files, engine_launches=launches,
                **stats)


# ---- ld_triangle ----------------------------------------------------------

# the chr21 store's rows in each source file: 500 (the per-cell hover path;
# the reference's readable cap, its README.md:74), 2,000 (past the cap: the
# columnar heatmap) and 10,000 (BASELINE metric #2: the streamed table
# over ResidentCounts, 5 row blocks of 2,048)
TRI_ROWS = {"t500": range(1000, 1500), "t2000": range(20_000, 40_000, 10),
            "t10k": range(50_000, 60_000)}
TRI_SAMPLED = 200  # rows of the larger files held against the recount


def _triangle_sources(src, names, rows_of):
    """One source file of rsIDs per name, the rows ``rows_of[name]``."""
    os.makedirs(src, exist_ok=True)
    for name in names:
        with open(os.path.join(src, f"{name}.txt"), "w") as fh:
            fh.write("\n".join(rsid_of(r) for r in rows_of[name]) + "\n")


def _triangle_rows(path, n_rows, seed):
    """(store rows of the matrix, [(row index, its cells)]) of a triangle
    TSV: every row, or ``n_rows`` sampled ones, read line by line (the
    10,000-row table is 0.4 GB)."""
    with open(path) as fh:
        head = [fh.readline() for _ in range(4)]
        rsids = head[2].rstrip("\n").split("\t")[2:]
        rows = np.array([int(r[2:]) - 100_000 for r in rsids])
        n = len(rsids)
        pick = (set(range(n)) if n_rows is None else set(
            np.random.default_rng(seed).choice(n, n_rows, replace=False)))
        picked = []
        for i, line in enumerate(fh):
            if i in pick:
                cells = line.rstrip("\n").split("\t")
                check(cells[0] == rsids[i] and len(cells) == n + 2,
                      f"{path}: row {i} is {cells[:2]} with {len(cells)} "
                      "fields")
                picked.append((i, cells[2:]))
    check(len(picked) == len(pick), f"{path}: {len(picked)} rows read")
    return rows, picked


def _check_triangle_tsv(path, recount, n_rows=None, seed=0):
    """A triangle TSV (no threshold) against ``recount(i rows, j rows) ->
    r^2 strings``: below the diagonal each cell is the recount's, on and
    above it '0'.  Returns the number of cells checked."""
    rows, picked = _triangle_rows(path, n_rows, seed)
    cells_checked = 0
    for i, cells in picked:
        want = recount(np.full(i, rows[i]), rows[:i]) if i else []
        check(list(cells[:i]) == list(want) and all(
            c == "0" for c in cells[i:]),
            f"{path}: row {i} differs from the f64 recount")
        cells_checked += len(cells)
    return cells_checked


def _figure(path):
    """The figure JSON a heatmap HTML embeds."""
    with open(path) as fh:
        html = fh.read()
    m = re.search(r"const FIG = (\{.*?\});\n", html, re.S)
    check(m is not None, f"{path}: no figure")
    return json.loads(m.group(1))


def _run_triangle(tag, src, data, out, extra):
    """``ld_triangle.main`` on the card: returns (matrices, wall seconds,
    phase sums, engine launches); the engine must have counted on the
    card and no kernel of ops/ld_kernels launched."""
    from ld_tools_tpu_torch import ld_triangle
    from ld_tools_tpu_torch.ops import engine
    from ld_tools_tpu_torch.ops import ld_kernels as lk

    lk.reset_launches()
    engine.reset_launches()
    stats = {}
    t0 = time.perf_counter()
    n = ld_triangle.main(["-S", src, "-D", data, "-t", out, "-E", "cuda",
                          *extra], stats)
    wall = time.perf_counter() - t0
    launches = engine.count_on_device.launches
    kernels = sum(_launches().values())
    check(launches > 0, f"ld_triangle ({tag}) never counted on the card")
    check(kernels == 0, f"ld_triangle ({tag}) launched {kernels} kernels")
    log(f"ld_triangle ({tag}, {' '.join(extra)}): {n} matrices in "
        f"{wall:.2f}s; engine launches {launches}; phases (summed over the "
        "threads) " + " ".join(f"{k}={v:.3f}" for k, v in stats.items()
                               if k != "matrices"))
    return n, wall, stats, launches


def phase_triangle(work, data, gp):
    """ld_triangle at chr21 width on the chr21 store: the 500- and
    2,000-rsID files with -o both -j on -p 3 threads (the per-cell path
    and the columnar heatmap), then the 10,000-rsID file with -o table
    (the streamed table over ResidentCounts).  Every row of the 500-row
    table and 200 sampled rows of each larger one must equal an f64
    recount from the store.  Returns the summary and the -E cuda run that
    the parity phase repeats with -E torch."""
    from ld_tools_tpu_torch.ingest import pack
    from ld_tools_tpu_torch.io import heatmap

    c1 = pack.popcounts(gp)

    def recount(i, j):
        return _recount(gp, i, j, c1)[0]

    src = os.path.join(work, "tri_src")
    _triangle_sources(src, ("t500", "t2000"), TRI_ROWS)
    out = os.path.join(work, "tri_out")
    extra = ("-o", "both", "-j", "-p", "3")
    n, wall, stats, launches = _run_triangle("chr21", src, data, out, extra)
    check(n == 2, f"ld_triangle built {n} matrices of 2")
    summary = {"both": dict(wall_s=wall, engine_launches=launches, **stats)}
    base = {k: os.path.join(out, f"{k}_LD_matr", f"{k}_chr21_r")
            for k in ("t500", "t2000")}
    cells = _check_triangle_tsv(base["t500"] + ".tsv", recount)
    cells += _check_triangle_tsv(base["t2000"] + ".tsv", recount,
                                 TRI_SAMPLED, seed=3)
    with open(base["t500"] + ".json") as fh:
        hover = json.load(fh)["data"][0]["hovertext"]
    check(len(hover) == 500 and "r2: " in hover[499][0],
          "the 500-row heatmap has no per-cell hover text")
    col = _figure(base["t2000"] + ".html")["columnar"]
    check(col["n"] == 2000 and col["qw"] == 2 and "freqq" in col,
          "the 2,000-row heatmap is not columnar with int16 codes")
    check(2000 > heatmap._HOVER_CELLS_MAX >= 500, "the hover cap moved")

    src_t = os.path.join(work, "tri_src_table")
    _triangle_sources(src_t, ("t10k",), TRI_ROWS)
    out_t = os.path.join(work, "tri_out_table")
    n, wall, stats, launches = _run_triangle("chr21", src_t, data, out_t,
                                             ("-o", "table"))
    check(n == 1 and launches == 5, f"the 10,000-row table: {n} matrices, "
          f"{launches} engine launches (5 row blocks of 2,048 expected)")
    summary["table"] = dict(wall_s=wall, engine_launches=launches, **stats)
    cells += _check_triangle_tsv(
        os.path.join(out_t, "t10k_LD_matr", "t10k_chr21_r.tsv"), recount,
        TRI_SAMPLED, seed=4)
    log(f"ld_triangle check: every row of the 500-row table and "
        f"{TRI_SAMPLED} rows of the 2,000- and 10,000-row tables ({cells} "
        "cells) equal the f64 recount")
    shutil.rmtree(out_t, ignore_errors=True)
    return summary, ("chr21 500 + 2,000", src, data, extra, out)


def _mixed_cols(data, pgroup):
    """Each ploidy profile's cohort columns in a chrX store (both
    genders, every population)."""
    from ld_tools_tpu_torch.tools.common import DataConfig

    cfg = DataConfig.resolve(data, True, "both", "all")
    cp = cfg.store().chrom("X").cohort_ploidy(cfg.sample_names)
    return [cp.cols_for(g) for g in range(int(pgroup.max()) + 1)]


def phase_triangle_x(work, data, gp, pgroup):
    """ld_triangle on the chrX store: 300 and 1,000 rsIDs straddling the
    first PAR bound, -o both: the grouped engine (mixed_pair_ld) on the
    per-cell path and the columnar heatmap with int32 codes and
    pair-dependent frequencies; 50 sampled rows of each table against a
    recount.  Returns the summary and the parity phase's run."""
    lo, _ = chrx_bounds(gp.shape[0])
    rows_of = {"x300": range(lo - 150, lo + 150),
               "x1000": range(lo - 500, lo + 500)}
    src = os.path.join(work, "tri_x_src")
    _triangle_sources(src, rows_of, rows_of)
    out = os.path.join(work, "tri_x_out")
    extra = ("-o", "both", "-p", "2")
    n, wall, stats, launches = _run_triangle("chrX", src, data, out, extra)
    check(n == 2, f"ld_triangle (chrX) built {n} matrices of 2")
    cols = _mixed_cols(data, pgroup)

    def recount(i, j):
        return _recount_mixed(gp, pgroup, cols, i, j)[0].astype(str)

    base = {k: os.path.join(out, f"{k}_LD_matr", f"{k}_chrX_r")
            for k in rows_of}
    cells = sum(_check_triangle_tsv(base[k] + ".tsv", recount, 50, seed=5)
                for k in rows_of)
    col = _figure(base["x1000"] + ".html")["columnar"]
    check(col["n"] == 1000 and col["qw"] == 4 and "f1q" in col,
          "the 1,000-row chrX heatmap is not columnar with int32 codes and "
          "pair frequencies")
    log(f"ld_triangle check (chrX): 50 sampled rows of each table ({cells} "
        "cells, inside and across the PAR bound) equal the recount")
    return (dict(wall_s=wall, engine_launches=launches, **stats),
            ("chrX 300 + 1,000", src, data, extra, out))


def _recount_mixed(gp, pgroup, cols, i, j):
    """Exact r^2 / D' strings and rounded r^2 of the pairs (i, j) of a
    mixed-ploidy store, from counts by the plain version on the card:
    each row's alleles in its profile's live columns ``cols[profile]``
    (the cohort's, sample-major, the second haplotype where diploid), the
    pair's lists cut to the shorter one and each side's alt count over
    its own list (calc_ld.py:30-44), then the port's f64 finish."""
    import torch

    from ld_tools_tpu_torch.ops.exact import (exact_ld_elementwise,
                                              format_rounded, round4)

    r2s = np.empty(len(i), dtype=object)
    dps = np.empty(len(i), dtype=object)
    r2r = np.empty(len(i))
    for ga in range(len(cols)):
        for gb in range(len(cols)):
            at = np.flatnonzero((pgroup[i] == ga) & (pgroup[j] == gb))
            if not at.size:
                continue
            A = np.unpackbits(gp[i[at]], axis=1, count=N_HAP)[:, cols[ga]]
            B = np.unpackbits(gp[j[at]], axis=1, count=N_HAP)[:, cols[gb]]
            m = min(A.shape[1], B.shape[1])
            ta = torch.from_numpy(A[:, :m]).to("cuda", torch.int32)
            tb = torch.from_numpy(B[:, :m]).to("cuda", torch.int32)
            cab = (ta * tb).sum(dim=1).cpu().numpy()
            ex = exact_ld_elementwise(cab, A.sum(axis=1), B.sum(axis=1), m,
                                      len1=A.shape[1], len2=B.shape[1])
            r2s[at] = format_rounded(ex.r_square, ex.r_square_is_int_zero)
            dps[at] = format_rounded(ex.d_prime, ex.d_prime_is_int_zero)
            rr = round4(ex.r_square)
            rr[ex.r_square_is_int_zero] = 0.0
            r2r[at] = rr
    return r2s, dps, r2r


def _check_mixed_hits(tag, path, data, gp, pos, pgroup, seed):
    """A mixed scan's TSV against :func:`_recount_mixed` (the cohort's
    columns of each profile from the store in ``data``): sampled hits
    inside the segments and across them (values), and sampled
    pairs across each boundary inside the window (a hit exactly when the
    rounded r^2 >= 0.8).  Returns (hits, hits across segments)."""
    cols = _mixed_cols(data, pgroup)
    v = gp.shape[0]
    lo, hi = chrx_bounds(v)
    i, j, r2s, dps = read_tsv(path, pos)
    check(len(i) > 0 and bool(np.all(i > j)), f"{tag}: hits")
    seg_i = np.searchsorted([lo, hi], i, side="right")
    seg_j = np.searchsorted([lo, hi], j, side="right")
    across = np.flatnonzero(seg_i != seg_j)
    check(across.size > 0, f"{tag}: no hit across the segments")
    rng = np.random.default_rng(seed)
    within = np.flatnonzero(seg_i == seg_j)
    pick = np.concatenate([
        rng.choice(within, size=min(2000, within.size), replace=False),
        rng.choice(across, size=min(2000, across.size), replace=False)])
    want_r2, want_dp, _ = _recount_mixed(gp, pgroup, cols, i[pick],
                                         j[pick])
    check(np.array_equal(want_r2.astype(str), r2s[pick]),
          f"{tag}: sampled hit r^2")
    check(np.array_equal(want_dp.astype(str), dps[pick]),
          f"{tag}: sampled hit D'")
    key = i * v + j
    a = np.concatenate([rng.integers(lo, lo + 300, size=2000),
                        rng.integers(hi, hi + 300, size=2000)])
    b = np.concatenate([rng.integers(lo - 300, lo, size=2000),
                        rng.integers(hi - 300, hi, size=2000)])
    _, _, r2r = _recount_mixed(gp, pgroup, cols, a, b)
    want = (r2r >= 0.8) & (np.abs(pos[a] - pos[b]) <= 1_000_000)
    is_hit = np.isin(a * v + b, key)
    check(np.array_equal(is_hit, want),
          f"{tag}: sampled pairs across the boundaries: "
          f"{int((is_hit != want).sum())} of {len(a)} disagree")
    log(f"mixed scan check ({tag}): {len(pick)} sampled hits (of "
        f"{len(i)}; {across.size} across the segments) and {len(a)} pairs "
        f"across the boundaries ({int(is_hit.sum())} hits) agree with the "
        "recount")
    return len(i), across.size


def phase_mixed_scan(work):
    """ld_scan on a chrX store of chr21's row count (102,400 variants x
    2,504 samples; males haploid outside the PAR bands: three ploidy
    segments) with -w 1000000, r^2 >= 0.8, in both resident layouts: the
    segments' scans must launch K5/K3 (int8) or K6/K4 (packed) only, the
    engine must count the cross-segment rectangles on the card, the two
    TSVs must be identical and hold the recount's hits.  Returns the
    summary and the store (its directory, packed rows and ploidy
    profiles of the rows), which the chrX triangle takes on."""
    from ld_tools_tpu_torch.ops import engine

    t0 = time.perf_counter()
    gp, pos, pgroup, profiles = chrx_dataset(N_VARIANTS, seed=23)
    data = os.path.join(work, "chrX")
    write_store(data, "X", gp, pos, seed=23, pgroup=pgroup,
                ploidy_profiles=profiles)
    log(f"data: chrX {gp.shape[0]} variants x {N_HAP // 2} samples "
        f"({int((profiles[1] == 1).sum())} haploid outside the PAR bands "
        f"{chrx_bounds(gp.shape[0])}), made and written in "
        f"{time.perf_counter() - t0:.1f}s")
    runs, bodies = {}, {}
    for tag, limit in (("int8", None), ("packed", "0")):
        if limit is not None:
            os.environ[LIMIT] = limit
        try:
            report, secs, launches = _run_scan(
                data, os.path.join(work, f"out_x_{tag}"),
                ("-w", "1000000"), chrom="X")
        finally:
            os.environ.pop(LIMIT, None)
        st = report.stats
        rects = engine.count_on_device.launches
        _log_scan(f"chrX, {tag}", report, secs, launches)
        check(st["segments"] == 3, f"chrX {tag}: {st['segments']} segments")
        check(st["resident_packed"] == (3.0 if limit else 0.0),
              f"chrX {tag}: {st['resident_packed']} packed segments")
        _check_layout_launches(f"chrX, {tag}", launches, packed=bool(limit))
        check(st["rects"] > 0 and rects == st["rects"],
              f"chrX {tag}: {st['rects']} rectangles, {rects} engine "
              "launches")
        log(f"mixed scan (chrX, {tag}): {st['segments']} segments, "
            f"{st['rects']} rectangles (engine launches {rects}): dispatch "
            f"{st['rect_dispatch_s']:.3f}s, finish {st['rect_finish_s']:.3f}s"
            f"; segments' count {st['count_s']:.3f}s, fetch "
            f"{st['fetch_s']:.3f}s; wall {secs:.2f}s")
        with open(report.path, "rb") as fh:
            bodies[tag] = fh.read()
        runs[tag] = dict(hits=report.n_hits, seconds=secs, stats=st,
                         engine_launches=rects,
                         launches={KERNELS.get(k, ("-",))[0] + " " + k: n
                                   for k, n in launches.items() if n})
    check(bodies["int8"] == bodies["packed"],
          "chrX: the packed layout's TSV differs from the int8 layout's")
    _, n_across = _check_mixed_hits(
        "chrX", os.path.join(work, "out_x_int8", "ld_scan_chrX_r_0.8.tsv"),
        data, gp, pos, pgroup, seed=9)
    runs["across_hits"] = n_across
    return runs, (data, gp, pgroup)


def phase_parity(work, triangle_runs):
    """-E cuda (both layouts) and -E torch on a small store: identical
    bytes; then ld_triangle's -E cuda runs (``triangle_runs``) again
    with -E torch: identical files."""
    from ld_tools_tpu_torch import ld_scan

    gp, pos = scan_dataset(N_PARITY, seed=5)
    data = os.path.join(work, "parity")
    write_store(data, "21", gp, pos, seed=5)
    bodies = {}
    for engine, limit in (("cuda", None), ("cuda", "0"), ("torch", None)):
        tag = engine + (" packed" if limit else "")
        out = os.path.join(work, f"parity_{engine}_{limit}")
        if limit is not None:
            os.environ[LIMIT] = limit
        try:
            t0 = time.perf_counter()
            (report,) = ld_scan.main(["-C", "21", "-D", data, "-t", out,
                                      "-z", "0.8", "-E", engine])
        finally:
            os.environ.pop(LIMIT, None)
        check(report.stats["tsv_native"] == 1, f"parity: -E {tag}: the "
              "TSV took the plain path "
              f"({report.stats.get('tsv_plain_reason')})")
        with open(report.path, "rb") as fh:
            bodies[tag] = fh.read()
        log(f"parity: -E {tag}: {report.n_hits} hits in "
            f"{time.perf_counter() - t0:.2f}s")
    check(bodies["cuda"] == bodies["torch"] == bodies["cuda packed"],
          "-E cuda and -E torch TSVs differ")
    check(bodies["cuda"].count(b"\n") > 2, "parity TSV holds no hits")
    log("parity: the -E cuda TSVs of both layouts are byte-identical to "
        "-E torch")
    _parity_area(work, data, gp.shape[0])
    datax = os.path.join(work, "parity_x")
    gpx, posx, pgx, profx = chrx_dataset(N_PARITY, seed=6)
    write_store(datax, "X", gpx, posx, seed=6, pgroup=pgx,
                ploidy_profiles=profx)
    _parity_mixed_scan(work, datax)
    lo, _ = chrx_bounds(N_PARITY)
    _parity_lite([(data, rsid_of(10), rsid_of(17)),
                  (datax, rsid_of(lo - 3), rsid_of(lo + 5))])
    for run in triangle_runs:
        _parity_triangle(*run)


def _parity_triangle(label, src, data, extra, cuda_out):
    """An ld_triangle -E cuda run's files against the same run with -E
    torch (the engine's plain counts on the CPU): byte for byte."""
    from ld_tools_tpu_torch import ld_triangle
    from ld_tools_tpu_torch.ops import engine

    out = cuda_out + "_torch"
    engine.reset_launches()
    t0 = time.perf_counter()
    ld_triangle.main(["-S", src, "-D", data, "-t", out, "-E", "torch",
                      *extra])
    secs = time.perf_counter() - t0
    check(engine.count_on_device.launches == 0,
          f"parity: ld_triangle -E torch ({label}) counted on the card")
    want, got = _tree(cuda_out), _tree(out)
    check(got == want and want, f"parity: ld_triangle ({label}): -E cuda "
          "and -E torch files differ")
    log(f"parity: ld_triangle ({label}, {' '.join(extra)}): {len(want)} "
        f"files ({sum(map(len, want.values())) / 1e6:.1f} MB), -E cuda "
        f"byte-identical to -E torch ({secs:.2f}s)")
    shutil.rmtree(out, ignore_errors=True)


def _parity_area(work, data, v):
    """ld_area, -E cuda against -E torch, in each file type: the same
    files byte for byte; the cuda runs count on the card."""
    from ld_tools_tpu_torch import ld_area
    from ld_tools_tpu_torch.ops import engine

    src = os.path.join(work, "parity_area_src")
    rows = _area_sources(src, v, v, 1)
    for file_type in ("tsv", "json", "rsids"):
        trees = {}
        for eng in ("cuda", "torch"):
            out = os.path.join(work, f"parity_area_{file_type}_{eng}")
            engine.reset_launches()
            ld_area.main(["-S", src, "-D", data, "-t", out, "-o", file_type,
                          "-E", eng])
            check((engine.count_on_device.launches > 0) == (eng == "cuda"),
                  f"parity: ld_area -E {eng} -o {file_type}: "
                  f"{engine.count_on_device.launches} engine launches")
            trees[eng] = _tree(out)
        check(trees["cuda"] == trees["torch"] and trees["cuda"],
              f"parity: ld_area -o {file_type}: -E cuda and -E torch "
              "files differ")
        log(f"parity: ld_area -o {file_type} ({len(rows)} queries): "
            f"{len(trees['cuda'])} files, -E cuda byte-identical to "
            "-E torch")


def _parity_mixed_scan(work, datax):
    """The chrX scan, -E cuda against -E torch: the same TSV bytes."""
    from ld_tools_tpu_torch import ld_scan
    from ld_tools_tpu_torch.ops import engine

    bodies = {}
    for eng in ("cuda", "torch"):
        engine.reset_launches()
        (report,) = ld_scan.main(["-C", "X", "-D", datax, "-t",
                                  os.path.join(work, f"parity_x_{eng}"),
                                  "-z", "0.8", "-E", eng])
        check(report.stats["rects"] > 0 and (
            engine.count_on_device.launches > 0) == (eng == "cuda"),
            f"parity: chrX scan -E {eng}: {report.stats['rects']} "
            f"rectangles, {engine.count_on_device.launches} engine launches")
        check(report.stats["tsv_native"] == 1, f"parity: chrX scan -E {eng}"
              f": the TSV took the plain path "
              f"({report.stats.get('tsv_plain_reason')})")
        with open(report.path, "rb") as fh:
            bodies[eng] = fh.read()
    check(bodies["cuda"] == bodies["torch"] and bodies["cuda"].count(b"\n")
          > 2, "parity: the chrX scan's -E cuda and -E torch TSVs differ")
    log(f"parity: chrX scan ({report.stats['segments']} segments, "
        f"{report.stats['rects']} rectangles): -E cuda byte-identical to "
        "-E torch")


def _parity_lite(pairs):
    """ld_lite, -E cuda against -E torch, on each (data dir, rsID, rsID):
    the rendered table where tabulate is installed, else the query's
    values and annotations (everything the table shows)."""
    import importlib.util

    from ld_tools_tpu_torch import ld_lite
    from ld_tools_tpu_torch.cli.ld_lite_cli_en import add_args_en
    from ld_tools_tpu_torch.tools import lite

    render = importlib.util.find_spec("tabulate") is not None
    log("parity: tabulate " + ("installed: ld_lite's tables are compared"
                               if render else "not installed: ld_lite's "
                               "query values are compared, its table is "
                               "not rendered"))
    for data, a, b in pairs:
        got = {}
        for eng in ("cuda", "torch"):
            args = add_args_en(ld_lite.__version__, [a, b, "-D", data,
                                                     "-E", eng])
            got[eng] = lite.run(args) if render else lite.pair_query(args)
        check(got["cuda"] == got["torch"],
              f"parity: ld_lite {a} {b}: -E cuda and -E torch differ")
        vals = (lite.pair_query(args)["trg_vals"] if render
                else got["cuda"]["trg_vals"])
        log(f"parity: ld_lite {a} {b} ({os.path.basename(data)}): -E cuda "
            f"equals -E torch: {vals}")


def _run_module(module, *args, timeout=600, env=None):
    """``python -m module args`` from the repository root, as a user runs
    it (``env``: variables to add); it must exit 0.  Returns (stdout,
    stderr, the JSON launch report it prints on stderr: the counts of its
    own process, which start at 0 and are read at its end)."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here, **(env or {}))
    cmd = f"python -m {module} {' '.join(args)}".strip()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=here,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)
    check(proc.returncode == 0, f"{cmd} exited {proc.returncode}:\n"
          f"{proc.stderr[-3000:]}")
    reports = [json.loads(ln) for ln in proc.stderr.splitlines()
               if ln.startswith('{"launches"')]
    check(len(reports) == 1, f"{cmd} printed {len(reports)} launch reports")
    log(f"bench: {cmd}: exit 0 in {time.perf_counter() - t0:.1f}s")
    return proc.stdout, proc.stderr, reports[0]


def _only_launched(cmd, launches, sites):
    """The run launched each of ``sites`` and nothing else."""
    for site, n in launches.items():
        if site in sites:
            check(n > 0, f"{cmd} never launched {site}")
        else:
            check(n == 0, f"{cmd} launched {site} {n} times")


SUITE_CONFIGS = "5,1,3,2,6,6c"
SUITE_ROWS = [
    "5_batch_8chrom", "1_ld_lite_pair", "1b_ld_lite_pair_warm",
    "3_ld_area_50q_250kb", "3_ld_area_50q_250kb_warm",
    "2_ld_triangle_500_eur", "2b_ld_triangle_500_eur_warm",
    "6_triangle_10k_table", "6_triangle_10k_table_warm",
    "6b_hover_percell_2000_microbench",
    "6b_hover_percell_2000_microbench_warm",
    "6c_heatmap_columnar_10k", "6c_heatmap_columnar_10k_warm"]


def phase_bench(work, results):
    """The port's measurement entry points, as subprocesses: the headline
    sweep (its one JSON line, bench.py's keys), the K8 stage split (its
    launch counts are K8's on its path), the fast triangle variants and
    suite configs 5, 1, 3, 2, 6 and 6c (their artifact; the engine's
    launches in each tool row).  Returns the headline record."""
    out, err, rep = _run_module("ld_tools_tpu_torch.bench")
    lines = out.strip().splitlines()
    check(len(lines) == 1, f"the headline printed {len(lines)} lines")
    head = json.loads(lines[0])
    check(set(head) == {"metric", "value", "unit", "vs_baseline", "spread"},
          f"headline keys {sorted(head)}")
    check(head["metric"] ==
          "ld_triangle_allpairs_r2_variant_pairs_per_sec_per_chip"
          and head["unit"] == "pairs/s", "headline metric")
    check(np.isfinite(head["value"]) and head["value"] > 0, "headline value")
    _only_launched("the headline", rep["launches"], {"ld_triangle_blocks"})
    for ln in err.splitlines():
        if ln.startswith(("device:", "roofline:")):
            log(f"  {ln}")
    log(f"headline: {lines[0]}")

    out, _, rep = _run_module("ld_tools_tpu_torch.bench.microkernels")
    rows = out.strip().splitlines()
    check([r.split()[0] for r in rows] == list(STAGES),
          f"microkernels printed {rows}")
    _only_launched("bench.microkernels", rep["launches"], {"ld_stage_blocks"})
    for stage, row in zip(STAGES, rows):
        ms = float(row.split()[1])
        check(np.isfinite(ms) and ms > 0, f"stage {stage}: {row}")
        results[_stage_kernel(stage)]["launches"] = \
            rep["stages"][stage]["launches"]
        log(f"  {row}")

    out, _, rep = _run_module("ld_tools_tpu_torch.bench.kernels", "--only",
                              "fast")
    rows = out.strip().splitlines()
    check(len(rows) == 3, f"bench.kernels --only fast printed {rows}")
    _only_launched("bench.kernels --only fast", rep["launches"],
                   {"ld_triangle_blocks", "ld_triangle_blocks_packed"})
    for row in rows:
        log(f"  {row}")

    art = os.path.join(work, "suite.json")
    _, _, rep = _run_module("ld_tools_tpu_torch.bench.suite", "--configs",
                            SUITE_CONFIGS, "--out", art, timeout=900)
    # config 5's default kernel="dense": one unpack on the card, then K1;
    # configs 1 (ld_lite), 3 (ld_area), 2, 6 and 6c (ld_triangle) count
    # through the engine
    _only_launched(f"bench.suite --configs {SUITE_CONFIGS}", rep["launches"],
                   {"ld_triangle_blocks"})
    with open(art) as fh:
        rows = json.load(fh)["results"]
    check([r["config"] for r in rows] == SUITE_ROWS
          and all(r["seconds"] > 0 for r in rows),
          f"suite artifact rows {rows}")
    by = {r["config"]: r for r in rows}
    check(rep["engine"] > 0 and by["3_ld_area_50q_250kb"]["engine_launches"]
          > 0 and by["3_ld_area_50q_250kb"]["files"] > 0,
          f"suite config 3 on the card: {by['3_ld_area_50q_250kb']}, engine "
          f"launches {rep['engine']}")
    for row in rows:
        if not row["config"].startswith(("5_", "1")):
            check(row["engine_launches"] > 0, f"suite {row['config']} never "
                  "counted on the card")
    check(by["2_ld_triangle_500_eur"]["matrices"] == 1,
          f"suite config 2: {by['2_ld_triangle_500_eur']}")
    for row in rows:
        log(f"  suite: {json.dumps(row)}")
    return head


# the launch sites of the smoke artifact's configurations: K1 (int8 rows,
# and packed rows unpacked on the card by plain tensor shifts), K2, K3, K4,
# K5 and K6
SMOKE_SITES = {"ld_triangle_blocks", "ld_triangle_blocks_packed",
               "ld_band_sweep_blocks", "ld_band_sweep_blocks_packed",
               "ld_band_count", "ld_band_count_packed"}
SCALING_MESHES = [1, 2, 4, 8]
WG_SCALE = "2,0.5"  # config wg cut to 2 chromosomes, 0.5 GiB of BGZF
WG_RERUN_S = 5.0   # the re-prep is a no-op
WG_WINDOW_ROWS = 2000  # 100 kb at the fixture's 50 bp spacing


def _check_wg_tsv(chrom, data, path, seed):
    """One chromosome's scan TSV of config wg against an f64 recount from
    the store: sampled hits' strings, and sampled pairs in the window
    (and just past it) are hits exactly when their rounded f64 r^2 >= 0.8
    and they lie in the window."""
    from ld_tools_tpu_torch.ingest import pack
    from ld_tools_tpu_torch.ingest.store import ChromData

    cd = ChromData(data, chrom)
    gp, pos = cd.packed, np.asarray(cd.pos)
    c1 = pack.popcounts(gp)
    v = gp.shape[0]
    i, j, r2s, dps = read_tsv(path, pos)
    check(len(i) > 0, f"wg chr{chrom}: no hits")
    check(bool(np.all(i > j)) and bool(np.all(pos[i] - pos[j] <= 100_000)),
          f"wg chr{chrom}: hits must have i > j and lie in the window")
    key = np.sort(i * v + j)
    check(bool(np.all(np.diff(key) > 0)), f"wg chr{chrom}: duplicate hits")
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(i), size=min(3000, len(i)), replace=False)
    want_r2, want_dp, _ = _recount(gp, i[pick], j[pick], c1)
    check(np.array_equal(want_r2, r2s[pick]), f"wg chr{chrom}: hit r^2")
    check(np.array_equal(want_dp, dps[pick]), f"wg chr{chrom}: hit D'")
    a = rng.integers(WG_WINDOW_ROWS + 8, v, size=6000)
    b = np.concatenate([a[:3000] - rng.integers(1, 8, size=3000),
                        a[3000:] - rng.integers(1, WG_WINDOW_ROWS + 8,
                                                size=3000)])
    _, _, r2_round = _recount(gp, a, b, c1)
    want = (r2_round >= 0.8) & (pos[a] - pos[b] <= 100_000)
    is_hit = np.isin(a * v + b, key)
    check(np.array_equal(is_hit, want),
          f"wg chr{chrom}: {int((is_hit != want).sum())} of {len(a)} sampled "
          "pairs disagree with the f64 recount")
    log(f"  wg chr{chrom}: {len(i)} hits; {len(pick)} hits and {len(a)} "
        f"pairs ({int(is_hit.sum())} hits among them) agree with the f64 "
        "recount")


def phase_measure(work):
    """The measurement scripts, as subprocesses: the kernel smoke artifact
    (17 configurations, every one ok, launches from K1-K6 only), the
    scaling model (its measured block finite and positive; K5 launched),
    the sharded-scan scaling at its card defaults (four mesh sizes, each
    row's distinct cards, equal hits; K5 and K3, K7 past one shard) and
    suite config wg at WG_SCALE (its rows, hits, the re-prep a no-op, K5
    and K3 launched, each chromosome's TSV against an f64 recount).
    Returns their records."""
    import torch

    from ld_tools_tpu_torch.bench.smoke import NAMES

    out = {}
    art = os.path.join(work, "smoke.json")
    _, _, rep = _run_module("ld_tools_tpu_torch.bench.smoke", "--out", art)
    _only_launched("bench.smoke", rep["launches"], SMOKE_SITES)
    with open(art) as fh:
        smoke = json.load(fh)
    rows = smoke["results"]
    check([r["config"] for r in rows] == NAMES and all(r["ok"] for r in rows)
          and smoke["failures"] == 0, f"bench.smoke artifact {rows}")
    errs = {r["config"]: r.get("max_abs_err_vs_f32_order") for r in rows}
    f32_errs = [e for n, e in errs.items() if e is not None and "meas" not in n]
    out["smoke"] = {"max_f32_err": max(f32_errs),
                    "max_meas_err": max(e for n, e in errs.items()
                                        if "meas" in n),
                    "seconds": sum(r["seconds"] for r in rows),
                    "launches": {k: n for k, n in rep["launches"].items() if n}}
    for r in rows:
        log(f"  smoke: {json.dumps(r)}")
    log(f"  smoke: 17 configurations ok, largest f32 error "
        f"{out['smoke']['max_f32_err']:.3g} (meas {out['smoke']['max_meas_err']:.3g}); "
        f"launches {out['smoke']['launches']}")

    art = os.path.join(work, "scaling_model.json")
    _, _, rep = _run_module("ld_tools_tpu_torch.bench.scaling_model", "--out",
                            art)
    _only_launched("bench.scaling_model", rep["launches"], {"ld_band_count"})
    with open(art) as fh:
        model = json.load(fh)
    meas = model["measured"]
    for k in ("dispatch_s", "h2d_MBps", "d2h_MBps", "count_call_fixed_s",
              "count_device_gpairs_s"):
        check(np.isfinite(meas[k]) and meas[k] > 0, f"scaling model {k}: "
              f"{meas[k]}")
    check(meas["count_blocks_measured"] == 136, f"scaling model {meas}")
    chr21 = model["models"]["chr21_scan"]
    effs = {f"{link}/{phase}": [chr21[link][phase][str(n)]["efficiency"]
                                for n in (2, 4, 8)]
            for link in ("relay", "direct", "multihost_direct")
            for phase in ("cold", "warm_resident")}
    out["scaling_model"] = {"measured": meas, "chr21_eff_2_4_8": effs,
                            "launches": rep["launches"]["ld_band_count"]}
    log(f"  scaling model: measured {json.dumps(meas)}")
    log(f"  scaling model: chr21 efficiency at 2/4/8 {json.dumps(effs)}")

    stdout, _, rep = _run_module("ld_tools_tpu_torch.bench.scaling",
                                 timeout=900)
    _only_launched("bench.scaling", rep["launches"],
                   {"ld_band_count", "ld_band_count_sharded",
                    "ld_band_sweep_blocks"})
    rows = [json.loads(ln) for ln in stdout.splitlines()
            if ln.startswith('{"devices"')]
    check([r["devices"] for r in rows] == SCALING_MESHES,
          f"bench.scaling rows {rows}")
    check(rows[0]["hits"] > 0 and len({r["hits"] for r in rows}) == 1,
          f"bench.scaling hits {[r['hits'] for r in rows]}")
    cards = torch.cuda.device_count()
    for r in rows:
        count = "ld_band_count" if r["devices"] == 1 else "ld_band_count_sharded"
        check(r["launches"].get(count, 0) > 0
              and r["launches"].get("ld_band_sweep_blocks", 0) > 0,
              f"bench.scaling at {r['devices']} shards launched "
              f"{r['launches']}")
        # n shards on the first n cards, else n on the first card
        check(r["cards"] == (r["devices"] if r["devices"] <= cards else 1),
              f"bench.scaling at {r['devices']} shards on {cards} card(s) "
              f"says cards {r['cards']}")
        log(f"  scaling: {json.dumps(r)}")
    out["scaling"] = rows

    art = os.path.join(work, "suite_wg.json")
    keep = os.path.join(work, "wg")
    _, _, rep = _run_module(
        "ld_tools_tpu_torch.bench.suite", "--configs", "wg", "--out", art,
        timeout=900, env={"TPU_LD_WG_SCALE": WG_SCALE, "TPU_LD_WG_DIR": keep})
    _only_launched("bench.suite --configs wg", rep["launches"],
                   {"ld_band_count", "ld_band_sweep_blocks",
                    "gather_rows_device"})
    with open(art) as fh:
        rows = json.load(fh)["results"]
    by = {r["config"]: r for r in rows}
    check([r["config"] for r in rows] == [
        "wg_prep_5gb", "wg_prep_5gb_rerun", "wg_scan_100kb",
        "wg_e2e_prep_plus_scan"], f"suite wg rows {rows}")
    scan = by["wg_scan_100kb"]
    check(scan["hits"] > 0 and scan["device"] == "cuda"
          and scan["launches"].get("ld_band_count", 0) > 0
          and scan["launches"].get("ld_band_sweep_blocks", 0) > 0,
          f"suite wg scan {scan}")
    check(by["wg_prep_5gb_rerun"]["seconds"] < WG_RERUN_S,
          f"suite wg re-prep {by['wg_prep_5gb_rerun']}")
    (data,) = [os.path.join(keep, n) for n in os.listdir(keep)]
    for k, chrom in enumerate(sorted(scan["chroms"])):
        check(not scan["chroms"][chrom]["resident_packed"],
              f"suite wg chr{chrom} ran packed: {scan}")
        _check_wg_tsv(chrom, data, os.path.join(
            data, "scan_out", f"ld_scan_chr{chrom}_r_0.8.tsv"), seed=k)
    shutil.rmtree(keep, ignore_errors=True)
    for r in rows:
        log(f"  suite: {json.dumps(r)}")
    out["wg"] = rows
    return out


def main():
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import ld_tools_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script: {exc}",
              file=sys.stderr)
        return 2
    os.environ.pop(LIMIT, None)  # the scans below run at the default limit
    torch.backends.cuda.matmul.allow_tf32 = False  # exact f32 plain counts

    kind, smi = phase_device()
    build = phase_build()
    gp, pos = scan_dataset(N_VARIANTS, seed=4)
    log(f"data: {gp.shape[0]} variants x {N_HAP} haplotypes "
        f"({time.perf_counter() - t_start:.1f}s so far)")
    results = {}
    g1, gq1 = triangle_rows()
    phase_triangles(results, g1, gq1)
    phase_stage(results, g1)
    del g1, gq1
    phase_ragged(gp, pos, results)
    phase_scan_shapes(gp, pos, results)
    gather = phase_gather(gp)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        scan, stores = phase_scan(work, gp, pos, results)
        area = phase_area(work, stores["chr21"], gp, pos)
        triangle, tri_run = phase_triangle(work, stores["chr21"], gp)
        sharded = phase_sharded(work, stores, gp, pos, results)
        entry = phase_entry()
        mixed, (datax, gpx, pgx) = phase_mixed_scan(work)
        triangle["chrX"], tri_run_x = phase_triangle_x(work, datax, gpx, pgx)
        del gpx, pgx
        phase_parity(work, [tri_run, tri_run_x])
        shutil.rmtree(stores["chr21"], ignore_errors=True)
        shutil.rmtree(datax, ignore_errors=True)
        del stores
        torch.cuda.empty_cache()  # the bench processes share the card
        headline = phase_bench(work, results)
        measure = phase_measure(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    kernels = []
    for name, (tag, replaces) in KERNELS.items():
        r = results[name]
        check(r.get("launches", 0) >= 1, f"{name} was never launched on its "
              "path")
        kernels.append(dict(
            name=name, tag=tag, route="cuda",
            source=(COUNT_SOURCE if tag in ("K5", "K6", "K7") else
                    BLOCK_SOURCE),
            replaces=replaces, launches=r["launches"],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], int_mm_ms=r["int_mm_ms"],
            roofline_share=r["bound_ms"] / r["ms"],
            path=r["path"], shape=r["shape"], **r.get("extra", {}),
        ))
    # the gather (replaces no TPU kernel): launches on the 1.1M scan's
    # path (the full panel, packed), its time and bound there in one
    # launch over the chromosome, and the cohort's int8 gather beside it
    g = results[GATHER]
    check(g["launches"] >= 1, f"{GATHER} was never launched on its path")
    r, c = gather["full panel, packed"], gather["cohort, int8"]
    kernels.append(dict(
        name=GATHER, tag="gather", route="cuda", source=GATHER_SOURCE,
        replaces=None, launches=g["launches"], max_abs_err=0.0, ms=r["ms"],
        plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
        bound_by=r["bound_by"], library_ms=None, int_mm_ms=None,
        roofline_share=r["bound_ms"] / r["ms"], path=g["path"],
        shape=[r["rows"], r["src_bytes"], r["out_width"]],
        cohort=dict(ms=c["ms"], plain_ms=c["plain_ms"],
                    bound_ms=c["bound_ms"], bound_by=c["bound_by"],
                    roofline_share=c["roofline_share"],
                    shape=[c["rows"], c["src_bytes"], c["out_width"]]),
    ))
    log(f"total: {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"build_s": build["seconds"], "gather": gather,
                      "scan": scan,
                      "area": area, "triangle": triangle,
                      "mixed_scan": mixed, "sharded": sharded,
                      "entry": entry, "headline": headline,
                      "measure": measure},
                     default=float))
    # the build's per-instance resources again, past the long phases
    print(json.dumps({"ptxas": build["ptxas"], "sass": build["sass"]}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:] == ["--sweep-worker"]:  # a rank of phase_sharded's
            sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
            sys.exit(sweep_worker())
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
