#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (ld_tools_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on any failure:

1. device   the card's name and power limit (nvidia-smi);
2. build    nvcc compiles csrc/ld_kernels.cu for sm_90a (every instance);
3. kernels  each kernel against its plain PyTorch version on the card, at
            the shapes the scan and the headline sweep give it (640-row
            blocks, W = 5,120 int8 haplotypes or 640 packed bytes, a ragged
            row count, monomorphic rows): the triangle kernel on int8 rows
            (K1), its bf16 and tf32 routes (K1b) and its bit-plane form on
            the packed bytes (K2); the band sweep (K3) and its bit-plane
            form (K4); the fused count pass (K5) and its bit-plane form
            (K6), in both mask modes, both measures, with and without the
            distance window.  Every bit-plane and K1b output must equal its
            int8 twin's bit for bit (K2 = K1, K1b = K1, K4 = K3, K6 = K5).
            Pass-1 counts against pass-2 hits in both mask modes and both
            resident layouts.  Per kernel its time, the plain version's,
            the least time the card could take, and torch._int_mm over the
            same int8 block products as a yardstick the port never calls;
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
            f64 recount of sampled hits and pairs;
5. parity   a 10,240-variant store: the -E cuda TSVs of both layouts must
            be byte-identical to the -E torch TSV (plain versions, CPU);
6. bench    the port's measurement entry points, each as ``python -m``
            must exit 0: the headline sweep (``ld_tools_tpu_torch.bench``,
            one JSON line with bench.py's metric and keys), the K8 stage
            split (``bench.microkernels``: K8's launches on its path), the
            fast triangle variants (``bench.kernels --only fast``) and
            suite config 5 with its artifact.  Each reports its own launch
            counts, and each must have launched its kernels and no other.

K8 (the staged triangle kernel, ``ld_stage_blocks``: K1's kernel at four
epilogues) is held against its plain version at every stage in phase 3,
at V = 10,240 with 512-row blocks and on the ragged rows, and timed
there.  So are K1 at the 512- and 1,024-row blocks and K2 at the
1,024-row blocks that ``bench.kernels --only fast`` launches.

It ends with a JSON line of the build time, the scans' phases and launch
counts and the headline record, a ``kernels`` JSON line, the nvidia-smi line and, last, the
device JSON line.  It needs the repository around it and a CUDA card.
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
SOURCE = "ld_tools_tpu_torch/csrc/ld_kernels.cu"
PALLAS = "ld_tools_tpu/ops/ld_pallas.py"
# K8's stages (ops/ld_kernels.STAGES) and block (bench_microkernels.py's)
STAGES = ("counts", "scale", "fast", "exact")
STAGE_BLOCK = 512
# the other (route, block) pairs ``bench.kernels --only fast`` launches
BENCH_BLOCKS = (("ld_triangle_kernel", 512), ("ld_triangle_kernel", 1024),
                ("ld_triangle_kernel<FORM_BITS>", 1024))


def _stage_kernel(stage):
    """K8 at one stage: K1's kernel with epilogue EPI_<STAGE>."""
    return f"ld_triangle_kernel/EPI_{stage.upper()}"


# kernel name -> (its tag in ROADMAP.md, the TPU kernel it replaces)
KERNELS = {
    "ld_triangle_kernel": ("K1", f"{PALLAS}:259"),
    "ld_triangle_kernel<FORM_BF16>": ("K1b", f"{PALLAS}:292"),
    "ld_triangle_kernel<FORM_TF32>": ("K1b", f"{PALLAS}:292"),
    "ld_triangle_kernel<FORM_BITS>": ("K2", f"{PALLAS}:303"),
    "ld_band_sweep_kernel": ("K3", f"{PALLAS}:747"),
    "ld_band_sweep_kernel<FORM_BITS>": ("K4", f"{PALLAS}:693"),
    "ld_band_count_kernel": ("K5", f"{PALLAS}:909"),
    "ld_band_count_kernel<FORM_BITS>": ("K6", f"{PALLAS}:949"),
    **{_stage_kernel(s): ("K8", "scripts/bench_microkernels.py:76")
       for s in STAGES},
}
# launch site (ops/ld_kernels.py) -> the kernel it launches
KERNEL_OF_SITE = {
    "ld_triangle_blocks": "ld_triangle_kernel",
    "ld_triangle_blocks_bf16": "ld_triangle_kernel<FORM_BF16>",
    "ld_triangle_blocks_tf32": "ld_triangle_kernel<FORM_TF32>",
    "ld_triangle_blocks_packed": "ld_triangle_kernel<FORM_BITS>",
    "ld_band_sweep_blocks": "ld_band_sweep_kernel",
    "ld_band_sweep_blocks_packed": "ld_band_sweep_kernel<FORM_BITS>",
    "ld_band_count": "ld_band_count_kernel",
    "ld_band_count_packed": "ld_band_count_kernel<FORM_BITS>",
    "ld_stage_blocks": "ld_triangle_kernel/EPI_*",  # one of the four
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


def write_store(d, chrom, gp, pos, seed):
    """A prepared-looking data directory: samples.txt + the packed store
    (the port's ingest copies), so prep builds conversion.db offline."""
    from ld_tools_tpu_torch.ingest import pack, synth

    panel = synth.make_panel(N_HAP // 2, np.random.default_rng(seed))
    os.makedirs(d, exist_ok=True)
    synth.write_panel(os.path.join(d, "samples.txt"), panel)
    v = gp.shape[0]
    pack.write_chrom(
        d, chrom, pos=pos, rsid=[f"rs{100_000 + i}" for i in range(v)],
        ref=["A"] * v, alt=["G"] * v, vt=["SNP"] * v,
        samples=[row[0] for row in panel], genotypes_packed=gp,
        n_haplotypes=N_HAP,
    )


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
    # the kernel's name and template argument beside them
    kernel = "?"
    for ln in info["log"].splitlines():
        m = re.search(r"Compiling entry function '.*?\d(ld_[a-z_]+?_kernel)"
                      r"ILi(\d+)E", ln)
        if m:
            kernel = f"{m.group(1)}<{m.group(2)}>"
        elif "registers" in ln or "spill" in ln:
            log(f"  ptxas {kernel}: {ln.strip()}")
    return info["seconds"]


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
        "ld_triangle_kernel": (lk.ld_triangle_blocks,
                               lk.ld_triangle_blocks_plain, False,
                               H100_INT8_OPS),
        "ld_triangle_kernel<FORM_BF16>": (lk.ld_triangle_blocks_bf16,
                                          lk.ld_triangle_blocks_bf16_plain,
                                          False, H100_BF16_FLOPS),
        "ld_triangle_kernel<FORM_TF32>": (lk.ld_triangle_blocks_tf32,
                                          lk.ld_triangle_blocks_tf32_plain,
                                          False, H100_TF32_FLOPS),
        "ld_triangle_kernel<FORM_BITS>": (lk.ld_triangle_blocks_packed,
                                          lk.ld_triangle_blocks_packed_plain,
                                          True, H100_INT8_OPS),
    }


def _check_triangle(name, g, gq, c1, ipq, cij, what, block=BLOCK):
    """A triangle route against its plain version on the ``block``-row
    blocks ``cij``, fast and exact epilogues, D' on and off, and against
    K1 (its int8 twin) bit for bit; the largest abs error against the
    plain version.  ``g`` holds the int8 rows, ``gq`` the same rows
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
            check(torch.equal(a, t), f"{tag}: differs from K1")
        del got, ref, twin
    return err


def triangle_rows():
    """The headline sweep's rows (bench.py): V = 10,240 random rows with
    monomorphic and near-monomorphic ones, as int8 (V, 5,120) and packed
    (V, 640) tensors on the card."""
    import torch

    rng = np.random.default_rng(0)
    v1 = N_TRIANGLE
    freqs = rng.uniform(0.05, 0.95, size=(v1, 1))
    G1 = (rng.random((v1, N_HAP)) < freqs).astype(np.int8)
    G1[1] = 0
    G1[2] = 1
    G1[3] = 0
    G1[3, 9] = 1
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
    out = (torch.empty((v1, v1), dtype=torch.float32, device=dev), None)
    G1_dev = g1[:, :N_HAP].contiguous()
    gp1_dev = gq1[:, :N_HAP // 8].contiguous()
    # each route's entry point: (its name, the call)
    paths = {
        "ld_triangle_kernel": ("ld_triangle_matrix", lambda: (
            lk.ld_triangle_matrix(G1_dev, N_HAP, **fast))),
        "ld_triangle_kernel<FORM_BF16>": (
            "ld_triangle_matrix(mxu_dtype=bfloat16)",
            lambda: lk.ld_triangle_matrix(G1_dev, N_HAP,
                                          mxu_dtype="bfloat16", **fast)),
        "ld_triangle_kernel<FORM_TF32>": (
            "ld_triangle_matrix(mxu_dtype=float32)",
            lambda: lk.ld_triangle_matrix(G1_dev, N_HAP,
                                          mxu_dtype="float32", **fast)),
        "ld_triangle_kernel<FORM_BITS>": (
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
        log(f"{KERNELS[name][0]} {name}: {ms:.3f} ms, plain {plain_ms:.3f} "
            f"ms, bound {b[0]:.3f} ms ({b[1]}), torch._int_mm {mm1:.3f} ms, "
            f"max abs err {err:.3g}")
    del out, r2_k1
    for name, block in BENCH_BLOCKS:
        bi, bj = lk._triangle_coords(v1 // block)
        cij = torch.from_numpy(lk.pack_block_coords(bi, bj)).to(dev)
        e = _check_triangle(name, g1, gq1, c1, ipq, cij, f"V={v1}", block)
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], e)
    log(f"K1 at blocks 512 and 1024, K2 at 1024: equal the plain versions "
        f"(V={v1})")
    torch.cuda.empty_cache()


def _check_stage(stage, g, c1, ipq, cij, what):
    """K8 at one stage against its plain version on the blocks ``cij``:
    counts bit for bit, f32 values within 1e-6; the largest abs error."""
    import torch

    from ld_tools_tpu_torch.ops import ld_kernels as lk

    kw = dict(block=STAGE_BLOCK, stage=stage)
    got = lk.ld_stage_blocks(g, c1, ipq, cij, N_HAP, **kw)
    ref = lk.ld_stage_blocks_plain(g, c1, ipq, cij, N_HAP, **kw)
    torch.cuda.synchronize()
    if stage == "counts":
        check(torch.equal(got, ref), f"K8 counts {what}: differ in "
              f"{int((got != ref).sum())} cells")
        return 0.0
    e = float((got - ref).abs().max())
    check(e <= 1e-6, f"K8 {stage} {what}: max abs err {e}")
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
    # the triangle routes on the same rows: the last block row is partial
    for name in _triangle_routes():
        e = _check_triangle(name, g, gq, c1r, ipqr, cij, f"V={n_rows}")
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], e)
    for name, block in BENCH_BLOCKS:
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
    hit = torch.cat([cij[:20], cij[-20:]])  # the last holds partial blocks
    err = {"ld_band_sweep_kernel": 0.0, "ld_band_sweep_kernel<FORM_BITS>": 0.0}
    for outs, sel in ((("cab",), 0), (("cab", "r2", "dp", "meas"), 0),
                      (("meas",), 1)):
        kw = dict(outs=outs, sel=sel, block_m=BLOCK, block_n=BLOCK)
        vecs = (c1r, c1r, ipqr, ipqr, hit, N_HAP)
        got3 = lk.ld_band_sweep_blocks(g, g, *vecs, **kw)
        got4 = lk.ld_band_sweep_blocks_packed(gq, gq, *vecs, **kw)
        ref3 = lk.ld_band_sweep_blocks_plain(g, g, *vecs, **kw)
        ref4 = lk.ld_band_sweep_blocks_packed_plain(gq, gq, *vecs, **kw)
        for name, got, ref in (("ld_band_sweep_kernel", got3, ref3),
                               ("ld_band_sweep_kernel<FORM_BITS>", got4,
                                ref4)):
            for o in outs:
                if o == "cab":
                    check(torch.equal(got[o], ref[o]), f"{name} cab differs")
                else:
                    e = float((got[o] - ref[o]).abs().max())
                    err[name] = max(err[name], e)
                    check(e <= 1e-6, f"{name} {o} sel={sel}: max abs err {e}")
        for o in outs:
            check(torch.equal(got4[o], got3[o]), f"K4 {o} differs from K3")
    for name, e in err.items():
        results[name] = dict(max_abs_err=e)
    log("K3, K4: every output equals the plain versions; K4 = K3 bit for bit")
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
    diag = int((bi == bj).sum())
    cells5 = (nb5 - diag) * BLOCK * BLOCK + diag * BLOCK * (BLOCK - 1) // 2
    rows5 = -(-v // BLOCK) * BLOCK

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
        b = bound(2 * cells5 * N_HAP, rows5 * (res.g.shape[1] + 12) + 8 * nb5)
        results[name] = dict(
            max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b[0],
            bound_by=b[1], library_ms=None, int_mm_ms=mm5,
            path="ld_scan (pass 1)",
            shape=f"{nb5} blocks of {BLOCK}x{BLOCK}, W={res.g.shape[1]} "
                  f"{'bytes' if res.packed else 'int8'}, integer mask")
        log(f"{KERNELS[name][0]} {name}: {ms:.3f} ms, plain {plain_ms:.3f} "
            f"ms, bound {b[0]:.3f} ms ({b[1]}), torch._int_mm {mm5:.3f} ms "
            f"({nb5} blocks)")
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
            ("ld_band_sweep_kernel", rd, lk.ld_band_sweep_blocks,
             lk.ld_band_sweep_blocks_plain),
            ("ld_band_sweep_kernel<FORM_BITS>", rp,
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
    check(torch.equal(cab["ld_band_sweep_kernel"],
                      cab["ld_band_sweep_kernel<FORM_BITS>"]),
          "K4 main-path cab differs from K3's")
    del rd, rp, cab, counts
    torch.cuda.empty_cache()


def _run_scan(data_dir, out_dir, extra=()):
    from ld_tools_tpu_torch import ld_scan
    from ld_tools_tpu_torch.ops import ld_kernels as lk

    argv = ["-C", "21", "-D", data_dir, "-t", out_dir, "-z", "0.8",
            "-E", "cuda", *extra]
    lk.reset_launches()
    t0 = time.perf_counter()
    (report,) = ld_scan.main(argv)
    secs = time.perf_counter() - t0
    launches = {KERNEL_OF_SITE[fn.__name__]: fn.launches
                for fn in lk.LAUNCH_SITES}
    return report, secs, launches


def _log_scan(tag, report, secs, launches):
    st = report.stats
    phases = ("host_prep_s", "upload_s", "count_s", "fetch_s", "finish_s",
              "write_s")
    # the rest: data prep checks, the store's load, the cohort columns
    st["rest_s"] = secs - sum(st[k] for k in phases)
    ran = {KERNELS[k][0]: n for k, n in launches.items() if n}
    log(f"scan ({tag}): {report.n_hits} hits in {secs:.2f}s; phases "
        + " ".join(f"{k}={st[k]:.3f}" for k in phases + ("rest_s",))
        + f"; blocks {st['blocks']}, hit blocks {st['hit_blocks']}, "
        f"resident {'packed' if st['resident_packed'] else 'int8'} "
        f"{st['resident_bytes'] / 1e6:.1f} MB, resident hit "
        f"{st['resident_hit']:.0f}; launches {ran}")
    check(st["blocks_checked"] == st["hit_blocks"],
          "pass 2 did not check every hit block against pass 1")


def _check_layout_launches(tag, launches, packed):
    """The run launched the count and sweep kernels of its layout only."""
    want = ("<FORM_BITS>" if packed else "")
    for kind in ("ld_band_count_kernel", "ld_band_sweep_kernel"):
        mine, other = kind + want, kind + ("" if packed else "<FORM_BITS>")
        check(launches[mine] > 0, f"scan ({tag}) never launched {mine}")
        check(launches[other] == 0,
              f"scan ({tag}) launched {other} {launches[other]} times")


def _recount(gp, i, j):
    """f64 exact r^2 / D' strings and rounded r^2 for pairs (i, j), from
    popcounts of the packed genotypes (the port's exact finisher)."""
    from ld_tools_tpu_torch.ingest import pack
    from ld_tools_tpu_torch.ops.exact import (exact_ld_elementwise,
                                              format_rounded, round4)

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
    for name in ("ld_band_count_kernel", "ld_band_sweep_kernel"):
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
    shutil.rmtree(data, ignore_errors=True)

    # (b) the slice at full size, at the default limit
    t0 = time.perf_counter()
    gpf, posf = scan_dataset(N_VARIANTS_FULL, seed=22, run=RUN_FULL)
    data = os.path.join(work, "chr_full")
    write_store(data, "21", gpf, posf, seed=22)
    setup_s = time.perf_counter() - t0
    log(f"data: {gpf.shape[0]} variants x {N_HAP} haplotypes, runs of "
        f"{RUN_FULL}, made and written in {setup_s:.1f}s")
    check(LIMIT not in os.environ, f"{LIMIT} must be unset (default 4 GiB)")
    report, secs, launches = _run_scan(data, os.path.join(work, "out_full"),
                                       ("-w", "1000000"))
    _log_scan("1.1M, window", report, secs, launches)
    st = report.stats
    check(st["resident_packed"] == 1.0,
          "auto must keep a 1.1M-variant chromosome packed")
    # v_pad: V (a multiple of the 7,680-row chunk) and one chunk more
    check(st["resident_bytes"] == (N_VARIANTS_FULL + 7680) * W_PACKED,
          f"resident bytes {st['resident_bytes']}")
    _check_layout_launches("1.1M, window", launches, packed=True)
    for name in ("ld_band_count_kernel<FORM_BITS>",
                 "ld_band_sweep_kernel<FORM_BITS>"):
        results[name]["launches"] = launches[name]
        results[name]["path"] += (f", launches from the {N_VARIANTS_FULL}-"
                                  "variant -w 1000000 scan")
    _check_hits("1.1M, window", report.path, gpf, posf, RUN_FULL, 1_000_000,
                seed=2)
    runs["full_size_window"] = (report, secs, launches)
    shutil.rmtree(data, ignore_errors=True)
    return {tag: dict(hits=r.n_hits, seconds=s, stats=r.stats,
                      launches={KERNELS[k][0] + " " + k: n
                                for k, n in l.items() if n})
            for tag, (r, s, l) in runs.items()}


def phase_parity(work):
    """-E cuda (both layouts) and -E torch on a small store: identical
    bytes."""
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
        with open(report.path, "rb") as fh:
            bodies[tag] = fh.read()
        log(f"parity: -E {tag}: {report.n_hits} hits in "
            f"{time.perf_counter() - t0:.2f}s")
    check(bodies["cuda"] == bodies["torch"] == bodies["cuda packed"],
          "-E cuda and -E torch TSVs differ")
    check(bodies["cuda"].count(b"\n") > 2, "parity TSV holds no hits")
    log("parity: the -E cuda TSVs of both layouts are byte-identical to "
        "-E torch")


def _run_module(module, *args, timeout=600):
    """``python -m module args`` from the repository root, as a user runs
    it; it must exit 0.  Returns (stdout, stderr, the JSON launch report
    it prints on stderr: the counts of its own process, which start at 0
    and are read at its end)."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
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


def phase_bench(work, results):
    """The port's measurement entry points, as subprocesses: the headline
    sweep (its one JSON line, bench.py's keys), the K8 stage split (its
    launch counts are K8's on its path), the fast triangle variants and
    suite config 5 (its artifact).  Returns the headline record."""
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
                            "5", "--out", art)
    # config 5's default kernel="dense": one unpack on the card, then K1
    _only_launched("bench.suite --configs 5", rep["launches"],
                   {"ld_triangle_blocks"})
    with open(art) as fh:
        (row,) = json.load(fh)["results"]
    check(row["config"] == "5_batch_8chrom" and row["seconds"] > 0,
          f"suite artifact row {row}")
    log(f"  suite: {json.dumps(row)}")
    return head


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
    build_s = phase_build()
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
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        scan = phase_scan(work, gp, pos, results)
        phase_parity(work)
        torch.cuda.empty_cache()  # the bench processes share the card
        headline = phase_bench(work, results)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    kernels = []
    for name, (tag, replaces) in KERNELS.items():
        r = results[name]
        check(r.get("launches", 0) >= 1, f"{name} was never launched on its "
              "path")
        kernels.append(dict(
            name=name, tag=tag, route="cuda", source=SOURCE,
            replaces=replaces, launches=r["launches"],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], int_mm_ms=r["int_mm_ms"],
            path=r["path"], shape=r["shape"],
        ))
    log(f"total: {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"build_s": build_s, "scan": scan,
                      "headline": headline}, default=float))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
