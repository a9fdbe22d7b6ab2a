#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (ld_tools_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on any failure:

1. device   the card's name and power limit (nvidia-smi);
2. build    nvcc compiles csrc/ld_kernels.cu for sm_90a;
3. kernels  each kernel against its plain PyTorch version on the card, at
            the shapes the scan and the headline sweep give it (640-row
            blocks, W = 5,120, a ragged row count, monomorphic rows): the
            triangle kernel (K1), the band sweep (K3) and the fused count
            pass (K5) in both mask modes, both measures, with and without
            the distance window; pass-1 counts against pass-2 hits in both
            mask modes; per kernel its time, the plain version's, the
            least time the card could take, and torch._int_mm over the
            same int8 block products as a yardstick the port never calls;
4. scan     the ld_scan tool (ld_tools_tpu_torch.ld_scan.main, what
            ``python -m ld_tools_tpu_torch.ld_scan`` runs) on a chr21-scale
            store of 102,400 variants x 5,008 haplotypes written by the
            port's own ingest, once without and once with -w 1000000, with
            the launch counts read around each run, the hits held against
            an f64 recount of sampled pairs, and the windowed hits held
            against the unwindowed ones;
5. parity   a 10,240-variant store: the -E cuda TSV must be byte-identical
            to the -E torch TSV (plain versions on the CPU).

It ends with a JSON line of the build time and the scans' phases and
launch counts, a ``kernels`` JSON line, the nvidia-smi line and, last, the
device JSON line.  It needs the repository around it and a CUDA card.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

H100_INT8_OPS = 1979e12  # dense int8 tensor-core peak, H100 SXM data sheet
H100_HBM_BYTES = 3.35e12  # HBM3 bytes per second, H100 SXM data sheet
# chr21 scale: scripts/bench_suite.py, config 4b_chr21_scan_100k_exact
N_VARIANTS = 102_400
N_HAP = 5008
BLOCK = 640
SOURCE = "ld_tools_tpu_torch/csrc/ld_kernels.cu"
REPLACES = {
    "ld_triangle_kernel": "ld_tools_tpu/ops/ld_pallas.py:259",
    "ld_band_sweep_kernel": "ld_tools_tpu/ops/ld_pallas.py:747",
    "ld_band_count_kernel": "ld_tools_tpu/ops/ld_pallas.py:909",
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


def bound(ops, nbytes):
    """(ms, "operations" or "bytes"): the larger of int8 tensor-core time
    and HBM time at the card's published peaks."""
    t_ops = ops / H100_INT8_OPS * 1e3
    t_bytes = nbytes / H100_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def scan_dataset(v, seed):
    """scripts/bench_suite.py:_scan_dataset: blocks of 64 identical rows
    with 2% flip noise, positions over 46 Mb; the store's packed bytes."""
    rng = np.random.default_rng(seed)
    blk = 64
    base = (
        rng.random((v // blk, N_HAP))
        < rng.uniform(0.05, 0.95, size=(v // blk, 1))
    ).astype(np.int8)
    G = np.repeat(base, blk, axis=0)
    G = np.where(rng.random(G.shape) < 0.02, 1 - G, G).astype(np.int8)
    pos = np.sort(rng.choice(46_000_000, size=v, replace=False)).astype(
        np.int64)
    return np.packbits(G.astype(np.uint8), axis=1), pos


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
    regs = [ln.strip() for ln in info["log"].splitlines()
            if "registers" in ln or "spill" in ln]
    log(f"build: nvcc {info['seconds']:.1f}s -> {_cuda_build.LIB}")
    for ln in regs:
        log(f"  ptxas: {ln}")
    return info["seconds"]


def _check_rows(gp_host, pos, n_rows):
    """A ragged (n_rows) slice of the chromosome with monomorphic (all 0,
    all 1) and near-monomorphic rows, as the scan's device tensors."""
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
    return G, res


def _check_triangle(g, c1, ipq, cij, what):
    """K1 against its plain version on the blocks ``cij`` of ``g``, fast
    and exact epilogues, D' on and off; the largest abs error."""
    import torch

    from ld_tools_tpu_torch.ops import ld_kernels as lk

    err = 0.0
    for epi, want_dp in (("fast", False), ("exact", True), ("exact", False)):
        kw = dict(epilogue=epi, want_dprime=want_dp, block_m=BLOCK,
                  block_n=BLOCK)
        got = lk.ld_triangle_blocks(g, c1, ipq, cij, N_HAP, **kw)
        ref = lk.ld_triangle_blocks_plain(g, c1, ipq, cij, N_HAP, **kw)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            if b is None:
                check(a is None, "K1 returned D' it was not asked for")
                continue
            e = float((a - b).abs().max())
            err = max(err, e)
            check(e <= 1e-6, f"K1 {what} {epi}/dp={want_dp}: max abs err {e}")
        del got, ref
    return err


def phase_kernels(gp_host, pos, results):
    """Every kernel against its plain version on the card; timings."""
    import torch

    from ld_tools_tpu_torch.ops import ld_kernels as lk
    from ld_tools_tpu_torch.ops import ld_stream as ls

    torch.backends.cuda.matmul.allow_tf32 = False  # exact f32 plain counts
    dev = torch.device("cuda")
    W = 5120

    # K1: the headline triangle sweep, V = 10,240 random rows (bench.py)
    rng = np.random.default_rng(0)
    v1 = 10240
    freqs = rng.uniform(0.05, 0.95, size=(v1, 1))
    G1 = (rng.random((v1, N_HAP)) < freqs).astype(np.int8)
    G1[1] = 0
    G1[2] = 1
    G1[3] = 0
    G1[3, 9] = 1
    g1 = torch.zeros((v1, W), dtype=torch.int8, device=dev)
    g1[:, :N_HAP] = torch.from_numpy(G1).to(dev)
    c1 = g1.to(torch.float32).sum(dim=1)
    ipq = lk._ipq_from_counts(c1, torch.tensor(float(N_HAP), device=dev))
    bi, bj = lk._triangle_coords(v1 // BLOCK)
    cij1 = torch.from_numpy(lk.pack_block_coords(bi, bj)).to(dev)
    kw1 = dict(block_m=BLOCK, block_n=BLOCK)
    err1 = _check_triangle(g1, c1, ipq, cij1, f"V={v1}")
    out = (torch.empty((v1, v1), dtype=torch.float32, device=dev), None)
    fast = dict(epilogue="fast", want_dprime=False, **kw1)
    ms1 = cuda_ms(lambda: lk.ld_triangle_blocks(g1, c1, ipq, cij1, N_HAP,
                                                out=out, **fast), reps=20)
    plain1 = cuda_ms(lambda: lk.ld_triangle_blocks_plain(
        g1, c1, ipq, cij1, N_HAP, **fast), reps=2)
    del out

    def int_mm_rows(g, nb):
        for k in range(nb):
            torch._int_mm(g[k * BLOCK:(k + 1) * BLOCK],
                          g[:(k + 1) * BLOCK].t())

    mm1 = cuda_ms(lambda: int_mm_rows(g1, v1 // BLOCK), reps=5)
    n1 = len(bi)
    b1 = bound(2 * n1 * BLOCK * BLOCK * N_HAP,
               v1 * W + 8 * v1 + 4 * n1 + 4 * n1 * BLOCK * BLOCK)
    # the triangle sweep as its own path: launches counted around it
    lk.reset_launches()
    r2, _ = lk.ld_triangle_matrix(g1[:, :N_HAP].contiguous(), N_HAP,
                                  block_m=BLOCK, block_n=BLOCK,
                                  epilogue="fast", want_dprime=False)
    torch.cuda.synchronize()
    check(torch.isfinite(r2).all(), "K1 path: non-finite r^2")
    launches1 = lk.ld_triangle_blocks.launches
    check(launches1 == 1, f"K1 path launched {launches1} times")
    del r2, g1
    results["ld_triangle_kernel"] = dict(
        launches=launches1, max_abs_err=err1, ms=ms1, plain_ms=plain1,
        bound_ms=b1[0], bound_by=b1[1], library_ms=None, int_mm_ms=mm1,
        path="triangle sweep, V=10240 (ld_triangle_matrix)",
        shape=f"{n1} blocks of {BLOCK}x{BLOCK}, W={W}, fast epilogue")
    log(f"K1 ld_triangle_kernel: {ms1:.3f} ms, plain {plain1:.3f} ms, "
        f"bound {b1[0]:.3f} ms ({b1[1]}), torch._int_mm {mm1:.3f} ms, "
        f"max abs err {err1:.3g}")

    # K5, K1 and K3 on a ragged slice with monomorphic rows, every mode
    n_rows = 10_000
    Gc, rc = _check_rows(gp_host, pos, n_rows)
    g, c1r, ipqr, posr = (rc.g[:n_rows], rc.c1[:n_rows], rc.ipq[:n_rows],
                          rc.pos[:n_rows])
    nbc = -(-n_rows // BLOCK)
    bi, bj = np.tril_indices(nbc)
    cij = torch.from_numpy(lk.pack_block_coords(bi, bj)).to(dev)
    thres = 0.8 - 5e-4
    for exact_mask in (True, False):
        for sel in (0, 1):
            for use_dist in (False, True):
                kw = dict(sel=sel, exact_mask=exact_mask, use_dist=use_dist,
                          block_m=BLOCK, block_n=BLOCK)
                got = lk.ld_band_count(
                    g, c1r, ipqr, posr, cij, (N_HAP, 1_000_000), (thres,),
                    packed=False, **kw)
                ref = lk.ld_band_count_plain(
                    g, c1r, ipqr, posr, cij, N_HAP, 1_000_000, thres, **kw)
                check(torch.equal(got, ref),
                      f"K5 exact_mask={exact_mask} sel={sel} "
                      f"dist={use_dist}: counts differ in "
                      f"{int((got != ref).sum())} blocks")
                check(int(got.sum()) > 0, "K5 check kept nothing")
    # K1 on the same ragged rows: the last block row is partial
    err1 = max(err1, _check_triangle(g, c1r, ipqr, cij, f"V={n_rows}"))
    results["ld_triangle_kernel"]["max_abs_err"] = err1
    err3 = 0.0
    hit = torch.cat([cij[:20], cij[-20:]])  # the last holds partial blocks
    for outs, sel in ((("cab",), 0), (("cab", "r2", "dp", "meas"), 0),
                      (("meas",), 1)):
        got = lk.ld_band_sweep_blocks(g, g, c1r, c1r, ipqr, ipqr, hit, N_HAP,
                                      outs=outs, sel=sel, block_m=BLOCK,
                                      block_n=BLOCK)
        ref = lk.ld_band_sweep_blocks_plain(g, g, c1r, c1r, ipqr, ipqr, hit,
                                            N_HAP, outs=outs, sel=sel,
                                            block_m=BLOCK, block_n=BLOCK)
        for o in outs:
            if o == "cab":
                check(torch.equal(got[o], ref[o]), "K3 cab differs")
            else:
                e = float((got[o] - ref[o]).abs().max())
                err3 = max(err3, e)
                check(e <= 1e-6, f"K3 {o} sel={sel}: max abs err {e}")
    # pass-1 counts against pass-2 hits, both mask modes, on the card
    for max_hap in (ls._EXACT_MASK_MAX_HAP, 0):
        saved = ls._EXACT_MASK_MAX_HAP
        ls._EXACT_MASK_MAX_HAP = max_hap
        try:
            for measure in ("r_square", "d_prime"):
                hits = ls.stream_threshold_scan(
                    Gc, pos=pos[:n_rows], measure=measure, thres=0.8,
                    max_dist=1_000_000, device="cuda")
                st = hits.stats
                check(st["blocks_checked"] == st["hit_blocks"] > 0,
                      f"pass 2 checked {st['blocks_checked']} of "
                      f"{st['hit_blocks']} hit blocks")
        finally:
            ls._EXACT_MASK_MAX_HAP = saved
    log(f"pass-1 counts == pass-2 hits per block: integer and f32 masks, "
        f"r^2 and D' ({n_rows} ragged rows)")
    del rc, g, c1r, ipqr, posr

    # K5 and K3 at the main path's shapes: the chromosome's count pass
    # and its batch of hit blocks
    res = ls.prepare_resident(gp_host, N_HAP, pos, "cuda", packed=True)
    v = gp_host.shape[0]
    bi, bj = ls._scan_blocks(v, pos, BLOCK, None)
    cij = torch.from_numpy(lk.pack_block_coords(bi, bj)).to(dev)
    kw5 = dict(sel=0, exact_mask=True, use_dist=False, block_m=BLOCK,
               block_n=BLOCK)

    def count():
        return lk.ld_band_count(res.g, res.c1, res.ipq, res.pos, cij,
                                (N_HAP, 0), (thres,), packed=False, **kw5)

    def count_plain():
        return lk.ld_band_count_plain(res.g, res.c1, res.ipq, res.pos, cij,
                                      N_HAP, 0, thres, **kw5)

    counts = count()
    ref = count_plain()
    check(torch.equal(counts, ref), "K5 main-path counts differ from plain")
    ms5 = cuda_ms(count, reps=3)
    plain5 = cuda_ms(count_plain, reps=1, warmup=0)
    del ref
    mm5 = cuda_ms(lambda: int_mm_rows(res.g, -(-v // BLOCK)), reps=1)
    nb5 = len(bi)
    diag = int((bi == bj).sum())
    cells5 = (nb5 - diag) * BLOCK * BLOCK + diag * BLOCK * (BLOCK - 1) // 2
    rows5 = -(-v // BLOCK) * BLOCK
    b5 = bound(2 * cells5 * N_HAP, rows5 * (W + 12) + 8 * nb5)
    results["ld_band_count_kernel"] = dict(
        max_abs_err=0.0, ms=ms5, plain_ms=plain5, bound_ms=b5[0],
        bound_by=b5[1], library_ms=None, int_mm_ms=mm5,
        path="ld_scan (pass 1)",
        shape=f"{nb5} blocks of {BLOCK}x{BLOCK}, W={W}, integer mask")
    log(f"K5 ld_band_count_kernel: {ms5:.3f} ms, plain {plain5:.3f} ms, "
        f"bound {b5[0]:.3f} ms ({b5[1]}), torch._int_mm {mm5:.3f} ms "
        f"({nb5} blocks)")

    hit_idx = torch.nonzero(counts > 0).reshape(-1)
    per_batch = ls._FETCH_CELLS_PER_BATCH // (BLOCK * BLOCK)
    hit_cij = cij[hit_idx[:per_batch]].contiguous()
    nb3 = hit_cij.shape[0]
    check(nb3 > 0, "the main path has no hit blocks")
    kw3 = dict(outs=("cab",), sel=0, block_m=BLOCK, block_n=BLOCK)
    args3 = (res.g, res.g, res.c1, res.c1, res.ipq, res.ipq, hit_cij, N_HAP)
    got = lk.ld_band_sweep_blocks(*args3, **kw3)
    ref = lk.ld_band_sweep_blocks_plain(*args3, **kw3)
    check(torch.equal(got["cab"], ref["cab"]), "K3 main-path cab differs")
    del got, ref
    ms3 = cuda_ms(lambda: lk.ld_band_sweep_blocks(*args3, **kw3), reps=5)
    plain3 = cuda_ms(lambda: lk.ld_band_sweep_blocks_plain(*args3, **kw3),
                     reps=1)
    hb = hit_cij.to(torch.int64).cpu().numpy()

    def int_mm_blocks():
        for code in hb:
            r, c = (code >> 16) * BLOCK, (code & 0xFFFF) * BLOCK
            torch._int_mm(res.g[r:r + BLOCK], res.g[c:c + BLOCK].t())

    mm3 = cuda_ms(int_mm_blocks, reps=3)
    rows3 = len(set((hb >> 16).tolist()) | set((hb & 0xFFFF).tolist()))
    b3 = bound(2 * nb3 * BLOCK * BLOCK * N_HAP,
               rows3 * BLOCK * (W + 8) + 4 * nb3 + 4 * nb3 * BLOCK * BLOCK)
    results["ld_band_sweep_kernel"] = dict(
        max_abs_err=err3, ms=ms3, plain_ms=plain3, bound_ms=b3[0],
        bound_by=b3[1], library_ms=None, int_mm_ms=mm3,
        path="ld_scan (pass 2)",
        shape=f"{nb3} hit blocks of {BLOCK}x{BLOCK}, W={W}, outs=cab")
    log(f"K3 ld_band_sweep_kernel: {ms3:.3f} ms, plain {plain3:.3f} ms, "
        f"bound {b3[0]:.3f} ms ({b3[1]}), torch._int_mm {mm3:.3f} ms "
        f"({nb3} blocks), max abs err {err3:.3g}")
    del res
    torch.cuda.empty_cache()


def _run_scan(data_dir, out_dir, extra=()):
    from ld_tools_tpu_torch import ld_scan

    argv = ["-C", "21", "-D", data_dir, "-t", out_dir, "-z", "0.8",
            "-E", "cuda", *extra]
    t0 = time.perf_counter()
    (report,) = ld_scan.main(argv)
    return report, time.perf_counter() - t0


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


def phase_scan(work, gp, pos, results):
    from ld_tools_tpu_torch.ops import ld_kernels as lk

    v = gp.shape[0]
    data = os.path.join(work, "chr21")
    write_store(data, "21", gp, pos, seed=21)
    runs = {}
    for tag, extra in (("full", ()), ("window", ("-w", "1000000"))):
        out = os.path.join(work, f"out_{tag}")
        lk.reset_launches()
        report, secs = _run_scan(data, out, extra)
        launches = {fn.__name__: fn.launches for fn in lk.LAUNCH_SITES}
        st = report.stats
        phases = ("host_prep_s", "upload_s", "count_s", "fetch_s",
                  "finish_s", "write_s")
        # the rest: data prep checks, the store's load, the cohort columns
        st["rest_s"] = secs - sum(st[k] for k in phases)
        log(f"scan ({tag}): {report.n_hits} hits in {secs:.2f}s; phases "
            + " ".join(f"{k}={st[k]:.3f}" for k in phases + ("rest_s",))
            + f"; blocks {st['blocks']}, hit blocks {st['hit_blocks']}, "
            f"resident hit {st['resident_hit']:.0f}; launches {launches}")
        check(launches["ld_band_count"] > 0, "the scan never launched K5")
        check(launches["ld_band_sweep_blocks"] > 0,
              "the scan never launched K3")
        check(st["blocks_checked"] == st["hit_blocks"],
              "pass 2 did not check every hit block against pass 1")
        runs[tag] = (report, secs, launches)
    full, _, launches = runs["full"]
    results["ld_band_count_kernel"]["launches"] = launches["ld_band_count"]
    results["ld_band_sweep_kernel"]["launches"] = (
        launches["ld_band_sweep_blocks"])

    i, j, r2s, dps = read_tsv(full.path, pos)
    # every pair inside a 64-row block of identical base rows is a
    # candidate; nothing else can reach r^2 = 0.8
    within = (v // 64) * 64 * 63 // 2
    check(0.2 * within <= len(i) <= within,
          f"{len(i)} hits is implausible for {within} correlated pairs")
    check(bool(np.all(i > j)), "hits must have i > j")
    key = np.sort(i * v + j)
    check(bool(np.all(np.diff(key) > 0)), "duplicate hits")
    rng = np.random.default_rng(1)
    pick = rng.choice(len(i), size=min(3000, len(i)), replace=False)
    want_r2, want_dp, _ = _recount(gp, i[pick], j[pick])
    check(np.array_equal(want_r2, r2s[pick]), "sampled hit r^2 strings")
    check(np.array_equal(want_dp, dps[pick]), "sampled hit D' strings")
    # sampled pairs in general: inside a 64-block, neighbouring blocks,
    # anywhere; each is a hit exactly when its rounded f64 r^2 >= 0.8
    a = rng.integers(1, v, size=9000)
    b = np.concatenate([
        a[:3000] - rng.integers(1, 64, size=3000),
        a[3000:6000] - rng.integers(1, 256, size=3000),
        rng.integers(0, v, size=3000),
    ])
    ok = (b >= 0) & (b < a)
    a, b = a[ok], b[ok]
    _, _, r2_round = _recount(gp, a, b)
    is_hit = np.isin(a * v + b, key)
    check(np.array_equal(is_hit, r2_round >= 0.8),
          f"sampled pairs: {int((is_hit != (r2_round >= 0.8)).sum())} of "
          f"{len(a)} disagree with the f64 recount")
    log(f"scan check: {len(pick)} hits and {len(a)} pairs "
        f"({int(is_hit.sum())} hits among them) agree with the f64 recount")

    wi, wj, wr2, wdp = read_tsv(runs["window"][0].path, pos)
    near = np.abs(pos[i] - pos[j]) <= 1_000_000
    check(np.array_equal(wi, i[near]) and np.array_equal(wj, j[near])
          and np.array_equal(wr2, r2s[near]) and np.array_equal(wdp, dps[near]),
          "the -w 1000000 hits are not the full hits within 1 Mb")
    log(f"scan check: -w 1000000 gives exactly the {len(wi)} full-scan hits "
        f"within 1 Mb")
    return {tag: dict(hits=r.n_hits, seconds=s, stats=r.stats,
                      launches=l) for tag, (r, s, l) in runs.items()}


def phase_parity(work):
    """-E cuda and -E torch on a 10,240-variant store: identical bytes."""
    from ld_tools_tpu_torch import ld_scan

    gp, pos = scan_dataset(10_240, seed=5)
    data = os.path.join(work, "parity")
    write_store(data, "21", gp, pos, seed=5)
    bodies = {}
    for engine in ("cuda", "torch"):
        out = os.path.join(work, f"parity_{engine}")
        t0 = time.perf_counter()
        (report,) = ld_scan.main(["-C", "21", "-D", data, "-t", out,
                                  "-z", "0.8", "-E", engine])
        with open(report.path, "rb") as fh:
            bodies[engine] = fh.read()
        log(f"parity: -E {engine}: {report.n_hits} hits in "
            f"{time.perf_counter() - t0:.2f}s")
    check(bodies["cuda"] == bodies["torch"],
          "-E cuda and -E torch TSVs differ")
    check(bodies["cuda"].count(b"\n") > 2, "parity TSV holds no hits")
    log("parity: -E cuda TSV is byte-identical to -E torch")


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

    kind, smi = phase_device()
    build_s = phase_build()
    gp, pos = scan_dataset(N_VARIANTS, seed=4)
    log(f"data: {gp.shape[0]} variants x {N_HAP} haplotypes "
        f"({time.perf_counter() - t_start:.1f}s so far)")
    results = {}
    phase_kernels(gp, pos, results)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        scan = phase_scan(work, gp, pos, results)
        phase_parity(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    kernels = []
    for name in ("ld_triangle_kernel", "ld_band_sweep_kernel",
                 "ld_band_count_kernel"):
        r = results[name]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
            launches=r.get("launches", 0), max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            int_mm_ms=r["int_mm_ms"], path=r["path"], shape=r["shape"],
        ))
    log(f"total: {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"build_s": build_s, "scan": scan}, default=float))
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
