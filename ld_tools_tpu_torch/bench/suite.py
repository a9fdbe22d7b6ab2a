"""Benchmark suite: the BASELINE configs the port can run, with a JSON
artifact (the counterpart of scripts/bench_suite.py).

    python -m ld_tools_tpu_torch.bench.suite [--configs 0,4,5]
        [--out FILE.json] [--device cuda|cpu]

Each config prints one labelled line and adds rows to the artifact
(``--out``); the headline metric stays in ``python -m
ld_tools_tpu_torch.bench``.

Ported configs:
0.  ingest: the native BGZF scanner (the port's ``ingest.native``),
    single vs multi-thread.
4.  chr21 scale: a 102,400 x 5,008 streamed threshold scan (r^2 >= 0.8),
    cold and warm (resident cache), without (4) and with (4b) the exact
    f64 finish.
4c. chr2 scale: the same scan at 204,800 variants, exact.
5.  multi-chromosome batch: 8 chromosomes of 8,192 variants through
    ``ld_triangle_matrix_packed`` (fast r^2), round-robin over the
    processes of a ``torch.distributed`` group (one process: all 8).

Not ported, and refused rather than skipped: 1, 2, 3, 6 and 6c run the
ld_lite / ld_triangle / ld_area tools (ROADMAP queue 6); 0gb and wg, the
GB-scale ingest and the whole-genome prep and scan, are measurement work
still to port (ROADMAP queue 9).

Sizes are the module constants below, so a test can shrink them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from ld_tools_tpu_torch.bench import common
from ld_tools_tpu_torch.utils.device import resolve_device

CONFIG0_SAMPLES = 2504
CONFIG0_VARIANTS = 6000
CONFIG4_VARIANTS = 102_400
CONFIG4C_VARIANTS = 204_800
CONFIG5_CHROMS = 8
CONFIG5_VARIANTS = 8192
SCAN_RUN = 64  # rows per run of identical base rows in the scan data


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


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


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
    _sync(dev)
    t0 = time.perf_counter()
    total_pairs = 0
    for gp in packed_by_chrom:
        triangle(gp)
        _sync(dev)
        total_pairs += V * (V + 1) / 2
    dt = time.perf_counter() - t0
    gpps = total_pairs / dt / 1e9
    print(f"config5 {CONFIG5_CHROMS}-chromosome batch ({len(mine)} in this "
          f"process): {dt:.1f}s, {gpps:.1f} Gpairs/s")
    rec.record("5_batch_8chrom", dt, gpairs_per_s=round(gpps, 2),
               chroms_on_host=len(mine), device=dev.type)


def _not_ported(key, what, queue):
    def config(rec, dev):
        raise NotImplementedError(
            f"suite config {key} ({what}) is not ported yet "
            f"(ROADMAP queue {queue})")
    return config


CONFIGS = {
    "0": config0,
    "1": _not_ported("1", "the ld_lite tool", 6),
    "2": _not_ported("2", "the ld_triangle tool", 6),
    "3": _not_ported("3", "the ld_area tool", 6),
    "4": config4,
    "4c": config4c,
    "5": config5,
    "6": _not_ported("6", "the ld_triangle tool", 6),
    "6c": _not_ported("6c", "the ld_triangle heatmap", 6),
    "0gb": _not_ported("0gb", "GB-scale ingest", 9),
    "wg": _not_ported("wg", "whole-genome prep and scan", 9),
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
                    help=f"comma list of configs ({', '.join(CONFIGS)}); "
                         "the default runs the ported ones but 4c")
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
    common.log_launches()
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"meta": meta, "results": rec.rows}, fh, indent=1)
        print(f"wrote {args.out}")
    return rec.rows


if __name__ == "__main__":
    main()
