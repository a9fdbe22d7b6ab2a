"""Headline benchmark: all-pairs r^2 variant-pairs/sec/chip (the
counterpart of the repository's bench.py).

    python -m ld_tools_tpu_torch.bench                # on the card
    python -m ld_tools_tpu_torch.bench --device cpu   # plain versions

Configuration (bench.py's): V = 10,240 variants x 5,008 haplotypes,
640-row blocks, the lower-triangle sweep of K1 (``ld_triangle_blocks``,
int8 tensor cores) with the divide-free r^2 epilogue, fed from the
store's bitpacked rows through one ``unpack_rows_device``.  The baseline
is the pure-Python per-pair kernel of the reference's calc_ld
(``bench/oracle.py``) on the same 5,008-haplotype vectors.

Timing (``utils.profiling.sweep_seconds``, CUDA events): n sweeps cycle
over 4 different datasets, each sweep's alt counts jittered by a seed so
no two sweeps or runs share inputs; per-sweep time = (T(20) - T(4)) / 16,
the minimum over 3 timed runs of each, after one untimed run.  Each
sweep's work is what ``_ld_triangle_call`` does per call: the 1/(p*q)
vector of the jittered counts, then the kernel.  The output matrix is one
(V, V) f32 buffer allocated outside the timed runs (the kernel writes the
lower-triangle blocks; the rest is never touched, as the TPU kernel
leaves it).  A sample is kept only when it is slower than 0.95x the
speed of light (bench.py's FLOP count at the card's int8 peak) and
T(20) > 1.05 T(4); 5 samples, at most 9 attempts, and if every attempt
is implausible it raises.  The value is the median sample.

Prints ONE JSON line, bench.py's:
  {"metric": ..., "value": N, "unit": "pairs/s", "vs_baseline": N,
   "spread": {...}}
The device (name, power limit), the roofline and the kernel launch
counts go to stderr.  There is no CPU fallback: without a card the run
fails unless ``--device cpu`` asks for the plain versions (V = 1,024,
3 timed repetitions, as bench.py's CPU mode).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ld_tools_tpu_torch.bench import common
from ld_tools_tpu_torch.bench.oracle import oracle_ld
from ld_tools_tpu_torch.ops import ld_kernels as lk
from ld_tools_tpu_torch.utils.device import resolve_device
from ld_tools_tpu_torch.utils.profiling import (
    Roofline,
    detect_chip,
    sweep_seconds,
)

METRIC = "ld_triangle_allpairs_r2_variant_pairs_per_sec_per_chip"
V_CARD = 10_240
V_CPU = 1_024
BLOCK = 640
# wide sweep spread: bench.py's, so that the difference resolves
N_LO, N_HI = 4, 20
TRIALS = 3
N_SAMPLES = 5
N_ATTEMPTS = 9
CPU_REPS = 3


def measure_baseline_pairs_per_sec(n_hap: int = common.N_HAP) -> float:
    """The reference's per-pair Python kernel rate on 5,008-haplotype
    vectors."""
    rng = np.random.default_rng(7)
    g1 = list(map(int, (rng.random(n_hap) < 0.4).astype(int)))
    g2 = list(map(int, (rng.random(n_hap) < 0.6).astype(int)))
    n_pairs = 30
    t0 = time.perf_counter()
    for _ in range(n_pairs):
        oracle_ld(g1, g2)
    return n_pairs / (time.perf_counter() - t0)


def _datasets(v_pad: int, dev):
    """N_SETS (int8 rows, f32 alt counts): random rows, packed as the
    store writes them, inflated on the card once."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(common.N_SETS):
        freqs = rng.uniform(0.05, 0.95, size=(v_pad, 1))
        G = (rng.random((v_pad, common.N_HAP)) < freqs).astype(np.uint8)
        Gw = np.zeros((v_pad, common.W_DENSE), dtype=np.uint8)
        Gw[:, :common.N_HAP] = G
        gp = torch.from_numpy(lk.pack_rows(Gw)).to(dev)
        g = lk.unpack_rows_device(gp)
        c1 = torch.from_numpy(Gw.astype(np.float32).sum(axis=1)).to(dev)
        out.append((g, c1))
    return out


def time_card_sweep(v: int, block: int, dev):
    """Plausible per-sweep seconds of K1's fast-r^2 sweep, and the
    number of blocks a sweep computes."""
    v_pad = -(-v // block) * block
    datasets = _datasets(v_pad, dev)
    cij = common.triangle_cij(v_pad, block, dev)
    n_blocks = cij.shape[0]
    out = (torch.empty((v_pad, v_pad), dtype=torch.float32, device=dev),
           None)
    many = common.sweeps(lambda g, c1, ipq: lk.ld_triangle_blocks(
        g, c1, ipq, cij, common.N_HAP, block_m=block, block_n=block,
        epilogue="fast", want_dprime=False, out=out)[0], dev)

    # a sweep computes n_blocks full block x block tiles over the padded
    # haplotypes; no sweep can beat the card's int8 peak on that count
    sweep_flops = 2.0 * n_blocks * block * block * common.W_DENSE
    sol_s = sweep_flops / (common.peak_tflops(int8=True) * 1e12)
    t0 = time.perf_counter()
    dts = []
    for attempt in range(N_ATTEMPTS):
        dt, times = sweep_seconds(many, datasets, n_lo=N_LO, n_hi=N_HI,
                                  trials=TRIALS, seed_base=attempt * TRIALS)
        common.log(f"warm+measure: {time.perf_counter() - t0:.1f}s "
                   f"[T{N_LO}={times[N_LO] * 1e3:.3f}ms "
                   f"T{N_HI}={times[N_HI] * 1e3:.3f}ms]")
        if dt > 0.95 * sol_s and times[N_HI] > times[N_LO] * 1.05:
            dts.append(dt)
            if len(dts) >= N_SAMPLES:
                break
        else:
            common.log(f"implausible timing (dt={dt * 1e3:.3f}ms vs speed "
                       f"of light {sol_s * 1e3:.3f}ms); remeasuring")
    if not dts:
        raise RuntimeError(f"all {N_ATTEMPTS} timing attempts implausible "
                           f"(last dt={dt})")
    if len(dts) < N_SAMPLES:
        common.log(f"only {len(dts)}/{N_SAMPLES} plausible samples")
    return dts, n_blocks


def _time_cpu(v: int, dev) -> float:
    """Seconds per sweep of the plain version at V = ``v``."""
    rng = np.random.default_rng(0)
    freqs = rng.uniform(0.05, 0.95, size=(v, 1))
    G = torch.from_numpy(
        (rng.random((v, common.N_HAP)) < freqs).astype(np.int8)).to(dev)

    def sweep():
        return lk.ld_triangle_matrix(G, common.N_HAP, block_m=512,
                                     block_n=512, want_dprime=False,
                                     epilogue="fast")

    sweep()
    t0 = time.perf_counter()
    for _ in range(CPU_REPS):
        sweep()
    return (time.perf_counter() - t0) / CPU_REPS


def run(device: str = "cuda") -> dict:
    """Measure, log to stderr, and return the headline record."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    common.log(common.describe_device(dev))
    lk.reset_launches()
    v = V_CARD if on_card else V_CPU
    pairs = v * (v + 1) / 2
    if on_card:
        dts, n_blocks = time_card_sweep(v, BLOCK, dev)
        dts = sorted(dts)
        dt = dts[len(dts) // 2]  # the median sample
        # bytes: the stationary a-block once per row run, the b-block
        # once per block, one f32 r^2 tile per block (bench.py's model)
        nb = v // BLOCK
        bytes_moved = (nb * BLOCK * common.W_DENSE
                       + n_blocks * BLOCK * common.W_DENSE
                       + n_blocks * BLOCK * BLOCK * 4)
        roof = Roofline(n_pairs=pairs, n_haplotypes_padded=common.W_DENSE,
                        bytes_moved=bytes_moved, chip=detect_chip(),
                        int8_mxu=True)
        common.log(f"roofline: {json.dumps(roof.achieved(dt))}")
    else:
        dts = []
        dt = _time_cpu(v, dev)
    common.log_launches()
    pairs_per_sec = pairs / dt
    tflops = 2 * pairs * common.W_DENSE / dt / 1e12
    common.log(f"{v} variants x {common.N_HAP} haplotypes: "
               f"{dt * 1e3:.3f} ms/sweep, {pairs_per_sec / 1e9:.2f} Gpairs/s, "
               f"~{tflops:.1f} TFLOP/s effective")
    baseline = measure_baseline_pairs_per_sec()
    common.log(f"reference python kernel: {baseline:.0f} pairs/s")
    rec = {
        "metric": METRIC,
        "value": round(pairs_per_sec, 1),
        "unit": "pairs/s",
        "vs_baseline": round(pairs_per_sec / baseline, 1),
    }
    if len(dts) > 1:
        rec["spread"] = {
            "n_samples": len(dts),
            "gpairs_per_s_median": round(pairs / dt / 1e9, 2),
            "gpairs_per_s_min": round(pairs / max(dts) / 1e9, 2),
            "gpairs_per_s_max": round(pairs / min(dts) / 1e9, 2),
        }
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m ld_tools_tpu_torch.bench",
        description="All-pairs r^2 sweep rate (pairs/s) on one card.")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu "
                         "(the plain versions at V = 1,024)")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device)), flush=True)


if __name__ == "__main__":
    main()
