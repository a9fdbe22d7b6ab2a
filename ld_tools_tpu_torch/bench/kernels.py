"""Kernel-variant sweep of the all-pairs triangle (the counterpart of
scripts/bench_kernels.py).

    python -m ld_tools_tpu_torch.bench.kernels [--v 10240] [--only SUBSTR]
        [--device cuda|cpu]

The seven variants of the TPU sweep: {dense int8 (K1,
``ld_triangle_blocks``), bit-plane packed (K2,
``ld_triangle_blocks_packed``), bf16 (K1b, ``ld_triangle_blocks_bf16``)}
x block sizes x {fast, exact-order epilogue} x {r^2 only, r^2 + D'}, each
timed with ``utils.profiling.sweep_seconds`` (CUDA events) over 4 datasets
with per-sweep jittered alt counts, into (V, V) output buffers allocated
outside the timed runs.  The share of the peak is against the card's bf16
peak for the bf16 rows and its int8 peak otherwise (``CHIP_PEAKS``).  A
variant that fails raises: nothing carries on past it.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ld_tools_tpu_torch.bench import common
from ld_tools_tpu_torch.ops import ld_kernels as lk
from ld_tools_tpu_torch.utils.device import resolve_device
from ld_tools_tpu_torch.utils.profiling import sweep_seconds

# (name, form, block, epilogue, want_dprime): scripts/bench_kernels.py's
VARIANTS = (
    ("dense/512/fast/r2only", "dense", 512, "fast", False),
    ("dense/1024/fast/r2only", "dense", 1024, "fast", False),
    ("dense/512/exact/r2only", "dense", 512, "exact", False),
    ("dense/512/exact/r2+dp", "dense", 512, "exact", True),
    ("packed/1024/exact/r2only", "packed", 1024, "exact", False),
    ("packed/1024/fast/r2only", "packed", 1024, "fast", False),
    ("bf16/512/exact/r2only", "bf16", 512, "exact", False),
)
# form -> the launch site (K1 and K1b take int8 rows, K2 the packed bytes)
SITES = {
    "dense": lk.ld_triangle_blocks,
    "packed": lk.ld_triangle_blocks_packed,
    "bf16": lk.ld_triangle_blocks_bf16,
}


def _datasets(raw, block: int, form: str, dev):
    """The raw rows padded to the block, packed, and (but for the packed
    form) inflated to int8 on the device: [(rows, f32 alt counts)]."""
    v = raw[0].shape[0]
    v_pad = -(-v // block) * block
    out = []
    for G in raw:
        Gw = np.zeros((v_pad, common.W_DENSE), dtype=np.uint8)
        Gw[:v, :common.N_HAP] = G
        gp = torch.from_numpy(lk.pack_rows(Gw)).to(dev)
        c1 = torch.from_numpy(Gw.astype(np.float32).sum(axis=1)).to(dev)
        out.append((gp if form == "packed" else lk.unpack_rows_device(gp),
                    c1))
    return out, v_pad


def run(v: int = 10_240, only: str = "", device: str = "cuda") -> dict:
    """Time each variant; prints one row per variant and returns
    {name: ms}."""
    dev = resolve_device(device)
    common.log(common.describe_device(dev))
    on_card = dev.type == "cuda"
    pairs = v * (v + 1) / 2
    rng = np.random.default_rng(0)
    raw = []
    for _ in range(common.N_SETS):
        freqs = rng.uniform(0.05, 0.95, size=(v, 1))
        raw.append((rng.random((v, common.N_HAP)) < freqs).astype(np.uint8))
    lk.reset_launches()
    result = {}
    for name, form, block, epilogue, want_dprime in VARIANTS:
        if only and only not in name:
            continue
        datasets, v_pad = _datasets(raw, block, form, dev)
        cij = common.triangle_cij(v_pad, block, dev)
        site = SITES[form]
        out = tuple(
            torch.empty((v_pad, v_pad), dtype=torch.float32, device=dev)
            if want else None for want in (True, want_dprime))

        many = common.sweeps(
            lambda g, c1, ipq, site=site, block=block, epilogue=epilogue,
            want_dprime=want_dprime, cij=cij, out=out: site(
                g, c1, ipq, cij, common.N_HAP, block_m=block, block_n=block,
                epilogue=epilogue, want_dprime=want_dprime, out=out)[0], dev)
        t0 = time.perf_counter()
        dt, _ = sweep_seconds(many, datasets)
        wall = time.perf_counter() - t0
        result[name] = dt * 1e3
        tflops = 2 * pairs * common.W_DENSE / dt / 1e12
        if on_card:
            peak = common.peak_tflops(int8=form != "bf16")
            share = f"{tflops / peak * 100:5.1f}% peak"
        else:
            share = "(cpu: plain version, no device peak)"
        print(f"{name:34s} {dt * 1e3:7.2f} ms  {pairs / dt / 1e9:7.2f} "
              f"Gpairs/s  {tflops:6.1f} TF/s  {share}  (total {wall:.0f}s)",
              flush=True)
        del datasets, out
    common.log_launches()
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m ld_tools_tpu_torch.bench.kernels",
        description="Triangle kernel variants (K1, K1b, K2), timed.")
    ap.add_argument("--v", type=int, default=10_240)
    ap.add_argument("--only", type=str, default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.v, args.only, args.device)


if __name__ == "__main__":
    main()
