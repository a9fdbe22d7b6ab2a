"""Split the triangle kernel's time into its stages (K8; the counterpart
of scripts/bench_microkernels.py).

    python -m ld_tools_tpu_torch.bench.microkernels [--v 10240]
        [--block 512] [--only STAGE] [--device cuda|cpu]

K1's own kernel (``ld_stage_blocks``: ld_block_kernel<FORM_S8,
STORE_TRIANGLE>, the same tiles, block list and int8 wgmma count core) at
each rung, one epilogue stage more each time:

  counts : the int8 count + f32 store            (tensor cores + output)
  scale  : counts times one per-row vector       (+1 multiply per cell)
  fast   : the divide-free r^2 epilogue           (the headline's)
  exact  : the exact-order r^2 epilogue           (the parity path's)

Each is timed with ``utils.profiling.sweep_seconds`` (CUDA events) over
the 4 datasets with per-sweep jittered alt counts; the 1/(p*q) vector of
each sweep's counts is part of the sweep, as in the TPU bench.  Every row
reports the effective TOP/s on the same operation count (2 * V(V+1)/2 *
5,120), so the differences between rows are the stages' costs; the share
of the peak is against the card's int8 peak (``CHIP_PEAKS``).  A stage
that fails raises.  The launch counts of the run go to stderr as JSON.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ld_tools_tpu_torch.bench import common
from ld_tools_tpu_torch.ops import ld_kernels as lk
from ld_tools_tpu_torch.utils.device import resolve_device
from ld_tools_tpu_torch.utils.profiling import sweep_seconds


def _datasets(v: int, v_pad: int, dev):
    """N_SETS (int8 (v_pad, 5,120) rows, zero past v, f32 alt counts)."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(common.N_SETS):
        G = np.zeros((v_pad, common.W_DENSE), np.int8)
        G[:v, :common.N_HAP] = (
            rng.random((v, common.N_HAP)) < rng.uniform(0.05, 0.95, (v, 1)))
        g = torch.from_numpy(G).to(dev)
        out.append((g, g.to(torch.float32).sum(dim=1)))
    return out


def run(v: int = 10_240, block: int = 512, only: str = "",
        device: str = "cuda") -> dict:
    """Time each stage; prints one row per stage and returns
    {stage: {"ms", "launches"}}."""
    dev = resolve_device(device)
    common.log(common.describe_device(dev))
    peak = common.peak_tflops(int8=True) if dev.type == "cuda" else None
    v_pad = -(-v // block) * block
    pairs = v * (v + 1) / 2
    datasets = _datasets(v, v_pad, dev)
    cij = common.triangle_cij(v_pad, block, dev)
    out = torch.empty((v_pad, v_pad), dtype=torch.float32, device=dev)
    lk.reset_launches()
    result = {}
    for stage in lk.STAGES:
        if only and only not in stage:
            continue

        many = common.sweeps(
            lambda g, c1, ipq, stage=stage: lk.ld_stage_blocks(
                g, c1, ipq, cij, common.N_HAP, block=block, stage=stage,
                out=out), dev)
        before = lk.ld_stage_blocks.launches
        dt, _ = sweep_seconds(many, datasets)
        result[stage] = {"ms": dt * 1e3,
                         "launches": lk.ld_stage_blocks.launches - before}
        tf = 2 * pairs * common.W_DENSE / dt / 1e12
        share = (f"{tf / peak * 100:5.1f}% int8 peak" if peak
                 else "(cpu: plain version, no device peak)")
        print(f"{stage:8s} {dt * 1e3:7.2f} ms  {pairs / dt / 1e9:7.2f} "
              f"Gpairs/s  {tf:6.1f} TF/s  {share}", flush=True)
    common.log_launches(stages=result)
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m ld_tools_tpu_torch.bench.microkernels",
        description="The triangle kernel's time, stage by stage (K8).")
    ap.add_argument("--v", type=int, default=10_240)
    ap.add_argument("--block", type=int, default=512)
    ap.add_argument("--only", type=str, default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.v, args.block, args.only, args.device)


if __name__ == "__main__":
    main()
