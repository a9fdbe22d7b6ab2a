"""What the bench entry points share: the headline data shape, the card's
peaks and name, the timed sweep with its input jitter, and the launch
report."""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

from ld_tools_tpu_torch.ops import ld_kernels as lk
from ld_tools_tpu_torch.utils.profiling import CHIP_PEAKS, detect_chip

N_HAP = 5008   # 1000 Genomes phase 3 haplotypes
N_SETS = 4     # distinct datasets a timed sweep cycles over
HP8_PAD = 640  # 5,008 haplotypes -> 626 packed bytes -> 16-aligned 640
W_DENSE = HP8_PAD * 8


def log(msg) -> None:
    print(msg, file=sys.stderr, flush=True)


def sync(dev: torch.device) -> None:
    """Wait for the card's queued work (nothing on the CPU): before every
    stop of a host clock."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def launch_counts() -> dict:
    """Every kernel launch site's count, by name."""
    return {fn.__name__: fn.launches for fn in lk.LAUNCH_SITES}


def launches_since(before: dict) -> dict:
    """The sites that launched since ``before`` (a :func:`launch_counts`),
    with their launches."""
    return {k: n - before[k] for k, n in launch_counts().items()
            if n > before[k]}


def peak_tflops(int8: bool) -> float:
    """The card's dense tensor-core peak, int8 (TOP/s) or bf16 (TFLOP/s),
    from CHIP_PEAKS; raises without a known card."""
    bf16, _, int8_speedup = CHIP_PEAKS[detect_chip()]
    return bf16 * int8_speedup if int8 else bf16


def describe_device(dev: torch.device) -> str:
    """One line naming where the numbers come from: the card's name and
    power limit (nvidia-smi), or the CPU."""
    if dev.type != "cuda":
        return "device: cpu (the plain PyTorch versions; no device metric)"
    name = torch.cuda.get_device_name(dev)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError) as exc:
        smi = f"power limit not read ({exc})"
    return f"device: {name}; nvidia-smi: {smi}"


def sweeps(call, dev):
    """``make_many`` for :func:`sweep_seconds`: n sweeps cycling over the
    datasets [(rows, f32 alt counts)], each with its counts jittered by
    1 + seed * (i+1) * 1e-7 (bench.py:117, so no two sweeps or timed runs
    share inputs) and their 1/(p*q) computed inside the sweep, as
    ``_ld_triangle_call`` does, then ``call(rows, c1, ipq)`` -> a (V, V)
    f32 matrix whose first cell feeds the returned sum."""
    n_t = torch.tensor(float(np.float32(N_HAP)), dtype=torch.float32,
                       device=dev)

    def many(n):
        def fn(datasets, seed):
            acc = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(n):
                g, c1 = datasets[i % N_SETS]
                c1j = c1 * (1.0 + seed * float(np.float32((i + 1) * 1e-7)))
                out = call(g, c1j, lk._ipq_from_counts(c1j, n_t))
                acc = acc + out[0, 0]
            return acc
        return fn
    return many


def triangle_cij(v_pad: int, block: int, dev) -> torch.Tensor:
    """The lower-triangle block list of a (v_pad, v_pad) sweep."""
    bi, bj = lk._triangle_coords(v_pad // block)
    return torch.from_numpy(lk.pack_block_coords(bi, bj)).to(dev)


def log_launches(**extra) -> None:
    """The kernel launch counts of this process (every site, 0 included)
    as one JSON line on stderr: proof that the timed path went through
    the kernels."""
    log(json.dumps({"launches": launch_counts(), **extra}))
