"""Sharded-scan scaling at 1, 2, 4 and 8 shards: the counterpart of
scripts/bench_scaling.py.

    python -m ld_tools_tpu_torch.bench.scaling [--v N] [--h N]
        [--doc PATH] [--device cuda|cpu]

Times the tile-sharded streamed scan (``ops/ld_stream.
stream_threshold_scan`` over n shards: the count pass K7, i.e. K5 once
per shard, then K3 on the hit blocks; one shard is the plain call, K5
then K3) and the ring sweep (``parallel/sweep.all_pairs_ring`` over the
same shards on the first min(V, 2,048) rows), each after one warm call,
the best of 3, and reports pairs/s and the efficiency against the
one-shard run.  The hits must be the same at every mesh size: the run
raises where they differ.

The n shards are the first n local cards (``scan_mesh(n)``) where there
are n, else the explicit list ``[cuda:0] * n``: n shards that queue on
one card.  Each row says both: ``devices`` the shard count, as in the
JAX script's rows, and ``cards`` the distinct devices under them, so a
row whose cards are fewer than its shards shows the sharded path's
overhead, not scaling across cards.  On the card the default workload
is the chr21 scale, 102,400 variants x 5,008 haplotypes; on the CPU
(``--device cpu``, the plain versions) the JAX script's 4,096 x 512.

Writes one JSON line per mesh size (the JAX script's keys, ``cards`` and
the kernel launches of that size), then a markdown table; ``--doc PATH``
also writes the table to PATH.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ld_tools_tpu_torch.bench import common
from ld_tools_tpu_torch.utils.device import resolve_device

MESH_SIZES = (1, 2, 4, 8)
CARD_SIZE = (102_400, 5008)  # chr21 scale
CPU_SIZE = (4096, 512)       # the JAX script's defaults
RING_ROWS = 2048
_FLIP_ROWS = 8192  # rows of the flip draw at a time (bounds its f64 buffer)


def _workload(v=4096, h=512, seed=0):
    """Blocks of 32 identical rows with 3 % flips and unique sorted
    positions: the JAX script's random stream, the flip draw taken in row
    chunks so that it never needs V x H doubles at once."""
    rng = np.random.default_rng(seed)
    blk = 32
    base = (
        rng.random((v // blk, h)) < rng.uniform(0.05, 0.95, (v // blk, 1))
    ).astype(np.int8)
    G = np.repeat(base, blk, axis=0)
    for lo in range(0, G.shape[0], _FLIP_ROWS):
        hi = min(lo + _FLIP_ROWS, G.shape[0])
        G[lo:hi] ^= (rng.random((hi - lo, h)) < 0.03).astype(np.int8)
    pos = np.sort(rng.choice(10**8, size=v, replace=False)).astype(np.int64)
    return G, pos


def shard_list(n: int, device) -> list:
    """n shards: the first n local cards (``scan_mesh(n)``; on the CPU n
    CPU shards), or the first card n times where there are fewer."""
    from ld_tools_tpu_torch.ops.ld_stream import scan_mesh

    mesh = scan_mesh(n, device)
    return mesh if len(mesh) == n else mesh[:1] * n


def bench_scan(G, pos, mesh, device, reps=3):
    """(best seconds, hits) of the scan over the shard list ``mesh`` (one
    shard: the plain one-device call)."""
    from ld_tools_tpu_torch.ops.ld_stream import stream_threshold_scan

    kw = dict(
        pos=pos, measure="r_square", thres=0.8, band=512, chunk=1024,
        exact=False, device=device,
    )
    mesh = mesh if len(mesh) > 1 else None
    stream_threshold_scan(G, mesh=mesh, **kw)  # first-call costs
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        hits = stream_threshold_scan(G, mesh=mesh, **kw)
        best = min(best, time.perf_counter() - t0)
    return best, hits


def bench_ring(G, mesh, device, reps=3):
    """Best seconds of the ring sweep over the shard list ``mesh``."""
    from ld_tools_tpu_torch.parallel.sweep import all_pairs_ring

    dev = resolve_device(device)
    all_pairs_ring(G, mesh=mesh)
    common.sync(dev)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        all_pairs_ring(G, mesh=mesh)
        common.sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best


def hit_keys(hits, v: int) -> np.ndarray:
    """The scan's hit set as sorted i * v + j keys."""
    return np.sort(np.asarray(hits.i, dtype=np.int64) * v
                   + np.asarray(hits.j, dtype=np.int64))


def run(v, h, device) -> list:
    """One row per mesh size; raises where the hits differ from the
    one-shard scan's."""
    G, pos = _workload(v, h)
    pairs = v * (v - 1) / 2
    rows = []
    base_scan = base_ring = base_keys = None
    for n in MESH_SIZES:
        mesh = shard_list(n, device)
        before = common.launch_counts()
        t_scan, hits = bench_scan(G, pos, mesh, device)
        t_ring = bench_ring(G[: min(v, RING_ROWS)], mesh, device)
        launches = common.launches_since(before)
        keys = hit_keys(hits, v)
        if n == 1:
            base_scan, base_ring, base_keys = t_scan, t_ring, keys
        elif not np.array_equal(keys, base_keys):
            raise RuntimeError(
                f"the scan over {n} shards found {len(keys)} hits, the "
                f"one-shard scan {len(base_keys)}: the hit sets differ")
        row = {
            "devices": n,
            "cards": len(set(mesh)),
            "scan_s": round(t_scan, 3),
            "scan_gpairs_per_s": round(pairs / t_scan / 1e9, 3),
            "scan_speedup": round(base_scan / t_scan, 2),
            "scan_efficiency": round(base_scan / t_scan / n, 2),
            "ring_s": round(t_ring, 3),
            "ring_speedup": round(base_ring / t_ring, 2),
            "hits": int(len(hits.i)),
            "launches": launches,
        }
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def table(rows, v, h, dev) -> str:
    if dev.type == "cuda":
        shared = [r["devices"] for r in rows if r["cards"] < r["devices"]]
        where = (f"{common.describe_device(dev)}, "
                 f"{torch.cuda.device_count()} local card(s). The n shards "
                 "are the first n cards where there are n.")
        if shared:
            where += (f" At {', '.join(map(str, shared))} shards there are "
                      "fewer cards, so the shards are the first card n "
                      "times: they queue on it, and those rows show the "
                      "sharded path's overhead, not scaling across cards.")
    else:
        where = ("The shards are the CPU repeated (the plain PyTorch "
                 "versions): the table shows the sharded path's overhead, "
                 "no device metric.")
    lines = [
        "# Sharded-scan scaling",
        "",
        f"Workload: {v} variants x {h} haplotypes, all lower-triangle "
        "pairs, r^2 >= 0.8 threshold scan (exact=False), plus a "
        f"{min(v, RING_ROWS)}-variant all_pairs_ring.",
        "",
        where,
        "",
        "| shards | cards | scan s | scan Gpairs/s | scan speedup | "
        "scan eff | ring s | ring speedup |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['devices']} | {r['cards']} | {r['scan_s']} "
            f"| {r['scan_gpairs_per_s']} "
            f"| {r['scan_speedup']}x | {r['scan_efficiency']} "
            f"| {r['ring_s']} | {r['ring_speedup']}x |"
        )
    return "\n".join(lines) + "\n"


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(
        prog="python -m ld_tools_tpu_torch.bench.scaling",
        description="The sharded scan and the ring sweep at 1, 2, 4 and 8 "
                    "shards.")
    ap.add_argument("--doc", default=None,
                    help="also write the markdown table to this path")
    ap.add_argument("--v", type=int, default=None,
                    help=f"variants (default {CARD_SIZE[0]} on the card, "
                         f"{CPU_SIZE[0]} on the CPU)")
    ap.add_argument("--h", type=int, default=None,
                    help=f"haplotypes (default {CARD_SIZE[1]} on the card, "
                         f"{CPU_SIZE[1]} on the CPU)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    common.log(common.describe_device(dev))
    size = CARD_SIZE if dev.type == "cuda" else CPU_SIZE
    v = args.v if args.v is not None else size[0]
    h = args.h if args.h is not None else size[1]
    rows = run(v, h, args.device)
    text = table(rows, v, h, dev)
    print(text)
    if args.doc:
        os.makedirs(os.path.dirname(os.path.abspath(args.doc)), exist_ok=True)
        with open(args.doc, "w") as fh:
            fh.write(text)
        print(f"wrote {args.doc}")
    common.log_launches()
    return rows


if __name__ == "__main__":
    main()
