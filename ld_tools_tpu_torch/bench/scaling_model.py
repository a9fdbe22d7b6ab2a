"""Multi-card scaling model composed from measured components: the
counterpart of scripts/scaling_model.py.

    python -m ld_tools_tpu_torch.bench.scaling_model [--out F]
        [--measured F] [--device cuda|cpu]

One card cannot show how a chromosome scan scales over several, but it
can measure every component such a scan is built from:

  - the latency of one dispatch (a chained ``x + 1``, synchronised);
  - host-to-device and device-to-host bandwidth (pageable numpy memory,
    as the tools upload);
  - the fused count kernel's rate and fixed cost per call (K5,
    ``ops/ld_kernels.ld_band_count``).

``model``, ``model_multihost`` and ``batch_model`` compose them into
predicted phase times at 1, 2, 4 and 8 cards; they are the JAX script's
arithmetic, with its signatures, keys and rounding, so that a
``--measured`` artifact of either package gives the same tables.  This
host has a direct PCIe link to its card and no relay in between: the
model's ``relay`` tables are the ones built from this host's measured
link (the key is kept for parity), and the ``direct`` and
``multihost_direct`` tables take the JAX model's stated link constants
(8 GB/s, 50 us dispatch, 3 GB/s between hosts) and its host-time terms
(``host_s``), kept for parity, not measured on this card.

The artifact goes where ``--out`` says.  Without a card the measurement
raises unless ``--device cpu`` asks for the CPU (the plain versions; no
device metric).  Sizes are the module constants below, so that a test
can shrink them.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ld_tools_tpu_torch.bench import common
from ld_tools_tpu_torch.ops import ld_kernels as lk
from ld_tools_tpu_torch.utils.device import resolve_device

DISPATCH_SHAPE = (8, 128)
H2D_BYTES = 64 << 20   # a chr21-scale packed matrix
D2H_BYTES = 8 << 20    # a result pull
COUNT_V = 10_240       # K5's rows: the headline's row count ...
COUNT_H = 5120         # ... at 5,008 haplotypes padded to 128
COUNT_BLOCK = 640
COUNT_REPS = 5


def _chain_median(fn, x0, dev, n=7):
    """Median latency of ``fn`` chained by data dependency, each call
    synchronised before the clock stops; the first call is dropped."""
    xs = [x0]
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        xs.append(fn(xs[-1]))
        common.sync(dev)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts[1:]))


def measure(device="cuda") -> dict:
    """The measured block: dispatch latency, H2D and D2H rates, K5's fixed
    cost per call and its rate over the 136 triangle blocks of COUNT_V
    rows (padded to 256 with (0, 0), as the scan pads) against one block,
    with thresholds salted per call so that no call repeats another."""
    dev = resolve_device(device)
    out = {"backend": dev.type,
           "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"),
           "device_line": common.describe_device(dev)}

    out["dispatch_s"] = _chain_median(
        lambda x: x + 1,
        torch.zeros(DISPATCH_SHAPE, dtype=torch.float32, device=dev), dev)

    host = np.random.default_rng(0).integers(0, 255, size=(H2D_BYTES,),
                                             dtype=np.uint8)
    ts = []
    for k in range(3):
        host[0] = k
        t0 = time.perf_counter()
        torch.from_numpy(host).to(dev, copy=True)
        common.sync(dev)
        ts.append(time.perf_counter() - t0)
    out["h2d_MBps"] = H2D_BYTES / float(np.median(ts)) / 1e6

    d = torch.zeros((D2H_BYTES,), dtype=torch.uint8, device=dev)
    ts = []
    for k in range(3):
        dd = d + k
        common.sync(dev)
        t0 = time.perf_counter()
        dd.to("cpu", copy=True).numpy()
        ts.append(time.perf_counter() - t0)
    out["d2h_MBps"] = D2H_BYTES / float(np.median(ts)) / 1e6

    V, H, B = COUNT_V, COUNT_H, COUNT_BLOCK
    rng = np.random.default_rng(1)
    G = (rng.random((V, H)) < 0.3).astype(np.int8)
    c1 = G.astype(np.float32).sum(axis=1, keepdims=True)
    p = c1 / H
    pq = p * (1 - p)
    ipq = np.where(pq == 0, 0, 1 / np.where(pq == 0, 1, pq)).astype(
        np.float32)
    pos = np.arange(V, dtype=np.int32) * 500
    g_dev = torch.from_numpy(G).to(dev)
    c1_dev = torch.from_numpy(c1).to(dev)
    ipq_dev = torch.from_numpy(ipq).to(dev)
    pos_dev = torch.from_numpy(pos).to(dev)
    nb = V // B

    def count_call(bi_l, bj_l, salt):
        cij = torch.from_numpy(lk.pack_block_coords(bi_l, bj_l)).to(dev)
        thres = np.float32(0.7995) + np.float32(salt * 1e-7)
        return lk.ld_band_count(
            g_dev, c1_dev, ipq_dev, pos_dev, cij, (H, 0), (thres,),
            packed=False, sel=0, exact_mask=True, use_dist=False,
            block_m=B, block_n=B)

    def timed(bi_l, bj_l, salt):
        t0 = time.perf_counter()
        count_call(bi_l, bj_l, salt)
        common.sync(dev)
        return time.perf_counter() - t0

    tri = [(i, j) for i in range(nb) for j in range(i + 1)]
    big_bi = [t[0] for t in tri]
    big_bj = [t[1] for t in tri]
    tgt = 1 << (len(tri) - 1).bit_length()  # padded as the scan pads
    big_bi += [0] * (tgt - len(tri))
    big_bj += [0] * (tgt - len(tri))
    timed(big_bi, big_bj, 0)  # first-call costs of both shapes
    timed([0], [0], 0)
    ts_big, ts_one = [], []
    for k in range(COUNT_REPS):
        ts_big.append(timed(big_bi, big_bj, k + 1))
        ts_one.append(timed([0], [0], k + 1))
    t_big = float(np.median(ts_big))
    t_one = float(np.median(ts_one))
    pairs_big = len(tri) * B * B
    out["count_call_fixed_s"] = t_one
    out["count_device_gpairs_s"] = pairs_big / max(t_big - t_one, 1e-9) / 1e9
    out["count_blocks_measured"] = len(tri)
    return out


def model(meas, *, v=102400, h=5008, hits=2_000_000, cap=98304,
          direct=False):
    """Predicted streamed-scan phase times for 1/2/4/8 cards of one host
    (scripts/scaling_model.model).

    direct=False: the measured link of this host (key ``relay`` in the
    artifact): N replicated uploads pay N transfers.  direct=True: the
    JAX model's stated direct-attached constants (8 GB/s H2D and D2H,
    50 us dispatch), kept for parity, not measured here.
    """
    if direct:
        h2d = 8e9 / 1e6
        d2h = 8e9 / 1e6
        disp = 50e-6
    else:
        h2d = meas["h2d_MBps"]
        d2h = meas["d2h_MBps"]
        disp = meas["dispatch_s"]
    rate = meas["count_device_gpairs_s"] * 1e9
    fixed = meas["count_call_fixed_s"] if not direct else disp * 2
    g_bytes = v * (h // 8)  # bitpacked wire format
    pairs = v * (v - 1) / 2
    blocks = (v / 640) ** 2 / 2
    hit_bytes = hits * 12  # i, j (packed int32) + int16 cab + padding
    # the JAX model's N-independent host term (prep ~O(V), finish
    # ~O(hits)), kept for parity
    host_s = 0.15 + (v / 102400) * 0.2 + (hits / 2e6) * 0.15
    rows = {}
    for n in (1, 2, 4, 8):
        upload = g_bytes / 1e6 / h2d * (1 if direct else n)
        count = pairs / (rate * n) + np.ceil(blocks / (cap * n)) * fixed
        fetch = hit_bytes / 1e6 / d2h + (fixed if not direct else disp)
        total = upload + count + fetch + host_s
        rows[n] = {
            "upload_s": round(upload, 3),
            "count_s": round(count, 3),
            "fetch_s": round(fetch, 3),
            "host_s": host_s,
            "total_s": round(total, 3),
        }
    t1 = rows[1]["total_s"]
    for n, r in rows.items():
        r["efficiency"] = round(t1 / (n * r["total_s"]), 3)
    # warm: the resident cache holds G, the upload drops out
    warm = {}
    for n, r in rows.items():
        wt = r["count_s"] + r["fetch_s"] + r["host_s"]
        warm[n] = {"total_s": round(wt, 3)}
    wt1 = warm[1]["total_s"]
    for n, r in warm.items():
        r["efficiency"] = round(wt1 / (n * r["total_s"]), 3)
    return {"cold": rows, "warm_resident": warm}


def model_multihost(meas, *, v=102400, h=5008, hits=2_000_000,
                    cap=98304):
    """Cooperative scan, one process per card on hosts of their own
    (scripts/scaling_model.model_multihost): each uploads its replica
    over its own link, counts, fetches and finishes its own tiles, and the
    hits meet in one allgather.  The JAX model's stated constants: 8 GB/s
    links, 50 us dispatch, 3 GB/s between hosts."""
    h2d = 8e9
    d2h = 8e9
    dcn = 3e9
    disp = 50e-6
    rate = meas["count_device_gpairs_s"] * 1e9
    fixed = disp * 2
    g_bytes = v * (h // 8)
    pairs = v * (v - 1) / 2
    blocks = (v / 640) ** 2 / 2
    hit_bytes = hits * 12
    prep = 0.15 + (v / 102400) * 0.2    # replicated per process
    finish = (hits / 2e6) * 0.15        # shards with the hits
    out = {}
    for phase, with_upload in (("cold", True), ("warm_resident", False)):
        rows = {}
        for n in (1, 2, 4, 8):
            upload = (g_bytes / h2d if with_upload else 0.0)
            count = pairs / (rate * n) + np.ceil(
                blocks / (cap * n)
            ) * fixed
            fetch = hit_bytes / n / d2h + disp
            host = (prep if with_upload else 0.0) + finish / n
            gather = hit_bytes / dcn if n > 1 else 0.0
            rows[n] = {
                "total_s": round(upload + count + fetch + host + gather,
                                 4),
            }
        t1 = rows[1]["total_s"]
        for n, r in rows.items():
            r["efficiency"] = round(t1 / (n * r["total_s"]), 3)
        out[phase] = rows
    return out


def batch_model(n_chroms=24):
    """Whole chromosomes, one per worker (parallel/batch.py):
    share-nothing, so the efficiency is the load balance,
    (n_chroms / N) / ceil(n_chroms / N)."""
    rows = {}
    for n in (1, 2, 4, 8):
        rows[n] = {
            "efficiency": round(
                (n_chroms / n) / -(-n_chroms // n) / 1.0, 3
            )
        }
    return rows


CONFIGS = {
    "chr21_scan": dict(v=102400, hits=2_000_000),
    "chr2_scan": dict(v=204_800, hits=4_000_000),
    "chr_800k_scan": dict(v=819_200, hits=16_000_000),
}

ASSUMPTIONS = {
    "configs": "V x 5008 haplotypes, thres 0.8 cooperative scan of "
               "ONE chromosome; hits scale ~linearly with V here",
    "relay_link": "the key is the JAX artifact's; here it holds the link "
                  "measured on this host, a direct PCIe link to its card "
                  "with no relay: N replicated uploads pay N transfers",
    "direct_link": "the JAX model's stated constants, kept for parity and "
                   "not measured on this card: 8 GB/s PCIe per host, 50 us "
                   "dispatch, per-host uploads overlap; count-call fixed "
                   "cost ~2 dispatches",
    "host_s": "the JAX model's N-independent host term (0.15 s + 0.2 s "
              "per 102,400 variants + 0.15 s per 2 M hits), kept for "
              "parity, not measured on this host",
    "not_modeled": "allgather of hits across processes on one host "
                   "(hit bytes << G bytes), process-group startup",
    "falsify": "run `python -m ld_tools_tpu_torch.ld_scan -d N` on the "
               "chr21-scale store over N cards and compare the phase "
               "stats",
}


def build(meas) -> dict:
    """The artifact: the measured block, every model table and the
    assumptions."""
    result = {"measured": meas, "models": {}}
    for cname, kw in CONFIGS.items():
        result["models"][cname] = {
            "relay": model(meas, direct=False, **kw),
            "direct": model(meas, direct=True, **kw),
            "multihost_direct": model_multihost(meas, **kw),
        }
    result["models"]["genome_batch_24chrom"] = {
        "any_link": {"cold": batch_model(24)},
        "note": "share-nothing chromosome-per-worker data parallelism "
                "(parallel/batch.py): no replication, no collectives",
    }
    result["assumptions"] = ASSUMPTIONS
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m ld_tools_tpu_torch.bench.scaling_model",
        description="Predicted 2/4/8-card efficiency from measured "
                    "components.")
    ap.add_argument("--out", default=None, help="write the artifact here")
    ap.add_argument("--measured", default=None,
                    help="reuse an artifact's measured block instead of "
                         "measuring")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.measured:
        with open(args.measured) as fh:
            meas = json.load(fh)["measured"]
    else:
        lk.reset_launches()
        meas = measure(args.device)
        common.log(meas["device_line"])
    print(json.dumps(meas, indent=1))
    result = build(meas)
    for cname in CONFIGS:
        print(f"\n{cname}:")
        for link in ("relay", "direct", "multihost_direct"):
            for phase in ("cold", "warm_resident"):
                effs = {n: float(result["models"][cname][link][phase][n][
                    "efficiency"]) for n in (2, 4, 8)}
                print(f"  {link}/{phase}: eff {effs}")
    print("\ngenome_batch_24chrom (share-nothing): eff "
          + str({n: batch_model(24)[n]["efficiency"] for n in (2, 4, 8)}))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
        print(f"wrote {args.out}")
    common.log_launches()
    return result


if __name__ == "__main__":
    main()
