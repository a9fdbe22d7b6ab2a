"""Kernel smoke suite with a JSON artifact: every production
configuration of the kernels, checked against host oracles (the
counterpart of scripts/tpu_smoke.py).

    python -m ld_tools_tpu_torch.bench.smoke [--out F] [--v 1536]
        [--device cuda|cpu]

Runs the 17 configurations the JAX script runs, by the same names, on
small shapes at the real haplotype width (5,008, padded to 5,120), and
checks each device result against the host:

  - integer count tiles (``cab``) and per-block counts must equal the
    numpy int64 product and the exact integer mask bit for bit;
  - f32 outputs are held within TOL = 3e-6 against a numpy float32
    mirror of the kernels' own operation order (``oracle_epilogue_f32``;
    the kernels are built with -fmad=false, so each product and sum is
    rounded as numpy rounds it); the f32 threshold measure of the
    fallback path (``meas``) within 5e-4.

The configurations: seven ``tri_*`` (the triangle, K1 on int8 rows and
on packed rows unpacked on the device, K2 on the packed bytes; blocks of
512 and 640), seven ``band_*`` (the band sweep, K3 dense and K4 packed,
at 256 x 512 blocks over 512 rows and 1,024 columns) and three
``count_fused_*`` (the count pass, K5 dense and K6 packed, at blocks of
512 with and without the distance window; padding rows at position
-2^30).  The JAX script's two Mosaic probes (the scoped-VMEM budget and
the SMEM block cap) have no counterpart: the CUDA kernels tile
themselves and take any number of blocks (ops/ld_kernels.py).

Prints one JSON line per configuration and writes the artifact
``{"meta", "results", "failures"}`` to ``--out``; exits 1 when any
configuration fails or mismatches.  Without a card it raises unless
``--device cpu`` asks for the plain versions.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ld_tools_tpu_torch.bench import common
from ld_tools_tpu_torch.ops import ld_kernels as lk
from ld_tools_tpu_torch.utils.device import resolve_device

f32 = np.float32

H = 5008
# ulp-scale agreement with the host mirror of the f32 operation order
TOL = 3e-6
MEAS_TOL = 5e-4  # the f32 fallback measure (see the band configs)

PROBES_NOTE = ("the JAX suite's vmem_budget_probe and count_block_cap_probe "
               "have no counterpart: the CUDA kernels tile themselves and "
               "have no SMEM block cap (ops/ld_kernels.py)")

TRI_CASES = [
    ("tri_dense_exact_dp", dict(packed=False, epilogue="exact",
                                want_dprime=True, block=512)),
    ("tri_dense_fast", dict(packed=False, epilogue="fast",
                            want_dprime=False, block=512)),
    ("tri_dense_fast_b640", dict(packed=False, epilogue="fast",
                                 want_dprime=False, block=640)),
    ("tri_packed_dense_exact_dp", dict(packed=True, kernel="dense",
                                       epilogue="exact", want_dprime=True,
                                       block=512)),
    ("tri_packed_dense_fast", dict(packed=True, kernel="dense",
                                   epilogue="fast", want_dprime=False,
                                   block=512)),
    ("tri_packed_bitplane_exact_dp", dict(packed=True, kernel="bitplane",
                                          epilogue="exact",
                                          want_dprime=True, block=512)),
    ("tri_packed_bitplane_fast", dict(packed=True, kernel="bitplane",
                                      epilogue="fast", want_dprime=False,
                                      block=512)),
]

# the streamed scan's configurations: the count pass ("cab" with the
# integer-exact mask), the fetch pass ("cab" exact / "cab", "r2", "dp"
# fast) and the f32 "meas" outputs of the fallback for cohorts past the
# int32-exact bound
BAND_CASES = [
    ("band_dense_count_cab", dict(packed=False, outs=("cab",), sel=0)),
    ("band_dense_fetch_exact", dict(packed=False, outs=("cab",), sel=1)),
    ("band_dense_fetch_fast", dict(packed=False,
                                   outs=("cab", "r2", "dp"), sel=0)),
    ("band_dense_meas_fallback_r2", dict(packed=False, outs=("meas",),
                                         sel=0)),
    ("band_dense_meas_fallback_dp", dict(packed=False, outs=("meas",),
                                         sel=1)),
    ("band_packed_count_cab", dict(packed=True, outs=("cab",), sel=0)),
    ("band_packed_fetch_fast", dict(packed=True,
                                    outs=("cab", "r2", "dp"), sel=0)),
]

COUNT_CASES = [
    ("count_fused_dense_r2", dict(packed=False, sel=0, use_dist=False)),
    ("count_fused_dense_dp_dist", dict(packed=False, sel=1, use_dist=True)),
    ("count_fused_packed_r2", dict(packed=True, sel=0, use_dist=False)),
]

NAMES = [c[0] for c in TRI_CASES + BAND_CASES + COUNT_CASES]
BAND, CHUNK = 512, 1024
COUNT_BLOCK = 512


def oracle_counts(G):
    """(cab, c1) of G as int64.  The product runs in float64 BLAS: every
    count is at most H < 2^53, so it is exact."""
    Gf = G.astype(np.float64)
    return (Gf @ Gf.T).astype(np.int64), G.astype(np.int64).sum(axis=1)


def oracle_epilogue_f32(c_ab, c1, c2, n_hap, epilogue):
    """Host mirror of the kernels' epilogues (``ld_kernels._ld_epilogue``
    / ``_fast_r2``) in numpy float32, the same operation order: the card's
    output should agree to about an ulp."""
    c = c_ab.astype(f32)
    n = f32(n_hap)
    inv_n = f32(1.0) / n
    c1c = c1.astype(f32)[:, None]
    c2r = c2.astype(f32)[None, :]
    p1 = c1c * inv_n
    p2 = c2r * inv_n
    if epilogue == "fast":
        pq1 = p1 * (f32(1.0) - p1)
        pq2 = p2 * (f32(1.0) - p2)
        ipq1 = np.where(pq1 == 0, f32(0), f32(1.0) / np.where(pq1 == 0, f32(1), pq1))
        ipq2 = np.where(pq2 == 0, f32(0), f32(1.0) / np.where(pq2 == 0, f32(1), pq2))
        d = c * inv_n - p1 * p2
        return (d * d) * (ipq1 * ipq2), None
    p_ab = c * inv_n
    q1 = (n - c1c) * inv_n
    q2 = (n - c2r) * inv_n
    d = p_ab - p1 * p2
    r2_den = (p1 * q1) * (p2 * q2)
    den_pos = np.minimum(p1 * q2, q1 * p2)
    den_neg = np.maximum(-(p1 * p2), -(q1 * q2))
    den = np.where(d >= 0, den_pos, den_neg)
    den_zero = den == f32(0)
    dp = np.where(den_zero, f32(0), d / np.where(den_zero, f32(1), den))
    dp_zero = dp == f32(0)
    r2 = np.where(dp_zero, f32(0), (d * d) / np.where(dp_zero, f32(1), r2_den))
    return r2, dp


class Suite:
    """The records of one run."""

    def __init__(self):
        self.results = []
        self.failures = 0

    def record(self, name, ok, seconds, max_err=None, note=""):
        rec = {"config": name, "ok": bool(ok), "seconds": round(seconds, 2)}
        if max_err is not None:
            rec["max_abs_err_vs_f32_order"] = float(f"{max_err:.3g}")
        if note:
            rec["note"] = note
        self.results.append(rec)
        self.failures += not ok
        print(json.dumps(rec), flush=True)

    def run(self, name, fn):
        """Run one configuration: ``fn()`` -> (ok, max_err or None, note).
        An exception fails the configuration and is recorded with it."""
        t0 = time.perf_counter()
        try:
            ok, err, note = fn()
        except Exception as exc:  # noqa: BLE001 - recorded, counted a failure
            self.record(name, False, time.perf_counter() - t0,
                        note=f"{type(exc).__name__}: {str(exc)[:160]}")
            return
        self.record(name, ok, time.perf_counter() - t0, err, note)


def _data(v):
    """Seed 0: per-row allele frequencies in [0, 1), rows 0-1 monomorphic
    (the sentinel branch), row 2 fixed but for its last 5 haplotypes (the
    ill-conditioned D' regime)."""
    rng = np.random.default_rng(0)
    freqs = rng.uniform(0.0, 1.0, size=(v, 1))
    G = (rng.random((v, H)) < freqs).astype(np.int8)
    G[0] = 0
    G[1] = 1
    G[2] = 1
    G[2, 5003:] = 0
    return G


def _f32_ipq(c1):
    p = c1 / np.float32(H)
    pq = p * (1 - p)
    return np.where(pq == 0, 0, 1 / np.where(pq == 0, 1, pq)).astype(
        np.float32)


def _host(t) -> np.ndarray:
    return t.cpu().numpy()


def run(v, device) -> dict:
    """Every configuration on ``device``; returns the artifact."""
    dev = resolve_device(device)
    suite = Suite()
    G = _data(v)
    cab_o, c1_o = oracle_counts(G)
    tril = np.tril_indices(v, -1)
    h_pad = -(-H // 128) * 128
    Gw = np.zeros((v, h_pad), dtype=np.uint8)
    Gw[:, :H] = G
    gp = lk.pack_rows(Gw)

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    r2_f32, dp_f32 = oracle_epilogue_f32(cab_o, c1_o, c1_o, H, "exact")
    r2fast_f32, _ = oracle_epilogue_f32(cab_o, c1_o, c1_o, H, "fast")

    def tri(cfg):
        kw = dict(epilogue=cfg["epilogue"], want_dprime=cfg["want_dprime"],
                  block_m=cfg["block"], block_n=cfg["block"])
        if cfg["packed"]:
            r2, dp = lk.ld_triangle_matrix_packed(on(gp), H,
                                                  kernel=cfg["kernel"], **kw)
        else:
            r2, dp = lk.ld_triangle_matrix(on(G), H, mxu_dtype="int8", **kw)
        ref_r2 = r2fast_f32 if cfg["epilogue"] == "fast" else r2_f32
        err = float(np.abs(_host(r2)[tril] - ref_r2[tril]).max())
        if dp is not None:
            err = max(err, float(np.abs(_host(dp)[tril]
                                        - dp_f32[tril]).max()))
        return err <= TOL, err, ""

    for name, cfg in TRI_CASES:
        suite.run(name, lambda cfg=cfg: tri(cfg))

    v_band = -(-v // max(BAND, CHUNK)) * max(BAND, CHUNK)
    Gb = np.zeros((v_band, h_pad), dtype=np.int8)
    Gb[:v, :H] = G
    gpb = lk.pack_rows(Gb.astype(np.uint8))
    c1 = Gb.astype(np.float32).sum(axis=1, keepdims=True)
    ipq = _f32_ipq(c1)
    nb, nc = min(BAND, v), min(CHUNK, v)
    cab_band_o = cab_o[:nb, :nc]
    r2m_o, dpm_o = r2fast_f32[:nb, :nc], dp_f32[:nb, :nc]

    def band(cfg):
        g = gpb if cfg["packed"] else Gb
        vals = lk.ld_band_sweep(
            on(g[:BAND]), on(g[:CHUNK]), on(c1[:BAND]), on(c1[:CHUNK]),
            on(ipq[:BAND]), on(ipq[:CHUNK]), H, packed=cfg["packed"],
            outs=cfg["outs"], sel=cfg["sel"], block_m=256, block_n=512)
        ok, err = True, 0.0
        if "cab" in cfg["outs"]:
            cab = _host(vals["cab"])[:nb, :nc].astype(np.int64)
            ok &= np.array_equal(cab, cab_band_o)
            err = max(err, float(np.abs(cab - cab_band_o).max()))
        if "meas" in cfg["outs"]:
            meas = _host(vals["meas"])[:nb, :nc]
            ref = r2m_o if cfg["sel"] == 0 else dpm_o
            err = max(err, float(np.abs(meas - ref).max()))
            # the fallback measure's band: the f32 mask the integer mask
            # was built to escape, where the 1/(p*q) scaling amplifies
            # one rounding of d = c*inv_n - p1*p2 in cancellation cells
            ok &= err <= MEAS_TOL
        if "r2" in cfg["outs"]:
            err = max(
                err,
                float(np.abs(_host(vals["r2"])[:nb, :nc]
                             - r2_f32[:nb, :nc]).max()),
                float(np.abs(_host(vals["dp"])[:nb, :nc]
                             - dp_f32[:nb, :nc]).max()),
            )
            ok &= err <= TOL
        return bool(ok), err, ""

    for name, cfg in BAND_CASES:
        suite.run(name, lambda cfg=cfg: band(cfg))

    # the fused count pass: per-block counts of kept pairs, bit for bit
    # with the exact integer mask over the full matrix (they size the
    # fetch buffers)
    cb = COUNT_BLOCK
    v_cb = -(-v // cb) * cb
    Gc = np.zeros((v_cb, h_pad), dtype=np.int8)
    Gc[:v, :H] = G
    gpc = lk.pack_rows(Gc.astype(np.uint8))
    c1c = Gc.astype(np.float32).sum(axis=1, keepdims=True)
    ipqc = _f32_ipq(c1c)
    pos_c = np.full((v_cb,), -(2**30), dtype=np.int32)
    pos_c[:v] = np.arange(v, dtype=np.int32) * 1000
    nbb = v_cb // cb
    bi_l, bj_l = [], []
    for i_b in range(nbb):
        for j_b in range(i_b + 1):
            bi_l.append(i_b)
            bj_l.append(j_b)
    thres_m = np.float32(0.3 - 5e-4)
    max_d = 400_000
    cab_full = oracle_counts(Gc)[0]

    def count(cfg):
        counts = _host(lk.ld_band_count(
            on(gpc if cfg["packed"] else Gc), on(c1c), on(ipqc), on(pos_c),
            on(lk.pack_block_coords(bi_l, bj_l)), (H, max_d), (thres_m,),
            packed=cfg["packed"], sel=cfg["sel"], exact_mask=True,
            use_dist=cfg["use_dist"], block_m=cb, block_n=cb))
        keep = lk.exact_keep_mask(
            torch.from_numpy(cab_full.astype(np.int32)),
            torch.from_numpy(c1c), torch.from_numpy(c1c.T), H, thres_m,
            cfg["sel"]).numpy()
        rows_g = np.arange(v_cb)[:, None]
        cols_g = np.arange(v_cb)[None, :]
        keep &= cols_g < rows_g
        if cfg["use_dist"]:
            keep &= np.abs(pos_c[:, None].astype(np.int64)
                           - pos_c[None, :].astype(np.int64)) <= max_d
        want = np.array([
            keep[bi_l[k] * cb:(bi_l[k] + 1) * cb,
                 bj_l[k] * cb:(bj_l[k] + 1) * cb].sum()
            for k in range(len(bi_l))
        ])
        delta = int(np.abs(counts.astype(np.int64) - want).max())
        # a delta breaks integer exactness; it is no f32 order drift
        return (np.array_equal(counts, want), None,
                f"max_count_delta={delta}" if delta else "")

    for name, cfg in COUNT_CASES:
        suite.run(name, lambda cfg=cfg: count(cfg))

    return {
        "meta": {"backend": dev.type,
                 "devices": [common.describe_device(dev)],
                 "v": v, "h": H,
                 "note": "errors are vs a host mirror of the kernels' own "
                         "f32 operation order; exact integer outputs must "
                         "match bit for bit",
                 "probes": PROBES_NOTE},
        "results": suite.results,
        "failures": suite.failures,
    }


def main(argv=None) -> int:
    """Runs the suite; returns the exit code (1 on any failure)."""
    ap = argparse.ArgumentParser(
        prog="python -m ld_tools_tpu_torch.bench.smoke",
        description="Every production kernel configuration against host "
                    "oracles, with a JSON artifact.")
    ap.add_argument("--out", default=None, help="write the artifact here")
    ap.add_argument("--v", type=int, default=1536)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"smoke {common.describe_device(dev)}", flush=True)
    lk.reset_launches()
    out = run(args.v, args.device)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
        print(f"wrote {args.out}", flush=True)
    common.log_launches()
    return 1 if out["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
