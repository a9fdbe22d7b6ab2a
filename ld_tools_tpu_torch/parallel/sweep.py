"""All-pairs LD sweeps sharded over a list of local devices: the
counterpart of ld_tools_tpu/parallel/sweep.py.

The variant axis of one chromosome splits into row bands, one shard per
entry of a device list (``make_mesh``, or any sequence of devices; a
device may repeat, so ``[cuda:0] * 4`` is four shards on one card and
``[cpu] * 4`` four on the CPU):

- ``all_pairs_replicated``: every distinct device holds all of G; shard
  k computes band k against every column;
- ``all_pairs_ring``: shard k starts with band k; at step s it multiplies
  its band by the block that started on shard (k - s) mod D, then passes
  the block on to shard k + 1 (JAX's ``lax.ppermute``: a ``.to`` of the
  next shard's device, a no-op where the device repeats);
- ``all_pairs_trapezoid``: 2D bands, shard k owning bands k and
  2D-1-k, so that every shard's share of the lower triangle is the same;
  two block buffers rotate and each shard computes only the blocks its
  triangle needs.

Each band-by-block product is ``ops/ld_math``'s int8 count and f32
epilogue, the same as the one-device sweep's, so every shard layout gives
the one-device values bit for bit.  The sweeps return the full (V, V) r^2
and D' on the first device, rows in natural order (the trapezoid's strict
upper triangle zero).  A sweep across processes (JAX's cross-process
ring) is not here.
"""

from __future__ import annotations


import numpy as np
import torch

from ld_tools_tpu_torch.ops.ld_kernels import shard_devices
from ld_tools_tpu_torch.ops.ld_math import (haplotype_counts_int8,
                                            ld_from_counts_static_n)
from ld_tools_tpu_torch.utils.device import device_guard, resolve_device


def make_mesh(n_devices=None, device="cuda") -> list:
    """The first ``n_devices`` local cards (all by default; asking for
    more than there are raises, as in JAX: results labelled N-device must
    have run on N), or on the CPU ``n_devices`` (default 1) shards."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * (1 if n_devices is None else int(n_devices))
    devices = [torch.device("cuda", k) for k in range(torch.cuda.device_count())]
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(f"requested {n_devices} devices, only "
                             f"{len(devices)} available")
        devices = devices[:n_devices]
    return devices


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _band_ld(g_rows, g_cols, c1_rows, c1_cols, n_hap):
    """Band x block counts and f32 epilogue: (r2, dp).  JAX traces the
    sweep with n fixed, so XLA divides by n as a product with 1/n."""
    out = ld_from_counts_static_n(haplotype_counts_int8(g_rows, g_cols),
                                  c1_rows, c1_cols, n_hap)
    return out["r_square"], out["d_prime"]


def _prep(G, mesh, band_mult: int):
    """Shared prologue: the shard devices, V padded to a multiple of
    ``band_mult * D * 8`` (JAX's ``_prep``), row sums, and the padded rows
    and sums on every distinct device.  Returns (devices, v, h, v_pad,
    {device: G}, {device: c1})."""
    devices = shard_devices(make_mesh() if mesh is None else mesh)
    d = len(devices)
    G = np.asarray(G, dtype=np.int8)
    v, h = G.shape
    v_pad = _round_up(v, band_mult * d * 8)
    Gp = np.zeros((v_pad, h), dtype=np.int8)
    Gp[:v] = G
    c1 = Gp.astype(np.int64).sum(axis=1).astype(np.float32)
    g_on, c1_on = {}, {}
    for dev in dict.fromkeys(devices):
        g_on[dev] = torch.from_numpy(Gp).to(dev)
        c1_on[dev] = torch.from_numpy(c1).to(dev)
    return devices, v, h, v_pad, g_on, c1_on


def _assemble(bands, dev, v):
    """Row bands (in row order) -> the (v, v) matrix on ``dev``."""
    return torch.cat([b.to(dev) for b in bands])[:v, :v]


def all_pairs_replicated(G, n_haplotypes=None, mesh=None):
    """Row-band sweep with G on every device: shard k computes rows
    [k*V/D, (k+1)*V/D) against all columns.  Returns (r2, d_prime), each
    (V, V) f32 on the first device."""
    devices, v, h, v_pad, g_on, c1_on = _prep(G, mesh, 1)
    n_hap = h if n_haplotypes is None else int(n_haplotypes)
    vb = v_pad // len(devices)
    r2s, dps = [], []
    for k, dev in enumerate(devices):
        rows = slice(k * vb, (k + 1) * vb)
        with device_guard(dev):
            r2, dp = _band_ld(g_on[dev][rows], g_on[dev], c1_on[dev][rows],
                              c1_on[dev], n_hap)
        r2s.append(r2)
        dps.append(dp)
    return _assemble(r2s, devices[0], v), _assemble(dps, devices[0], v)


def all_pairs_ring(G, n_haplotypes=None, mesh=None):
    """Ring sweep: shard k holds band k; at step s it multiplies its band
    by the block that started on shard (k - s) mod D, then passes the
    block to shard k + 1.  After D steps every shard holds its full
    (V/D, V) row band.  Returns (r2, d_prime) on the first device."""
    devices, v, h, v_pad, g_on, c1_on = _prep(G, mesh, 1)
    n_hap = h if n_haplotypes is None else int(n_haplotypes)
    d = len(devices)
    vb = v_pad // d
    band = [(g_on[dev][k * vb:(k + 1) * vb], c1_on[dev][k * vb:(k + 1) * vb])
            for k, dev in enumerate(devices)]
    buf = list(band)
    acc = [(torch.zeros((vb, v_pad), dtype=torch.float32, device=dev),
            torch.zeros((vb, v_pad), dtype=torch.float32, device=dev))
           for dev in devices]
    for s in range(d):
        for k, dev in enumerate(devices):
            src = (k - s) % d
            with device_guard(dev):
                r2, dp = _band_ld(band[k][0], buf[k][0], band[k][1],
                                  buf[k][1], n_hap)
                acc[k][0][:, src * vb:(src + 1) * vb] = r2
                acc[k][1][:, src * vb:(src + 1) * vb] = dp
        # the ppermute: shard k's block moves on to shard k + 1
        buf = [tuple(t.to(devices[k]) for t in buf[(k - 1) % d])
               for k in range(d)]
    return (_assemble([a[0] for a in acc], devices[0], v),
            _assemble([a[1] for a in acc], devices[0], v))


def all_pairs_trapezoid(G, n_haplotypes=None, mesh=None):
    """Triangle-balanced ring sweep: 2D bands, shard k owning the low band
    k and the high band 2D-1-k.  Two block buffers rotate (low blocks and
    high blocks); each shard computes only the blocks its triangle needs,
    3 band-by-block products at step 0 and 2 after.  Cells above the
    diagonal of a diagonal block are multiplied by 0, as in JAX.  Returns
    the full (V, V) r^2 and D' with the strict upper triangle zero, rows
    in natural order, on the first device."""
    devices, v, h, v_pad, g_on, c1_on = _prep(G, mesh, 2)
    n_hap = h if n_haplotypes is None else int(n_haplotypes)
    d = len(devices)
    vb = v_pad // (2 * d)

    def band(dev, b):
        return g_on[dev][b * vb:(b + 1) * vb], c1_on[dev][b * vb:(b + 1) * vb]

    def band_block(rows, blk, r_band, c_band, acc):
        """Masked band x block product written into the output band."""
        r2, dp = _band_ld(rows[0], blk[0], rows[1], blk[1], n_hap)
        dev = r2.device
        idx = torch.arange(vb, device=dev)
        keep = ((c_band * vb + idx)[None, :] <= (r_band * vb + idx)[:, None]
                ).to(torch.float32)
        acc[0][:, c_band * vb:(c_band + 1) * vb] = r2 * keep
        acc[1][:, c_band * vb:(c_band + 1) * vb] = dp * keep

    low = [band(dev, k) for k, dev in enumerate(devices)]
    high = [band(dev, 2 * d - 1 - k) for k, dev in enumerate(devices)]
    buf_a, buf_b = list(low), list(high)

    def zeros(dev):
        return (torch.zeros((vb, v_pad), dtype=torch.float32, device=dev),
                torch.zeros((vb, v_pad), dtype=torch.float32, device=dev))

    lo_acc = [zeros(dev) for dev in devices]
    hi_acc = [zeros(dev) for dev in devices]
    for s in range(d):
        for k, dev in enumerate(devices):
            src = (k - s) % d          # low-family band index in buf_a
            src_hi = 2 * d - 1 - src   # high-family band index in buf_b
            with device_guard(dev):
                if src <= k:  # the low band needs low blocks src <= k
                    band_block(low[k], buf_a[k], k, src, lo_acc[k])
                # the high band needs every low block ...
                band_block(high[k], buf_a[k], 2 * d - 1 - k, src, hi_acc[k])
                if src >= k:  # ... and the high blocks src_hi <= 2D-1-k
                    band_block(high[k], buf_b[k], 2 * d - 1 - k, src_hi,
                               hi_acc[k])
        buf_a = [tuple(t.to(devices[k]) for t in buf_a[(k - 1) % d])
                 for k in range(d)]
        buf_b = [tuple(t.to(devices[k]) for t in buf_b[(k - 1) % d])
                 for k in range(d)]
    # natural row order: band k is shard k's low band, band 2D-1-k its high
    rows = [lo_acc[k] for k in range(d)] + [hi_acc[k] for k in reversed(range(d))]
    return (_assemble([r[0] for r in rows], devices[0], v),
            _assemble([r[1] for r in rows], devices[0], v))
