"""All-pairs LD sweeps sharded over devices and processes: the
counterpart of ld_tools_tpu/parallel/sweep.py.

The variant axis of one chromosome splits into row bands, one shard per
entry of a mesh (``make_mesh``, or any sequence of local devices; a
device may repeat in a list the caller passes, so ``[cuda:0] * 4`` is
four shards on one card and ``[cpu] * 4`` four on the CPU):

- ``all_pairs_replicated``: every distinct device holds all of G; shard
  k computes band k against every column, with no traffic;
- ``all_pairs_ring``: shard k starts with band k; at step s it multiplies
  its band by the block that started on shard (k - s) mod D, then passes
  the block on to shard k + 1 (JAX's ``lax.ppermute``: :func:`_shift`);
- ``all_pairs_trapezoid``: 2D bands, shard k owning bands k and
  2D-1-k, so that every shard's share of the lower triangle is the same;
  two block buffers rotate and each shard computes only the blocks its
  triangle needs.

Across processes: after ``utils.distributed.initialize_if_needed()``,
``make_mesh()`` is a :class:`ProcessMesh` of every process's local shards
in rank order (JAX's global mesh after ``jax.distributed``), and
``make_mesh(n)`` its first n shards in all.  A block moves to the next
shard with ``.to`` where both shards are in one process, and as a host
copy over the group's gloo ``send``/``recv`` where they are not.

Each band-by-block product is ``ops/ld_math``'s int8 count and f32
epilogue, the same as the one-device sweep's, so every shard layout gives
the one-device values bit for bit.  In one process the sweeps return the
full (V, V) r^2 and D' on the first device, rows in natural order (the
trapezoid's strict upper triangle zero); across processes each process
returns the row bands its own shards hold (:class:`RowBand`, the
counterpart of a JAX array's ``addressable_shards``).
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from ld_tools_tpu_torch.ops.ld_kernels import shard_devices
from ld_tools_tpu_torch.ops.ld_math import (haplotype_counts_int8,
                                            ld_from_counts_static_n)
from ld_tools_tpu_torch.ops.ld_stream import scan_mesh
from ld_tools_tpu_torch.utils.device import device_guard
from ld_tools_tpu_torch.utils.distributed import process_count, process_index

# rows [rows.start, rows.stop) of a sweep's (V, V) output, held by one of
# this process's shards (a ``data`` of (rows, V) on the shard's device)
RowBand = collections.namedtuple("RowBand", "rows data")


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """The shards of every process of a torch.distributed group, in rank
    order: shard k lies on ``devices[k]`` of process ``owners[k]``;
    ``rank`` is this process's."""

    owners: tuple
    devices: tuple
    rank: int

    def __len__(self) -> int:
        return len(self.owners)


def make_mesh(n_devices=None, device="cuda", devices=None):
    """The shards of a sweep (JAX's ``make_mesh``): the first
    ``n_devices`` shards, or all of them, raising ValueError where fewer
    than ``n_devices`` exist, since silently truncating would record
    "n-device" results that ran on fewer devices.

    This process's shards are ``devices`` where given: an explicit list,
    the one place a device repeats on purpose (``[cuda:0] * 4`` is four
    shards on one card).  Otherwise they are ``scan_mesh(None, device)``:
    every visible card, or under a launcher this process's card; alone on
    the CPU, ``n_devices`` CPU shards (default 1).  Under an initialised
    torch.distributed group of more than one process, a
    :class:`ProcessMesh` of every process's shards in rank order, of which
    ``n_devices`` counts the first in all (JAX's global devices); it
    raises where that leaves a process without a shard."""
    group = process_count() > 1
    if devices is None:
        devices = scan_mesh(None if group else n_devices, device)
    local = [str(d) for d in devices]
    if not group:
        return [torch.device(d) for d in _first(local, n_devices)]
    import torch.distributed as dist

    gathered = [None] * process_count()
    dist.all_gather_object(gathered, local)
    owners = _first([r for r, shards in enumerate(gathered) for _ in shards],
                    n_devices)
    idle = sorted(set(range(len(gathered))) - set(owners))
    if idle:
        raise ValueError(f"the first {len(owners)} shards of the group leave "
                         f"process(es) {idle} without a shard")
    return ProcessMesh(
        owners=tuple(owners),
        devices=tuple(d for shards in gathered for d in shards)[:len(owners)],
        rank=process_index())


def _first(shards: list, n) -> list:
    """The first ``n`` of ``shards`` (all where ``n`` is None); ValueError
    where there are fewer."""
    if n is None:
        return shards
    if len(shards) < int(n):
        raise ValueError(f"requested {n} devices, only {len(shards)} "
                         "available")
    return shards[:int(n)]


@dataclasses.dataclass(frozen=True)
class _Plan:
    """The shards of a sweep: ``n`` in all, ``devices`` {shard index:
    device} of this process's, ``owners`` the rank of each; ``spans``
    whether they span processes."""

    n: int
    devices: dict
    owners: tuple
    rank: int
    spans: bool


def _plan(mesh) -> _Plan:
    if mesh is None:
        mesh = make_mesh()
    if not isinstance(mesh, ProcessMesh):  # a list of this process's shards
        mesh = ProcessMesh((0,) * len(mesh), tuple(mesh), 0)
    mine = [k for k, r in enumerate(mesh.owners) if r == mesh.rank]
    devs = shard_devices([mesh.devices[k] for k in mine])
    return _Plan(len(mesh), dict(zip(mine, devs)), mesh.owners, mesh.rank,
                 spans=len(set(mesh.owners)) > 1)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _band_ld(g_rows, g_cols, c1_rows, c1_cols, n_hap):
    """Band x block counts and f32 epilogue: (r2, dp).  JAX traces the
    sweep with n fixed, so XLA divides by n as a product with 1/n."""
    out = ld_from_counts_static_n(haplotype_counts_int8(g_rows, g_cols),
                                  c1_rows, c1_cols, n_hap)
    return out["r_square"], out["d_prime"]


def _prep(G, mesh, band_mult: int):
    """Shared prologue: the shard plan, V padded to a multiple of
    ``band_mult * D * 8`` (JAX's ``_prep``), row sums, and the padded rows
    and sums on every distinct device of this process.  Returns (plan, v,
    h, v_pad, {device: G}, {device: c1})."""
    plan = _plan(mesh)
    G = np.asarray(G, dtype=np.int8)
    v, h = G.shape
    v_pad = _round_up(v, band_mult * plan.n * 8)
    Gp = np.zeros((v_pad, h), dtype=np.int8)
    Gp[:v] = G
    c1 = Gp.astype(np.int64).sum(axis=1).astype(np.float32)
    g_on, c1_on = {}, {}
    for dev in dict.fromkeys(plan.devices.values()):
        g_on[dev] = torch.from_numpy(Gp).to(dev)
        c1_on[dev] = torch.from_numpy(c1).to(dev)
    return plan, v, h, v_pad, g_on, c1_on


def _shift(plan: _Plan, bufs: dict, tag: int = 0) -> dict:
    """One ring step (JAX's ``lax.ppermute`` over the shard axis): the
    block of every shard moves to shard k + 1 mod D.  ``bufs`` maps each
    of this process's shards to its block (a tuple of tensors of one
    shape on every shard); returns the blocks they hold after the step.
    Within a process a block moves with ``.to``; between processes as host
    copies over gloo, each process posting every send and receive of its
    shards before waiting on any (``tag`` tells concurrent rings apart)."""
    import torch.distributed as dist

    d = plan.n
    width = max((len(b) for b in bufs.values()), default=0)
    ops, sent, got = [], [], {}
    for k, blk in bufs.items():
        dst = (k + 1) % d
        if plan.owners[dst] != plan.rank:
            for i, t in enumerate(blk):
                host = t.cpu().contiguous()
                sent.append(host)
                ops.append(dist.isend(host, plan.owners[dst],
                                      tag=tag + width * dst + i))
    for k, blk in bufs.items():
        src = (k - 1) % d
        if plan.owners[src] == plan.rank:
            got[k] = bufs[src]
            continue
        got[k] = tuple(torch.empty(t.shape, dtype=t.dtype) for t in blk)
        for i, h in enumerate(got[k]):
            ops.append(dist.irecv(h, plan.owners[src],
                                  tag=tag + width * k + i))
    for op in ops:
        op.wait()
    return {k: tuple(t.to(plan.devices[k]) for t in blk)
            for k, blk in got.items()}


def _output(plan: _Plan, bands, vb: int, v: int):
    """(r2, dp) from this process's bands [(band index, r2, dp)]: in one
    process the (v, v) matrices on the first shard's device, rows in
    natural order; across processes two lists of :class:`RowBand`."""
    bands = sorted(bands, key=lambda b: b[0])
    if not plan.spans:
        first = plan.devices[0]
        return tuple(torch.cat([b[i].to(first) for b in bands])[:v, :v]
                     for i in (1, 2))
    r2s, dps = [], []
    for b, r2, dp in bands:
        lo, hi = min(b * vb, v), min((b + 1) * vb, v)
        if hi > lo:  # a band wholly in the padding holds no row
            r2s.append(RowBand(slice(lo, hi), r2[:hi - lo, :v]))
            dps.append(RowBand(slice(lo, hi), dp[:hi - lo, :v]))
    return r2s, dps


def all_pairs_replicated(G, n_haplotypes=None, mesh=None):
    """Row-band sweep with G on every device: shard k computes rows
    [k*V/D, (k+1)*V/D) against all columns.  Returns (r2, d_prime), each
    (V, V) f32 on the first device (across processes: this process's
    :class:`RowBand` lists)."""
    plan, v, h, v_pad, g_on, c1_on = _prep(G, mesh, 1)
    n_hap = h if n_haplotypes is None else int(n_haplotypes)
    vb = v_pad // plan.n
    bands = []
    for k, dev in plan.devices.items():
        rows = slice(k * vb, (k + 1) * vb)
        with device_guard(dev):
            r2, dp = _band_ld(g_on[dev][rows], g_on[dev], c1_on[dev][rows],
                              c1_on[dev], n_hap)
        bands.append((k, r2, dp))
    return _output(plan, bands, vb, v)


def all_pairs_ring(G, n_haplotypes=None, mesh=None):
    """Ring sweep: shard k holds band k; at step s it multiplies its band
    by the block that started on shard (k - s) mod D, then passes the
    block to shard k + 1.  After D steps every shard holds its full
    (V/D, V) row band.  Returns (r2, d_prime) on the first device (across
    processes: this process's :class:`RowBand` lists)."""
    plan, v, h, v_pad, g_on, c1_on = _prep(G, mesh, 1)
    n_hap = h if n_haplotypes is None else int(n_haplotypes)
    d = plan.n
    vb = v_pad // d
    band = {k: (g_on[dev][k * vb:(k + 1) * vb],
                c1_on[dev][k * vb:(k + 1) * vb])
            for k, dev in plan.devices.items()}
    buf = dict(band)
    acc = {k: (torch.zeros((vb, v_pad), dtype=torch.float32, device=dev),
               torch.zeros((vb, v_pad), dtype=torch.float32, device=dev))
           for k, dev in plan.devices.items()}
    for s in range(d):
        for k, dev in plan.devices.items():
            src = (k - s) % d
            with device_guard(dev):
                r2, dp = _band_ld(band[k][0], buf[k][0], band[k][1],
                                  buf[k][1], n_hap)
                acc[k][0][:, src * vb:(src + 1) * vb] = r2
                acc[k][1][:, src * vb:(src + 1) * vb] = dp
        if s + 1 < d:
            buf = _shift(plan, buf)
    return _output(plan, [(k, *acc[k]) for k in acc], vb, v)


def all_pairs_trapezoid(G, n_haplotypes=None, mesh=None):
    """Triangle-balanced ring sweep: 2D bands, shard k owning the low band
    k and the high band 2D-1-k.  Two block buffers rotate (low blocks and
    high blocks); each shard computes only the blocks its triangle needs,
    3 band-by-block products at step 0 and 2 after.  Cells above the
    diagonal of a diagonal block are multiplied by 0, as in JAX.  Returns
    the full (V, V) r^2 and D' with the strict upper triangle zero, rows
    in natural order, on the first device (across processes: this
    process's :class:`RowBand` lists)."""
    plan, v, h, v_pad, g_on, c1_on = _prep(G, mesh, 2)
    n_hap = h if n_haplotypes is None else int(n_haplotypes)
    d = plan.n
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

    low = {k: band(dev, k) for k, dev in plan.devices.items()}
    high = {k: band(dev, 2 * d - 1 - k) for k, dev in plan.devices.items()}
    buf_a, buf_b = dict(low), dict(high)

    def zeros(dev):
        return (torch.zeros((vb, v_pad), dtype=torch.float32, device=dev),
                torch.zeros((vb, v_pad), dtype=torch.float32, device=dev))

    lo_acc = {k: zeros(dev) for k, dev in plan.devices.items()}
    hi_acc = {k: zeros(dev) for k, dev in plan.devices.items()}
    for s in range(d):
        for k, dev in plan.devices.items():
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
        if s + 1 < d:
            buf_a = _shift(plan, buf_a)
            buf_b = _shift(plan, buf_b, tag=2 * d)
    bands = ([(k, *lo_acc[k]) for k in lo_acc]
             + [(2 * d - 1 - k, *hi_acc[k]) for k in hi_acc])
    return _output(plan, bands, vb, v)
