"""Entry points of the port (the counterpart of __graft_entry__.py):
a one-device check of the flagship LD step and a dry run of the sharded
sweeps and scan.

    from ld_tools_tpu_torch.entry import entry, dryrun_multichip
    fn, args = entry()          # on the card; entry("cpu") on the CPU
    r2, dp = fn(*args)
    dryrun_multichip(4)         # four cards; raises where fewer exist
    dryrun_multichip(4, devices=["cuda:0"] * 4)  # four shards on one card
"""

from __future__ import annotations

import numpy as np
import torch

from ld_tools_tpu_torch.utils.device import resolve_device


def entry(device="cuda"):
    """(fn, example_args) for the flagship compute path: the all-pairs LD
    step of ``ops/ld_math.ld_block`` (the int8 count product and the f32
    r^2 / D' epilogue) on a 1,024 x 5,120 {0, 1} matrix from
    ``np.random.default_rng(0)`` on ``device``; ``fn`` returns
    (r_square, d_prime)."""
    from ld_tools_tpu_torch.ops.ld_math import ld_block

    dev = resolve_device(device)

    def ld_step(g):
        out = ld_block(g, g)
        return out["r_square"], out["d_prime"]

    rng = np.random.default_rng(0)
    G = (rng.random((1024, 5120)) < 0.3).astype(np.int8)
    return ld_step, (torch.from_numpy(G).to(dev),)


def dryrun_multichip(n_devices: int, device="cuda", devices=None) -> None:
    """Run the three all-pairs sweeps over ``make_mesh(n_devices, device,
    devices=devices)`` (ValueError where fewer than ``n_devices`` shards
    exist, as JAX asserts n devices; ``devices`` is an explicit shard list,
    in which a card may repeat) on a ragged (16 n + 5) x 128 matrix, check
    their shapes, finiteness and agreement, then hold the sharded
    threshold scan over the same shards against the one-device scan, hit
    for hit.  Raises AssertionError on any disagreement."""
    from ld_tools_tpu_torch.ops.ld_stream import stream_threshold_scan
    from ld_tools_tpu_torch.parallel import (
        all_pairs_replicated,
        all_pairs_ring,
        all_pairs_trapezoid,
        make_mesh,
    )

    mesh = make_mesh(n_devices, device, devices=devices)
    rng = np.random.default_rng(1)
    v, h = n_devices * 16 + 5, 128  # ragged V exercises padding
    G = (rng.random((v, h)) < rng.uniform(0.1, 0.9, (v, 1))).astype(np.int8)

    r2_ring, dp_ring = all_pairs_ring(G, mesh=mesh)
    r2_rep, dp_rep = all_pairs_replicated(G, mesh=mesh)
    r2_trap, dp_trap = all_pairs_trapezoid(G, mesh=mesh)
    for arr in (r2_ring, dp_ring, r2_rep, dp_rep, r2_trap, dp_trap):
        np_arr = arr.cpu().numpy()
        if np_arr.shape != (v, v) or not np.all(np.isfinite(np_arr)):
            raise AssertionError(f"sweep output of shape {np_arr.shape}, "
                                 f"finite: {np.isfinite(np_arr).all()}")
    rep = r2_rep.cpu().numpy()
    if not np.allclose(r2_ring.cpu().numpy(), rep, atol=1e-5):
        raise AssertionError("the ring sweep differs from the replicated one")
    tri = np.tril_indices(v, 0)
    if not np.allclose(r2_trap.cpu().numpy()[tri], rep[tri], atol=1e-5):
        raise AssertionError("the trapezoid sweep differs from the "
                             "replicated one")

    # the tile-sharded streamed threshold scan over the same shards,
    # exact host refinish from the integer counts
    kw = dict(measure="r_square", thres=0.5, band=16, chunk=16, exact=True,
              device=device)
    hits = stream_threshold_scan(G, mesh=mesh, **kw)
    ref = stream_threshold_scan(G, **kw)
    if not (np.array_equal(hits.i, ref.i) and np.array_equal(hits.j, ref.j)
            and np.array_equal(hits.r_square, ref.r_square)):
        raise AssertionError("the sharded scan's hits differ from the "
                             "one-device scan's")
