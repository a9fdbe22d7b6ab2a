"""The port's sharded count (K7's plain route), mesh scan and checkpoints
on the CPU against the JAX package's.

K7 (``ld_band_count_sharded`` over ``[cpu] * n``) must give the int32
counts of JAX's ``ld_band_count_sharded`` over ``scan_mesh(n)`` in
interpret mode, and of its own unsharded count.  The mesh scan mirrors
tests/test_stream.py's mesh tests, the checkpoints its resume tests.  Every
JAX reference comes from one child process with 4 virtual CPU devices and
no FMA instructions (see test_torch_ld_kernels).  Exact scans are held
bit for bit, f32 fast-scan values to 1e-6.
"""

import numpy as np
import pytest
import torch

from ld_tools_tpu_torch.ops import ld_kernels as tk
from ld_tools_tpu_torch.ops import ld_stream as tls

from .conftest import random_haplotypes
from .test_torch_ld_kernels import deferred, jax_without_fma
from .test_torch_scan import _assert_same_hits

STREAM = "ld_tools_tpu.ops.ld_stream"
PALLAS = "ld_tools_tpu.ops.ld_pallas"
BLOCK = 8
THRES = 0.3 - 5e-4
MAX_DIST = 300_000


def _k7_inputs(packed):
    """One resident layout (JAX's, at band = chunk = 16) with monomorphic
    and near-monomorphic rows, and the lower-triangle block list."""
    rng = np.random.default_rng(71)
    G = random_haplotypes(rng, 60, 64, maf_low=0.05, maf_high=0.95)
    for k in range(1, 60, 3):
        G[k] = np.where(rng.random(64) < 0.05, 1 - G[k - 1], G[k - 1])
    G[3] = 0
    G[9] = 1
    G[10] = 0
    G[10, 4] = 1
    pos = np.sort(rng.choice(10**6, size=60, replace=False)).astype(np.int64)
    src = np.packbits(G.astype(np.uint8), axis=1) if packed else G
    res = tls.prepare_resident(src, 64, pos, "cpu", packed=packed,
                               resident="packed" if packed else "dense",
                               band=16, chunk=16)
    assert res.packed == packed
    bi, bj = np.tril_indices(-(-60 // BLOCK))
    return res, tk.pack_block_coords(bi, bj)


def _jax_k7_padded(cij, n):
    """JAX's per-call layout of a sharded count (ld_stream.py:553-566):
    n slices of ``loc`` blocks, (0, 0) padding; and how to trim it."""
    loc = 1
    while loc < -(-len(cij) // n):
        loc *= 2
    padded = np.zeros((n * loc,), dtype=np.int32)
    padded[:len(cij)] = cij
    keep = np.concatenate([
        np.arange(s * loc, s * loc + min(loc, max(0, len(cij) - s * loc)))
        for s in range(n)])
    return padded, keep


K7_CASES = [(packed, use_dist, n) for packed in (False, True)
            for use_dist in (False, True) for n in (2, 4)]


def _k7_static(packed, use_dist):
    return dict(packed=packed, sel=0, exact_mask=True, use_dist=use_dist,
                block_m=BLOCK, block_n=BLOCK)


def _k7_params(use_dist):
    return ((64, MAX_DIST if use_dist else 0), (THRES,))


def _copies(res, devices):
    """K7's resident operands: {device: tensor} maps of res's tensors."""
    return tuple(tk.shard_replicas(t, devices)
                 for t in (res.g, res.c1, res.ipq, res.pos))


def _scan_G(seed, v, h, mono=()):
    """Runs of noisy copies (so the thresholds keep pairs) with
    monomorphic rows ``mono``; ascending positions."""
    rng = np.random.default_rng(seed)
    G = random_haplotypes(rng, v, h, maf_low=0.05, maf_high=0.95)
    for k in range(1, v):
        if k % 4:
            G[k] = np.where(rng.random(h) < 0.05, 1 - G[k - 1], G[k - 1])
    for k in mono:
        G[k] = 0
    pos = np.sort(np.random.default_rng(seed + 1).choice(
        10**6, size=v, replace=False)).astype(np.int64)
    return G, pos


# (JAX kwargs, mesh size) of the mirrored mesh scans; every scan runs the
# exact finish unless it says exact=False
SCAN_CASES = {
    # test_scan_sharded_mesh_matches_single_device
    "mesh": (dict(measure="r_square", thres=0.3, band=16, chunk=16,
                  use_pallas=False, max_dist=600_000), 2),
    "mesh4": (dict(measure="r_square", thres=0.3, band=16, chunk=16,
                   use_pallas=False, max_dist=600_000), 4),
    # test_scan_sharded_packed_input
    "packed": (dict(measure="d_prime", thres=0.5, band=16, chunk=16,
                    use_pallas=False), 4),
    # test_scan_sharded_mesh_fused_block_count_interpret.  JAX's mesh
    # scan with the fused count cannot fetch hits (its Pallas band kernel
    # inside shard_map trips check_vma; that test's data has no hits), so
    # these hold the port's mesh scan against JAX's one-device fused scan
    "fused2": (dict(measure="r_square", thres=0.3, band=16, chunk=16,
                    use_pallas=True, interpret=True, count_block=8,
                    max_dist=600_000), 2),
    "fused4": (dict(measure="r_square", thres=0.3, band=16, chunk=16,
                    use_pallas=True, interpret=True, count_block=8,
                    max_dist=600_000), 4),
    # the f32 values of a fast scan
    "fast": (dict(measure="d_prime", thres=0.5, band=16, chunk=16,
                  use_pallas=False, exact=False), 4),
}


def _scan_input(case):
    if case == "packed" or case == "fast":
        G, pos = _scan_G(40, 40, 53)
        gp = np.packbits(G.astype(np.uint8), axis=1)
        return dict(G_packed=gp, n_haplotypes=53, pos=pos)
    if case.startswith("fused"):
        G, pos = _scan_G(60, 60, 64, mono=(3,))
    else:
        G, pos = _scan_G(70, 70, 64, mono=(3,))
    return dict(G=G, pos=pos)


def _ckpt_input():
    G = _scan_G(50, 50, 80)[0]
    return G, (np.arange(50, dtype=np.int64) + 1) * 100


@pytest.fixture(scope="module")
def jax_refs():
    """Every JAX reference of this module, from one child process."""
    calls = {}
    for packed, use_dist, n in K7_CASES:
        res, cij = _k7_inputs(packed)
        padded, _ = _jax_k7_padded(cij, n)
        fn = deferred(PALLAS, "ld_band_count_sharded",
                      deferred(STREAM, "scan_mesh", n), interpret=True,
                      **_k7_static(packed, use_dist))
        pi, pf = _k7_params(use_dist)
        calls["k7", packed, use_dist, n] = ("__main__", "call", (
            fn, res.g.numpy(), res.c1.numpy(), res.ipq.numpy(),
            res.pos.numpy(), padded, np.asarray(pi, dtype=np.int32),
            np.asarray(pf, dtype=np.float32)), {})
    for case, (jkw, n) in SCAN_CASES.items():
        mesh = (None if case.startswith("fused")
                else deferred(STREAM, "scan_mesh", n))
        calls["scan", case] = (STREAM, "stream_threshold_scan", (), dict(
            _scan_input(case), mesh=mesh, **jkw))
    G, pos = _ckpt_input()
    calls["ckpt"] = (STREAM, "stream_threshold_scan", (G,), dict(
        pos=pos, measure="r_square", thres=0.4, band=16, chunk=16,
        use_pallas=False, exact=True))
    out = jax_without_fma(list(calls.values()), n_devices=4)
    return dict(zip(calls, out))


@pytest.mark.parametrize("packed,use_dist,n", K7_CASES)
def test_k7_counts_match_jax(jax_refs, packed, use_dist, n):
    res, cij = _k7_inputs(packed)
    pi, pf = _k7_params(use_dist)
    got = tk.ld_band_count_sharded(
        ["cpu"] * n, *_copies(res, ["cpu"]), torch.from_numpy(cij), pi, pf,
        **_k7_static(packed, use_dist))
    assert got.dtype == torch.int32 and got.shape == (len(cij),)
    _, keep = _jax_k7_padded(cij, n)
    want = np.asarray(jax_refs["k7", packed, use_dist, n])[keep]
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 0
    # and the port's own unsharded count of the same blocks
    one = tk.ld_band_count(res.g, res.c1, res.ipq, res.pos,
                           torch.from_numpy(cij), pi, pf,
                           **_k7_static(packed, use_dist))
    assert torch.equal(got, one)


def test_k7_takes_per_device_copies_and_empty_shards():
    """Resident tensors may come as {device: tensor} maps; more shards
    than blocks leave the last shards empty; the counts keep block order."""
    res, cij = _k7_inputs(False)
    pi, pf = _k7_params(True)
    cpu = torch.device("cpu")
    kw = _k7_static(False, True)
    want = tk.ld_band_count(res.g, res.c1, res.ipq, res.pos,
                            torch.from_numpy(cij[:3]), pi, pf, **kw)
    got = tk.ld_band_count_sharded(
        [cpu] * 5, {cpu: res.g}, {cpu: res.c1}, {cpu: res.ipq},
        {cpu: res.pos}, cij[:3], pi, pf, **kw)
    assert torch.equal(got, want)
    assert tk.shard_slices(3, 5) == [(0, 1), (1, 2), (2, 3), (3, 3), (3, 3)]
    assert tk.shard_slices(10, 4) == [(0, 3), (3, 6), (6, 9), (9, 10)]
    assert tk.shard_slices(0, 2) == [(0, 0), (0, 0)]


def test_k7_refuses_mixed_device_kinds():
    res, cij = _k7_inputs(False)
    with pytest.raises(ValueError, match="mix"):
        tk.ld_band_count_sharded(["cpu", "meta"], *_copies(res, ["cpu"]),
                                 cij, *_k7_params(False),
                                 **_k7_static(False, False))


def test_k7_never_moves_the_resident_tensors():
    """The route follows the tensors: copies that lie on another device
    than their shard's ('meta' for a card here), a map without the shard's
    device, or bare tensors raise; nothing is copied to the CPU and run
    there."""
    res, cij = _k7_inputs(False)
    args = (torch.from_numpy(cij), *_k7_params(False))
    kw = _k7_static(False, False)
    cpu, meta = torch.device("cpu"), torch.device("meta")
    elsewhere = tuple({cpu: t.to(meta)}
                      for t in (res.g, res.c1, res.ipq, res.pos))
    with pytest.raises(ValueError, match="lies on meta"):
        tk.ld_band_count_sharded([cpu] * 2, *elsewhere, *args, **kw)
    with pytest.raises(ValueError, match="no resident copy"):
        tk.ld_band_count_sharded([cpu] * 2, *({meta: t} for t in
                                 (res.g, res.c1, res.ipq, res.pos)),
                                 *args, **kw)
    with pytest.raises(TypeError, match="map"):
        tk.ld_band_count_sharded([cpu] * 2, res.g, res.c1, res.ipq, res.pos,
                                 *args, **kw)
    with pytest.raises(ValueError, match="block list"):
        tk.ld_band_count_sharded([cpu] * 2, *_copies(res, [cpu]),
                                 torch.from_numpy(cij).to(meta),
                                 *_k7_params(False), **kw)
    assert tk.ld_band_count_sharded.launches == 0


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_mesh_scan_matches_jax_and_one_device(jax_refs, case):
    jkw, n = SCAN_CASES[case]
    kw = {k: x for k, x in jkw.items()
          if k not in ("use_pallas", "interpret")}
    kw.setdefault("count_block", 8)
    inp = _scan_input(case)
    got = tls.stream_threshold_scan(mesh=["cpu"] * n, device="cpu", **inp,
                                    **kw)
    one = tls.stream_threshold_scan(device="cpu", **inp, **kw)
    _assert_same_hits(got, one)
    _assert_same_hits(got, jax_refs["scan", case])
    st = got.stats
    assert st["shards"] == n and len(st["shard_blocks"]) == n
    assert sum(st["shard_blocks"]) == st["blocks"]
    assert sum(st["shard_hit_blocks"]) == st["hit_blocks"] == \
        st["blocks_checked"]


@pytest.mark.parametrize("count_block", [16, 8])
def test_checkpoint_resume(jax_refs, tmp_path, count_block):
    """test_scan_checkpoint_resume(_fused_path): max_tiles_per_call=2
    writes one file per batch; a second call resumes every batch; both
    equal a clean scan and the JAX scan."""
    G, pos = _ckpt_input()
    kw = dict(pos=pos, measure="r_square", thres=0.4, band=16, chunk=16,
              count_block=count_block, max_tiles_per_call=2, device="cpu",
              checkpoint_dir=str(tmp_path))
    first = tls.stream_threshold_scan(G, **kw)
    files = sorted(tmp_path.glob("scan_*_batch*.npz"))
    assert len(files) == first.stats["batches"] > 1
    assert len({p.name.split("_")[1] for p in files}) == 1
    second = tls.stream_threshold_scan(G, **kw)
    assert second.stats["batches_resumed"] == second.stats["batches"]
    assert second.stats["blocks"] == 0
    kw.pop("checkpoint_dir")
    clean = tls.stream_threshold_scan(G, **kw)
    for got in (first, second):
        _assert_same_hits(got, clean)
        _assert_same_hits(got, jax_refs["ckpt"])


def test_checkpoint_partial_resume_and_fingerprint(tmp_path):
    """A resume with some batch files gone runs exactly those batches; a
    changed threshold, tiling or shard list is fingerprinted (or not) as
    JAX fingerprints it: the mesh is not in the fingerprint."""
    G, pos = _ckpt_input()
    kw = dict(pos=pos, measure="r_square", thres=0.4, band=16, chunk=16,
              count_block=8, max_tiles_per_call=2, device="cpu",
              checkpoint_dir=str(tmp_path))
    first = tls.stream_threshold_scan(G, **kw)
    files = sorted(tmp_path.glob("scan_*_batch*.npz"))
    for p in files[::2]:
        p.unlink()
    again = tls.stream_threshold_scan(G, mesh=["cpu"] * 3, **kw)
    assert again.stats["batches_resumed"] == len(files) - len(files[::2])
    _assert_same_hits(again, first)
    assert len(list(tmp_path.glob("scan_*_batch*.npz"))) == len(files)
    tls.stream_threshold_scan(G, **dict(kw, thres=0.5))
    tls.stream_threshold_scan(G, **dict(kw, max_tiles_per_call=3))
    fps = {p.name.split("_")[1] for p in tmp_path.glob("scan_*.npz")}
    assert len(fps) == 3


def test_empty_batches_keep_the_cab_dtype(tmp_path):
    """A batch without hits saves empty arrays of the cab dtype rule
    (int16 below 32,768 haplotype bits): a cooperative scan gathers them
    beside other processes' real ones."""
    G, pos = _ckpt_input()
    tls.stream_threshold_scan(G, pos=pos, thres=0.99, band=16, chunk=16,
                              count_block=8, max_tiles_per_call=1,
                              device="cpu", checkpoint_dir=str(tmp_path))
    files = list(tmp_path.glob("scan_*_batch*.npz"))
    assert files
    for p in files:
        saved = np.load(p)
        assert saved["cab"].dtype == np.int16
        assert saved["i"].dtype == saved["j"].dtype == np.int64
    assert any(np.load(p)["i"].size == 0 for p in files)


def test_tiles_follow_the_jax_order():
    """The port's tiles are the JAX scan's: band x chunk, row bands then
    column chunks up to the diagonal, distance-pruned; each block sits in
    the tile of its top-left cell."""
    v, band, chunk, cb = 100, 16, 32, 8
    pos = (np.arange(v, dtype=np.int64) + 1) * 1000
    bi, bj = tls._scan_blocks(v, pos, cb, 20_000)
    tiles, home = tls._scan_tiles(v, pos, band, chunk, bi, bj, cb, 20_000)
    want = [(r0, c0) for r0 in range(0, v, band)
            for c0 in range(0, min(r0 + band, v), chunk)
            if not (min(c0 + chunk, v) - 1 < r0
                    and pos[r0] - pos[min(c0 + chunk, v) - 1] > 20_000)]
    assert tiles == want
    for b in range(len(bi)):
        r0, c0 = tiles[home[b]]
        assert r0 <= bi[b] * cb < r0 + band and c0 <= bj[b] * cb < c0 + chunk
