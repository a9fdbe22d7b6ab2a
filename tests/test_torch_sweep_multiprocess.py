"""The port's sweeps across processes and its entry points (``entry``), on the
CPU.

Mirrors tests/test_distributed.py:81 with the port's own code (the
workers import no JAX): two real processes join a gloo group from
torchrun's variables, each brings two local shards (an explicit list),
and ``make_mesh(devices=...)`` spans the four; the ring's and the
trapezoid's blocks cross the process boundary at every step.  Each process's row bands must equal the port's
one-device sweep bit for bit, and the chromosome list splits round-robin.
The entry points (ld_tools_tpu_torch/entry.py) are held against
__graft_entry__.py: ``entry`` within 1e-6 of the JAX step run in a child
process without FMA, ``dryrun_multichip`` over four CPU shards.
"""

from ld_tools_tpu_torch.entry import dryrun_multichip, entry

from .test_torch_distributed import _launch_pair, _results, _worker
from .test_torch_ld_kernels import assert_f32_close, deferred, jax_without_fma

_SWEEP_WORKER = r"""
import json, os, sys
sys.path.insert(0, os.environ["TPU_LD_REPO"])
import numpy as np
import torch
from ld_tools_tpu_torch.utils.distributed import (
    initialize_if_needed, process_count, process_index)

assert initialize_if_needed()
assert process_count() == 2

from ld_tools_tpu_torch.parallel import (
    all_pairs_replicated, all_pairs_ring, all_pairs_trapezoid, make_mesh)
from ld_tools_tpu_torch.parallel.batch import chromosomes_for_this_process
from ld_tools_tpu_torch.parallel.sweep import ProcessMesh

chroms = chromosomes_for_this_process(["1", "2", "3", "4", "5"])
rng = np.random.default_rng(0)
# identical on every process: the JAX test's 32 x 40, and 60 rows, which
# leave the trapezoid's high bands rows of their own past the padding
mats = {"32": (rng.random((32, 40)) < 0.4).astype(np.int8)}
mats["60"] = (rng.random((60, 40)) < rng.uniform(0.1, 0.9, (60, 1))
              ).astype(np.int8)
mesh = make_mesh(devices=["cpu", "cpu"])  # 2 local shards: 4 over the group
assert isinstance(mesh, ProcessMesh) and len(mesh) == 4, mesh
out = {"pid": process_index(), "chroms": chroms,
       "owners": list(mesh.owners), "rows": {}, "equal": {}}
for name, fn in (("ring", all_pairs_ring), ("trapezoid", all_pairs_trapezoid),
                 ("replicated", all_pairs_replicated)):
    for v, G in mats.items():
        one_r2, one_dp = fn(G, mesh=["cpu"])
        r2s, dps = fn(G, mesh=mesh)
        out["rows"][f"{name}{v}"] = [[b.rows.start, b.rows.stop] for b in r2s]
        out["equal"][f"{name}{v}"] = all(
            b.rows == c.rows and torch.equal(b.data, one_r2[b.rows])
            and torch.equal(c.data, one_dp[c.rows]) for b, c in zip(r2s, dps))
print(json.dumps(out), flush=True)
"""


def test_two_process_sweeps(tmp_path):
    """Four shards over two processes: each process returns the bands of
    its own two shards, equal to the one-device sweep bit for bit."""
    cmd = _worker(tmp_path, "sweep_worker.py", _SWEEP_WORKER)
    results = _results(_launch_pair(
        cmd, retry_ok=lambda o: all(rc == 0 for rc, _, _ in o)))
    by_pid = {r["pid"]: r for r in results}
    assert set(by_pid) == {0, 1}
    for r in results:
        assert r["owners"] == [0, 0, 1, 1]
        assert set(r["equal"]) == {f"{name}{v}" for v in ("32", "60") for name
                                   in ("ring", "trapezoid", "replicated")}
        assert all(r["equal"].values()), r["equal"]
    # each process holds the rows of its own shards, every row once: the
    # ring's 4 bands of 8 (32 rows: no padding; 60 rows: 64 padded), the
    # trapezoid's 8 bands of 8 (64 padded rows), shard k holding bands k
    # and 7 - k, where a band wholly in the padding is left out
    rows = {pid: r["rows"] for pid, r in by_pid.items()}
    assert rows[0]["ring32"] == [[0, 8], [8, 16]]
    assert rows[1]["ring32"] == [[16, 24], [24, 32]]
    assert rows[0]["ring60"] == [[0, 16], [16, 32]]
    assert rows[1]["ring60"] == [[32, 48], [48, 60]]
    assert rows[0]["trapezoid32"] == [[0, 8], [8, 16]]
    assert rows[1]["trapezoid32"] == [[16, 24], [24, 32]]
    assert rows[0]["trapezoid60"] == [[0, 8], [8, 16], [48, 56], [56, 60]]
    assert rows[1]["trapezoid60"] == [[16, 24], [24, 32], [32, 40], [40, 48]]
    assert rows[0]["replicated60"] == rows[0]["ring60"]
    # round-robin chromosome split: disjoint, complete, balanced
    assert by_pid[0]["chroms"] == ["1", "3", "5"]
    assert by_pid[1]["chroms"] == ["2", "4"]


def test_entry_points_on_the_cpu():
    """``entry(device="cpu")`` against __graft_entry__.entry() (JAX in a
    child process without FMA): r^2 and D' within 1e-6; and the dry run
    of the sweeps and the sharded scan over four CPU shards."""
    fn, args = entry(device="cpu")
    assert args[0].shape == (1024, 5120) and args[0].device.type == "cpu"
    got = fn(*args)
    jax_entry = deferred("__graft_entry__", "entry")
    jax_fn = deferred("operator", "getitem", jax_entry, 0)
    jax_g = deferred("operator", "getitem",
                     deferred("operator", "getitem", jax_entry, 1), 0)
    (want,) = jax_without_fma([("__main__", "call", (jax_fn, jax_g), {})])
    for g, w in zip(got, want):
        assert g.shape == (1024, 1024)
        assert_f32_close(g.numpy(), w)
    dryrun_multichip(4, device="cpu")
