"""The port's cooperative scan: two real processes in one gloo group.

Mirrors tests/test_distributed.py's scan tests with the port's own code
(the workers import no JAX): utils.distributed.initialize_if_needed from
torchrun's variables, a cooperative scan over a two-shard CPU mesh per
process whose hits every process gathers, a kill mid-scan and a resume
from the per-process checkpoints, and the ld_scan tool under a group (one
chromosome together, or the chromosomes split).  The tool's TSVs are
held byte for byte against the JAX tool's.
"""

import json
import os
import socket
import subprocess
import sys
import types

import pytest

from ld_tools_tpu.ingest import prep_intgen_data, synth
from ld_tools_tpu.tools import scan as jax_scan
from ld_tools_tpu_torch import ld_scan as torch_ld_scan
from ld_tools_tpu_torch.utils import distributed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_DATA = r"""
import numpy as np
rng = np.random.default_rng(5)  # identical data on every process
V, H = 120, 64
base = (rng.random((V // 4, H)) < rng.uniform(0.1, 0.9, (V // 4, 1)))
G = np.repeat(base, 4, axis=0).astype(np.int8)
pos = (np.arange(V, dtype=np.int64) + 1) * 500
"""

_SCAN_WORKER = r"""
import json, os, sys
sys.path.insert(0, os.environ["TPU_LD_REPO"])
""" + _DATA + r"""
from ld_tools_tpu_torch.utils.distributed import (
    initialize_if_needed, process_count, process_index)

assert initialize_if_needed()
assert process_count() == 2
from ld_tools_tpu_torch.ops.ld_stream import (
    _allgather_hits, scan_mesh, stream_threshold_scan)

kw = dict(measure="r_square", thres=0.4, band=16, chunk=16, count_block=8,
          exact=True, device="cpu")
coop = stream_threshold_scan(G, pos=pos, mesh=scan_mesh(2, device="cpu"),
                             multiprocess=True, **kw)
solo = stream_threshold_scan(G, pos=pos, **kw)
ok = all(np.array_equal(getattr(coop, k), getattr(solo, k))
         for k in ("i", "j", "r_square", "d_prime", "r_square_is_int_zero",
                   "d_prime_is_int_zero"))
# a hit-less process gathers empty arrays of the others' dtypes (int16)
rank = process_index()
n = 3 if rank == 0 else 0
got = _allgather_hits({"i": np.arange(n, dtype=np.int64),
                       "j": np.arange(n, dtype=np.int64),
                       "cab": np.arange(n, dtype=np.int16) - 2}, ("cab",))
print(json.dumps({
    "pid": rank, "hits": int(len(coop.i)), "match": bool(ok),
    "shards": coop.stats["shards"], "blocks": coop.stats["blocks"],
    "solo_blocks": solo.stats["blocks"],
    "gather": [str(got["cab"].dtype), got["cab"].tolist(),
               got["i"].tolist()],
}), flush=True)
"""

_RESUME_WORKER = r"""
import json, os, sys
sys.path.insert(0, os.environ["TPU_LD_REPO"])
""" + _DATA + r"""
from ld_tools_tpu_torch.utils.distributed import (
    initialize_if_needed, process_index)

assert initialize_if_needed()
from ld_tools_tpu_torch.ops.ld_stream import stream_threshold_scan

kw = dict(measure="r_square", thres=0.4, band=16, chunk=16, count_block=8,
          exact=True, device="cpu")
if os.environ["MODE"] == "die":
    # hard-kill each process mid-scan at a different batch (counted in
    # checkpoint writes): partial per-process checkpoints stay on disk
    limit = 2 if process_index() == 0 else 4
    orig_savez = np.savez
    state = {"n": 0}
    def wrapper(*a, **k):
        if state["n"] >= limit:
            os._exit(3)
        state["n"] += 1
        return orig_savez(*a, **k)
    np.savez = wrapper

coop = stream_threshold_scan(G, pos=pos, multiprocess=True,
                             max_tiles_per_call=2,
                             checkpoint_dir=os.environ["CKPT_DIR"], **kw)
solo = stream_threshold_scan(G, pos=pos, **kw)
ok = all(np.array_equal(getattr(coop, k), getattr(solo, k))
         for k in ("i", "j", "r_square", "d_prime"))
print(json.dumps({
    "pid": process_index(), "hits": int(len(coop.i)), "match": bool(ok),
    "resumed": coop.stats["batches_resumed"],
    "batches": coop.stats["batches"],
}), flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch_pair(cmd, extra_env=None, retry_ok=None):
    """Run ``cmd`` as ranks 0 and 1 of a two-process gloo group (torchrun's
    variables); [(returncode, stdout, stderr)] by rank.  One retry absorbs
    a port race (``retry_ok`` decides whether a result stands)."""
    for attempt in range(2):
        port = _free_port()
        procs = []
        for rank in range(2):
            # one thread each: tiny shapes, and the test run's other
            # workers time CPU work beside them
            env = dict(os.environ, TPU_LD_REPO=REPO, PYTHONPATH=REPO,
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank),
                       TPU_LD_DIST_TIMEOUT_S="60", OMP_NUM_THREADS="1",
                       **(extra_env or {}))
            procs.append(subprocess.Popen(
                cmd, env=env, cwd=REPO, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        outs = []
        for p in procs:
            try:
                out, err = p.communicate(timeout=240)
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
            outs.append((p.returncode, out, err))
        if retry_ok is None or retry_ok(outs):
            break
    return outs


def _results(outs):
    for rc, _, err in outs:
        assert rc == 0, f"worker failed:\n{err[-3000:]}"
    return [json.loads(out.strip().splitlines()[-1]) for _, out, _ in outs]


def _worker(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return [sys.executable, str(path)]


def test_two_process_cooperative_scan(tmp_path):
    """Tiles split over two processes, each with a two-shard CPU mesh;
    every process ends with the single-process hit set, and gloo carries
    int16 counts and a hit-less process's empty arrays."""
    cmd = _worker(tmp_path, "scan_worker.py", _SCAN_WORKER)
    results = _results(_launch_pair(
        cmd, retry_ok=lambda o: all(rc == 0 for rc, _, _ in o)))
    assert {r["pid"] for r in results} == {0, 1}
    assert all(r["match"] and r["shards"] == 2 for r in results)
    assert results[0]["hits"] == results[1]["hits"] > 0
    # the two processes counted disjoint shares of the blocks
    assert sum(r["blocks"] for r in results) == results[0]["solo_blocks"]
    assert all(0 < r["blocks"] < r["solo_blocks"] for r in results)
    for r in results:
        assert r["gather"] == ["int16", [-2, -1, 0], [0, 1, 2]]


def test_two_process_cooperative_scan_kill_and_resume(tmp_path):
    """A cooperative scan killed mid-flight resumes from its per-process
    checkpoints and gives the single-process hits on every process."""
    cmd = _worker(tmp_path, "resume_worker.py", _RESUME_WORKER)
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    outs = _launch_pair(cmd, {"MODE": "die", "CKPT_DIR": str(ckpt)},
                        retry_ok=lambda o: all(rc == 3 for rc, _, _ in o))
    assert all(rc == 3 for rc, _, _ in outs), outs
    partial = list(ckpt.glob("scan_*_batch*.npz"))
    assert len(partial) == 2 + 4  # each process's writes before its kill
    fps = {p.name.split("_")[1] for p in partial}
    assert len(fps) == 2  # per-process fingerprints differ
    outs = _launch_pair(cmd, {"MODE": "resume", "CKPT_DIR": str(ckpt)},
                        retry_ok=lambda o: all(rc == 0 for rc, _, _ in o))
    results = _results(outs)
    assert {r["pid"] for r in results} == {0, 1}
    assert all(r["match"] for r in results)
    assert results[0]["hits"] == results[1]["hits"] > 0
    assert sorted(r["resumed"] for r in results) == [2, 4]
    assert all(r["batches"] == 9 for r in results)


CHROMS = {"5": 90, "11": 40}


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("intgen"))
    synth.generate_dataset(d, n_samples=30, chrom_variant_counts=CHROMS,
                           seed=7)
    prep_intgen_data(d)
    return d


def _jax_tsvs(store, trg, chroms="all"):
    jax_scan.run(types.SimpleNamespace(
        chroms=chroms, trg_dir_path=trg, intgen_dir_path=store,
        skip_intgen_data_ver=True, gend_names="both", pop_names="all",
        ld_measure="r_square", ld_low_thres=0.5, max_dist=None,
        checkpoint_dir=None, devices=None, engine="xla"))
    return {n: open(os.path.join(trg, n), "rb").read()
            for n in sorted(os.listdir(trg))}


def test_cli_sharded_and_resumable_tsv_matches_jax(store, tmp_path):
    """-E torch -d 2 -k <dir>: the JAX tool's bytes, on the first run and
    on the second, which resumes every batch from the checkpoints."""
    want = _jax_tsvs(store, str(tmp_path / "jax"))
    ckpt = tmp_path / "ckpt"
    for run in range(2):
        out = tmp_path / f"torch{run}"
        reports = torch_ld_scan.main([
            "-C", "all", "-D", store, "-t", str(out), "-f", "-E", "torch",
            "-z", "0.5", "-d", "2", "-k", str(ckpt)])
        got = {n: open(out / n, "rb").read() for n in sorted(os.listdir(out))}
        assert got == want and len(want) == len(CHROMS)
        for r in reports:
            assert r.stats["shards"] == 2
            assert r.stats["batches_resumed"] == (r.stats["batches"]
                                                  if run else 0)
    assert len(list(ckpt.glob("scan_*_batch*.npz"))) >= len(CHROMS)


@pytest.mark.parametrize("chroms", ["5", "all"])
def test_cli_under_a_process_group_matches_jax(store, tmp_path, chroms):
    """``python -m ld_tools_tpu_torch.ld_scan`` as two ranks: one
    chromosome is scanned together and rank 0 writes it; several are
    split round-robin, each rank writing its own.  The files are the JAX
    tool's bytes, and each process reports its launch counts."""
    want = _jax_tsvs(store, str(tmp_path / "jax"), chroms)
    out = tmp_path / "torch"
    cmd = [sys.executable, "-m", "ld_tools_tpu_torch.ld_scan", "-C", chroms,
           "-D", store, "-t", str(out), "-f", "-E", "torch", "-z", "0.5",
           "-k", str(tmp_path / "ckpt")]
    outs = _launch_pair(cmd, retry_ok=lambda o: all(rc == 0 for rc, _, _ in o))
    for rc, _, err in outs:
        assert rc == 0, err[-3000:]
        reports = [ln for ln in err.splitlines()
                   if ln.startswith('{"launches"')]
        assert len(reports) == 1
        assert set(json.loads(reports[0])["launches"].values()) == {0}
    got = {n: open(out / n, "rb").read() for n in sorted(os.listdir(out))}
    assert got == want
    assert list((tmp_path / "ckpt").glob("scan_*_batch*.npz"))


def test_initialize_needs_all_four_variables(monkeypatch, caplog):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert not distributed.initialize_if_needed()
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with caplog.at_level("WARNING"):
        assert not distributed.initialize_if_needed()
    assert "MASTER_PORT, RANK missing" in caplog.text
    assert distributed.process_count() == 1
    assert distributed.process_index() == 0


def test_local_device_follows_local_rank(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert distributed.local_device("cuda") == torch.device("cuda", 1)
    assert distributed.local_device("cpu") is None
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert distributed.local_device("cuda") is None


def test_scan_mesh_takes_local_cards_and_repeats_them(monkeypatch):
    """The first n local cards, repeated past their count (four shards
    on one card); one card per process under a launcher; on the CPU, n
    CPU shards."""
    import torch

    from ld_tools_tpu_torch.ops.ld_stream import scan_mesh

    cuda = [torch.device("cuda", k) for k in range(3)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert scan_mesh() == cuda[:1]
    assert scan_mesh(4) == cuda[:1] * 4
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert scan_mesh() == cuda
    assert scan_mesh(2) == cuda[:2]
    assert scan_mesh(4) == cuda + cuda[:1]
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert scan_mesh() == [cuda[1]]
    assert scan_mesh(2) == [cuda[1]] * 2
    assert scan_mesh(3, device="cpu") == [torch.device("cpu")] * 3
    assert scan_mesh(device="cpu") == [torch.device("cpu")]
