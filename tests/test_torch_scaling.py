"""The port's sharded-scan scaling script (ld_tools_tpu_torch/bench/
scaling.py) on the CPU: the JAX script's workload, the hit set over
[cpu] * n against JAX's one-device scan, and the refusal of hit sets that
differ between mesh sizes."""

import json
import os
import types

import numpy as np
import pytest

from ld_tools_tpu.ops import ld_stream as jls
from ld_tools_tpu_torch.bench import scaling

# the JAX script appends to XLA_FLAGS when it is imported: keep the
# flags the suite runs with
_XLA_FLAGS = os.environ.get("XLA_FLAGS")
from scripts import bench_scaling as jax_scaling  # noqa: E402

if _XLA_FLAGS is not None:
    os.environ["XLA_FLAGS"] = _XLA_FLAGS

V, H = 256, 64


@pytest.mark.parametrize("v,h,flip_rows", [(256, 64, 8192), (320, 48, 100)])
def test_workload_is_the_jax_scripts(v, h, flip_rows, monkeypatch):
    """The same random stream, the flip draw also when it is taken in
    several row chunks."""
    monkeypatch.setattr(scaling, "_FLIP_ROWS", flip_rows)
    for got, want in zip(scaling._workload(v, h), jax_scaling._workload(v, h)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def jax_hits():
    G, pos = jax_scaling._workload(V, H)
    hits = jls.stream_threshold_scan(
        G, pos=pos, measure="r_square", thres=0.8, band=512, chunk=1024,
        exact=False, use_pallas=False)
    return np.sort(np.asarray(hits.i, np.int64) * V
                   + np.asarray(hits.j, np.int64))


@pytest.mark.parametrize("n", [1, 2, 4])
def test_scan_over_cpu_shards_finds_the_jax_hits(n, jax_hits):
    G, pos = scaling._workload(V, H)
    seconds, hits = scaling.bench_scan(G, pos, ["cpu"] * n, "cpu", reps=1)
    assert seconds > 0 and len(jax_hits) > 0
    np.testing.assert_array_equal(scaling.hit_keys(hits, V), jax_hits)
    if n > 1:
        assert hits.stats["shards"] == n


def test_hits_that_differ_between_mesh_sizes_raise(monkeypatch, capsys):
    real = scaling.bench_scan

    def one_hit_short(G, pos, mesh, device, reps=3):
        seconds, hits = real(G, pos, mesh, device, reps=1)
        if len(mesh) == 2:
            hits = types.SimpleNamespace(i=hits.i[1:], j=hits.j[1:])
        return seconds, hits

    monkeypatch.setattr(scaling, "bench_scan", one_hit_short)
    monkeypatch.setattr(scaling, "bench_ring", lambda G, mesh, device: 1.0)
    with pytest.raises(RuntimeError, match="hit sets differ"):
        scaling.run(V, H, "cpu")
    # the one-shard row was printed before the mismatch
    (row,) = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
              if ln.startswith('{"devices"')]
    assert row["devices"] == 1 and row["hits"] > 0


def test_main_prints_a_row_per_mesh_size_and_the_table(tmp_path, capsys):
    doc = tmp_path / "doc" / "SCALING.md"
    rows = scaling.main(["--device", "cpu", "--v", str(V), "--h", str(H),
                         "--doc", str(doc)])
    assert [r["devices"] for r in rows] == list(scaling.MESH_SIZES)
    assert len({r["hits"] for r in rows}) == 1 and rows[0]["hits"] > 0
    keys = {"devices", "scan_s", "scan_gpairs_per_s", "scan_speedup",
            "scan_efficiency", "ring_s", "ring_speedup", "hits"}
    for r in rows:
        assert set(r) == keys | {"cards", "launches"} and r["launches"] == {}
        assert r["cards"] == 1  # every shard on the one CPU
    out = capsys.readouterr().out
    printed = [json.loads(ln) for ln in out.splitlines()
               if ln.startswith('{"devices"')]
    assert printed == rows
    table = doc.read_text()
    assert table in out and "CPU repeated" in table
    assert table.count("\n| ") == len(rows) + 1  # header and one per size


def test_shard_lists_and_the_table_name_their_cards(monkeypatch):
    """n shards are the first n cards where there are n, else the first
    card n times; the rows' ``cards`` and the table's prose say which
    rows had fewer cards than shards, and only those."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    cuda = [torch.device("cuda", k) for k in range(2)]
    assert [scaling.shard_list(n, "cuda") for n in (1, 2, 4)] == [
        cuda[:1], cuda, cuda[:1] * 4]
    assert scaling.shard_list(4, "cpu") == [torch.device("cpu")] * 4
    monkeypatch.setattr(scaling.common, "describe_device",
                        lambda dev: "device: a card")
    rows = [dict(devices=n, cards=len(set(scaling.shard_list(n, "cuda"))),
                 scan_s=1.0, scan_gpairs_per_s=1.0, scan_speedup=1.0,
                 scan_efficiency=round(1 / n, 2), ring_s=1.0,
                 ring_speedup=1.0) for n in scaling.MESH_SIZES]
    text = scaling.table(rows, V, H, torch.device("cuda"))
    assert "2 local card(s)" in text
    assert "At 4, 8 shards there are fewer cards" in text
    assert "| 2 | 2 | 1.0 |" in text and "| 8 | 1 | 1.0 |" in text
    assert "fewer cards" not in scaling.table(rows[:2], V, H,
                                              torch.device("cuda"))
