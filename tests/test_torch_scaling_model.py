"""The port's scaling model (ld_tools_tpu_torch/bench/scaling_model.py) on
the CPU: its arithmetic regenerates SCALING_MODEL_r05.json's tables from
the artifact's measured block, exactly as scripts/scaling_model.py does;
its measurement returns every key at shrunken sizes; ``--measured``
writes an artifact with the JAX keys."""

import json
import math
import os

import pytest

from ld_tools_tpu_torch.bench import scaling_model as tsm
from ld_tools_tpu_torch.ops import ld_kernels as tk
from scripts import scaling_model as jsm

ART = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "SCALING_MODEL_r05.json")

LINKS = {
    "relay": lambda mod, meas, kw: mod.model(meas, direct=False, **kw),
    "direct": lambda mod, meas, kw: mod.model(meas, direct=True, **kw),
    "multihost_direct": lambda mod, meas, kw: mod.model_multihost(meas,
                                                                  **kw),
}


def _artifact():
    with open(ART) as fh:
        return json.load(fh)


def _as_json(x):
    """What the artifact holds: int keys become strings."""
    return json.loads(json.dumps(x))


@pytest.mark.parametrize("config", sorted(tsm.CONFIGS))
@pytest.mark.parametrize("link", sorted(LINKS))
def test_model_tables_regenerate_the_artifact(config, link):
    art = _artifact()
    meas = art["measured"]
    kw = tsm.CONFIGS[config]
    got = LINKS[link](tsm, meas, kw)
    assert got == LINKS[link](jsm, meas, kw)
    assert _as_json(got) == art["models"][config][link]


def test_batch_model_and_build_match_the_artifact():
    art = _artifact()
    assert tsm.batch_model(24) == jsm.batch_model(24)
    got = _as_json(tsm.build(art["measured"]))
    assert got["measured"] == art["measured"]
    assert got["models"]["genome_batch_24chrom"]["any_link"] == \
        art["models"]["genome_batch_24chrom"]["any_link"]
    for config in tsm.CONFIGS:
        assert got["models"][config] == art["models"][config]
    # the same assumptions are named; their text describes this host
    assert set(got["assumptions"]) == set(art["assumptions"])
    assert "no relay" in got["assumptions"]["relay_link"]


MEASURED_KEYS = {"backend", "device", "dispatch_s", "h2d_MBps", "d2h_MBps",
                 "count_call_fixed_s", "count_device_gpairs_s",
                 "count_blocks_measured"}


def test_measure_on_the_cpu_returns_every_key(monkeypatch):
    monkeypatch.setattr(tsm, "H2D_BYTES", 1 << 20)
    monkeypatch.setattr(tsm, "D2H_BYTES", 1 << 18)
    monkeypatch.setattr(tsm, "COUNT_V", 1024)
    monkeypatch.setattr(tsm, "COUNT_H", 256)
    monkeypatch.setattr(tsm, "COUNT_BLOCK", 64)
    monkeypatch.setattr(tsm, "COUNT_REPS", 2)
    tk.reset_launches()
    meas = tsm.measure("cpu")
    assert MEASURED_KEYS <= set(meas) == MEASURED_KEYS | {"device_line"}
    assert set(_artifact()["measured"]) == MEASURED_KEYS
    assert meas["backend"] == meas["device"] == "cpu"
    assert meas["device_line"].startswith("device: cpu")
    for k in MEASURED_KEYS - {"backend", "device"}:
        assert math.isfinite(meas[k]) and meas[k] > 0, k
    # 16 blocks of 64 rows a side: the 136 triangle blocks, as on the card
    assert meas["count_blocks_measured"] == 136
    assert not any(fn.launches for fn in tk.LAUNCH_SITES)


def test_measured_artifact_round_trip(tmp_path, capsys):
    out = tmp_path / "model.json"
    result = tsm.main(["--measured", ART, "--out", str(out)])
    with open(out) as fh:
        written = json.load(fh)
    art = _artifact()
    assert written == _as_json(result)
    assert set(written) == set(art)
    assert set(written["models"]) == set(art["models"])
    for config in tsm.CONFIGS:
        for link in LINKS:
            assert set(written["models"][config][link]) == {
                "cold", "warm_resident"}
    printed = capsys.readouterr().out
    assert "chr21_scan:" in printed and f"wrote {out}" in printed
