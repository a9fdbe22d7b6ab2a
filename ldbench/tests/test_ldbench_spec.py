"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix and metric parses and resolves by name, within the limits of
the format of BENCHMARK.json; a cell and a metric that exist only in a test's
folder are found without editing a file."""

import json
import re

import pytest

from ldbench.spec import ROOT, Spec

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(text, limit=200):
    return 1 <= len(text) <= limit and "\n" not in text and "\t" not in text


def test_benchmark_json_has_its_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert BENCH["command"] == ["python3", "ldbench/run.py"]
    assert BENCH["paths"] == ["ldbench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    for key, keys in (("configs", {"name", "source", "file", "reduced",
                                   "why"}),
                      ("workloads", {"name", "config", "traffic", "chips",
                                     "why"})):
        for entry in BENCH[key]:
            assert set(entry) == keys, entry
            assert _line(entry["why"])
    for key, keys in (("end_to_end", {"name", "unit", "better", "bound",
                                      "source"}),
                      ("per_layer", {"name", "unit", "better", "source",
                                     "layer", "moves"})):
        for m in BENCH[key]:
            assert set(m) - {"workloads"} == keys, m
            assert m["better"] in ("lower", "higher")
            assert UNIT.fullmatch(m["unit"]), m["unit"]


def test_names_and_bounds():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    for name in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.fullmatch(name), name
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    spec = Spec()
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for name in CELLS:
        cell = spec.cell(name)
        e2e = spec.traffic(cell["traffic"])["metric"]["name"]
        got = [m["name"] for m in spec.end_to_end(cell, e2e)]
        assert "setup_s" in got and e2e in got, (name, got)
        for m in BENCH["end_to_end"]:  # a metric that names cells
            if name in m.get("workloads", []):
                assert m["name"] == e2e
        layers = spec.per_layer(cell, set(got))
        assert layers, name
        for m in layers:
            assert m["moves"] in got


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_resolves_by_name(name):
    spec = Spec()
    cell = spec.cell(name)
    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    assert traffic["tool"] in ("ld_scan", "ld_area")
    entry = {c["name"]: c for c in BENCH["configs"]}[cell["config"]]
    assert entry["file"] == f"ldbench/configs/{cell['config']}.json"
    assert config["reduced"] == entry["reduced"]
    assert config["source"] == entry["source"]
    assert isinstance(config["assumed"], list)
    for key in config["reduced"]:
        assert key in config and not key.endswith(("_dim", "_rank"))
    for m in spec.per_layer(cell, {traffic["metric"]["name"], "setup_s"}):
        assert callable(spec.reader(m["name"]))


def test_every_file_under_paths_is_named_from_name_characters():
    for path in (ROOT / "ldbench").rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", rel), rel


def test_a_cell_and_a_metric_of_a_test_folder_are_found(tiny):
    cell = tiny.cell("t21_scan")
    assert tiny.config(cell["config"])["n_variants"] == 4096
    layers = [m["name"] for m in tiny.per_layer(cell, {"scan_s"})]
    assert "test.jobs" in layers
    read = tiny.reader("test.jobs")
    assert read(type("Run", (), {"records": [1, 2, 3]})) == 3.0
    with pytest.raises(KeyError):
        Spec().cell("t21_scan")  # the real benchmark does not know it


def test_a_cell_file_that_disagrees_with_benchmark_json_is_refused(tiny):
    tiny.bench["workloads"][0]["traffic"] = "tarea"
    with pytest.raises(ValueError):
        tiny.cell("t21_scan")
