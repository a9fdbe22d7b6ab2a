"""Fixtures of the benchmark's CPU tests: tiny cells in a test's own
folder (found by name beside ``ldbench/``'s, no file there edited), and
the card check of the tests marked ``chip``."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {
    "configs": {
        "tiny21": {"source": "test", "chrom": "21", "n_samples": 50,
                   "n_variants": 4096, "first_pos": 1, "span_bp": 200_000,
                   "ld_run_rows": 8, "flip": 0.02, "freq": [0.05, 0.95],
                   "par1_end": None, "warm_rows": 1024, "straddle_rows": 0,
                   "reduced": [], "assumed": []},
        "tinyX": {"source": "test", "chrom": "X", "n_samples": 50,
                  "n_variants": 4096, "first_pos": 10_001,
                  "span_bp": 200_000, "ld_run_rows": 64, "flip": 0.02,
                  "freq": [0.05, 0.95], "par1_end": 100_000,
                  "warm_rows": 1024, "straddle_rows": 32, "reduced": [],
                  "assumed": []},
    },
    "traffic": {
        "tscan": {"tool": "ld_scan", "args": ["-z", "0.8", "-w", "20000"],
                  "metric": {"name": "scan_s", "per": "job"}},
        "tarea": {"tool": "ld_area", "args": ["-p", "4", "-w", "5000"],
                  "queries": 100, "files": 4,
                  "metric": {"name": "area_queries_per_s", "per": "second"}},
    },
    "workloads": {
        "t21_scan": {"config": "tiny21", "traffic": "tscan", "chips": 1},
        "tX_scan": {"config": "tinyX", "traffic": "tscan", "chips": 1},
        "t21_area": {"config": "tiny21", "traffic": "tarea", "chips": 1},
    },
}

# a metric that exists only in the test's folder
TEST_METRIC = '''"""test.jobs: the window's jobs."""


def read(run):
    return float(len(run.records))
'''


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card (the H100); skips elsewhere")


@pytest.fixture
def card():
    """Skip unless a CUDA card is there (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the port on "
                    "the H100")


def tiny_bench() -> dict:
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    scans = ["t21_scan", "tX_scan"]
    return {
        "workloads": [dict(name=n, why="test", **w)
                      for n, w in TINY["workloads"].items()],
        "end_to_end": [
            {"name": "scan_s", "unit": "s", "better": "lower", "bound": 0.25,
             "source": "host_clock", "workloads": scans},
            {"name": "area_queries_per_s", "unit": "queries/s",
             "better": "higher", "bound": 0.25, "source": "host_clock",
             "workloads": ["t21_area"]},
            {"name": "setup_s", "unit": "s", "better": "lower",
             "bound": 0.25, "source": "host_clock"}],
        "per_layer": [dict(m, workloads=scans + ["t21_area"])
                      for m in real["per_layer"]] + [
            {"name": "test.jobs", "unit": "jobs", "better": "higher",
             "source": "host_clock", "layer": "test", "moves": "scan_s"}],
    }


def write_tiny(top: Path) -> Path:
    for kind, items in TINY.items():
        (top / kind).mkdir(parents=True, exist_ok=True)
        for name, body in items.items():
            (top / kind / f"{name}.json").write_text(json.dumps(body))
    (top / "metrics").mkdir(exist_ok=True)
    (top / "metrics" / "test.jobs.py").write_text(TEST_METRIC)
    return top


@pytest.fixture
def tiny(tmp_path):
    """A Spec whose tiny cells, configurations, traffic and one metric
    live in the test's folder only."""
    from ldbench.spec import Spec

    return Spec(bench=tiny_bench(), extra_dirs=[write_tiny(tmp_path / "tiny")])
