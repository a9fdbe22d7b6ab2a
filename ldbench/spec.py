"""Finding a cell's parts by name.

``BENCHMARK.json`` at the root of the checkout lists the cells and the
metrics; each part sits in a file of its own under ``ldbench/``, found by
its name:

- ``workloads/<cell>.json``: the configuration and the traffic of a cell;
- ``configs/<config>.json``: the sizes of a deployment (``reduced``,
  ``assumed``, its source);
- ``traffic/<traffic>.json``: the tool, its arguments and what it reports;
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(run)``,
  which returns a number or None where it finds nothing to read.

A later change adds a cell, a configuration, a traffic mix or a metric by
adding files and entries; no file here names one.  ``extra_dirs`` (tests)
are searched before this folder.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def _check_name(name: str) -> str:
    if not NAME.fullmatch(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


class Spec:
    def __init__(self, bench=None, extra_dirs=()):
        if bench is None:
            with open(ROOT / "BENCHMARK.json") as fh:
                bench = json.load(fh)
        self.bench = bench
        self.dirs = [Path(d) for d in extra_dirs] + [HERE]

    def path(self, kind: str, name: str, ext: str) -> Path:
        _check_name(name)
        for d in self.dirs:
            p = d / kind / f"{name}{ext}"
            if p.is_file():
                return p
        raise KeyError(f"no {kind[:-1] if kind.endswith('s') else kind} "
                       f"named {name!r} under {', '.join(map(str, self.dirs))}")

    def _json(self, kind: str, name: str) -> dict:
        with open(self.path(kind, name, ".json")) as fh:
            return dict(json.load(fh), name=name)

    def cell(self, name: str) -> dict:
        """The cell's file, held against its entry in BENCHMARK.json."""
        cell = self._json("workloads", name)
        entry = {w["name"]: w for w in self.bench["workloads"]}.get(name)
        if entry is None:
            raise KeyError(f"cell {name!r} is not in BENCHMARK.json")
        for key in ("config", "traffic", "chips"):
            if entry[key] != cell[key]:
                raise ValueError(f"cell {name!r}: {key} is {cell[key]!r} in "
                                 f"its file, {entry[key]!r} in BENCHMARK.json")
        return cell

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def end_to_end(self, cell: dict, e2e_name: str) -> list:
        """The end-to-end metrics the cell reports: those that name it, and
        those that name no cell (set-up)."""
        out = []
        for m in self.bench["end_to_end"]:
            if "workloads" in m:
                if cell["name"] in m["workloads"]:
                    out.append(m)
            elif m["name"] == "setup_s" or m["name"] == e2e_name:
                out.append(m)
        return out

    def per_layer(self, cell: dict, e2e_names) -> list:
        """The per-layer metrics the cell reports: those that list it, and
        those without a list that move one of its end-to-end metrics."""
        out = []
        for m in self.bench["per_layer"]:
            if "workloads" in m:
                if cell["name"] in m["workloads"]:
                    out.append(m)
            elif m["moves"] in e2e_names:
                out.append(m)
        return out

    def reader(self, name: str):
        """``read(run)`` of the metric's file."""
        path = self.path("metrics", name, ".py")
        spec = importlib.util.spec_from_file_location(
            "ldbench_metric_" + re.sub(r"\W", "_", name), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
