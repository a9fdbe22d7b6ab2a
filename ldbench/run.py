#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card.

    python3 ldbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (``python3 -m ldbench.run`` works the same).
The cell, its configuration, traffic and metrics are found by name
(``ldbench/spec.py``).  A run:

1. set-up (``setup_s``, from the start of the process): the store from the
   seed, made on the card and written by the port's ingest, prep, and one
   warm-up job on a slice of the cell's own shapes;
2. the window: whole jobs back to back, until the job running at
   ``--seconds`` has finished, timed as the sum of the jobs' walls; with
   ``--trace 1`` under ``torch.profiler``;
3. after the window: the device's memory peak, then the reference judges
   every file the window's jobs wrote (``ldbench/reference.py``);
4. the numbers compared, each beside its limit, as the last lines on
   standard error, and one JSON line as the last line of standard output.

It exits non-zero and prints no result where there is no card (or fewer
than the cell asks for), and where a module of JAX or of the JAX package
has been loaded by the time the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

if __package__ in (None, ""):  # run as a file: the checkout's root
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# top-level module names a run must not have loaded, compared whole (the
# port's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "ld_tools_tpu", "chip_smoke", "bench",
             "scripts")


def forbidden_modules(modules=None) -> list:
    """The FORBIDDEN top-level names among ``modules`` (default:
    ``sys.modules``)."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def _e2e_value(metric: dict, records, window_s: float) -> float:
    """A traffic's end-to-end metric over the whole window: seconds per
    job, or units (queries) per second."""
    if metric["per"] == "job":
        return window_s / len(records)
    if metric["per"] == "second":
        return sum(r.units for r in records) / window_s
    raise ValueError(f"unknown metric kind {metric['per']!r}")


def run_cell(spec, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float = None):
    """Set-up, window and judgement of one run of cell ``name``.  Returns
    (the result line's object, {check: (value, limit)})."""
    import torch

    from ldbench import data, jobs, tracing

    t0 = time.perf_counter() if t0 is None else t0
    cell = spec.cell(name)
    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    work = tempfile.mkdtemp(prefix=f"ldbench-{name}-")
    try:
        phases = {"start": time.perf_counter() - t0}
        ds = data.make_dataset(config, seed, device)
        phases["data"] = time.perf_counter() - t0
        store = data.prepare_store(os.path.join(work, "store"), ds)
        phases["store"] = time.perf_counter() - t0
        job = jobs.make_job(traffic, config, ds, store, work, seed, device)
        job.warm_up()
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t0

        records = []
        window_s = 0.0  # the jobs' walls: what a job makes for the tool
        # before its wall starts (ld_area's query files) is left out
        with tracing.Tracer(trace, device, work) as tracer:
            while window_s < seconds:
                with tracer.job(len(records)):
                    records.append(job.run(len(records)))
                window_s += records[-1].wall_s
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        job.free()
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()

        r0 = time.perf_counter()
        checks, failed = job.judge(records)
        print(f"ldbench: set-up {setup_s:.1f} s (at "
              + ", ".join(f"{k} {v:.1f}" for k, v in phases.items())
              + f"), window {window_s:.1f} s "
              f"({len(records)} jobs), reference {time.perf_counter() - r0:.1f}"
              " s; jobs " + json.dumps([
                  {"wall_s": round(r.wall_s, 3),
                   **{k: round(v, 3) for k, v in r.stats.items()
                      if k.endswith("_s") and isinstance(v, float)}}
                  for r in records]), file=sys.stderr)
        kind = (torch.cuda.get_device_name(0) if device == "cuda"
                else "cpu")
        e2e = traffic["metric"]
        metrics = {}
        dev = {"platform": "gpu" if device == "cuda" else "cpu", "kind": kind,
               "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
        out = {"correct": None, "attempted": len(records), "failed": failed}
        if not trace:
            values = {e2e["name"]: _e2e_value(e2e, records, window_s),
                      "setup_s": setup_s}
            for m in spec.end_to_end(cell, e2e["name"]):
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
        else:
            tr = tracer.trace
            span = tr.span("ldbench.window")
            view = types.SimpleNamespace(
                cell=cell, config=config, traffic=traffic, ds=ds, job=job,
                records=records, trace=tr, kind=kind,
                jobs=[tr.span(f"ldbench.job.{r.index}") for r in records])
            for m in spec.per_layer(cell, {e2e["name"], "setup_s"}):
                value = spec.reader(m["name"])(view)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            dev["busy_s"] = tr.busy_s(*span) / int(cell["chips"])
            dev["window_s"] = (span[1] - span[0]) / 1e6
            out["breakdown"] = {"device_ops": tr.top_ops(*span),
                                "idle_gaps": tr.idle_gaps(*span)}
        out["correct"] = failed == 0 and all(
            v <= lim for v, lim in checks.values())
        out["metrics"] = metrics
        out["device"] = dev
        out["checks"] = {k: {"value": v, "limit": lim}
                         for k, (v, lim) in checks.items()}
        return out, checks
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from ldbench.spec import Spec

    try:
        spec = Spec()
        cell = spec.cell(args.workload)
    except (OSError, KeyError, ValueError) as exc:
        print(f"ldbench: {exc}", file=sys.stderr)
        return 2
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < int(cell["chips"]):
        print(f"ldbench: cell {args.workload} needs {cell['chips']} CUDA "
              f"card(s), this machine has {have}; no result", file=sys.stderr)
        return 2
    try:
        import ld_tools_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"ldbench: the port is not in this checkout ({exc}); no result",
              file=sys.stderr)
        return 2
    result, checks = run_cell(spec, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", T0)
    found = forbidden_modules()
    if found:
        print("ldbench: the run loaded forbidden modules: " + ", ".join(found)
              + "; no result", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for k, (v, lim) in checks.items():
        print(f"ldbench check {k}: {v} (limit {lim})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
