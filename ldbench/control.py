#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from: the program's
and the lower-precision controls', at a cell's own size, in one process.

    python3 ldbench/control.py --workload <cell> --seeds 11,12,13 [--out F]

For each seed: the cell's set-up, one job of the program through the timed
path, judged by the reference (the program's reading, which sets the lower
end of a limit), then the controls, judged the same way:

- ``f32_reference``: the reference itself, its finish computed in float32,
  the precision below the float64 that the tools state, in the program's
  place (every cell);
- ``port_f32_scan``: the port's own lower-precision path, the scan with
  the device's f32 values and no exact refinish
  (``stream_threshold_scan(exact=False)``; the cells of one ploidy
  profile).

One JSON line per seed on standard output (and appended to ``--out``).
The benchmark's own runs never run this.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _port_f32(job):
    """One scan of the port with ``exact=False`` forced on its driver."""
    from ld_tools_tpu_torch.ops import ld_stream

    orig = ld_stream.stream_threshold_scan

    def f32_scan(*a, **kw):
        kw["exact"] = False
        return orig(*a, **kw)

    ld_stream.stream_threshold_scan = f32_scan
    try:
        return job.run(10_000)
    finally:
        ld_stream.stream_threshold_scan = orig


def readings(spec, name: str, seed: int, device: str = "cuda") -> dict:
    """{reading: number} of one seed (see the module's doc)."""
    import torch

    from ldbench import data, jobs

    cell = spec.cell(name)
    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    work = tempfile.mkdtemp(prefix=f"ldbench-control-{name}-")
    try:
        ds = data.make_dataset(config, seed, device)
        store = data.prepare_store(os.path.join(work, "store"), ds)
        job = jobs.make_job(traffic, config, ds, store, work, seed, device)
        job.warm_up()
        rec = job.run(0)
        out = {"seed": seed}
        if isinstance(job, jobs.ScanJob):
            header, body, looked = job.expected()
            with open(rec.path) as fh:
                out["program"] = job.mismatched_rows(fh.read(), header, body,
                                                     looked)
            _, body32, _ = job.expected(torch.float32)
            out["f32_reference"] = job.mismatched_rows(header + body32,
                                                       header, body, looked)
            if ds.pgroup is None:
                low = _port_f32(job)
                with open(low.path) as fh:
                    out["port_f32_scan"] = job.mismatched_rows(
                        fh.read(), header, body, looked)
            out["expected_rows"] = body.count("\n")
        else:
            want = job.expected(0)
            out["program"] = jobs.mismatched_files(jobs.read_tree(rec.path),
                                                   want)
            out["f32_reference"] = jobs.mismatched_files(
                job.expected(0, torch.float32), want)
            out["expected_files"] = len(want)
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--out")
    args = p.parse_args(argv)

    import torch

    from ldbench.spec import Spec

    if not torch.cuda.is_available():
        print("ldbench control: no CUDA card", file=sys.stderr)
        return 2
    spec = Spec()
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps(dict(readings(spec, args.workload, seed),
                               workload=args.workload))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
