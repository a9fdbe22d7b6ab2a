"""The general job generator: one traffic file (``ldbench/traffic/<name>.
json``) says which tool a cell drives and with which arguments; this module
runs that tool's jobs and judges what they wrote.

- ``ld_scan``: a job is one whole chromosome, store to TSV closed on
  disk, through ``ld_tools_tpu_torch.ld_scan.main(argv)`` with the CLI's
  own arguments.  Before each job the resident cache is cleared, so that
  every scan pays the store load and the upload, as a user's process does.
- ``ld_area``: a job is one batch of query files through
  ``ld_tools_tpu_torch.ld_area.main(argv, stats)``; each batch's query
  rsIDs are drawn anew from the seed.

Each job writes into a directory of its own under the run's work
directory; the reference (``ldbench.reference``) judges every file once the
window has closed.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import sys
import time

import numpy as np

from ldbench import data, reference


# pairs of one ploidy segment farther apart than the band, sampled from the
# seed, that the reference computes exactly besides the band
FAR_PAIRS = 200_000


@dataclasses.dataclass
class JobRecord:
    """One timed job: its wall seconds, the tool's phase stats, what it
    wrote (``path``) and how much work it answered (``units``)."""

    index: int
    wall_s: float
    stats: dict
    path: str
    units: int


def _cohort(panel, gend: str, pops: str):
    """The tools' cohort selection (tools/common.DataConfig): sample indices
    in panel order, and the header text of the selection."""
    gends = {"male": ("male",), "female": ("female",)}.get(
        gend, ("male", "female"))
    pop_names = tuple(pops.upper().split(","))
    idx = [k for k, row in enumerate(panel) if row[3] in gends
           and (pop_names == ("ALL",) or row[2] in pop_names
                or row[1] in pop_names)]
    text = (",".join(f'"{g}"' for g in gends),
            ",".join(f'"{p}"' for p in pop_names))
    return np.asarray(idx, dtype=np.int64), text


def _tool_args(argv, flags) -> argparse.Namespace:
    """The traffic's arguments that the reference needs, read by a parser
    of the harness's own (the port's parser is the program's)."""
    p = argparse.ArgumentParser(add_help=False)
    for names, kw in flags:
        p.add_argument(*names, **kw)
    args, _ = p.parse_known_args(argv)
    return args


_COMMON = [(("-g",), dict(dest="gend", default="both")),
           (("-e",), dict(dest="pops", default="all")),
           (("-z",), dict(dest="thres", type=float, default=0.8))]


class Job:
    """A tool's jobs on one store: ``warm_up()`` in set-up, ``run(k)`` in
    the window, ``judge(records)`` after it."""

    def __init__(self, traffic, config, ds, store, work, seed, device):
        self.traffic, self.config, self.ds = traffic, config, ds
        self.store, self.work, self.seed = store, work, seed
        self.device = device
        self.engine = "cuda" if device == "cuda" else "torch"
        self.args = list(traffic.get("args", []))

    def free(self) -> None:
        """Drop what the program keeps on the device between jobs."""
        from ld_tools_tpu_torch.ops import ld_stream

        ld_stream.clear_resident_cache()


class ScanJob(Job):
    def __init__(self, *a):
        super().__init__(*a)
        opts = _tool_args(self.args, _COMMON + [
            (("-l",), dict(dest="measure", default="r_square")),
            (("-w",), dict(dest="max_dist", type=int, default=None))])
        self.cohort, self.cohort_text = _cohort(self.ds.panel, opts.gend,
                                                opts.pops)
        self.prm = reference.ScanParams(
            measure=opts.measure, thres=opts.thres, max_dist=opts.max_dist,
            band=2 * int(self.config["ld_run_rows"]) - 1
            + int(self.config.get("straddle_rows") or 0),
            n_far=FAR_PAIRS)

    def _scan(self, store, out):
        from ld_tools_tpu_torch import ld_scan
        from ld_tools_tpu_torch.ops import ld_stream

        ld_stream.clear_resident_cache()
        argv = ["-C", self.ds.chrom, "-D", store, "-t", out, "-E", self.engine,
                *self.args]
        (report,) = ld_scan.main(argv)
        return report

    def warm_up(self) -> None:
        """One scan of a slice of this chromosome's own rows (across the
        ploidy bound where there is one), under a resident limit scaled
        with the slice, so that the slice takes the layout (int8 or
        packed) that the whole chromosome takes."""
        from ld_tools_tpu_torch.ops import ld_stream

        v = self.ds.n_variants
        n = min(v, int(self.config["warm_rows"]))
        mid = 0
        if self.ds.pgroup is not None:
            mid = int(np.flatnonzero(np.diff(self.ds.pgroup))[0]) + 1
        lo = max(0, min(mid - n // 2, v - n))
        store = data.prepare_store(os.path.join(self.work, "warm_store"),
                                   self.ds, slice(lo, lo + n))
        key = "TPU_LD_DENSE_RESIDENT_BYTES"
        old = os.environ.get(key)
        os.environ[key] = str(int(ld_stream.dense_resident_limit() * n / v))
        try:
            self._scan(store, os.path.join(self.work, "warm_out"))
        finally:
            if old is None:
                del os.environ[key]
            else:
                os.environ[key] = old
        shutil.rmtree(store, ignore_errors=True)
        shutil.rmtree(os.path.join(self.work, "warm_out"), ignore_errors=True)

    def run(self, k: int) -> JobRecord:
        out = os.path.join(self.work, f"out{k}")
        t0 = time.perf_counter()
        report = self._scan(self.store, out)
        wall = time.perf_counter() - t0
        return JobRecord(k, wall, dict(report.stats), report.path, 1)

    def expected(self, dtype=None):
        """(header, body) of the TSV the reference expects, and the pairs
        it looked at outside the band."""
        import torch

        lists = reference.Lists(self.ds, self.device, self.cohort)
        hits, looked = reference.scan_hits(
            self.ds, lists, self.prm, self.seed,
            dtype=dtype or torch.float64)
        del lists
        return (reference.scan_header(self.ds, self.prm, self.cohort_text),
                reference.scan_body(self.ds, hits), looked)

    def judge(self, records) -> dict:
        """Every job's TSV against the reference: each distinct file in
        full, each other one byte for byte against one judged.  Returns
        ({check name: (value, limit)}, the jobs that wrote a wrong file)."""
        header, body, looked = self.expected()
        judged = {}  # the bytes of each distinct file: its mismatched rows
        bad = failed = 0
        for rec in records:
            with open(rec.path, "rb") as fh:
                got = fh.read()
            if got not in judged:
                judged[got] = self.mismatched_rows(got.decode(), header, body,
                                                   looked)
            bad += judged[got]
            failed += judged[got] > 0
        checks = {"mismatched_rows": (bad, 0),
                  "empty_reference": (int(not body), 0)}
        return checks, failed

    def mismatched_rows(self, text, header, body, looked) -> int:
        """Rows in which ``text`` (a TSV) differs from the reference: its
        header lines, the expected hits it lacks or writes otherwise, and
        hits it writes that the reference did not look at and that fail
        an exact recount."""
        if text == header + body:
            return 0
        head_got, _, body_got = text.partition("\n")
        col_got, _, body_got = body_got.partition("\n")
        bad = int(head_got + "\n" + col_got + "\n" != header)
        want = set(body.splitlines())
        got = set(body_got.splitlines())
        missing = sorted(want - got)
        extra = sorted(got - want)
        bad += len(missing) + len(extra) - self._genuine(extra, looked)
        self._explain(missing, "missing")
        self._explain(extra, "unexpected")
        return bad

    def _explain(self, lines, what: str, n: int = 4) -> None:
        """Print the first ``n`` of ``lines`` with the pair's segments and
        a recount in plain Python (the reference tool's arithmetic, pair
        by pair), to stderr."""
        from ldbench.reference import oracle_line

        v = self.ds.n_variants
        for ln in lines[:n]:
            f = ln.split("\t")
            i = int(np.searchsorted(self.ds.pos, int(f[0])))
            j = int(np.searchsorted(self.ds.pos, int(f[2])))
            if i >= v or j >= v:
                continue
            print(f"ldbench: {what} row {ln!r} (rows {i}, {j}, profiles "
                  f"{self._profile(i)}, {self._profile(j)}); recount: "
                  f"{oracle_line(self.ds, self.cohort, i, j)}",
                  file=sys.stderr)
        if len(lines) > n:
            print(f"ldbench: ... {len(lines) - n} more {what} rows",
                  file=sys.stderr)

    def _profile(self, row: int) -> int:
        return 0 if self.ds.pgroup is None else int(self.ds.pgroup[row])

    def _genuine(self, lines, looked) -> int:
        """How many of ``lines`` (hits the program wrote that the reference
        did not expect) lie where the reference did not look, within one
        ploidy segment, and read the same in an exact recount: LD that the
        generator was not meant to make."""
        if not lines:
            return 0
        import torch

        v, pos = self.ds.n_variants, self.ds.pos
        lists = reference.Lists(self.ds, self.device, self.cohort)
        fields = [ln.split("\t") for ln in lines]
        i = np.searchsorted(pos, [int(f[0]) for f in fields])
        j = np.searchsorted(pos, [int(f[2]) for f in fields])
        i = np.minimum(i, v - 1)
        j = np.minimum(j, v - 1)
        ok = ((i - j > self.prm.band) & (lists.group[i] == lists.group[j])
              & ~np.isin(i * v + j, list(looked)))
        if self.prm.max_dist is not None:
            ok &= pos[i] - pos[j] <= self.prm.max_dist
        if not ok.any():
            return 0
        sel = np.flatnonzero(ok)
        ii, jj, ld = reference._keep_pairs(lists, i[sel], j[sel], self.prm,
                                          torch.float64)
        hits = reference.Hits(ii, jj, reference.fmt4(ld.r2, ld.r2_iz),
                              reference.fmt4(ld.dp, ld.dp_iz))
        again = set(reference.scan_body(self.ds, hits).splitlines())
        n = sum(ln in again for ln in (lines[k] for k in sel))
        if n:
            print(f"ldbench: {n} hit(s) beyond the reference's band recount "
                  "exactly: LD the generator was not meant to make")
        return n


class AreaJob(Job):
    def __init__(self, *a):
        super().__init__(*a)
        opts = _tool_args(self.args, _COMMON + [
            (("-l",), dict(dest="measure", default="r_square")),
            (("-w",), dict(dest="flank", type=int, default=100_000)),
            (("-o",), dict(dest="file_type", default="tsv"))])
        if opts.file_type != "tsv":
            raise ValueError("the reference writes ld_area's TSV only")
        self.cohort, self.cohort_text = _cohort(self.ds.panel, opts.gend,
                                                opts.pops)
        self.prm = reference.AreaParams(measure=opts.measure,
                                        thres=opts.thres, flank=opts.flank)
        self.n_queries = int(self.traffic["queries"])
        self.n_files = int(self.traffic["files"])

    def queries(self, k: int, salt: int = 29) -> np.ndarray:
        """Batch ``k``'s query rows, drawn from the seed: the same number
        of distinct rows in every batch."""
        rng = np.random.default_rng([self.seed, salt, k])
        return np.sort(rng.choice(self.ds.n_variants, size=self.n_queries,
                                  replace=False))

    def _sources(self, k: int, rows) -> str:
        src = os.path.join(self.work, f"src{k}")
        os.makedirs(src, exist_ok=True)
        for f, part in enumerate(np.array_split(rows, self.n_files)):
            with open(os.path.join(src, f"q{f}.txt"), "w") as fh:
                fh.write("\n".join(self.ds.rsid(part)) + "\n")
        return src

    def _area(self, src, out, stats):
        from ld_tools_tpu_torch import ld_area

        argv = ["-S", src, "-D", self.store, "-t", out, "-E", self.engine,
                *self.args]
        return ld_area.main(argv, stats)

    def warm_up(self) -> None:
        """One batch of a tenth of the queries, in as many files, on this
        store."""
        rows = self.queries(0, salt=31)[:max(self.n_files,
                                               self.n_queries // 10)]
        src = self._sources("warm", rows)
        out = os.path.join(self.work, "warm_out")
        self._area(src, out, {})
        shutil.rmtree(src, ignore_errors=True)
        shutil.rmtree(out, ignore_errors=True)

    def run(self, k: int) -> JobRecord:
        """Batch ``k``: its query files written, then the tool's call, which
        alone is the job's wall."""
        src = self._sources(k, self.queries(k))
        out = os.path.join(self.work, f"out{k}")
        stats = {}
        t0 = time.perf_counter()
        self._area(src, out, stats)
        wall = time.perf_counter() - t0
        return JobRecord(k, wall, stats, out, self.n_queries)

    def expected(self, k: int, dtype=None) -> dict:
        """{relative path: text} of the files batch ``k`` must leave."""
        import torch

        lists = reference.Lists(self.ds, self.device, self.cohort)
        rows = self.queries(k)
        want = {}
        thres = str(self.prm.thres)
        for f, part in enumerate(np.array_split(rows, self.n_files)):
            files = reference.area_files(self.ds, lists, part, self.prm,
                                         self.cohort_text,
                                         dtype or torch.float64)
            for rsid, text in files.items():
                if text is not None:
                    name = (f"{rsid}_chr{self.ds.chrom}_"
                            f"{self.prm.measure[0]}_{thres}.tsv")
                    want[os.path.join(f"q{f}_in_LD", self.ds.chrom,
                                      name)] = text
        return want

    def judge(self, records) -> dict:
        """Every batch's files against the reference: the files that are
        there and not expected, expected and not there, or different.
        Returns ({check name: (value, limit)}, the batches with one)."""
        bad = failed = empty = 0
        for rec in records:
            want = self.expected(rec.index)
            n = mismatched_files(read_tree(rec.path), want)
            bad += n
            failed += n > 0
            empty += not want
        return ({"mismatched_files": (bad, 0),
                 "empty_reference": (empty, 0)}, failed)


def read_tree(top: str) -> dict:
    """{relative path: text} of every file under ``top``."""
    out = {}
    for dirpath, _, files in os.walk(top):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path) as fh:
                out[os.path.relpath(path, top)] = fh.read()
    return out


def mismatched_files(got: dict, want: dict) -> int:
    keys = set(got) | set(want)
    return sum(got.get(k) != want.get(k) for k in keys)


TOOLS = {"ld_scan": ScanJob, "ld_area": AreaJob}


def make_job(traffic, config, ds, store, work, seed, device) -> Job:
    tool = traffic["tool"]
    if tool not in TOOLS:
        raise ValueError(f"no job runner for tool {tool!r}; known: "
                         f"{', '.join(TOOLS)}")
    return TOOLS[tool](traffic, config, ds, store, work, seed, device)
