"""The traced run: a ``torch.profiler`` trace of the window, and the
numbers read from it.

With ``--trace 1`` the window runs under ``torch.profiler`` (CPU, and CUDA
where the run has a card), each job inside a span ``ldbench.job.<k>`` and
the window inside ``ldbench.window``.  Spans of the benchmark's own are put
around the calls into the program's layers (``SPANS``) for that run only;
the program itself records none yet.  Once the window has closed the trace
is exported as Chrome JSON into the run's work directory and read back:

- the device's busy intervals: every kernel, copy and fill the trace holds;
- kernel time: the durations of the kernels, summed;
- idle gaps: the stretches of a window without device work, named by the
  innermost span the host was in.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import importlib
import json
import os

import numpy as np

# (module, attribute, span): the calls into each layer of the port that
# the traced run wraps in a span of that name
SPANS = (
    ("ld_tools_tpu_torch.tools.common", "prep_intgen_data", "tool.prep_check"),
    ("ld_tools_tpu_torch.tools.scan", "scan_chromosome", "tool.scan_chromosome"),
    ("ld_tools_tpu_torch.tools.scan", "format_rounded", "tool.scan_format"),
    ("ld_tools_tpu_torch.ops.ld_stream", "stream_threshold_scan", "driver.scan"),
    ("ld_tools_tpu_torch.ops.ld_stream", "prepare_resident", "driver.upload"),
    ("ld_tools_tpu_torch.ops.ld_stream", "_exact_refilter_counts",
     "finish.scan"),
    ("ld_tools_tpu_torch.ingest.pack", "pack_columns", "mixed.repack"),
    ("ld_tools_tpu_torch.ops.engine", "pair_counts_async", "engine.issue"),
    ("ld_tools_tpu_torch.ops.exact", "exact_ld_from_counts", "finish.counts"),
    ("ld_tools_tpu_torch.tools.area", "pair_counts_async", "engine.issue"),
    ("ld_tools_tpu_torch.tools.area", "measures_rounded_block_both",
     "finish.area"),
    ("ld_tools_tpu_torch.tools.area", "AreaRunner._write_group", "area.write"),
)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _spanned(fn, name):
    from torch.profiler import record_function

    @functools.wraps(fn)
    def wrapper(*a, **kw):
        with record_function(name):
            return fn(*a, **kw)
    return wrapper


@contextlib.contextmanager
def program_spans():
    """Wrap each call of ``SPANS`` in its span; restore them after."""
    undo = []
    try:
        for mod_name, attr, name in SPANS:
            owner = importlib.import_module(mod_name)
            *path, leaf = attr.split(".")
            for p in path:
                owner = getattr(owner, p)
            fn = getattr(owner, leaf)
            setattr(owner, leaf, _spanned(fn, name))
            undo.append((owner, leaf, fn))
        yield
    finally:
        for owner, leaf, fn in reversed(undo):
            setattr(owner, leaf, fn)


class Tracer:
    """``with Tracer(enabled, device, work) as tr:`` around the window,
    ``with tr.job(k):`` around each job; ``tr.trace`` is a :class:`Trace`
    once it has closed (None when not enabled)."""

    def __init__(self, enabled: bool, device: str, work: str):
        self.enabled, self.device, self.work = enabled, device, work
        self.trace = None
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile, record_function

            acts = [ProfilerActivity.CPU]
            if self.device == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._stack.enter_context(program_spans())
            self._prof = self._stack.enter_context(profile(activities=acts))
            self._stack.enter_context(record_function("ldbench.window"))
        return self

    def job(self, k: int):
        if not self.enabled:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(f"ldbench.job.{k}")

    def __exit__(self, *exc):
        self._stack.close()
        if self.enabled and exc[0] is None:
            path = os.path.join(self.work, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh)["traceEvents"]
            os.remove(path)
            self.trace = Trace(events)
        return False


def _merge(iv: np.ndarray) -> np.ndarray:
    """The union of intervals (n, 2), as sorted disjoint intervals."""
    if not len(iv):
        return np.zeros((0, 2))
    iv = iv[np.argsort(iv[:, 0])]
    out = [list(iv[0])]
    for a, b in iv[1:]:
        if a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return np.asarray(out)


class Trace:
    """A Chrome trace's device work and host spans, in microseconds."""

    def __init__(self, events):
        dev, kern, spans = [], [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            ts, dur = float(e["ts"]), float(e["dur"])
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                dev.append((ts, ts + dur, e.get("name", "")))
                if cat == "kernel":
                    kern.append((ts, ts + dur))
            elif cat == "user_annotation":
                spans.append((e.get("name", ""), ts, ts + dur))
        self.device = dev
        self.busy = _merge(np.asarray([(a, b) for a, b, _ in dev], float))
        self.kernels = np.asarray(kern, float).reshape(-1, 2)
        self.spans = spans

    def span(self, name: str):
        """(start, end) of the first span of that name, or None."""
        for n, a, b in self.spans:
            if n == name:
                return a, b
        return None

    def busy_s(self, a: float, b: float) -> float:
        """Seconds of [a, b] in which the device ran something."""
        lo = np.clip(self.busy[:, 0], a, b)
        hi = np.clip(self.busy[:, 1], a, b)
        return float((hi - lo).sum()) / 1e6

    def kernel_s(self, a: float, b: float) -> float:
        """Seconds of kernel time inside [a, b], kernel by kernel."""
        lo = np.clip(self.kernels[:, 0], a, b)
        hi = np.clip(self.kernels[:, 1], a, b)
        return float((hi - lo).sum()) / 1e6

    def top_ops(self, a: float, b: float, n: int = 10) -> list:
        """[name, seconds] of the device operations that took most time."""
        tot = collections.Counter()
        for s, e, name in self.device:
            if e > a and s < b:
                tot[name] += (min(e, b) - max(s, a)) / 1e6
        return [[k, v] for k, v in tot.most_common(n)]

    def idle_gaps(self, a: float, b: float, n: int = 10) -> list:
        """[host span, seconds] of the device's idle time inside [a, b],
        summed by the innermost span the host was in at each gap's middle;
        the largest ``n``."""
        busy = self.busy[(self.busy[:, 1] > a) & (self.busy[:, 0] < b)]
        g0 = np.concatenate([[a], np.minimum(busy[:, 1], b)])
        g1 = np.concatenate([np.maximum(busy[:, 0], a), [b]])
        keep = g1 > g0
        g0, g1 = g0[keep], g1[keep]
        names = [name for name, _, _ in self.spans
                 if name != "ldbench.window"]
        sa = np.asarray([s for name, s, _ in self.spans
                         if name != "ldbench.window"], float)
        sb = np.asarray([e for name, _, e in self.spans
                         if name != "ldbench.window"], float)
        tot = collections.Counter()
        for x0, x1 in zip(g0.tolist(), g1.tolist()):
            mid = (x0 + x1) / 2
            inside = np.flatnonzero((sa <= mid) & (sb >= mid))
            label = ("ldbench.window" if not inside.size else
                     names[inside[np.argmin(sb[inside] - sa[inside])]])
            if label.startswith("ldbench.job."):
                label = "ldbench.job"
            tot[label] += (x1 - x0) / 1e6
        return [[k, v] for k, v in tot.most_common(n)]
