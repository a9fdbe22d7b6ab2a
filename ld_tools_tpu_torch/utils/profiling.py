"""Profiling and roofline reporting: the counterpart of
ld_tools_tpu/utils/profiling.py.

- ``CHIP_PEAKS`` / ``detect_chip``: the card's published peaks, by name.
  An unknown card, or no card, raises: no peak is ever assumed.
- ``trace(log_dir)`` / ``maybe_trace()``: ``torch.profiler`` traces.
- ``span(name, stats, key)``: the program's phase timer, which also names
  the phase in a ``torch.profiler`` trace while one is recording.
- ``Roofline``: the analytic model of an all-pairs sweep (operations,
  bytes) against the card's peaks.
- ``sweep_seconds``: per-sweep time by differencing two sweep counts
  (the counterpart of ``honest_sweep_seconds``), timed with CUDA events
  on the card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
import warnings

# Peaks per card: (dense bf16 tensor-core TFLOP/s, HBM GB/s, int8 speed-up
# over bf16), the layout of the JAX package's table.  H100 SXM data sheet:
# 989 TFLOP/s bf16, 1,979 TOP/s int8, 3.35 TB/s HBM3, at the full 700 W.
CHIP_PEAKS = {
    "h100": (989.0, 3350.0, 2.0),
}


def detect_chip() -> str:
    """CHIP_PEAKS key of the first CUDA card, from its name; raises
    without a card or for a card the table does not hold.  Only the SXM
    H100 ("NVIDIA H100 80GB HBM3") has these peaks: the PCIe and NVL parts
    run lower clocks."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is available: the peaks are a "
                           "card's, and there is none to name")
    name = torch.cuda.get_device_name(0)
    up = name.upper()
    if "H100" in up and "PCIE" not in up and "NVL" not in up:
        return "h100"
    raise ValueError(f"no published peaks for card {name!r}; known: "
                     f"{', '.join(CHIP_PEAKS)}")


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` trace of the body (CPU, and CUDA activity when
    a card is present), written to ``log_dir`` as a Chrome trace
    ``trace_<pid>_<unix time>.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{int(time.time())}.json")
    )


@contextlib.contextmanager
def maybe_trace():
    """Trace to $TPU_LD_PROFILE_DIR when set; no-op otherwise."""
    log_dir = os.environ.get("TPU_LD_PROFILE_DIR")
    if not log_dir:
        yield
        return
    with trace(log_dir):
        yield


# the stats key of a root span: the summed seconds of its direct children
SPANNED = "spanned_s"

_NOT_TRACED = contextlib.nullcontext()
_OPEN = threading.local()  # each thread's open spans: [children's seconds]


@contextlib.contextmanager
def span(name: str, stats: dict, key: str):
    """Time the body on the host clock and add its seconds to
    ``stats[key]``, also when the body raises.

    While a ``torch.profiler`` profile is recording, the body also runs
    inside ``record_function(name)``, so that it shows as a
    ``user_annotation`` event on the trace's clock beside the kernels and
    copies (the benchmark's ``--trace 1``, ``$TPU_LD_PROFILE_DIR``);
    otherwise no profiler code runs.  Spans nest, per thread.  A root
    span, ``key`` :data:`SPANNED`, adds the summed seconds of its direct
    children instead of its own: what of its body some program span
    names.  Spans time phases, never single blocks or rows: one stays out
    of any loop that runs more than about a hundred times a call."""
    import torch

    annotate = (torch.profiler.record_function(name)
                if torch._C._autograd._profiler_enabled() else _NOT_TRACED)
    stack = _OPEN.__dict__.setdefault("stack", [])
    children = [0.0]
    stack.append(children)
    t0 = time.perf_counter()
    try:
        with annotate:
            yield
    finally:
        dt = time.perf_counter() - t0
        stack.pop()
        if stack:
            stack[-1][0] += dt
        stats[key] = stats.get(key, 0.0) + (children[0] if key == SPANNED
                                            else dt)


@dataclasses.dataclass
class Roofline:
    """Analytic roofline for an all-pairs LD sweep.  ``chip`` is a
    CHIP_PEAKS key and has no default (``detect_chip()`` names it)."""

    n_pairs: float
    n_haplotypes_padded: int
    bytes_moved: float
    chip: str
    int8_mxu: bool = False

    @property
    def flops(self) -> float:
        return 2.0 * self.n_pairs * self.n_haplotypes_padded

    def achieved(self, seconds: float) -> dict:
        peak_tflops, peak_gbps, int8_speedup = CHIP_PEAKS[self.chip]
        if self.int8_mxu:
            peak_tflops *= int8_speedup
        tflops = self.flops / seconds / 1e12
        gbps = self.bytes_moved / seconds / 1e9
        compute_bound_s = self.flops / (peak_tflops * 1e12)
        memory_bound_s = self.bytes_moved / (peak_gbps * 1e9)
        bound = "compute" if compute_bound_s >= memory_bound_s else "memory"
        light = max(compute_bound_s, memory_bound_s)
        return {
            "tflops": tflops,
            "gbps": gbps,
            "fraction_of_compute_peak": tflops / peak_tflops,
            "fraction_of_roofline": light / seconds,
            "bound": bound,
            "speed_of_light_s": light,
        }


def _tensors(x):
    import torch

    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def cuda_event_seconds(run) -> float:
    """Seconds of device time that ``run()`` enqueues, between two CUDA
    events on the current stream, the card idle before the first."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def host_seconds(run) -> float:
    """Wall seconds of ``run()`` on the host clock (the CPU: nothing to
    synchronise on)."""
    t0 = time.perf_counter()
    run()
    return time.perf_counter() - t0


def sweep_seconds(make_many, datasets, *, n_lo: int = 4, n_hi: int = 12,
                  trials: int = 3, seed_base: float = 0.0, timer=None):
    """Per-sweep time by differencing (honest_sweep_seconds' contract).

    ``make_many(n)`` returns ``fn(datasets, seed)``, which runs n sweeps
    cycling over genuinely different datasets with a per-sweep input
    jitter derived from ``seed``.  For n in (n_lo, n_hi): one untimed run
    (first-call costs), then the minimum of ``trials`` timed runs with
    distinct seeds ``seed_base + trial + 1``.  The per-sweep time is
    ``(T(n_hi) - T(n_lo)) / (n_hi - n_lo)``, so constant overheads cancel.

    ``timer(run) -> seconds`` times one run; by default CUDA events when
    the datasets hold CUDA tensors (:func:`cuda_event_seconds`), else the
    host clock (:func:`host_seconds`).

    Returns (per_sweep_seconds, {n: best_seconds}); a non-positive
    difference warns and returns NaN, which fails any plausibility gate.
    """
    if timer is None:
        on_card = any(t.is_cuda for t in _tensors(datasets))
        timer = cuda_event_seconds if on_card else host_seconds
    times = {}
    for n in (n_lo, n_hi):
        fn = make_many(n)
        timer(lambda: fn(datasets, 0.0))
        best = float("inf")
        for trial in range(trials):
            seed = float(seed_base + trial + 1.0)
            best = min(best, timer(lambda: fn(datasets, seed)))
        times[n] = best
    dt = (times[n_hi] - times[n_lo]) / (n_hi - n_lo)
    if dt <= 0:
        warnings.warn(
            f"non-positive differenced sweep time ({dt:.3g}s); "
            "measurement rejected — rerun with a fresh seed_base",
            stacklevel=2,
        )
        return float("nan"), times
    return dt, times
