"""Profiler hook: ``maybe_trace`` (counterpart of ld_tools_tpu/utils/profiling.py:67).

The rest of that module (roofline helpers, dispatch probes) is not
ported yet.
"""

from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def maybe_trace():
    """Trace to $TPU_LD_PROFILE_DIR with torch.profiler when set; no-op
    otherwise.  The Chrome trace lands in that directory as
    ``trace_<pid>_<unix time>.json``; CUDA activity is recorded when a
    card is present."""
    log_dir = os.environ.get("TPU_LD_PROFILE_DIR")
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{int(time.time())}.json")
    )
