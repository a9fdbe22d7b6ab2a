"""Structured logging + counters.

The reference logs via bare prints ('artifact... OK', elapsed-time lines —
prep_intgen_data.py:27-34, ld_area.py:331-342).  This framework uses the
stdlib logging module with one consistent format, plus lightweight named
counters for throughput reporting (variants ingested, pairs/s), since the
performance targets in BASELINE.md require measured numbers.
"""

from __future__ import annotations

import logging
import threading
import time

_FORMAT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"
_configured = False


def get_logger(name: str) -> logging.Logger:
    global _configured
    if not _configured:
        logging.basicConfig(level=logging.INFO, format=_FORMAT)
        _configured = True
    return logging.getLogger(f"tpu_ld.{name}")


class Counters:
    """Thread-safe named counters with rate reporting."""

    def __init__(self):
        self._lock = threading.Lock()
        self._values = {}
        self._t0 = time.time()

    def add(self, name: str, value=1):
        with self._lock:
            self._values[name] = self._values.get(name, 0) + value

    def get(self, name: str):
        with self._lock:
            return self._values.get(name, 0)

    def rates(self) -> dict:
        dt = max(time.time() - self._t0, 1e-9)
        with self._lock:
            return {f"{k}/s": v / dt for k, v in self._values.items()}

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._values)
