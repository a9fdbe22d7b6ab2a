"""Structured logging.

The reference logs via bare prints ('artifact... OK', elapsed-time lines —
prep_intgen_data.py:27-34, ld_area.py:331-342).  This framework uses the
stdlib logging module with one consistent format; the tools' phase
timers are ``utils.profiling.span``.
"""

from __future__ import annotations

import logging

_FORMAT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"
_configured = False


def get_logger(name: str) -> logging.Logger:
    global _configured
    if not _configured:
        logging.basicConfig(level=logging.INFO, format=_FORMAT)
        _configured = True
    return logging.getLogger(f"tpu_ld.{name}")
