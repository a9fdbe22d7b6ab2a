"""The yardstick's arithmetic: the work a job's inputs need, and the peaks
of the card it is measured against.

A scan evaluates every pair of a chromosome (within ``-w`` where given):
each pair's count is a product over the cohort's haplotypes, 2 operations
a haplotype, at the int8 tensor-core peak.  The least time of a job is that
work at the peak; it names no kernel, so a later change that replaces a
kernel reads against the same work.
"""

from __future__ import annotations

import json
import os

import numpy as np

PEAKS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "peaks.json")


def peaks(kind: str):
    """The published peaks of a card by ``torch.cuda.get_device_name()``,
    or None for a card the table does not hold (no peak is assumed)."""
    with open(PEAKS_FILE) as fh:
        return json.load(fh).get(kind)


def scan_pairs(pos, max_dist=None) -> int:
    """Pairs i > j a scan must evaluate: all of them, or those with
    pos[i] - pos[j] <= max_dist (positions ascending)."""
    v = len(pos)
    if max_dist is None:
        return v * (v - 1) // 2
    pos = np.asarray(pos, dtype=np.int64)
    first = np.searchsorted(pos, pos - max_dist, side="left")
    return int((np.arange(v) - first).sum())


def scan_ops(pos, max_dist, n_hap: int) -> float:
    """Integer operations of a scan's counts: 2 per haplotype and pair."""
    return 2.0 * n_hap * scan_pairs(pos, max_dist)
