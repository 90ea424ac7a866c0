"""Arithmetic the readers share."""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from portbench.counts import peaks


def percentile(values: List[float], q: float) -> Optional[float]:
    """The q-th percentile, linear between order statistics (numpy's
    default); None for no values."""
    return float(np.percentile(values, q)) if values else None


def steady(run):
    """The requests that arrive after the call: not the closed loop's
    ramp-up of C requests sent together at its start."""
    return [r for r in run.requests if not r.ramp_up]


def span_total(run, name: str):
    """(seconds, count) of the run's spans called ``name``."""
    ds = [b - a for n, a, b, _ in run.spans if n == name]
    return sum(ds), len(ds)


def roofline(run, kernel: str) -> Optional[float]:
    """The kernel's share of its memory roofline over the profiled stretch:
    the bytes its calls need (``portbench/counts/<kernel>.py``), scaled to
    the launches the profiler recorded, over their device time, against
    the card's HBM rate. None where nothing was recorded."""
    import importlib

    counts = importlib.import_module(f"portbench.counts.{kernel}")
    calls = run.kernel_calls.get(kernel) or []
    if run.device is None or not calls:
        return None
    hits = [(t, n) for name, (t, n) in run.device["kernels"].items()
            if counts.DEVICE_NAME in name]
    secs, launches = sum(t for t, _ in hits), sum(n for _, n in hits)
    if not launches or secs <= 0:
        return None
    need = sum(calls) / len(calls) * launches
    return 100.0 * need / secs / peaks.HBM_BYTES
