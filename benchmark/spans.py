"""The program's own spans and counters in a traced window, for the
readers in ``metrics/``.

A span is a ``record_function`` range the program enters while a profiler
records (``qmann_tpu_torch/utils/profiling.py::annotate``).  The profiler
keeps it in the trace only on a thread it profiles (the harness's thread,
not the engine's), and the program keeps every span's length in its
counter store (``profiling.observed``) as well.  A span's lengths are read
from the trace's host records where the trace has them, else from that
store.  Each function returns nothing to read (an empty list) for a
program that has no such span, counter or store.
"""
from __future__ import annotations

import math
from typing import List, Optional


def kept(name: str) -> List[float]:
    """What the program kept under ``name`` in this process's profiled
    windows."""
    try:
        from qmann_tpu_torch.utils.profiling import observed
    except ImportError:
        return []
    return observed(name)


def lengths_s(ctx, name: str) -> List[float]:
    """The lengths, in seconds, of the window's spans called ``name``."""
    recorded = [r.dur_ns / 1e9 for r in ctx["trace"].host if r.name == name]
    return recorded or kept(name)


def mean(values: List[float]) -> Optional[float]:
    return sum(values) / len(values) if values else None


def nearest_rank(values: List[float], q: float) -> Optional[float]:
    """The nearest-rank q-th percentile."""
    if not values:
        return None
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]
