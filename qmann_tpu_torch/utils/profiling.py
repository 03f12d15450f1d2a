"""Profiling utilities (counterpart of ``qmann_tpu/utils/profiling.py``).

The reference hand-times every (layer, lifecycle-op) pair with clock()
(MemN2N/MemN2N.c:133-141, report :3000-3021).  Here:
  * PhaseProfiler — host-clock time per pipeline phase (data/train/...);
    on a CUDA device each phase ends with ``torch.cuda.synchronize()`` so
    that work the phase queued is counted in it;
  * trace() — a torch.profiler trace of the host and the card, written as
    a Chrome trace;
  * annotate() — the program's span: a named range of the engine, the
    graph runner and the validation (``engine.*``, ``graphs.*``,
    ``eval.*``);
  * observe() / observed() — the program's one counter store, and stamp()
    the clock its counters read.

Spans and counters record only while a ``torch.profiler`` session records
somewhere in the process (``torch.autograd.profiler._is_profiler_enabled``,
which the profiler sets on start and clears on stop).  Otherwise annotate()
returns one shared no-op context, observe() returns at once and stamp()
returns None: one read of that flag, no ``record_function``, nothing kept.

While a session records, annotate(name, args) is a ``record_function``
range, so it lands in the session's trace on the same clock as the card's
records, with ``args`` (a graph's key, a wave's number) as the range's
arguments and the name one of a small fixed set.  The profiler records
such ranges only on the threads it profiles: by default the thread that
started it (``profile_all_threads`` in its experimental config adds every
thread).  So each span also keeps its length, in seconds, under its name
in the counter store, on any thread.  observed(name) returns what was kept
under ``name`` in the process's sessions, in order: a span's lengths or an
observe()d counter's values.
"""
from __future__ import annotations

import collections
import contextlib
import io
import os
import time
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _profiler


class PhaseProfiler:
    def __init__(self, device=None):
        self.totals = collections.defaultdict(float)
        self.counts = collections.defaultdict(int)
        dev = torch.device(device) if device is not None else None
        self._sync = dev if dev is not None and dev.type == "cuda" else None

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._sync is not None:
                torch.cuda.synchronize(self._sync)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        buf = io.StringIO()
        print("< Time Profile >", file=buf)
        for name, total in sorted(self.totals.items()):
            print(f"    {name:<12s} {total:10.3f}s  "
                  f"({self.counts[name]} calls)", file=buf)
        return buf.getvalue()


@contextlib.contextmanager
def trace(log_dir: str, with_stack: bool = False):
    """torch.profiler over the block (the CPU, and the card when torch sees
    one); writes log_dir/trace.json (chrome://tracing, Perfetto).  Yields
    the profiler.  ``with_stack`` also records the Python calls (the
    trace's python_function events), which bench/trace_forward.py reads."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, with_stack=with_stack) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class _Span:
    """A recording span: a ``record_function`` range, and its length kept
    under its name."""

    __slots__ = ("name", "_range", "_t0")

    def __init__(self, name: str, args: Optional[str]):
        self.name = name
        self._range = torch.profiler.record_function(name, args)

    def __enter__(self):
        self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        observe(self.name, time.perf_counter() - self._t0)
        return self._range.__exit__(*exc)


_OFF = contextlib.nullcontext()
# what observe() kept, by name
_KEPT: Dict[str, List[float]] = {}


def annotate(name: str, args=None):
    """The span ``name`` over a ``with`` block, with ``args`` (made a
    string, only while recording) as its arguments; a shared no-op when no
    profiler records."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, None if args is None else str(args))


def stamp() -> Optional[float]:
    """The counters' clock (``time.perf_counter``) while a profiler
    records, else None."""
    if not _profiler._is_profiler_enabled:
        return None
    return time.perf_counter()


def observe(name: str, value: float) -> None:
    """Keep ``value`` under ``name`` while a profiler records."""
    if not _profiler._is_profiler_enabled:
        return
    _KEPT.setdefault(name, []).append(value)


def observed(name: str) -> List[float]:
    """The values kept under ``name`` so far, in order (a copy)."""
    return list(_KEPT.get(name, ()))
