"""Profiling utilities (counterpart of ``qmann_tpu/utils/profiling.py``).

The reference hand-times every (layer, lifecycle-op) pair with clock()
(MemN2N/MemN2N.c:133-141, report :3000-3021).  Here:
  * PhaseProfiler — host-clock time per pipeline phase (data/train/...);
    on a CUDA device each phase ends with ``torch.cuda.synchronize()`` so
    that work the phase queued is counted in it;
  * trace() — a torch.profiler trace of the host and the card, written as
    a Chrome trace;
  * annotate() — a named range in that trace.
"""
from __future__ import annotations

import collections
import contextlib
import io
import os
import time

import torch


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


@contextlib.contextmanager
def annotate(name: str):
    """Named range visible in trace()'s timeline."""
    with torch.profiler.record_function(name):
        yield
