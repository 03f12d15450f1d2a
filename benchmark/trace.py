"""The traced window: ``torch.profiler`` over the window's work, reduced to
what the per-layer readers need.

The window's body runs inside a ``bench.window`` annotation, so the
window's length and the device's records share one clock.  The device's
busy time is the union of its records (kernels, copies, fills) inside the
window; a kernel record is any device record that is not a copy or a
fill (the spans' mirrors on the device's timeline are left out).  An idle
gap between two device records is named by what the host was doing then:
the shortest host record that spans the gap's middle.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, List, NamedTuple, Tuple

import torch

WINDOW = "bench.window"


class Record(NamedTuple):
    name: str
    start_ns: int
    dur_ns: int


class Trace(NamedTuple):
    window_s: float
    busy_s: float
    device: List[Record]      # every device record in the window
    kernels: List[Record]     # the kernel records among them
    host: List[Record]        # host records in the window

    def kernel_time(self, name_part: str) -> Tuple[int, float]:
        """(records, seconds) of the kernels whose name holds name_part."""
        hits = [r.dur_ns for r in self.kernels if name_part in r.name]
        return len(hits), sum(hits) / 1e9

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time and the longest idle
        gaps by what the host was doing, each summed by name."""
        ops: Dict[str, int] = defaultdict(int)
        for r in self.device:
            ops[short(r.name)] += r.dur_ns
        gaps: Dict[str, int] = defaultdict(int)
        for name, ns in idle_gaps(self):
            gaps[name] += ns

        def rank(d):
            return [[k, v / 1e9] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(ops), "idle_gaps": rank(gaps)}


def short(name: str) -> str:
    """A kernel's name without its template arguments and parameters."""
    base = name.split("(")[0]
    if "<" in base:
        base = base.split("<")[0]
    return base.replace("void ", "").strip()[:120] or name[:120]


def idle_gaps(trace: Trace):
    """(what the host was doing, ns) for each idle stretch of the device
    inside the window."""
    win = [r for r in trace.host if r.name == WINDOW]
    if not win:
        return []
    w0, w1 = win[0].start_ns, win[0].start_ns + win[0].dur_ns
    spans = sorted((r.start_ns, r.start_ns + r.dur_ns) for r in trace.device)
    gaps, cursor = [], w0
    for s, e in spans + [(w1, w1)]:
        if s > cursor:
            gaps.append(((cursor + s) // 2, s - cursor))
        cursor = max(cursor, e)
    # sweep the gaps' middles over the host records in start order,
    # keeping the records still open
    host = sorted((r for r in trace.host if r.name != WINDOW),
                  key=lambda r: r.start_ns)
    out, active, i = [], [], 0
    for mid, ns in gaps:
        while i < len(host) and host[i].start_ns <= mid:
            active.append(host[i])
            i += 1
        active = [r for r in active if r.start_ns + r.dur_ns >= mid]
        name = (min(active, key=lambda r: r.dur_ns).name if active
                else "host: no traced call")
        out.append((name, ns))
    return out


def _annotation(e) -> bool:
    """A span's mirror on the device's timeline, which is no device
    work."""
    kind = getattr(e, "activity_type", None)
    return (e.is_user_annotation() or e.name().startswith("bench.")
            or (kind is not None and "annotation" in str(kind())))


def _records(prof):
    events = prof.profiler.kineto_results.events()
    dev, host = [], []
    for e in events:
        rec = Record(e.name(), int(e.start_ns()), int(e.duration_ns()))
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            host.append(rec)
        elif not _annotation(e):
            dev.append(rec)
    return dev, host


def _is_kernel(name: str) -> bool:
    low = name.lower()
    return not (low.startswith("memcpy") or low.startswith("memset"))


def summarize(prof) -> Trace:
    dev, host = _records(prof)
    win = [r for r in host if r.name == WINDOW]
    if not win:
        raise RuntimeError("the trace holds no window annotation")
    w0 = win[0].start_ns
    w1 = w0 + win[0].dur_ns
    dev = [r for r in dev if r.start_ns < w1 and r.start_ns + r.dur_ns > w0]
    host = [r for r in host if r.start_ns < w1 and r.start_ns + r.dur_ns > w0]
    busy, cursor = 0, w0
    for s, e in sorted((max(r.start_ns, w0), min(r.start_ns + r.dur_ns, w1))
                       for r in dev):
        if e > cursor:
            busy += e - max(s, cursor)
            cursor = e
    return Trace(win[0].dur_ns / 1e9, busy / 1e9, dev,
                 [r for r in dev if _is_kernel(r.name)], host)


@contextlib.contextmanager
def traced(device: torch.device):
    """Profile the body as the window; the yielded dict holds the
    ``trace`` after the exit."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    box: dict = {}
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            yield box
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    box["trace"] = summarize(prof)
