"""Arithmetic the per-layer readers share; each reader file applies one of
these to its cell's trace and work."""
from benchmark import work


def idle_share(ctx):
    """100 * (1 - busy / window) of the traced window."""
    t = ctx["trace"]
    if t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def mfu(ctx):
    """The dense FLOPs of the window's work over the traced window and the
    card's peak, in per cent."""
    flops, window = ctx["work"].get("flops"), ctx["trace"].window_s
    if not flops or window <= 0:
        return None
    return work.mfu_percent(flops, window)


def kernels_per_step(ctx):
    """Kernel records of the traced window per training step (the
    validation passes' records included)."""
    steps = ctx["work"].get("steps")
    if not steps:
        return None
    return len(ctx["trace"].kernels) / steps


def roofline(ctx, kernel: str, least_key: str, launches_key: str):
    """100 * least time / device time of the kernel's records, the least
    time scaled to the recorded share of the program's launches (the
    profiler may drop records late in a process); None where no such
    kernel ran."""
    records, device_s = ctx["trace"].kernel_time(kernel)
    least = ctx["work"].get(least_key)
    launches = ctx["work"].get(launches_key)
    if not records or device_s <= 0 or not least or not launches:
        return None
    return 100.0 * least * min(1.0, records / launches) / device_s
