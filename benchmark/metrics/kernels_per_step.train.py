"""Kernel records per training step in the family's window."""
from benchmark.metrics_common import kernels_per_step


def read(ctx):
    return kernels_per_step(ctx)
