"""Kernel records per training step in the command-line run's window."""
from benchmark.metrics_common import kernels_per_step


def read(ctx):
    return kernels_per_step(ctx)
