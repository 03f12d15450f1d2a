"""The lattice kernel's share of its roofline in the family's window: the least
time of the lattice work (``work.forward_lattice_least_s`` per step and
validation pass) over the device time of the ``qmatvec`` records."""
from benchmark.metrics_common import roofline


def read(ctx):
    return roofline(ctx, "qmatvec", "lattice_least_s", "lattice_launches")
