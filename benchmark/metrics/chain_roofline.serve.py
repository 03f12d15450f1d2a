"""The chain kernel's share of its roofline: the least time of the
window's chains (``work.chain_call``) over the device time of the
``hop_chain_kernel`` records, for the recorded share of the launches.
None where no such kernel ran."""
from benchmark.metrics_common import roofline


def read(ctx):
    return roofline(ctx, "hop_chain_kernel", "chain_least_s",
                    "chain_launches")
