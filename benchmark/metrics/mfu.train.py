"""The family's training window as a share of the card's peak: the dense
FLOPs of every live sample's step (three forwards' worth) and validation
forward, over the traced window (``work.py``)."""
from benchmark.metrics_common import mfu


def read(ctx):
    return mfu(ctx)
