"""The serving window as a share of the card's peak: the dense forward
FLOPs of every query answered, over the traced window (``work.py``)."""
from benchmark.metrics_common import mfu


def read(ctx):
    return mfu(ctx)
