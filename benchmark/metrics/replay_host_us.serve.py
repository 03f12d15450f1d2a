"""The host's time per graph replay: the mean length of ``graphs.replay``
(the inputs' copy, the graph's launch and the launch accounting), in us."""
from benchmark.spans import lengths_s, mean


def read(ctx):
    m = mean(lengths_s(ctx, "graphs.replay"))
    return None if m is None else 1e6 * m
