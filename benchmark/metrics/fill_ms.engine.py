"""The engine's wave fill: the mean length of ``engine.fill``, from a
wave's first request until the wave closes, in ms."""
from benchmark.spans import lengths_s, mean


def read(ctx):
    m = mean(lengths_s(ctx, "engine.fill"))
    return None if m is None else 1e3 * m
