"""The engine's wave: the mean length of ``engine.wave``, from a wave's
close until its last future is resolved (vectorize, upload, replay,
readback, resolve), in ms."""
from benchmark.spans import lengths_s, mean


def read(ctx):
    m = mean(lengths_s(ctx, "engine.wave"))
    return None if m is None else 1e3 * m
