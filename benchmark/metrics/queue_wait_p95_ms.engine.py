"""The engine's queue wait: the 95th percentile (nearest rank) of the
window's ``engine.queue_wait_s``, each request's time from ``submit`` to
the close of its wave, in ms."""
from benchmark.spans import kept, nearest_rank


def read(ctx):
    p95 = nearest_rank(kept("engine.queue_wait_s"), 95)
    return None if p95 is None else 1e3 * p95
