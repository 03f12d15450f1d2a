"""The readers of the program's spans and counter (``benchmark/spans.py``
and the five ``metrics/`` files that use it) on planted traces and planted
observations: the right mean and percentile, the trace's records ahead of
the program's store, and nothing to read where the program left nothing."""
from __future__ import annotations

import pytest

from benchmark.harness import read_metric
from benchmark.trace import WINDOW, Record, Trace
from qmann_tpu_torch.utils import profiling

READERS = ("queue_wait_p95_ms.engine", "fill_ms.engine", "wave_ms.engine",
           "replay_host_us.cli", "replay_host_us.serve")


def ctx(*host):
    """A traced window holding these host records (name, dur_ns)."""
    records = [Record(WINDOW, 0, 10 ** 9)] + [
        Record(name, 1000 * i, ns) for i, (name, ns) in enumerate(host)]
    return {"trace": Trace(1.0, 0.0, [], [], records), "work": {}}


@pytest.fixture
def store(monkeypatch):
    """The program's store, empty, for the test to plant values in."""
    kept = {}
    monkeypatch.setattr(profiling, "_KEPT", kept)
    return kept


def test_span_means_from_the_trace(store):
    store["engine.fill"] = [1.0]   # the trace's records come first
    c = ctx(("engine.fill", 2_000_000), ("engine.fill", 4_000_000),
            ("engine.wave", 5_000_000), ("graphs.replay", 300_000),
            ("graphs.replay", 500_000), ("engine.replay", 9_000_000))
    assert read_metric("fill_ms.engine", c) == pytest.approx(3.0)
    assert read_metric("wave_ms.engine", c) == pytest.approx(5.0)
    assert read_metric("replay_host_us.cli", c) == pytest.approx(400.0)
    assert read_metric("replay_host_us.serve", c) == pytest.approx(400.0)


def test_span_means_from_the_store(store):
    """A thread the profiler did not record (the engine's): the lengths
    the program kept."""
    store.update({"engine.fill": [0.010, 0.012, 0.014],
                  "engine.wave": [0.005], "graphs.replay": [2e-4, 6e-4]})
    c = ctx(("bench.validate", 7_000_000))
    assert read_metric("fill_ms.engine", c) == pytest.approx(12.0)
    assert read_metric("wave_ms.engine", c) == pytest.approx(5.0)
    assert read_metric("replay_host_us.cli", c) == pytest.approx(400.0)


@pytest.mark.parametrize("n, want_ms", [(100, 95.0), (20, 19.0), (1, 1.0),
                                        (19, 19.0)])
def test_queue_wait_p95_is_the_nearest_rank(store, n, want_ms):
    store["engine.queue_wait_s"] = [i / 1000.0 for i in range(n, 0, -1)]
    got = read_metric("queue_wait_p95_ms.engine", ctx())
    assert got == pytest.approx(want_ms)


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read_is_none(store, name):
    assert read_metric(name, ctx(("bench.train_epoch", 1000))) is None


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_the_store_is_none(monkeypatch, name):
    """The parent of these spans: no ``observed`` to import."""
    monkeypatch.delattr(profiling, "observed")
    assert read_metric(name, ctx()) is None
