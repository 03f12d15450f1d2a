"""The port's spans and counter (``qmann_tpu_torch/utils/profiling.py``) on
the CPU: with no profiler nothing is entered or kept; under
``torch.profiler`` the engine's spans and queue-wait counter, and
``eval_split``'s spans, are recorded.  The ``cuda`` case (the graph
runner's three spans) skips without a card:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_tracing.py -q -m cuda
"""
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from qmann_tpu_torch import graphs  # noqa: E402
from qmann_tpu_torch.config import QmannConfig  # noqa: E402
from qmann_tpu_torch.data import Dictionary, babi  # noqa: E402
from qmann_tpu_torch.models import memn2n  # noqa: E402
from qmann_tpu_torch.serve import InferenceEngine  # noqa: E402
from qmann_tpu_torch.train import trainer  # noqa: E402
from qmann_tpu_torch.utils import profiling  # noqa: E402

V, M, W = 19, 10, 6   # qa1 shape
CFG = QmannConfig(dim_emb=16, verbose=False)
WAVE_CHILDREN = ("engine.vectorize", "engine.upload", "engine.replay",
                 "engine.readback", "engine.resolve")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def every_thread():
    """A profiler session that records every thread, the engine's too."""
    return profile(activities=[ProfilerActivity.CPU],
                   experimental_config=torch._C._profiler._ExperimentalConfig(
                       profile_all_threads=True))


def names(prof):
    return [e.name() for e in prof.profiler.kineto_results.events()]


def engine(batch_size=8):
    dictionary = Dictionary()
    for i in range(1, V):
        dictionary.add(f"w{i}")
    dims = babi.synthetic_batch(np.random.default_rng(0), 1, V, M, W)[0]
    params = memn2n.init_params(CFG, dims, torch.Generator().manual_seed(0),
                                device="cpu")
    return InferenceEngine(params, CFG, dims, dictionary,
                           batch_size=batch_size, device="cpu")


def stories(n, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        story = [[f"w{i}" for i in rng.integers(1, V, W)]
                 for _ in range(rng.integers(1, M + 1))]
        out.append((story, [f"w{i}" for i in rng.integers(1, V, 3)]))
    return out


def split(n, seed=2):
    dims, mem, que, mask = babi.synthetic_batch(
        np.random.default_rng(seed), n, V, M, W)
    idx = np.random.default_rng(seed + 1).integers(1, V, n)
    ans = np.zeros((n, dims.dim_input), np.float32)
    ans[np.arange(n), idx] = 1.0
    return dims, babi.VectorizedSplit(mem, que, ans,
                                      mask.sum(1).astype(np.int32),
                                      idx.astype(np.int32))


def test_no_profiler_enters_no_range_and_keeps_nothing(monkeypatch):
    """With no profiler the spans enter no record_function, stamp() is
    None and nothing is kept, through a served engine and eval_split too;
    under a profiler the same calls enter ranges."""
    entered = []
    real = torch.profiler.record_function

    def counting(*args, **kw):
        entered.append(args[0])
        return real(*args, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    kept = {k: list(v) for k, v in profiling._KEPT.items()}
    assert profiling.annotate("engine.wave") is profiling.annotate(
        "graphs.replay", "train_step")
    with profiling.annotate("engine.wave", 3):
        pass
    profiling.observe("engine.queue_wait_s", 1.0)
    assert profiling.stamp() is None
    eng = engine().start()
    try:
        answers = [f.result(timeout=60) for f in
                   [eng.submit(s, q) for s, q in stories(10)]]
    finally:
        eng.stop()
    dims, data = split(20)
    params = memn2n.init_params(CFG, dims, torch.Generator().manual_seed(0),
                                device="cpu")
    trainer.eval_split(params, data, CFG, chunk=8, device="cpu")
    assert len(answers) == 10 and eng.stats.waves >= 2
    assert entered == []
    assert {k: list(v) for k, v in profiling._KEPT.items()} == kept

    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.annotate("engine.wave", 3):
            pass
        trainer.eval_split(params, data, CFG, chunk=8, device="cpu")
        assert profiling.stamp() is not None
    assert entered == ["engine.wave"] + ["eval.upload"] * 3 + ["eval.read"]


def test_engine_spans_and_queue_wait_under_a_profiler():
    """A CPU engine serving N requests under a profiler: the fill, wave and
    wave children spans, in the trace and kept, the children inside a
    wave; exactly N queue waits, each >= 0, none for the requests
    submitted before the session."""
    n_before, n = 5, 21
    eng = engine()
    early = [eng.submit(s, q) for s, q in stories(n_before, seed=3)]
    k0 = {name: len(profiling.observed(name)) for name in
          ("engine.queue_wait_s", "engine.fill", "engine.wave")}
    try:
        with every_thread() as prof:
            eng.start()
            futures = [eng.submit(s, q) for s, q in stories(n)]
            answers = [f.result(timeout=60) for f in early + futures]
    finally:
        eng.stop()
    assert len(answers) == n_before + n
    waits = profiling.observed("engine.queue_wait_s")[
        k0["engine.queue_wait_s"]:]
    assert len(waits) == n and min(waits) >= 0.0
    got = names(prof)
    for name in ("engine.fill", "engine.wave") + WAVE_CHILDREN:
        assert name in got, name
    waves = profiling.observed("engine.wave")[k0["engine.wave"]:]
    assert len(waves) == got.count("engine.wave") >= 4
    assert len(profiling.observed("engine.fill")[k0["engine.fill"]:]) \
        == got.count("engine.fill")
    events = prof.profiler.kineto_results.events()
    spans = [(e.start_ns(), e.start_ns() + e.duration_ns())
             for e in events if e.name() == "engine.wave"]
    for e in events:
        if e.name() in WAVE_CHILDREN:
            assert any(a <= e.start_ns() and e.start_ns() + e.duration_ns()
                       <= b for a, b in spans), e.name()


def test_eval_split_spans_under_a_profiler():
    """eval_split on the CPU: one eval.upload a chunk and one eval.read,
    in the trace of the profiling thread and kept, with the results of a
    run without a profiler."""
    dims, data = split(20)
    params = memn2n.init_params(CFG, dims, torch.Generator().manual_seed(0),
                                device="cpu")
    want = trainer.eval_split(params, data, CFG, chunk=8, device="cpu")
    k0 = len(profiling.observed("eval.upload"))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = trainer.eval_split(params, data, CFG, chunk=8, device="cpu")
    assert got[:2] == want[:2] and np.array_equal(got[2], want[2])
    recorded = names(prof)
    assert recorded.count("eval.upload") == 3
    assert recorded.count("eval.read") == 1
    assert len(profiling.observed("eval.upload")[k0:]) == 3


def test_the_store_loses_no_value_across_threads():
    """More threads than cores keep values and spans at once, with a short
    switch interval: every one is kept."""
    n_threads, n = 16, 500
    k0 = {name: len(profiling.observed(name)) for name in
          ("test.stress", "test.stress_span")}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            def work():
                for i in range(n):
                    profiling.observe("test.stress", float(i))
                    with profiling.annotate("test.stress_span"):
                        pass
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    values = profiling.observed("test.stress")[k0["test.stress"]:]
    assert len(values) == n_threads * n
    assert sum(values) == n_threads * sum(range(n))
    assert len(profiling.observed("test.stress_span")) \
        - k0["test.stress_span"] == n_threads * n


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graph_runner_spans_on_the_card(cuda):
    """A body's first call is graphs.warm_up, its second graphs.capture
    and then graphs.replay, each later call graphs.replay: all in the
    trace of the profiling thread, and kept."""
    g = graphs.Graphs(cuda)
    x = torch.arange(8.0, device=cuda)
    k0 = {n: len(profiling.observed(n)) for n in
          ("graphs.warm_up", "graphs.capture", "graphs.replay")}
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        outs = [g(("double", 1), lambda t: 2.0 * t, x) for _ in range(4)]
        torch.cuda.synchronize()
    assert all(torch.equal(o, 2.0 * x) for o in outs)
    host = [e for e in prof.profiler.kineto_results.events()
            if e.device_type() != torch.autograd.DeviceType.CUDA
            and e.name().startswith("graphs.")]
    assert [e.name() for e in host] == [
        "graphs.warm_up", "graphs.capture", "graphs.replay",
        "graphs.replay", "graphs.replay"]
    assert {n: len(profiling.observed(n)) - k0[n] for n in k0} == {
        "graphs.warm_up": 1, "graphs.capture": 1, "graphs.replay": 3}
