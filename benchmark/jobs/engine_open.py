"""Independent users in an open loop: the continuous-batching engine
(``serve/engine.py::InferenceEngine``, prepared on the chain kernel) fed
through ``submit_indexed`` at Poisson arrivals of a fixed rate.

Traffic keys: ``rate`` (requests/s, fixed in the file: four fifths of the
knee that ``sweep_knee.py`` found), ``engine_batch`` and ``max_wait_ms``
(the engine's settings), ``pool`` (distinct stories drawn from the seed,
sent in turn), the story layout, ``route`` and ``trace_seconds``.

Each request is timed from when it was due to be sent to when its answer
was set (a callback on the engine's thread records it), so a stall of the
sender or the engine counts against every request behind it; a request
that fails or never answers within a minute of the window's close counts
as missing every limit (an infinite latency).  The sender shares the
process and its interpreter lock with the engine, as a server's handler
threads do; it keeps no request's future.  ``serve_p95_ms`` is the 95th
percentile (nearest rank) of every request due in the window.  How late
the sender ran is kept beside it.
"""
from __future__ import annotations

import collections
import functools
import gc
import itertools
import math
import time

import torch

from benchmark.common import make_weights, program_config
from benchmark.jobs import serving
from benchmark.stories import generator, poisson_offsets, traffic_stories

# how long past the window's close the sender waits for the last answers
DRAIN_S = 60.0


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


def _samples(st: dict, vocab: int, indexed_sample) -> list:
    """The stories as the packet stream's samples: each live sentence's
    words (the filled slots come first) and its temporal index.  The
    engine copies a sample's lists as it takes it, so samples of one
    length share their temporal indices."""
    rows = st["word_idx"][st["mask"]].cpu()           # [S, W], story-major
    flat = rows[rows >= 0].tolist()
    ends = list(itertools.accumulate((rows >= 0).sum(-1).tolist()))
    sentences = [flat[a:b] for a, b in zip([0] + ends[:-1], ends)]
    n_sen = st["n_sen"].tolist()
    te = {ns: [vocab + ns - j - 1 for j in range(ns)] for ns in set(n_sen)}
    qs = st["question_idx"].tolist()
    ans = st["answer_idx"].tolist()
    out, at = [], 0
    for i, ns in enumerate(n_sen):
        out.append(indexed_sample(sentences[at:at + ns], te[ns], qs[i],
                                  [ans[i]]))
        at += ns
    return out


class Job:
    def __init__(self, cell: dict, seed: int, device: torch.device):
        self.traffic = cell["traffic"]
        self.model = cell["model_file"]["model"]
        self.weight_std = cell["model_file"]["assumed"]["weight_std"]
        self.seed, self.device = seed, device
        self.engine = None

    def setup(self) -> None:
        from qmann_tpu_torch.data.babi import DataDims, Dictionary
        from qmann_tpu_torch.models import memn2n
        from qmann_tpu_torch.serve import InferenceEngine
        from qmann_tpu_torch.serve.packet import IndexedSample
        t, dev, md = self.traffic, self.device, self.model
        V, M, W = t["vocab"], t["max_sentences"], t["max_words"]
        st = traffic_stories(t, t["pool"], generator(self.seed, 0, dev), dev)
        self.stories = st
        # a million small lists: no collector passes while they are made
        gc.disable()
        try:
            self.samples = _samples(st, V, IndexedSample)
        finally:
            gc.enable()
        dictionary = Dictionary()
        for i in range(1, V):
            dictionary.add(f"w{i}")
        dims = DataDims(V, M, W, W + 1, V + M)
        self.weights = make_weights(md, V + M, self.weight_std, self.seed,
                                    dev)
        cfg = program_config(md, t["route"])
        self.engine = InferenceEngine(
            {k: v.clone() for k, v in self.weights.items()}, cfg, dims,
            dictionary, batch_size=t["engine_batch"],
            max_wait_ms=t["max_wait_ms"], device=dev)
        serving.require_chain(memn2n, self.engine.prepared, self.engine.cfg)
        self.engine.start()
        self.rate = t["rate"]
        self.sent = 0
        self.answers, self.story = [], []
        # three full waves: the eager warm-up, the capture, a replay
        for _ in range(3):
            futs = [self._submit() for _ in range(t["engine_batch"])]
            for i, f in futs:
                self._record(i, f.result(timeout=600))
        # the pool and the set-up's objects are long-lived: keep them out
        # of the collector's passes in the window, as a server would
        gc.collect()
        gc.freeze()

    def _submit(self):
        i = self.sent % len(self.samples)
        self.sent += 1
        return i, self.engine.submit_indexed(self.samples[i])

    def _record(self, story: int, answer: int) -> None:
        self.story.append(story)
        self.answers.append(answer)

    def window(self, seconds: float) -> dict:
        n_max = int(self.rate * seconds * 1.5) + 64
        g = generator(self.seed, 2, "cpu")
        offsets = [o for o in poisson_offsets(n_max, self.rate, g)
                   if o < seconds]
        n = len(offsets)
        done = [math.inf] * n
        answer = [None] * n
        story = [0] * n
        lag = [0.0] * n
        finished = collections.deque()
        stats0 = self.engine.stats.snapshot()

        def mark(i, fut):
            # on the engine's thread, as the answer is set; the sender
            # keeps no future
            done[i] = time.perf_counter()
            if fut.exception() is None:
                answer[i] = fut.result()
            finished.append(i)

        t0 = time.perf_counter()
        for i, off in enumerate(offsets):
            due = t0 + off
            now = time.perf_counter()
            if due > now:
                time.sleep(due - now)
            lag[i] = time.perf_counter() - due
            story[i], fut = self._submit()
            fut.add_done_callback(functools.partial(mark, i))
        deadline = t0 + seconds + DRAIN_S
        while len(finished) < n and time.perf_counter() < deadline:
            time.sleep(0.005)
        failed = 0
        lat = []
        for i, off in enumerate(offsets):
            if answer[i] is None:
                failed += 1
                lat.append(math.inf)
            else:
                self._record(story[i], answer[i])
                lat.append(done[i] - (t0 + off))
        stats1 = self.engine.stats.snapshot()
        waves = stats1["waves"] - stats0["waves"]
        work = {"requests": n, "waves": waves,
                "vectorize_s": stats1["vectorize_s"] - stats0["vectorize_s"],
                "infer_s": stats1["infer_s"] - stats0["infer_s"],
                "lag_p95_s": percentile(lag, 95) if n else 0.0,
                "latencies_s": lat}
        p95 = percentile(lat, 95) if n else math.inf
        return {"elapsed_s": seconds, "attempted": n, "failed": failed,
                "work": work, "metrics": {"serve_p95_ms": 1e3 * p95}}

    def release(self) -> None:
        if self.engine is not None:
            self.engine.stop()
            self.engine = None
        gc.unfreeze()

    def readings(self, control=False) -> dict:
        dev = self.stories["memory"].device
        return serving.readings(
            self.model, self.weights, self.stories,
            torch.tensor(self.answers, device=dev)[:, None],
            torch.tensor(self.story, device=dev), control=control)
