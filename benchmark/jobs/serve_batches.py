"""Batch serving with bench.py's program: ``chain`` serially dependent
batches of ``batch`` queries through ``forward_prepared``, as one captured
graph, its predictions copied to the host at the end of each replay.

The program is bench.py's (``qmann_tpu_torch/bench/common.py::
dependent_batches``), copied here so that the yardstick does not move:
each batch adds to the question a device scalar made from the previous
batch's predictions (always 0), so no batch can be hoisted.  The window
cycles through ``pool`` distinct query batches drawn from the seed, one a
replay, copied into the graph's input on the device.

Traffic keys: ``batch``, ``chain``, ``pool``, the story layout, ``route``
and ``trace_seconds``.  ``serve_queries_per_s`` is the answers on the host
over the window.  Every replay's answers are compared with the first
replay's of its batch (a change counts as failed), and the check compares
every distinct query's answer with the reference.
"""
from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import work
from benchmark.common import make_weights, program_config
from benchmark.jobs import serving
from benchmark.stories import generator, traffic_stories

SPAN_REPLAY = "bench.dependent_batches"
SPAN_READ = "bench.host_read"


def dependent_batches(forward, mem, que, mask, k: int, graphs):
    """bench.py's program: k serially dependent batches, one captured
    graph on the card; returns the [k, B] predictions on the device."""
    from qmann_tpu_torch.ops.losses import argmax_last

    def program(mem, que, mask):
        carry = torch.zeros((), dtype=que.dtype, device=que.device)
        preds = []
        with torch.inference_mode():
            for _ in range(k):
                pred = argmax_last(forward(mem, que + carry, mask).logits)
                carry = (pred[0] < 0).to(que.dtype)
                preds.append(pred)
            return torch.stack(preds)

    return graphs(("dependent_batches", forward, k), program, mem, que, mask)


class Job:
    def __init__(self, cell: dict, seed: int, device: torch.device):
        self.traffic = cell["traffic"]
        self.model = cell["model_file"]["model"]
        self.weight_std = cell["model_file"]["assumed"]["weight_std"]
        self.seed, self.device = seed, device

    def setup(self) -> None:
        from qmann_tpu_torch.graphs import Graphs
        from qmann_tpu_torch.models import memn2n
        t, dev, md = self.traffic, self.device, self.model
        cfg = program_config(md, t["route"])
        P, B = t["pool"], t["batch"]
        st = traffic_stories(t, P * B, generator(self.seed, 0, dev), dev)
        self.stories = st
        self.mem = st["memory"].view(P, B, *st["memory"].shape[1:])
        self.que = st["question"].view(P, B, -1)
        self.mask = st["mask"].view(P, B, -1)
        I = t["vocab"] + t["max_sentences"]
        self.weights = make_weights(md, I, self.weight_std, self.seed, dev)
        bound = float(t["max_words"] + 1)
        prep = memn2n.prepare_inference(
            {k: v.clone() for k, v in self.weights.items()}, cfg,
            max_count=bound, max_rowsum=bound)
        serving.require_chain(memn2n, prep, cfg)
        self.forward = (lambda m, q, k: memn2n.forward_prepared(
            prep, m, q, k, cfg))
        self.graphs = Graphs(dev)
        self.first = [None] * P
        self.replays = 0
        self.changed = 0
        K, D = md["num_hops"], md["dim_emb"]
        rows = st["mask"].view(P, B, -1).sum((1, 2)).tolist()
        self.batch_work = [{
            "queries": t["chain"] * B,
            "flops": t["chain"] * work.forward_flops(B, int(r), K, D, I),
            "chain_least_s": t["chain"] * work.least_s(
                *work.chain_call(B, int(r), K, D))} for r in rows]
        # the first call runs eagerly, the second captures; then each
        # batch once more
        for j in [0, 0] + list(range(P)):
            self._replay(j)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _replay(self, j: int):
        with record_function(SPAN_REPLAY):
            preds = dependent_batches(self.forward, self.mem[j], self.que[j],
                                      self.mask[j], self.traffic["chain"],
                                      self.graphs)
        with record_function(SPAN_READ):
            host = preds.cpu().numpy()
        if self.first[j] is None:
            self.first[j] = host
        elif not np.array_equal(host, self.first[j]):
            self.changed += host.size
        return host

    def window(self, seconds: float) -> dict:
        from qmann_tpu_torch.graphs import launch_counts
        P = self.traffic["pool"]
        acc = {"queries": 0, "flops": 0.0, "chain_least_s": 0.0,
               "batches": 0}
        changed0 = self.changed
        before = launch_counts()
        t0 = time.perf_counter()
        while True:
            j = self.replays % P
            self._replay(j)
            self.replays += 1
            for k in ("queries", "flops", "chain_least_s"):
                acc[k] += self.batch_work[j][k]
            acc["batches"] += self.traffic["chain"]
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        acc["chain_launches"] = launch_counts()[3] - before[3]
        return {"elapsed_s": elapsed, "attempted": acc["queries"],
                "failed": self.changed - changed0, "work": acc,
                "metrics": {"serve_queries_per_s": acc["queries"] / elapsed}}

    def release(self) -> None:
        self.graphs = self.forward = None

    def readings(self, control=False) -> dict:
        """The widest gap below the reference's best logit of every
        answer of every distinct query's batch (every replay of a batch gave
        the first one's, or counted as failed)."""
        answers = torch.from_numpy(np.concatenate([f.T for f in self.first]))
        return serving.readings(self.model, self.weights, self.stories,
                                answers.to(self.device), control=control)
