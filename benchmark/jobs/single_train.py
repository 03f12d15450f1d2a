"""One run of one task as ``python -m qmann_tpu_torch`` trains it:
``train_task``'s set-up, then in the window ``train_epoch`` (one captured
step a batch) and ``eval_split`` on the validation split after every
epoch, with ``train_task``'s per-epoch reads and best-model test.

Traffic keys: ``train``, ``valid`` and ``test`` stories, ``eval_chunk``
(the program's default chunk, to which a split is padded), the story
layout (``stories.traffic_stories``), ``route``, ``warm_epochs`` and
``trace_seconds``.

The window runs whole epochs; the run restarts from the drawn weights
after ``num_itr`` epochs, with its test pass, as the next task of a sweep
would.  ``cli_samples_per_s`` is the training samples in the window's
epochs over the window.
"""
from __future__ import annotations

import math
import time

import torch
from torch.profiler import record_function

from benchmark import work
from benchmark.common import make_weights, program_config
from benchmark.jobs import training
from benchmark.stories import ceil_div, generator, nonzeros, traffic_stories


class Job:
    def __init__(self, cell: dict, seed: int, device: torch.device):
        self.traffic = cell["traffic"]
        self.model = cell["model_file"]["model"]
        self.weight_std = cell["model_file"]["assumed"]["weight_std"]
        self.seed, self.device = seed, device

    def _split(self, n: int, g):
        """n stories as the program's ``VectorizedSplit`` (host arrays)
        and their work counts."""
        from qmann_tpu_torch.data.babi import VectorizedSplit
        st = traffic_stories(self.traffic, n, g, self.device)
        host = {k: st[k].cpu().numpy() for k in
                ("memory", "question", "answer", "n_sen", "answer_idx")}
        split = VectorizedSplit(host["memory"], host["question"],
                                host["answer"],
                                host["n_sen"].astype("int32"),
                                host["answer_idx"].astype("int32"))
        return split, st

    def setup(self) -> None:
        from qmann_tpu_torch.graphs import Graphs
        from qmann_tpu_torch.train import trainer
        from qmann_tpu_torch.train.optim import lr_schedule
        self.trainer = trainer
        t, dev, md = self.traffic, self.device, self.model
        self.cfg = program_config(md, t["route"])
        if self.cfg.en_sample_shuffled:
            raise ValueError("the harness runs unshuffled epochs")
        g = generator(self.seed, 0, dev)
        self.train_split, train = self._split(t["train"], g)
        self.valid_split, valid = self._split(t["valid"], g)
        self.test_split, test = self._split(t["test"], g)
        I = t["vocab"] + t["max_sentences"]
        self.params = make_weights(md, I, self.weight_std, self.seed, dev)
        self.init = {k: v.clone() for k, v in self.params.items()}

        # train_task's batches: [NB, B, ...] with the last batch's padding
        # masked and its live count as the divisor
        B, n = md["size_batch"], t["train"]
        nb = ceil_div(n, B)
        pad = nb * B - n

        def pack(x):
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
            return x.reshape((nb, B) + tuple(x.shape[1:]))

        sm = pack(torch.ones(n, device=dev))
        self.batches = {"memory": pack(train["memory"]),
                        "question": pack(train["question"]),
                        "answer": pack(train["answer"]),
                        "mask": pack(train["mask"]),
                        "sample_mask": sm, "size_b": sm.sum(1)}
        self.nb, self.n_train = nb, n
        self.graphs = Graphs(dev)
        self.lr_t = self.graphs.static("lr", ())
        self.schedule = list(lr_schedule(self.cfg))
        K, D = md["num_hops"], md["dim_emb"]

        def fwd(st, mult=1):
            rows = int(st["mask"].sum())
            return {"flops": mult * work.forward_flops(
                st["n_sen"].numel(), rows, K, D, I)}

        rows = self.batches["mask"].sum((1, 2)).tolist()
        qn = (nonzeros(self.batches["question"])
              * sm).sum(1).tolist()
        mn = nonzeros(self.batches["memory"]).sum((1, 2)).tolist()
        live = sm.sum(1).tolist()
        lattice = sum(work.forward_lattice_least_s(
            int(live[k]), int(qn[k]), int(rows[k]), int(mn[k]), K, D, I)
            for k in range(nb))

        def eval_lattice(st):
            return work.forward_lattice_least_s(
                st["n_sen"].numel(), int(nonzeros(st["question"]).sum()),
                int(st["mask"].sum()), int(nonzeros(st["memory"]).sum()), K,
                D, I)

        self.epoch_work = {
            "steps": nb, "samples": n,
            "flops": fwd(train, 3)["flops"] + fwd(valid)["flops"],
            "lattice_least_s": lattice + eval_lattice(valid)}
        self.test_work = {"flops": fwd(test)["flops"],
                          "lattice_least_s": eval_lattice(test)}
        self.epochs = 0
        self._best = (math.inf, math.inf)

        graphs = self.graphs
        rec = training.StepRecorder(
            graphs, self.params,
            lambda: graphs.static("epoch_costs", (nb,), torch.float32),
            "train_step")
        for _ in range(t["warm_epochs"]):
            self._epoch(rec)
        self.first = training.Steps(
            rec.steps.costs, [{k: v[None] for k, v in p.items()}
                              for p in rec.steps.after])
        for _ in range(2):
            self._test_pass()
        self._restart()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # ------------------------------------------------------------------
    def _epoch(self, graphs) -> bool:
        """One epoch as train_task's loop runs it: the graphed steps, the
        reads of the summed cost and matches, the validation pass and the
        best-model test.  True if the costs are finite."""
        itr, lr, remove_softmax = self.schedule[self.epochs
                                                % len(self.schedule)]
        self.lr_t.fill_(lr)
        with record_function(training.SPAN_EPOCH):
            _, cost_t, match_t = self.trainer.train_epoch(
                self.params, self.batches, self.lr_t, self.cfg,
                remove_softmax, graphs=graphs)
        with record_function(training.SPAN_READ):
            cost_train, _ = float(cost_t), int(match_t)
        with record_function(training.SPAN_VALID):
            cost_valid, err_valid, _ = self.trainer.eval_split(
                self.params, self.valid_split, self.cfg,
                chunk=self.traffic["eval_chunk"], device=self.device,
                graphs=graphs)
        if err_valid <= self._best[0] and cost_valid <= self._best[1]:
            self._best = (err_valid, cost_valid)
        self.epochs += 1
        return math.isfinite(cost_train) and math.isfinite(cost_valid)

    def _test_pass(self) -> None:
        with record_function(training.SPAN_VALID):
            self.trainer.eval_split(self.params, self.test_split, self.cfg,
                                    chunk=self.traffic["eval_chunk"],
                                    device=self.device, graphs=self.graphs)

    def _restart(self) -> None:
        for k, v in self.init.items():
            self.params[k].copy_(v)
        self.epochs = 0
        self._best = (math.inf, math.inf)

    # ------------------------------------------------------------------
    def window(self, seconds: float) -> dict:
        from qmann_tpu_torch.graphs import launch_counts
        before = launch_counts()
        acc = {"steps": 0, "samples": 0, "flops": 0.0,
               "lattice_least_s": 0.0}
        failed = 0
        t0 = time.perf_counter()
        while True:
            finite = self._epoch(self.graphs)
            for k in acc:
                acc[k] += self.epoch_work[k]
            failed += 0 if finite else self.n_train
            if self.epochs == len(self.schedule):
                self._test_pass()
                for k in ("flops", "lattice_least_s"):
                    acc[k] += self.test_work[k]
                self._restart()
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        acc["lattice_launches"] = launch_counts()[0] - before[0]
        return {"elapsed_s": elapsed, "attempted": acc["samples"],
                "failed": failed, "work": acc,
                "metrics": {"cli_samples_per_s": acc["samples"] / elapsed}}

    def release(self) -> None:
        for name in ("graphs", "params", "lr_t", "trainer"):
            setattr(self, name, None)

    # ------------------------------------------------------------------
    def readings(self, control=False) -> dict:
        lr = self.schedule[0][1]
        init = {k: v[None] for k, v in self.init.items()}
        batches = [{k: v[i][None] for k, v in self.batches.items()}
                   for i in range(training.FIRST_STEPS)]
        ref = training.reference_steps(self.model, init, batches, lr)
        if control == "tf32":
            other = training.reference_steps(self.model, init, batches, lr,
                                             control=True)
        elif control:
            other = training.reference_steps(self.model, init, batches, lr,
                                             fault=control)
        else:
            other = self.first
        return training.numbers(other, ref, init,
                                self.batches["size_b"][0].reshape(1), lr,
                                self.model)
