"""A family of runs trained as one stacked model: ``train_tasks_multi``'s
set-up, then ``multi_epoch`` in the window (the protocol of the
reference's run.sh: tasks x seeds runs, each task's train split of its own
size, every epoch validated).

Traffic keys: ``tasks``, ``seeds_per_task``, ``train_sizes`` (one per
task), ``valid`` and ``test`` stories a task, ``eval_chunk``, the story
layout (``stories.traffic_stories``), ``route`` (the program's path
flags), ``warm_epochs`` (set-up epochs: the first steps, their capture and
the validation's) and ``trace_seconds``.

The window runs whole epochs; each run's schedule restarts from the drawn
weights after ``num_itr`` epochs, with its test pass, as a new family
would.  ``train_samples_per_s`` is the live training samples of every run
in the window's epochs over the window; padding samples do not count.
"""
from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import work
from benchmark.common import make_weights, program_config
from benchmark.jobs import training
from benchmark.stories import ceil_div, generator, nonzeros, traffic_stories


def _split(traffic: dict, counts, g, device) -> dict:
    """T tasks' stories, task t's first counts[t] live, stacked as the
    family trainer keeps a split ([T, N_max, ...], small integer features
    in int8), with each story's nonzeros and live rows."""
    T, n_max = len(counts), max(counts)
    st = traffic_stories(traffic, T * n_max, g, device)
    live = (torch.arange(n_max, device=device)[None, :]
            < torch.tensor(counts, device=device)[:, None])   # [T, N]

    def stack(x):
        x = x.reshape((T, n_max) + tuple(x.shape[1:]))
        return x * live.reshape((T, n_max) + (1,) * (x.dim() - 2)).to(x.dtype)

    mem, que, ans, mask = (stack(st[k]) for k in
                           ("memory", "question", "answer", "mask"))
    return {
        "data": {"memory": mem.to(torch.int8), "question": que.to(torch.int8),
                 "answer": ans.to(torch.int8), "mask": mask.to(torch.bool),
                 "n": torch.tensor(counts, dtype=torch.int32, device=device)},
        "q_nnz": nonzeros(que), "m_nnz": nonzeros(mem).sum(-1),
        "rows": mask.sum(-1),
    }


class Job:
    def __init__(self, cell: dict, seed: int, device: torch.device):
        self.traffic = cell["traffic"]
        self.model = cell["model_file"]["model"]
        self.weight_std = cell["model_file"]["assumed"]["weight_std"]
        self.seed, self.device = seed, device

    def setup(self) -> None:
        from qmann_tpu_torch.graphs import Graphs
        from qmann_tpu_torch.train import multi
        from qmann_tpu_torch.train.optim import lr_schedule
        self.multi = multi
        t, dev, md = self.traffic, self.device, self.model
        cfg = program_config(md, t["route"])
        if cfg.en_sample_shuffled:
            raise ValueError("the harness runs unshuffled epochs")
        self.cfg = cfg
        T, S = t["tasks"], t["seeds_per_task"]
        R = T * S
        sizes = list(t["train_sizes"])
        if len(sizes) != T:
            raise ValueError("train_sizes needs one size a task")
        g = generator(self.seed, 0, dev)
        self.train = _split(t, sizes, g, dev)
        self.valid = _split(t, [t["valid"]] * T, g, dev)
        self.test = _split(t, [t["test"]] * T, g, dev)
        V, M = t["vocab"], t["max_sentences"]
        I = V + M
        run_task = [ti for ti in range(T) for _ in range(S)]
        self.task_id = torch.tensor(run_task, dtype=torch.int64, device=dev)
        self.params = make_weights(md, I, self.weight_std, self.seed, dev,
                                   runs=R)
        self.init = {k: v.clone() for k, v in self.params.items()}

        B = md["size_batch"]
        self.B = B
        n_run = np.array(sizes, np.int64)[run_task]
        self.n_live = int(n_run.sum())
        nb = ceil_div(max(sizes), B)
        self.nb = nb
        grid = np.arange(nb * B)
        perm = np.zeros((R, nb * B), np.int64)
        smask = np.zeros((nb, R, B), np.float32)
        for r in range(R):
            perm[r, :n_run[r]] = np.arange(n_run[r])
            smask[:, r] = (grid < n_run[r]).reshape(nb, B)
        self.smask = torch.from_numpy(smask).to(dev)
        self.size_b = self.smask.sum(2)
        self.graphs = Graphs(dev)
        self.perm = torch.from_numpy(perm).to(dev)
        self.lr_t = self.graphs.static("lr", ())
        self.best = {k: v.clone() for k, v in self.params.items()}
        self.best_err = torch.full((R,), float("inf"), device=dev)
        self.best_cost = torch.full((R,), float("inf"), device=dev)
        self.ind_best = torch.zeros((R,), dtype=torch.int32, device=dev)
        self.schedule = list(lr_schedule(cfg))
        self.epoch_work = self._epoch_work()
        self.test_work = self._eval_work(self.test)
        self.epochs = 0

        graphs = self.graphs
        rec = training.StepRecorder(
            graphs, self.params,
            lambda: graphs.static("epoch_costs", (nb, R)), "family_step")
        for _ in range(t["warm_epochs"]):
            self._epoch(rec)
        self.first = rec.steps
        # the run's test pass, warmed and captured before the window
        for _ in range(2):
            self._test_pass()
        self._restart()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # ------------------------------------------------------------------
    def _epoch(self, graphs) -> bool:
        """One epoch of every run, as train_tasks_multi's loop makes it,
        with its per-epoch read to the host; True if every cost is
        finite."""
        itr, lr, remove_softmax = self.schedule[self.epochs
                                                % len(self.schedule)]
        self.lr_t.fill_(lr)
        with record_function(training.SPAN_EPOCH):
            out = self.multi.multi_epoch(
                self.params, self.best, self.best_err, self.best_cost,
                self.ind_best, itr, self.train["data"], self.valid["data"],
                self.task_id, self.perm, self.smask, self.size_b, self.lr_t,
                self.cfg, remove_softmax, self.B, self.traffic["eval_chunk"],
                graphs)
        with record_function(training.SPAN_READ):
            hist = [x.cpu().numpy() for x in out[5:]]
        self.epochs += 1
        return all(np.isfinite(h).all() for h in hist)

    def _test_pass(self) -> None:
        with record_function(training.SPAN_VALID):
            cost, err = self.multi.multi_eval(
                self.params, self.test["data"], self.task_id, self.cfg,
                self.traffic["eval_chunk"], self.graphs)
            cost.cpu(), err.cpu()

    def _restart(self) -> None:
        """A new family from the drawn weights, as the next run.sh loop."""
        for k, v in self.init.items():
            self.params[k].copy_(v)
            self.best[k].copy_(v)
        self.best_err.fill_(float("inf"))
        self.best_cost.fill_(float("inf"))
        self.ind_best.zero_()
        self.epochs = 0

    # ------------------------------------------------------------------
    def _eval_work(self, split) -> dict:
        """Work of one validation or test pass over a split: every run's
        live stories once (a chunk's wrapped repeats are masked out)."""
        md = self.model
        K, D = md["num_hops"], md["dim_emb"]
        I = self.traffic["vocab"] + self.traffic["max_sentences"]
        tid = self.task_id
        samples = int(split["data"]["n"][tid].sum())
        rows = int(split["rows"][tid].sum())
        return {"flops": work.forward_flops(samples, rows, K, D, I),
                "lattice_least_s": work.forward_lattice_least_s(
                    samples, int(split["q_nnz"][tid].sum()), rows,
                    int(split["m_nnz"][tid].sum()), K, D, I,
                    runs=len(tid))}

    def _epoch_work(self) -> dict:
        md = self.model
        K, D = md["num_hops"], md["dim_emb"]
        I = self.traffic["vocab"] + self.traffic["max_sentences"]
        R, nb, B = len(self.task_id), self.nb, self.B
        tid = self.task_id[:, None]
        sm = self.smask.permute(1, 0, 2).reshape(R, nb * B)

        def per_batch(x):     # [T, N] per story -> [nb] live sums
            return (x[tid, self.perm].to(torch.float64) * sm).reshape(
                R, nb, B).sum((0, 2)).tolist()

        q, m, rows = (per_batch(self.train[k]) for k in
                      ("q_nnz", "m_nnz", "rows"))
        live = sm.reshape(R, nb, B).sum((0, 2)).tolist()
        lattice = sum(work.forward_lattice_least_s(
            int(live[k]), int(q[k]), int(rows[k]), int(m[k]), K, D, I,
            runs=R) for k in range(nb))
        ev = self._eval_work(self.valid)
        return {"steps": nb, "samples": self.n_live,
                "flops": 3 * work.forward_flops(self.n_live, int(sum(rows)),
                                                K, D, I) + ev["flops"],
                "lattice_least_s": lattice + ev["lattice_least_s"]}

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
            failed += 0 if finite else self.n_live
            if self.epochs == len(self.schedule):
                self._test_pass()
                for k in ("flops", "lattice_least_s"):
                    acc[k] += self.test_work[k]
                self._restart()
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        after = launch_counts()
        acc["lattice_launches"] = after[0] - before[0]
        return {"elapsed_s": elapsed, "attempted": acc["samples"],
                "failed": failed, "work": acc,
                "metrics": {"train_samples_per_s": acc["samples"] / elapsed}}

    def release(self) -> None:
        for name in ("graphs", "params", "best", "lr_t", "multi"):
            setattr(self, name, None)

    # ------------------------------------------------------------------
    def batch(self, k: int) -> dict:
        """Batch k of the first epoch, as the family step gathers it."""
        data = self.train["data"]
        R, B = len(self.task_id), self.B
        idx = self.perm.view(R, self.nb, B)[:, k]
        sel = (self.task_id[:, None], idx)
        return {"memory": data["memory"][sel].to(torch.float32),
                "question": data["question"][sel].to(torch.float32),
                "answer": data["answer"][sel].to(torch.float32),
                "mask": data["mask"][sel],
                "sample_mask": self.smask[k], "size_b": self.size_b[k]}

    def readings(self, control=False) -> dict:
        """The numbers of the program's first steps (or of the control:
        "tf32", or a fault of the reference: "half_batch") against the
        reference's."""
        lr = self.schedule[0][1]
        batches = [self.batch(k) for k in range(training.FIRST_STEPS)]
        ref = training.reference_steps(self.model, self.init, batches, lr)
        if control == "tf32":
            other = training.reference_steps(self.model, self.init, batches,
                                             lr, control=True)
        elif control:
            other = training.reference_steps(self.model, self.init, batches,
                                             lr, fault=control)
        else:
            other = self.first
        return training.numbers(other, ref, self.init, self.size_b[0], lr,
                                self.model)
