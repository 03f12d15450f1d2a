"""The family trainer (counterpart of ``qmann_tpu/train/multi.py``): R =
(tasks x seeds) MemN2N runs trained as one stacked family.

The reference's sweep protocols re-run a tiny model serially (run.sh: 10
loops x tasks 1-20, 200 trainings; sweep_fixed.sh: iwl {0, 1} x 20 tasks x
2 loops).  JAX vmaps the SGD step over a leading run axis R inside the
epoch's ``lax.scan``.  Here the parameters are stacked [R, ...] and every
batch is one forward, one backward and one in-place SGD step for all runs:
the lattice kernel takes the family axis in its grid, the read and the
Hamming kernel fold R into their batch, so a family step issues the
launches of one run and carries R times its work.  Runs never interact:
the gradient of the summed loss with respect to the stacked parameters is
each run's own, and cost and matches are kept per run.  (Stacked, not
``torch.func.vmap``: the ctypes launches have no batching rule, each
autograd.Function would need a vmap rule calling the same R-axis kernels,
and the in-place SGD step does not compose with functorch.)

Per run the semantics are ``trainer.train_task``'s, with JAX's two
documented deviations: no early-stopping break (every run trains the full
schedule; best-model tracking, and so the reported test error, is the
same, on the device, with the epoch the reference would have stopped at
kept in ``ind_best``), and validation in chunks of ``eval_chunk`` samples
(the metrics are masked sums, so chunking changes nothing).

Batching: every task's train split is padded to the largest; per-(run,
batch) sample masks and live counts give the reference's partial-batch
divisor, and an all-padding batch leaves its run untouched (the run's
parameters are restored, JAX's ``where(size_b > 0, new, old)``, weight
decay included).  The splits live on the device in int8 where the features
are small integers and are gathered and cast per batch.  Per-run shuffles
draw from ``np.random.default_rng(seed)``, as ``train_task`` does.

The integer fast path (``en_integer_fast_path``, on by default here as in
JAX): off ``use_pallas`` the embeddings take the exact GEMM for the runs
whose exactness predicate holds and the lattice for the others, with one
host sync per forward for every weight's predicates (``models.memn2n``).
At R = 200 and the padded layout the plain lattice would form ~9 GB of
products per embedding; the GEMM forms none.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from qmann_tpu_torch.config import QmannConfig
from qmann_tpu_torch.data.babi import TaskData, VectorizedSplit
from qmann_tpu_torch.device import resolve_device
from qmann_tpu_torch.models import memn2n
from qmann_tpu_torch.ops.losses import argmax_last
from qmann_tpu_torch.train.optim import (lr_schedule, sgd_update,
                                         zero_null_columns)

Params = Dict[str, torch.Tensor]
Data = Dict[str, torch.Tensor]


def _compact(x: np.ndarray) -> np.ndarray:
    """Integral small-range float32 features as int8 (4x less memory)."""
    if (x.dtype == np.float32 and x.size and np.all(x == np.round(x))
            and -128 <= x.min() and x.max() <= 127):
        return x.astype(np.int8)
    return x


def _stack_split(splits: Sequence[VectorizedSplit]) -> Dict[str, np.ndarray]:
    """T task splits as zero-padded [T, N_max, ...] arrays and counts."""
    n_max = max(len(s) for s in splits)

    def pad(xs):
        out = np.zeros((len(splits), n_max) + xs[0].shape[1:], xs[0].dtype)
        for t, a in enumerate(xs):
            out[t, :len(a)] = a
        return out

    return {
        "memory": _compact(pad([s.memory for s in splits])),
        "question": _compact(pad([s.question for s in splits])),
        "answer": _compact(pad([s.answer for s in splits])),
        "mask": pad([s.mask for s in splits]),
        "n": np.array([len(s) for s in splits], np.int32),
    }


def _gather(data: Data, task_id: torch.Tensor, idx: torch.Tensor):
    """data[task_id[r], idx[r, j]] -> [R, J, ...] float32 features and the
    bool memory mask."""
    sel = (task_id[:, None], idx)
    return (data["memory"][sel].to(torch.float32),
            data["question"][sel].to(torch.float32),
            data["answer"][sel].to(torch.float32), data["mask"][sel])


def _masked_eval_metrics(logits: torch.Tensor, answer: torch.Tensor,
                         sm: torch.Tensor):
    """The reference's valid/test metrics per run over the live samples:
    cost -sum p[y], matches of the ties-to-last argmax."""
    probs = torch.softmax(logits, dim=-1)
    cost = -((answer * probs).sum(-1) * sm).sum(-1)
    pred = argmax_last(logits, dim=-1)
    hit = torch.gather(answer, -1, pred[..., None])[..., 0]
    return cost, ((hit == 1.0).to(torch.float32) * sm).sum(-1)


def family_update(params: Params, grads: Mapping[str, torch.Tensor], lr,
                  size_b: torch.Tensor, cfg: QmannConfig, scale_dim: int,
                  padding_runs: Optional[np.ndarray] = None) -> Params:
    """The family's SGD step in place: ``sgd_update`` with the per-run
    divisor max(size_b, 1), ``zero_null_columns``, then the runs of
    padding_runs (host indices: runs whose batch is all padding) put back
    as they were, as JAX's where(size_b > 0, new, old)."""
    saved = None
    if padding_runs is not None and len(padding_runs):
        rows = torch.from_numpy(np.asarray(padding_runs)).to(size_b.device)
        saved = {k: v[rows].clone() for k, v in params.items()}
    sgd_update(params, grads, lr, torch.clamp_min(size_b, 1.0), cfg,
               scale_dim=scale_dim)
    zero_null_columns(params, cfg)
    if saved is not None:
        with torch.no_grad():
            for k, v in saved.items():
                params[k][rows] = v
    return params


def family_step(params: Params, batch: Mapping[str, torch.Tensor], lr,
                cfg: QmannConfig, remove_softmax: bool = False,
                padding_runs: Optional[np.ndarray] = None):
    """One SGD step for every run: the stacked forward, one autograd
    backward of the summed loss and ``family_update``.  Returns the per-run
    cost and matches [R] on the device."""
    names = list(params)
    leaves = [params[k].requires_grad_() for k in names]
    try:
        loss, met = memn2n.loss_and_metrics(
            params, batch["memory"], batch["question"], batch["answer"],
            batch["mask"], batch["sample_mask"], cfg, remove_softmax)
        # a weight no gradient reaches gets zeros, as under jax.grad
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(
            leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
    finally:
        for t in leaves:
            t.requires_grad_(False)
    family_update(params, dict(zip(names, grads)), lr, batch["size_b"], cfg,
                  batch["mask"].shape[-1], padding_runs)
    return met.cost.detach(), met.matches


@torch.no_grad()
def multi_eval(params: Params, data: Data, task_id: torch.Tensor,
               cfg: QmannConfig, eval_chunk: int):
    """Forward-only pass over a stacked split for every run, in chunks of
    eval_chunk samples (the index wraps; samples past a task's count are
    masked out).  Returns (cost [R], error [R]) on the device."""
    dev = task_id.device
    nv = data["memory"].shape[1]
    n_run = data["n"][task_id]
    cost = torch.zeros(task_id.shape[0], dtype=torch.float32, device=dev)
    match = torch.zeros_like(cost)
    ncheck = -(-nv // eval_chunk)
    pos = torch.arange(ncheck * eval_chunk, device=dev)
    vidx, vlive = pos % nv, pos < nv
    for c in range(ncheck):
        vi = vidx[c * eval_chunk:(c + 1) * eval_chunk]
        lv = vlive[c * eval_chunk:(c + 1) * eval_chunk]
        mem, qst, ans, msk = _gather(data, task_id,
                                     vi[None].expand(task_id.shape[0], -1))
        sm = (lv[None] & (vi[None] < n_run[:, None])).to(torch.float32)
        out = memn2n.forward(params, mem, qst, msk, cfg)
        c_r, m_r = _masked_eval_metrics(out.logits, ans, sm)
        cost, match = cost + c_r, match + m_r
    err = 1.0 - match / torch.clamp_min(n_run.to(torch.float32), 1.0)
    return cost, err


@dataclasses.dataclass
class MultiTrainResult:
    task_indices: List[int]          # [R]
    seeds: List[int]                 # [R]
    err_test: np.ndarray             # [R]
    cost_test: np.ndarray            # [R]
    err_valid_best: np.ndarray       # [R]
    ind_best: np.ndarray             # [R] epoch of the best snapshot
    history: List[dict]              # per epoch {cost/err train/valid} [R]
    time_train: float
    time_test: float
    params: Params                   # stacked [R, ...] final parameters
    best_params: Optional[Params]    # stacked [R, ...] best snapshots


def _initial_params(cfg: QmannConfig, dims, run_seed: Sequence[int],
                    params, dev: torch.device) -> Params:
    """The stacked initial weights: the caller's [R, ...] (copied to dev),
    else each run's ``init_params`` from its seed (train_task's)."""
    R = len(run_seed)
    if params is None:
        runs = [memn2n.init_params(cfg, dims,
                                   torch.Generator().manual_seed(s),
                                   device=dev) for s in run_seed]
        return {k: torch.stack([p[k] for p in runs]) for k in runs[0]}
    want = memn2n.param_shapes(cfg, dims.dim_input)
    out = {}
    for k, shape in want.items():
        if k not in params:
            raise ValueError(f"params lack {k!r}")
        v = params[k]
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(np.array(v, np.float32))
        if tuple(v.shape) != (R,) + shape:
            raise ValueError(f"parameter {k!r} has shape {tuple(v.shape)}, "
                             f"expected {(R,) + shape}")
        out[k] = v.detach().to(dev, torch.float32).clone()
    return out


def train_tasks_multi(cfg: QmannConfig, tasks: Mapping[int, TaskData],
                      seeds: Sequence[int], eval_chunk: int = 128,
                      log=print, integer_fast_path: Optional[bool] = None,
                      params: Optional[Mapping] = None,
                      device="cuda") -> MultiTrainResult:
    """Train every (task, seed) pair as one stacked family; runs are
    ordered task-major (task 0's seeds first).

    tasks: {task_index: TaskData}, all of one feature shape (load with
    pad_dict/pad_line, the sweep's uniform layout).  integer_fast_path
    defaults to on (JAX's choice for the family; False is the A/B).
    params: stacked [R, ...] initial weights, else each run is initialised
    from its seed as ``train_task`` would."""
    dev = resolve_device(device)
    if integer_fast_path is None:
        integer_fast_path = True
    cfg = cfg.replace(en_integer_fast_path=integer_fast_path)
    t_indices = sorted(tasks)
    datas = [tasks[t] for t in t_indices]
    dims = datas[0].dims
    shape = datas[0].train.memory.shape[1:]
    for d in datas[1:]:
        if (d.dims.dim_input != dims.dim_input
                or d.train.memory.shape[1:] != shape):
            raise ValueError("train_tasks_multi needs uniform task shapes; "
                             "load with pad_dict/pad_line")

    def upload(split):
        return {k: torch.from_numpy(v).to(dev) for k, v in
                _stack_split([getattr(d, split) for d in datas]).items()}

    train_data, valid_data, test_data = (upload(s) for s in
                                         ("train", "valid", "test"))
    run_task = [ti for ti in range(len(t_indices)) for _ in seeds]
    run_seed = [s for _ in t_indices for s in seeds]
    R = len(run_task)
    task_id = torch.tensor(run_task, dtype=torch.int64, device=dev)
    params = _initial_params(cfg, dims, run_seed, params, dev)

    B = cfg.size_batch
    n_train = np.array([len(d.train) for d in datas], np.int64)
    n_run = n_train[run_task]
    nb = int(-(-n_train.max() // B))
    # per-run batch grid, train_task's batching of each task
    grid = np.arange(nb * B)
    perm_base = np.zeros((R, nb * B), np.int64)
    smask = np.zeros((R, nb, B), np.float32)
    for r in range(R):
        perm_base[r, :n_run[r]] = np.arange(n_run[r])
        smask[r] = (grid < n_run[r]).reshape(nb, B)
    size_b = smask.sum(axis=2)                                # [R, nb]
    padding_runs = [np.flatnonzero(size_b[:, i] == 0) for i in range(nb)]
    smask_d = torch.from_numpy(smask).to(dev)
    size_b_d = torch.from_numpy(size_b).to(dev)
    perm_const = torch.from_numpy(perm_base).to(dev)
    rngs = [np.random.default_rng(s) for s in run_seed]

    best = {k: v.clone() for k, v in params.items()}
    best_err = torch.full((R,), float("inf"), device=dev)
    best_cost = torch.full((R,), float("inf"), device=dev)
    ind_best = torch.zeros((R,), dtype=torch.int32, device=dev)

    history: List[dict] = []
    t0 = time.time()
    for itr, lr, remove_softmax in lr_schedule(cfg):
        if cfg.en_sample_shuffled:
            perm = perm_base.copy()
            for r in range(R):
                perm[r, :n_run[r]] = rngs[r].permutation(n_run[r])
            perm_d = torch.from_numpy(perm).to(dev)
        else:
            perm_d = perm_const
        lr_t = torch.tensor(lr, dtype=torch.float32, device=dev)
        costs, matches = [], []
        for i in range(nb):
            mem, qst, ans, msk = _gather(train_data, task_id,
                                         perm_d[:, i * B:(i + 1) * B])
            batch = {"memory": mem, "question": qst, "answer": ans,
                     "mask": msk, "sample_mask": smask_d[:, i],
                     "size_b": size_b_d[:, i]}
            c, m = family_step(params, batch, lr_t, cfg, remove_softmax,
                               padding_runs[i])
            costs.append(c)
            matches.append(m)
        cost_train = torch.stack(costs).sum(0)
        match_train = torch.stack(matches).sum(0)
        cost_valid, err_valid = multi_eval(params, valid_data, task_id, cfg,
                                           eval_chunk)
        # best-model tracking: the error AND the cost must not regress
        improved = (err_valid <= best_err) & (cost_valid <= best_cost)
        best_err = torch.where(improved, err_valid, best_err)
        best_cost = torch.where(improved, cost_valid, best_cost)
        ind_best = torch.where(improved, itr, ind_best)
        if cfg.en_save_best_model:
            for k, v in params.items():
                imp = improved.reshape((-1,) + (1,) * (v.dim() - 1))
                best[k] = torch.where(imp, v, best[k])
        err_train = 1.0 - match_train.cpu().numpy() / np.maximum(n_run, 1)
        history.append({
            "cost_train": cost_train.cpu().numpy(),
            "err_train": err_train,
            "cost_valid": cost_valid.cpu().numpy(),
            "err_valid": err_valid.cpu().numpy(),
            "lr": lr,
        })
        if cfg.verbose:
            log(f"< ITR : {itr:3d} >  mean(err_train)="
                f"{float(err_train.mean()):.4f}  mean(err_valid)="
                f"{float(history[-1]['err_valid'].mean()):.4f}  "
                f"mean(err_valid_best)={float(best_err.mean()):.4f}")
    time_train = time.time() - t0

    eval_params = best if cfg.en_save_best_model else params
    t0 = time.time()
    cost_test, err_test = multi_eval(eval_params, test_data, task_id, cfg,
                                     eval_chunk)
    cost_test, err_test = cost_test.cpu().numpy(), err_test.cpu().numpy()
    time_test = time.time() - t0

    return MultiTrainResult(
        task_indices=[t_indices[t] for t in run_task],
        seeds=list(run_seed),
        err_test=err_test,
        cost_test=cost_test,
        err_valid_best=best_err.cpu().numpy(),
        ind_best=ind_best.cpu().numpy(),
        history=history,
        time_train=time_train,
        time_test=time_test,
        params=params,
        best_params=best if cfg.en_save_best_model else None,
    )
