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

``multi_epoch`` is JAX's one-program epoch (``jit`` over a ``lax.scan`` of
the steps, a ``lax.scan`` of the validation chunks and the best-model
selection): on the card it replays one captured CUDA graph of the family
step per batch and one of a validation chunk per chunk (``graphs.py``),
each reading its batch or chunk from device buffers through a device
counter, and selects the best snapshots with ``torch.where`` in place.
The host builds each epoch's permutations once, as JAX builds the scan's
inputs, and copies them into a buffer the graph reads.  On the plain
route with the integer fast path on (``memn2n.fast_path_reads_host``)
each forward reads the fast path's decisions on the host, where JAX's
``lax.cond`` decides on the device; no graph can hold that read, so that
route runs the same bodies eagerly.

Per run the semantics are ``trainer.train_task``'s, with JAX's two
documented deviations: no early-stopping break (every run trains the full
schedule; best-model tracking, and so the reported test error, is the
same, on the device, with the epoch the reference would have stopped at
kept in ``ind_best``), and validation in chunks of ``eval_chunk`` samples
(the metrics are masked sums, so chunking changes nothing).

Batching: every task's train split is padded to the largest; per-(run,
batch) sample masks and live counts give the reference's partial-batch
divisor, and an all-padding batch leaves its run untouched (JAX's
``where(size_b > 0, new, old)`` per parameter, weight decay included).
The splits live on the device in int8 where the features are small
integers and are gathered and cast per batch.  Per-run shuffles draw from
``np.random.default_rng(seed)``, as ``train_task`` does.

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
from qmann_tpu_torch.graphs import Graphs
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
                  size_b: torch.Tensor, cfg: QmannConfig,
                  scale_dim: int) -> Params:
    """The family's SGD step in place: ``sgd_update`` with the per-run
    divisor max(size_b, 1), ``zero_null_columns``, then the runs whose
    batch is all padding put back as they were: JAX's where(size_b > 0,
    new, old) per parameter, on the device (what a graph holds)."""
    saved, live = {k: v.clone() for k, v in params.items()}, size_b > 0
    sgd_update(params, grads, lr, torch.clamp_min(size_b, 1.0), cfg,
               scale_dim=scale_dim)
    zero_null_columns(params, cfg)
    with torch.no_grad():
        for k, v in saved.items():
            keep = live.reshape((-1,) + (1,) * (v.dim() - 1))
            torch.where(keep, params[k], v, out=params[k])
    return params


def family_step(params: Params, batch: Mapping[str, torch.Tensor], lr,
                cfg: QmannConfig, remove_softmax: bool = False):
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
                  batch["mask"].shape[-1])
    return met.cost.detach(), met.matches


def _family_epoch_step(params: Params, data: Data, task_id: torch.Tensor,
                       perm: torch.Tensor, smask: torch.Tensor,
                       size_b: torch.Tensor, lr, counter: torch.Tensor,
                       costs: torch.Tensor, matches: torch.Tensor,
                       cfg: QmannConfig, remove_softmax: bool) -> None:
    """Family step ``counter`` of an epoch, all on the device: batch
    ``counter`` of every run's grid (perm [R, NB * B], smask [NB, R, B],
    size_b [NB, R]) gathered from the stacked split, ``family_step``, the
    per-run cost and matches written into row ``counter`` of [NB, R]
    ``costs`` and ``matches``, then the counter ([1], int64) advanced.
    The body ``multi_epoch`` replays."""
    R, nb = task_id.shape[0], smask.shape[0]
    idx = perm.view(R, nb, -1).index_select(1, counter)[:, 0]
    mem, qst, ans, msk = _gather(data, task_id, idx)
    batch = {"memory": mem, "question": qst, "answer": ans, "mask": msk,
             "sample_mask": smask.index_select(0, counter)[0],
             "size_b": size_b.index_select(0, counter)[0]}
    c, m = family_step(params, batch, lr, cfg, remove_softmax)
    costs.index_copy_(0, counter, c[None])
    matches.index_copy_(0, counter, m[None])
    counter.add_(1)


@torch.no_grad()
def _eval_chunk(params: Params, data: Data, task_id: torch.Tensor,
                vidx: torch.Tensor, vlive: torch.Tensor,
                counter: torch.Tensor, cost: torch.Tensor,
                match: torch.Tensor, cfg: QmannConfig) -> None:
    """Validation chunk ``counter`` (of [NC, E] vidx, vlive) for every run,
    all on the device: the forward, the masked metrics added into the [R]
    ``cost`` and ``match`` accumulators, the counter advanced.  The body
    ``multi_eval`` replays."""
    vi = vidx.index_select(0, counter)[0]
    lv = vlive.index_select(0, counter)[0]
    R = task_id.shape[0]
    mem, qst, ans, msk = _gather(data, task_id, vi[None].expand(R, -1))
    sm = (lv[None] & (vi[None] < data["n"][task_id][:, None])).to(
        torch.float32)
    out = memn2n.forward(params, mem, qst, msk, cfg)
    c_r, m_r = _masked_eval_metrics(out.logits, ans, sm)
    cost.add_(c_r)
    match.add_(m_r)
    counter.add_(1)


def _eager(key, body, *inputs, bound=()):
    """A ``Graphs`` call's body, run eagerly."""
    return body(*inputs)


def _runner(graphs: Graphs, cfg: QmannConfig):
    """What runs the bodies of an epoch under cfg: graphs, or ``_eager``
    where the forward reads the host."""
    return _eager if memn2n.fast_path_reads_host(cfg) else graphs


def multi_eval(params: Params, data: Data, task_id: torch.Tensor,
               cfg: QmannConfig, eval_chunk: int,
               graphs: Optional[Graphs] = None):
    """Forward-only pass over a stacked split for every run, in chunks of
    eval_chunk samples (the index wraps; samples past a task's count are
    masked out).  Returns (cost [R], error [R]) on the device.  On the card
    each chunk is one replay of the graph of ``_eval_chunk`` (``graphs``:
    the run's programs, else a new ``Graphs``; params and data are bound
    to it; eagerly where the forward reads the host, ``_runner``)."""
    dev = task_id.device
    graphs = Graphs(dev) if graphs is None else graphs
    run = _runner(graphs, cfg)
    nv = data["memory"].shape[1]
    R = task_id.shape[0]
    ncheck = -(-nv // eval_chunk)
    pos = torch.arange(ncheck * eval_chunk, device=dev)
    vidx = graphs.static("eval_index", (ncheck, eval_chunk), torch.int64)
    vlive = graphs.static("eval_live", (ncheck, eval_chunk), torch.bool)
    vidx.copy_((pos % nv).view(ncheck, eval_chunk))
    vlive.copy_((pos < nv).view(ncheck, eval_chunk))
    counter = graphs.static("eval_chunk", (1,), torch.int64)
    cost = graphs.static("eval_cost", (R,))
    match = graphs.static("eval_match", (R,))
    for t in (counter, cost, match):
        t.zero_()
    bound = [*params.values(), *data.values(), task_id, vidx, vlive, counter,
             cost, match]
    for _ in range(ncheck):
        run(("multi_eval", cfg), lambda: _eval_chunk(
            params, data, task_id, vidx, vlive, counter, cost, match, cfg),
            bound=bound)
    err = 1.0 - match / torch.clamp_min(
        data["n"][task_id].to(torch.float32), 1.0)
    return cost.clone(), err


def multi_epoch(params: Params, best: Params, best_err: torch.Tensor,
                best_cost: torch.Tensor, ind_best: torch.Tensor, itr: int,
                train_data: Data, valid_data: Data, task_id: torch.Tensor,
                perm: torch.Tensor, smask: torch.Tensor,
                size_b: torch.Tensor, lr, cfg: QmannConfig,
                remove_softmax: bool, batch: int, eval_chunk: int,
                graphs: Optional[Graphs] = None):
    """One epoch for all R runs (JAX's ``multi_epoch``): every family step
    on the batch grid (perm [R, NB * batch], smask [NB, R, batch], size_b
    [NB, R]), the full validation pass in chunks of eval_chunk, and the
    best-model tracking of MemN2N/MemN2N.c:2168-2198 (error and cost must
    both not regress).  params, best, best_err, best_cost and ind_best are
    updated in place, on the device.  On the card the steps and the chunks
    replay their graphs (``graphs``: the run's programs, else a new
    ``Graphs`` for this call; params, the data, perm, smask, size_b and a
    tensor lr are bound to them: keep their storage), or run eagerly where
    the forward reads the host (``_runner``).

    Returns (params, best, best_err, best_cost, ind_best, cost_train [R],
    match_train [R], cost_valid [R], err_valid [R]), JAX's outputs; the
    train sums are taken once over the per-step rows in step order."""
    dev = task_id.device
    graphs = Graphs(dev) if graphs is None else graphs
    run = _runner(graphs, cfg)
    R, nb = task_id.shape[0], smask.shape[0]
    counter = graphs.static("epoch_step", (1,), torch.int64)
    costs = graphs.static("epoch_costs", (nb, R))
    matches = graphs.static("epoch_matches", (nb, R), torch.int32)
    counter.zero_()
    tensor_lr = isinstance(lr, torch.Tensor)
    key = ("family_step", cfg, remove_softmax, None if tensor_lr else lr)
    bound = [*params.values(), *train_data.values(), task_id, perm, smask,
             size_b, counter, costs, matches] + ([lr] if tensor_lr else [])
    for _ in range(nb):
        run(key, lambda: _family_epoch_step(
            params, train_data, task_id, perm, smask, size_b, lr, counter,
            costs, matches, cfg, remove_softmax), bound=bound)
    cost_train = costs.sum(0)
    match_train = matches.sum(0)
    cost_valid, err_valid = multi_eval(params, valid_data, task_id, cfg,
                                       eval_chunk, graphs)
    improved = (err_valid <= best_err) & (cost_valid <= best_cost)
    best_err.copy_(torch.where(improved, err_valid, best_err))
    best_cost.copy_(torch.where(improved, cost_valid, best_cost))
    ind_best.copy_(torch.where(improved, itr, ind_best))
    if cfg.en_save_best_model:
        for k, v in params.items():
            imp = improved.reshape((-1,) + (1,) * (v.dim() - 1))
            torch.where(imp, v, best[k], out=best[k])
    return (params, best, best_err, best_cost, ind_best, cost_train,
            match_train, cost_valid, err_valid)


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
    # per-run batch grid, train_task's batching of each task, laid out as
    # JAX's scan inputs: smask [nb, R, B], size_b [nb, R]
    grid = np.arange(nb * B)
    perm_base = np.zeros((R, nb * B), np.int64)
    smask = np.zeros((nb, R, B), np.float32)
    for r in range(R):
        perm_base[r, :n_run[r]] = np.arange(n_run[r])
        smask[:, r] = (grid < n_run[r]).reshape(nb, B)
    smask_d = torch.from_numpy(smask).to(dev)
    size_b_d = torch.from_numpy(smask.sum(axis=2)).to(dev)
    # the run's programs and the buffers they bind: the epoch's
    # permutations (copied in once per epoch) and the lr tensor
    graphs = Graphs(dev)
    perm_d = torch.from_numpy(perm_base).to(dev)
    lr_t = graphs.static("lr", ())
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
            perm_d.copy_(torch.from_numpy(perm))
        lr_t.fill_(lr)
        (params, best, best_err, best_cost, ind_best, cost_train,
         match_train, cost_valid, err_valid) = multi_epoch(
            params, best, best_err, best_cost, ind_best, itr, train_data,
            valid_data, task_id, perm_d, smask_d, size_b_d, lr_t, cfg,
            remove_softmax, B, eval_chunk, graphs)
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
                                     eval_chunk, graphs)
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
