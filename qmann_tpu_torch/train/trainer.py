"""The batched trainer (counterpart of ``qmann_tpu/train/trainer.py``):
per-batch SGD with the reference's clip, lr halving schedule, NULL column
zeroing and last-partial-batch divisor, per-epoch validation, best-model
tracking and early stopping, and the reference's metrics.

JAX scans the SGD step over an epoch inside one compiled program; here
``train_epoch`` is a Python loop over batches that stay on the device, and
each ``train_step`` is forward -> autograd backward -> in-place SGD with
no read back to the host.  The host reads the epoch's summed cost and
matches once per epoch.  Entry points run on the card unless the caller
passes ``device="cpu"``.

With ``en_linear_start`` the first ``num_itr_linear_start`` epochs train
with the attention softmax removed, at half the learning rate
(``optim.lr_schedule``); evaluation always keeps the softmax.  With
``en_similarity_analysis`` each epoch dumps the attention softmax's inputs
and outputs on the validation split (``utils/analysis.py``).

With ``mesh=`` (``parallel/mesh.py``) every rank of the mesh calls
``train_task`` alike: the epoch's batches are cut into each rank's block
once per epoch (``_shard_epoch_batches``) and each batch runs the sharded
step (``parallel/sharding.py``); the shuffle is the host-side one, as
JAX's is under a mesh.  Rank 0 alone logs and dumps the similarity
analysis.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from qmann_tpu_torch.config import QmannConfig
from qmann_tpu_torch.data.babi import TaskData, VectorizedSplit
from qmann_tpu_torch.device import resolve_device
from qmann_tpu_torch.models import memn2n
from qmann_tpu_torch.ops.losses import cross_entropy
from qmann_tpu_torch.train.optim import (lr_schedule, sgd_update,
                                         zero_null_columns)
from qmann_tpu_torch.utils.analysis import SimilarityAnalyzer

Params = Dict[str, torch.Tensor]
Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass
class EpochMetrics:
    cost_train: float
    err_train: float
    cost_valid: float
    err_valid: float
    lr: float


@dataclasses.dataclass
class TrainResult:
    params: Params
    best_params: Optional[Params]
    history: List[EpochMetrics]
    err_test: float
    cost_test: float
    time_train: float
    time_test: float


def _batched_arrays(split: VectorizedSplit, batch_size: int
                    ) -> Dict[str, np.ndarray]:
    """Pack a split into [NB, B, ...] arrays with a per-sample validity
    mask for the final partial batch."""
    n = len(split)
    nb = -(-n // batch_size)
    pad = nb * batch_size - n

    def pack(x):
        if pad:
            x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
        return x.reshape((nb, batch_size) + x.shape[1:])

    sample_mask = np.ones(n, np.float32)
    return {
        "memory": pack(split.memory),
        "question": pack(split.question),
        "answer": pack(split.answer),
        "mask": pack(split.mask),
        "sample_mask": pack(sample_mask),
        # live-count divisor per batch
        "size_b": pack(sample_mask).sum(axis=1).astype(np.float32),
    }


def _pack_shuffled(memory: torch.Tensor, question: torch.Tensor,
                   answer: torch.Tensor, mask: torch.Tensor,
                   perm: torch.Tensor, batch_size: int) -> Batch:
    """Device-side epoch shuffle: gather the once-uploaded sample arrays
    by a [N] permutation and reshape into [nb, B, ...] batches on the
    device; only the permutation crosses from the host.  sample_mask and
    size_b do not depend on the order and are reused."""
    n = memory.shape[0]
    nb = -(-n // batch_size)
    pad = nb * batch_size - n

    def pack(x):
        x = torch.index_select(x, 0, perm)
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        return x.reshape((nb, batch_size) + tuple(x.shape[1:]))

    return {"memory": pack(memory), "question": pack(question),
            "answer": pack(answer), "mask": pack(mask)}


def _without_fast_path(cfg: QmannConfig) -> QmannConfig:
    return (cfg.replace(en_integer_fast_path=False)
            if cfg.en_integer_fast_path else cfg)


def train_step(params: Params, batch: Mapping[str, torch.Tensor], lr,
               cfg: QmannConfig, remove_softmax: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One SGD step on one batch: forward, autograd backward, in-place
    ``sgd_update`` and ``zero_null_columns``.  Returns the batch's cost and
    matches as device tensors (no host sync).  The integer fast path is
    off here, as in JAX's ``train_epoch`` (it would cost a host sync per
    step; bit-identical either way)."""
    cfg = _without_fast_path(cfg)
    names = list(params)
    leaves = [params[k].requires_grad_() for k in names]
    try:
        loss, met = memn2n.loss_and_metrics(
            params, batch["memory"], batch["question"], batch["answer"],
            batch["mask"], batch["sample_mask"], cfg, remove_softmax)
        # a weight that no gradient reaches (A in attention mode 4, whose
        # binarized score passes none; the scale during linear start) gets
        # zeros, as under jax.grad
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(
            leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
    finally:
        for t in leaves:
            t.requires_grad_(False)
    # the scale's divisor takes the padded memory length as its dim
    sgd_update(params, dict(zip(names, grads)), lr, batch["size_b"], cfg,
               scale_dim=batch["mask"].shape[-1])
    zero_null_columns(params, cfg)
    return met.cost.detach(), met.matches


def train_epoch(params: Params, batches: Mapping[str, torch.Tensor], lr,
                cfg: QmannConfig, remove_softmax: bool = False
                ) -> Tuple[Params, torch.Tensor, torch.Tensor]:
    """``train_step`` over every batch of [NB, B, ...] device arrays, in
    order; params are updated in place.  Returns (params, summed cost,
    summed matches), the sums as device tensors."""
    cfg = _without_fast_path(cfg)
    costs, matches = [], []
    for i in range(batches["memory"].shape[0]):
        c, m = train_step(params, {k: v[i] for k, v in batches.items()}, lr,
                          cfg, remove_softmax)
        costs.append(c)
        matches.append(m)
    return params, torch.stack(costs).sum(), torch.stack(matches).sum()


def _pad_to(x: np.ndarray, n: int) -> np.ndarray:
    """Zero-pad the leading axis to exactly n rows (no-op if already
    there)."""
    pad = n - x.shape[0]
    if pad <= 0:
        return x
    return np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])


@torch.no_grad()
def evaluate(params: Params, memory: torch.Tensor, question: torch.Tensor,
             answer: torch.Tensor, mask: torch.Tensor, cfg: QmannConfig):
    """Forward-only pass over one chunk: (cost, matches, predictions) as
    device tensors."""
    out = memn2n.forward(params, memory, question, mask, cfg)
    met = cross_entropy(out.logits, answer)
    return met.cost, met.matches, met.pred


def eval_split(params: Params, split: VectorizedSplit, cfg: QmannConfig,
               chunk: int = 1024, device="cuda", mesh=None
               ) -> Tuple[float, float, np.ndarray]:
    """Returns (cost, error_rate, predictions).

    Every chunk is zero-padded to ``chunk`` samples, as in the JAX package
    (one shape per run).  Zero-padded samples contribute nothing: the cost
    -sum(y*p) and the match test hit==1.0 are both null on an all-zero
    answer, and a sample with no live memory row is NaN-free.  The host
    reads the sums once, after the last chunk.

    mesh: every rank calls this alike, with params whole on its device; a
    chunk's batch goes over "data" and its memory over "model" as
    ``parallel.sharding.infer_specs`` places them, and every rank returns
    the whole split's results."""
    n = len(split)
    costs, matches, preds = [], [], []
    if mesh is None:
        dev = resolve_device(device)

        def run(*arrays):
            return evaluate(params, *(torch.from_numpy(a).to(dev)
                                      for a in arrays), cfg)
    else:
        from qmann_tpu_torch.parallel.sharding import sharded_evaluate

        def run(*arrays):
            return sharded_evaluate(params, *arrays, cfg, mesh)

    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        c, m, p = run(*(_pad_to(x[s:e], chunk) for x in (
            split.memory, split.question, split.answer, split.mask)))
        costs.append(c)
        matches.append(m)
        preds.append(p[:e - s])
    if not costs:
        return 0.0, 1.0, np.zeros(0, np.int64)
    # the chunk costs added in float64, in chunk order, as the JAX
    # package adds its Python floats (cost_valid feeds the best-model test)
    cost = sum(torch.stack(costs).tolist())
    err = 1.0 - int(torch.stack(matches).sum()) / max(n, 1)
    return cost, err, torch.cat(preds).cpu().numpy()


@torch.no_grad()
def _similarity_dump(analyzer, itr: int, params: Params,
                     valid: VectorizedSplit, cfg: QmannConfig,
                     dev: torch.device) -> None:
    """EN_SIMILARITY_ANALYSIS (MemN2N/MemN2N.c:1416-1475): the attention
    softmax's inputs and outputs on the first ``similarity_probe_size``
    validation samples (0: the whole split), in zero-padded chunks of at
    most 512, the pad rows sliced off before recording."""
    n_valid = len(valid)
    probe = (n_valid if cfg.similarity_probe_size == 0
             else min(cfg.similarity_probe_size, n_valid))
    chunk = min(512, probe) if probe else 0
    for s in range(0, probe, max(chunk, 1)):
        e = min(s + chunk, probe)

        def pad(x):
            return torch.from_numpy(_pad_to(x[s:e], chunk)).to(dev)

        out = memn2n.forward(params, pad(valid.memory), pad(valid.question),
                             pad(valid.mask), cfg)
        analyzer.record(itr, out.scores[:, :e - s], out.attention[:, :e - s],
                        valid.mask[s:e], sample_offset=s)


def _shard_epoch_batches(mesh, step, batches: Mapping[str, np.ndarray],
                         remove_softmax: bool = False):
    """This rank's blocks of [NB, B, ...] epoch arrays, on its device, and
    their layout (``parallel.sharding.layout``: the batch over "data", the
    memory over "model" where the step splits it); size_b whole."""
    from qmann_tpu_torch.parallel.sharding import shard_batch
    lay = step.layout(batches["question"].shape[1],
                      batches["mask"].shape[-1], remove_softmax)
    return shard_batch(mesh, batches, lay.specs(lead=(None,))), lay


def _mesh_epoch(step, params: Params, batches, lay, lr,
                remove_softmax: bool):
    """``train_epoch`` over the mesh: the sharded step on each batch's
    blocks.  Returns (params, summed cost, summed matches)."""
    costs, matches = [], []
    for i in range(batches["memory"].shape[0]):
        c, m = step.local(params, {k: v[i] for k, v in batches.items()}, lr,
                          batches["size_b"][i], lay, remove_softmax)
        costs.append(c)
        matches.append(m)
    return params, torch.stack(costs).sum(), torch.stack(matches).sum()


def train_task(cfg: QmannConfig, data: TaskData,
               params: Optional[Mapping[str, torch.Tensor]] = None,
               device="cuda", mesh=None, log=print) -> TrainResult:
    """Full training run for one task (the reference's per-task loop).

    params: initial weights (copied to ``device``, or to the mesh rank's
    device; the caller's tensors are not modified), else ``init_params``
    from ``cfg.seed``.  mesh: see the module docstring."""
    dev = resolve_device(device) if mesh is None else mesh.device
    if params is None:
        params = memn2n.init_params(cfg, data.dims,
                                    torch.Generator().manual_seed(cfg.seed),
                                    device=dev)
    params = {k: v.detach().to(dev, torch.float32).clone()
              for k, v in params.items()}

    n_train = len(data.train)
    batches_np = _batched_arrays(data.train, cfg.size_batch)
    if mesh is None:
        batches = {k: torch.from_numpy(v).to(dev)
                   for k, v in batches_np.items()}
    else:
        from qmann_tpu_torch.parallel.mesh import rank0_only
        from qmann_tpu_torch.parallel.sharding import make_sharded_train_step
        step = make_sharded_train_step(cfg, mesh)
        cut = None    # (remove_softmax, this rank's blocks, their layout)
        log = rank0_only(log, mesh)
    train_dev = None
    if cfg.en_sample_shuffled and mesh is None:
        # once-per-task upload of the unbatched sample arrays; per-epoch
        # shuffles gather them on the device (_pack_shuffled)
        train_dev = tuple(torch.from_numpy(a).to(dev) for a in (
            data.train.memory, data.train.question, data.train.answer,
            data.train.mask))

    history: List[EpochMetrics] = []
    # the dump's buckets cover the linear-start epochs too
    total_epochs = cfg.num_itr + (cfg.num_itr_linear_start
                                  if cfg.en_linear_start else 0)
    analyzer = (SimilarityAnalyzer(cfg.similarity_analysis_dir, total_epochs)
                if cfg.en_similarity_analysis
                and (mesh is None or mesh.rank == 0) else None)
    best_params = None
    err_valid_best, cost_valid_best = float("inf"), float("inf")
    ind_early_stopping = 0
    rng = np.random.default_rng(cfg.seed)

    t0 = time.time()
    for itr, lr, remove_softmax in lr_schedule(cfg):
        if train_dev is not None:
            perm = torch.from_numpy(rng.permutation(n_train)).to(dev)
            batches = {**batches, **_pack_shuffled(*train_dev, perm,
                                                   cfg.size_batch)}
        elif cfg.en_sample_shuffled:
            perm = rng.permutation(n_train)
            t = data.train
            batches_np = _batched_arrays(VectorizedSplit(
                t.memory[perm], t.question[perm], t.answer[perm],
                t.n_sen[perm], t.answer_index[perm]), cfg.size_batch)
            cut = None
        lr_t = torch.tensor(lr, dtype=torch.float32, device=dev)
        if mesh is None:
            params, cost_t, match_t = train_epoch(params, batches, lr_t, cfg,
                                                  remove_softmax)
        else:
            # linear start keeps the memory whole: cut again when the
            # layout changes
            if cut is None or cut[0] != remove_softmax:
                cut = (remove_softmax, *_shard_epoch_batches(
                    mesh, step, batches_np, remove_softmax))
            params, cost_t, match_t = _mesh_epoch(step, params, *cut[1:],
                                                  lr_t, remove_softmax)
        cost_train = float(cost_t)
        err_train = 1.0 - int(match_t) / max(n_train, 1)

        cost_valid, err_valid, _ = eval_split(params, data.valid, cfg,
                                              device=dev, mesh=mesh)
        if analyzer is not None:
            _similarity_dump(analyzer, itr, params, data.valid, cfg, dev)

        # best-model tracking
        if err_valid <= err_valid_best and cost_valid <= cost_valid_best:
            ind_early_stopping = itr
            err_valid_best = err_valid
            cost_valid_best = cost_valid
            if cfg.en_save_best_model:
                best_params = {k: v.clone() for k, v in params.items()}

        history.append(EpochMetrics(cost_train, err_train, cost_valid,
                                    err_valid, lr))
        if cfg.verbose:
            log(f"< ITR : {itr:3d} >  (train,valid,valid_best) - "
                f"loss: {cost_train:f}, {cost_valid:f}, "
                f"{cost_valid_best:f}, error: {err_train:f}, "
                f"{err_valid:f}, {err_valid_best:f}")

        # early stopping
        if (cfg.en_save_best_model
                and (itr - ind_early_stopping) > cfg.count_early_stopping
                and err_valid > err_valid_best + 0.3):
            break
    time_train = time.time() - t0

    eval_params = best_params if (cfg.en_save_best_model
                                  and best_params is not None) else params
    t0 = time.time()
    cost_test, err_test, _ = eval_split(eval_params, data.test, cfg,
                                        device=dev, mesh=mesh)
    time_test = time.time() - t0
    return TrainResult(params, best_params, history, err_test, cost_test,
                       time_train, time_test)
