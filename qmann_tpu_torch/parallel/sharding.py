"""Sharding rules and the sharded steps (counterpart of
``qmann_tpu/parallel/sharding.py``).

The JAX package annotates shardings and lets XLA derive the collectives.
PyTorch has no such partitioner, so each step here is one local step per
rank, over its (data, model) shard, with every collective written out:

  batch tensors [B, ...]   -> split over "data" when B divides it
  memory [B, M, I], mask   -> split over "model" when M divides it and the
        wiring is one the distributed read covers (``reads_split_memory``):
        each hop's read is then ``distributed._attention_read_local``;
        otherwise M stays whole and the rank runs the port's own
        ``loss_and_metrics`` / ``forward`` on its batch shard (the lattice
        and read kernels under ``use_pallas``)
  parameters               -> whole on every rank (W too: JAX's vocab split
        of W is a placement XLA chose, which at bAbI's vocabularies would
        save kilobytes and cost two collectives a step; the numbers are the
        same)

``param_shardings``, ``batch_shardings`` and ``infer_specs`` return JAX's
PartitionSpecs as tuples of axis names (or None); ``shard_batch`` and
``put_infer_inputs`` cut this rank's block of global arrays by such
specs, and ``shard_params`` / ``shard_prepared`` place whole copies.

The training step differentiates the rank's loss divided by the number of
ranks whose loss is a copy of it (``Layout.copies``: the "model" axis, and
the "data" axis too when B does not divide it), then sums the gradients
over every rank: the transpose of ``vary`` applied to every parameter at
its entry into the loss (``qmann_tpu/parallel/explicit.py``), done as one
all_reduce of the stacked gradients.  ``sgd_update`` and
``zero_null_columns`` then run on every rank on equal inputs, so the
parameters stay bit-identical without a broadcast.  Cost, matches and
predictions come back summed (or gathered) over "data".
"""
from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from qmann_tpu_torch.config import QmannConfig
from qmann_tpu_torch.models import memn2n
from qmann_tpu_torch.ops.losses import argmax_last, cross_entropy
from qmann_tpu_torch.parallel.distributed import (all_reduce,
                                                  memory_sharded_logits)
from qmann_tpu_torch.parallel.mesh import AXES, DATA_AXIS, MODEL_AXIS, Mesh
from qmann_tpu_torch.train.optim import sgd_update, zero_null_columns

Params = Dict[str, torch.Tensor]
Spec = Tuple[Optional[str], ...]


def axis_if_divisible(mesh: Mesh, axis_name: str, dim: int):
    """Shard a dimension over a mesh axis only when it divides evenly;
    otherwise keep the dimension whole (qa1's 30-word vocabulary does not
    divide every mesh)."""
    return axis_name if dim % mesh.shape[axis_name] == 0 else None


def param_shardings(mesh: Mesh, params: Mapping) -> Dict[str, Spec]:
    """JAX's parameter specs: W's rows over "model" where they divide,
    everything else whole.  The port keeps W whole (module docstring)."""
    specs = {}
    for name, v in params.items():
        if name == "W":
            specs[name] = (axis_if_divisible(mesh, MODEL_AXIS, v.shape[0]),
                           None)
        else:
            specs[name] = (None,) * v.ndim
    return specs


def infer_specs(mesh: Mesh, batch: int, n_rows: int) -> Dict[str, Spec]:
    """Specs for inputs of ``batch`` queries over ``n_rows`` memory rows:
    the batch over "data", the rows over "model", an axis that does not
    divide kept whole."""
    b = axis_if_divisible(mesh, DATA_AXIS, batch)
    m = axis_if_divisible(mesh, MODEL_AXIS, n_rows)
    return {"memory": (b, m, None), "question": (b, None),
            "answer": (b, None), "mask": (b, m)}


def batch_shardings(mesh: Mesh, batch: Mapping) -> Dict[str, Spec]:
    """Specs for a training batch's [B, ...] tensors."""
    specs = infer_specs(mesh, batch["question"].shape[0],
                        batch["mask"].shape[-1])
    return {**specs, "sample_mask": specs["question"][:1]}


def reads_split_memory(cfg: QmannConfig) -> bool:
    """Whether the distributed read covers the config's hop: the plain
    softmax read, no feature head, softmax variant or EN_GRAD_QUANT (the
    wiring of ``qmann_tpu/parallel/explicit.py``)."""
    return not (cfg.en_sc_att or cfg.test_maxout or cfg.en_cosine_sim
                or cfg.en_shift_based_sm or cfg.en_exp_table_based
                or cfg.en_grad_quant)


class Layout(NamedTuple):
    """How a step cuts a global batch on this mesh."""
    batch_split: bool       # B over "data"
    memory_split: bool      # M over "model": the distributed read
    memory_rows: int        # M, global
    copies: int             # ranks whose loss is a copy of this rank's

    def specs(self, lead: Spec = ()) -> Dict[str, Spec]:
        b = DATA_AXIS if self.batch_split else None
        m = MODEL_AXIS if self.memory_split else None
        return {"memory": lead + (b, m, None), "question": lead + (b, None),
                "answer": lead + (b, None), "mask": lead + (b, m),
                "sample_mask": lead + (b,)}


def layout(cfg: QmannConfig, mesh: Mesh, batch: int, n_rows: int,
           remove_softmax: bool = False,
           memory_split: Optional[bool] = None) -> Layout:
    """The layout of ``infer_specs``, with the memory kept whole where the
    distributed read does not cover the config (or linear start, which
    has no softmax).  memory_split=True insists on the split (the explicit
    step) and raises where it cannot be made."""
    specs = infer_specs(mesh, batch, n_rows)
    b = specs["question"][0] is not None and mesh.data > 1
    divides = specs["mask"][1] is not None
    if memory_split:
        if not divides:
            raise ValueError(f"{n_rows} memory rows do not split over a "
                             f"model axis of {mesh.model}")
        if remove_softmax:
            raise NotImplementedError("the memory-sharded read has a "
                                      "softmax: linear start keeps the "
                                      "memory whole")
        m = True
    else:
        m = (divides and mesh.model > 1 and reads_split_memory(cfg)
             and not remove_softmax)
    return Layout(b, m, n_rows, mesh.model * (1 if b else mesh.data))


def _block(mesh: Mesh, x, spec: Spec):
    """This rank's block of x (numpy array or tensor) under spec."""
    for dim, axis in enumerate(spec):
        if axis is None or mesh.shape[axis] == 1:
            continue
        n = x.shape[dim] // mesh.shape[axis]
        k = mesh.index(axis)
        x = x[(slice(None),) * dim + (slice(k * n, (k + 1) * n),)]
    return x


def _on_device(mesh: Mesh, x) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return torch.as_tensor(x).to(mesh.device)


def put_infer_inputs(mesh: Mesh, specs: Mapping[str, Spec], **arrays):
    """This rank's blocks of named global arrays, on its device."""
    return {k: _on_device(mesh, _block(mesh, v, specs[k]))
            for k, v in arrays.items()}


def shard_batch(mesh: Mesh, batch: Mapping,
                specs: Optional[Mapping[str, Spec]] = None):
    """This rank's blocks of a global batch (``batch_shardings`` unless
    specs are given), on its device; other entries whole."""
    specs = batch_shardings(mesh, batch) if specs is None else specs
    return {k: _on_device(mesh, _block(mesh, v, specs[k]) if k in specs
                          else v) for k, v in batch.items()}


def shard_params(mesh: Mesh, params: Mapping) -> Params:
    """A float32 copy of every parameter on this rank's device."""
    return {k: torch.as_tensor(v, dtype=torch.float32).to(mesh.device)
            .clone() for k, v in params.items()}


def shard_prepared(mesh: Mesh, prep: memn2n.PreparedInference):
    """A PreparedInference on this rank's device, every tensor whole (the
    serving weights are ~100 KB at the reference's dims)."""
    def put(v):
        return None if v is None else v.to(mesh.device)

    return memn2n.PreparedInference(
        {k: put(v) for k, v in prep.raw.items()}, prep.fast,
        *(put(getattr(prep, f)) for f in ("query_wt", "embed_wt", "hmats",
                                          "hmats_q")))


def _sum_over_data(mesh: Mesh, lay: Layout, cost, matches):
    """The batch's cost and matches: this rank's, summed over "data" when
    the batch is split there."""
    if not lay.batch_split:
        return cost, matches
    both = all_reduce(torch.stack([cost.to(torch.float32),
                                   matches.to(torch.float32)]),
                      mesh.group(DATA_AXIS))
    return both[0], both[1].to(torch.int32)


def _gather_batch(mesh: Mesh, lay: Layout, x: torch.Tensor, batch: int):
    """The global [batch, ...] tensor from this rank's rows: each rank
    writes its block into zeros and the blocks are summed over "data"
    (gloo takes CUDA tensors in all_reduce, not in gathers)."""
    if not lay.batch_split:
        return x
    n = x.shape[0]
    buf = x.new_zeros((batch,) + tuple(x.shape[1:]))
    buf[mesh.data_idx * n:(mesh.data_idx + 1) * n] = x
    return all_reduce(buf, mesh.group(DATA_AXIS))


def _local_logits(model, lb, cfg: QmannConfig, mesh: Mesh, lay: Layout,
                  remove_softmax: bool = False) -> torch.Tensor:
    """The logits of this rank's batch block; ``model`` is a parameter
    dict or a PreparedInference."""
    if lay.memory_split:
        return memory_sharded_logits(model, lb["memory"], lb["question"],
                                     lb["mask"], cfg, mesh)
    if isinstance(model, memn2n.PreparedInference):
        return memn2n.forward_prepared(model, lb["memory"], lb["question"],
                                       lb["mask"], cfg).logits
    return memn2n.forward(model, lb["memory"], lb["question"], lb["mask"],
                          cfg, remove_softmax).logits


class ShardedTrainStep:
    """One SGD step over the mesh: ``step(params, batch, lr, size_b,
    remove_softmax=False) -> (params, cost, matches)`` with the global
    batch on every rank (numpy arrays or tensors; the rank cuts its block),
    params whole on this rank's device and updated in place, cost and
    matches of the whole batch.  ``local`` takes a batch already cut by
    ``layout(...).specs()`` (the trainer's epochs)."""

    def __init__(self, cfg: QmannConfig, mesh: Mesh,
                 memory_split: Optional[bool] = None):
        # the integer fast path is off in training, as train_step has it
        self.cfg = cfg.replace(en_integer_fast_path=False)
        self.mesh = mesh
        self.memory_split = memory_split

    def layout(self, batch: int, n_rows: int,
               remove_softmax: bool = False) -> Layout:
        return layout(self.cfg, self.mesh, batch, n_rows, remove_softmax,
                      self.memory_split)

    def __call__(self, params: Params, batch: Mapping, lr, size_b,
                 remove_softmax: bool = False):
        lay = self.layout(batch["question"].shape[0],
                          batch["mask"].shape[-1], remove_softmax)
        local = shard_batch(self.mesh, {k: batch[k] for k in lay.specs()},
                            lay.specs())
        cost, matches = self.local(params, local, lr, size_b, lay,
                                   remove_softmax)
        return params, cost, matches

    def local(self, params: Params, lb: Mapping[str, torch.Tensor], lr,
              size_b, lay: Layout, remove_softmax: bool = False):
        cfg, mesh = self.cfg, self.mesh
        dev = mesh.device
        names = list(params)
        leaves = [params[k].requires_grad_() for k in names]
        try:
            logits = _local_logits(params, lb, cfg, mesh, lay,
                                   remove_softmax)
            loss, met = memn2n.loss_from_logits(logits, lb["answer"],
                                                lb["sample_mask"])
            grads = torch.autograd.grad(loss / lay.copies, leaves,
                                        allow_unused=True)
        finally:
            for t in leaves:
                t.requires_grad_(False)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(leaves, grads)]
        flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]),
                          mesh.group(AXES))
        grads = dict(zip(names, torch.split(flat, [g.numel()
                                                   for g in grads])))
        grads = {k: g.view_as(params[k]) for k, g in grads.items()}
        # EN_SC_ATT's divisor takes the global memory length
        sgd_update(params, grads,
                   torch.as_tensor(lr, dtype=torch.float32, device=dev),
                   torch.as_tensor(size_b, dtype=torch.float32, device=dev),
                   cfg, scale_dim=lay.memory_rows)
        zero_null_columns(params, cfg)
        return _sum_over_data(mesh, lay, met.cost.detach(), met.matches)


def make_sharded_train_step(cfg: QmannConfig, mesh: Mesh) -> ShardedTrainStep:
    """The sharded SGD step (``ShardedTrainStep``): the memory split over
    "model" where the distributed read covers the config and M divides,
    else whole."""
    return ShardedTrainStep(cfg, mesh)


def _forward_blocks(model, cfg: QmannConfig, mesh: Mesh, **arrays):
    """(layout, this rank's blocks of the global arrays, their logits)."""
    lay = layout(cfg, mesh, arrays["question"].shape[0],
                 arrays["mask"].shape[-1])
    lb = put_infer_inputs(mesh, lay.specs(), **arrays)
    return lay, lb, _local_logits(model, lb, cfg, mesh, lay)


@torch.no_grad()
def sharded_evaluate(model, memory, question, answer, mask,
                     cfg: QmannConfig, mesh: Mesh):
    """Forward over global inputs on the mesh: (cost, matches, pred) of the
    whole batch, on every rank.  ``model``: parameters or a
    PreparedInference, whole on this rank's device."""
    lay, lb, logits = _forward_blocks(model, cfg, mesh, memory=memory,
                                      question=question, answer=answer,
                                      mask=mask)
    met = cross_entropy(logits, lb["answer"])
    cost, matches = _sum_over_data(mesh, lay, met.cost, met.matches)
    return cost, matches, _gather_batch(mesh, lay, met.pred,
                                        question.shape[0])


@torch.no_grad()
def sharded_predict(model, memory, question, mask, cfg: QmannConfig,
                    mesh: Mesh) -> torch.Tensor:
    """The predictions of ``sharded_evaluate`` without answers."""
    lay, _, logits = _forward_blocks(model, cfg, mesh, memory=memory,
                                     question=question, mask=mask)
    return _gather_batch(mesh, lay, argmax_last(logits, dim=-1),
                         question.shape[0])


def make_sharded_eval_step(cfg: QmannConfig, mesh: Mesh):
    """eval_step(params, memory, question, answer, mask) -> (cost,
    matches) of the whole batch."""
    def eval_step(params, memory, question, answer, mask):
        return sharded_evaluate(params, memory, question, answer, mask, cfg,
                                mesh)[:2]

    return eval_step


def serving_config(cfg: QmannConfig) -> QmannConfig:
    """A mesh pins the plain prepared forward, as JAX's does: the chain
    and the read kernel run a whole softmax row on one device."""
    return cfg.replace(use_fused_chain=False, use_pallas=False,
                       use_pallas_hamming=False)


def make_sharded_prepared_infer(prep: memn2n.PreparedInference,
                                cfg: QmannConfig, mesh: Mesh):
    """The mesh-aware serving forward on the prepared weights: the batch
    over "data", the memory over "model", the weights whole; the plain
    prepared forward pinned (``serving_config``).  Returns run(memory,
    question, answer, mask) -> (cost, matches, pred) of the whole batch,
    equal to the single-device prepared forward's."""
    cfg = serving_config(cfg)
    sprep = shard_prepared(mesh, prep)

    def run(memory, question, answer, mask):
        return sharded_evaluate(sprep, memory, question, answer, mask, cfg,
                                mesh)

    return run
