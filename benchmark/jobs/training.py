"""What the two training jobs share: the first three steps recorded in
set-up, the reference's three steps, the numbers compared, and the
per-epoch accounting of the window.

The program's first three steps are the window's own call (``train_epoch``
or ``multi_epoch``) on the window's own buffers, in the set-up's first
epoch: a ``StepRecorder`` in the place of the run's ``Graphs`` keeps the
parameters and the step's cost after each of them.  The reference starts
from the same weights (the harness drew them) and takes the same three
batches of the harness's stories.

The numbers, each the worst over what it covers:

* ``loss_gap``: over the three steps, |cost - reference cost| /
  |reference cost|, the cost summed over the batch (and a family's runs);
* ``grad_gap``: over the weights, the gap between the norms of the first
  gradient as the optimizer took it, worked out from the state after step
  1 as (w0 - w1) * live samples / step size, against the reference's
  norm or the median weight's, whichever is larger;
* ``change_gap``: the same of w3 - w0, the change after three steps.

Differences and norms are taken in float64, so that they add no rounding
of their own.

A weight whose reference gradient is below a thousandth of the median
weight's leaves both out.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple

import torch

from benchmark.reference import Reference

FIRST_STEPS = 3
SPAN_EPOCH = "bench.train_epoch"
SPAN_VALID = "bench.validate"
SPAN_READ = "bench.host_read"


class Steps(NamedTuple):
    costs: List[torch.Tensor]      # per step, [R]
    after: List[Dict[str, torch.Tensor]]   # parameters after each step


class StepRecorder:
    """The run's ``Graphs`` with a hook after each training step's call:
    it keeps the stacked parameters and the step's cost row for the first
    ``FIRST_STEPS`` steps."""

    def __init__(self, graphs, params: Dict[str, torch.Tensor], costs_of,
                 step_key: str):
        self.graphs, self.params = graphs, params
        self.costs_of, self.step_key = costs_of, step_key
        self.steps = Steps([], [])

    def static(self, *args, **kw):
        return self.graphs.static(*args, **kw)

    def __call__(self, key, body, *inputs, bound=()):
        out = self.graphs(key, body, *inputs, bound=bound)
        k = len(self.steps.costs)
        if key[0] == self.step_key and k < FIRST_STEPS:
            self.steps.costs.append(self.costs_of()[k].clone().reshape(-1))
            self.steps.after.append({n: v.clone()
                                     for n, v in self.params.items()})
        return out


def _opt_grad(w0, w1, size_b, lr, name, model):
    """(w0 - w1) * live samples / step size: the clipped gradient the
    SGD step applied, in float64 (the difference of two float32 states is
    exact there)."""
    lr_eff = lr * 0.1 if (name == "H" and model["type_weight_tying"] == 2) \
        else lr
    n = torch.clamp_min(size_b, 1.0).reshape(-1, 1, 1).double()
    return (w0.double() - w1.double()) * n / lr_eff


def _norm_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
               keep) -> float:
    norms_r = {k: float(torch.linalg.vector_norm(v.double()))
               for k, v in ref.items()}
    norms_p = {k: float(torch.linalg.vector_norm(prog[k].double()))
               for k in ref}
    med = sorted(norms_r.values())[len(norms_r) // 2]
    return max(abs(norms_p[k] - norms_r[k]) / max(norms_r[k], med)
               for k in keep)


def numbers(prog: Steps, ref: Steps, init: Dict[str, torch.Tensor],
            size_b: torch.Tensor, lr: float, model: dict) -> dict:
    """The three numbers of ``prog``'s first steps against ``ref``'s."""
    loss = max(abs(float(p.double().sum()) - float(r.double().sum()))
               / abs(float(r.double().sum()))
               for p, r in zip(prog.costs, ref.costs))
    g_p = {k: _opt_grad(init[k], prog.after[0][k], size_b, lr, k, model)
           for k in init}
    g_r = {k: _opt_grad(init[k], ref.after[0][k], size_b, lr, k, model)
           for k in init}
    gn = {k: float(torch.linalg.vector_norm(v)) for k, v in g_r.items()}
    med = sorted(gn.values())[len(gn) // 2]
    keep = [k for k in init if gn[k] >= 1e-3 * med]
    d_p = {k: prog.after[-1][k].double() - init[k].double() for k in init}
    d_r = {k: ref.after[-1][k].double() - init[k].double() for k in init}
    return {"loss_gap": loss, "grad_gap": _norm_gaps(g_p, g_r, keep),
            "change_gap": _norm_gaps(d_p, d_r, keep)}


def reference_steps(model: dict, init: Dict[str, torch.Tensor], batches,
                    lr: float, control: bool = False,
                    fault=None) -> Steps:
    """The reference's first steps from ``init`` (stacked [R, ...]) over
    ``batches`` (a list of dicts of [R, B, ...] tensors)."""
    ref = Reference(model, control=control)
    p = {k: v.clone() for k, v in init.items()}
    steps = Steps([], [])
    for batch in batches:
        steps.costs.append(ref.sgd_step(p, batch, lr, fault))
        steps.after.append({k: v.clone() for k, v in p.items()})
    return steps
