"""Masked softmax variants (counterpart of ``qmann_tpu/ops/softmax.py``).

Padded memory rows are masked before the max and the exp, so they get
exactly zero probability.  The variants:

  * exp (default): exp(x - max) / sum;
  * shift-based: exp(x - max) / round(log2(sum)) (half to even, 0 -> 1),
    with the reference's 0.7-scaled backward;
  * exp_plan: the piecewise-linear exp max_i(w_i x + b_i) over four
    segments, normalized by the sum;
  * exp2: 2^(x - max) / sum;
  * remove (linear start): no softmax; the scores pass through with the
    padded rows zeroed.

The exp variant's backward is the reference's p*(g - sum(p*g)), written
out; the shift-based one is 0.7 times it; exp_plan and exp2 are
differentiated as compositions, as JAX does.  Every variant gives a row
with no live entry (a padded sample of the last partial batch)
probability 0 and a zero gradient, never NaN.  JAX's exp_plan_softmax and
exp2_softmax lack that guard and give NaN there (ROADMAP.md, Queue 3);
the port keeps the guard its exp and shift-based variants share.
"""
from __future__ import annotations

from typing import Optional

import torch

_NEG_LARGE = -1e30


def _masked_exp_parts(x: torch.Tensor, mask: Optional[torch.Tensor],
                      exp_fn=torch.exp):
    """(exp_fn(x - max) masked, its sum over the last axis); a fully
    masked row's sum is taken as 1, so that row gets probability 0."""
    if mask is not None:
        x = torch.where(mask, x, _NEG_LARGE)
    m = x.amax(-1, keepdim=True)
    e = exp_fn(x - m)
    if mask is not None:
        e = torch.where(mask, e, 0.0)
    total = e.sum(-1, keepdim=True)
    if mask is not None:
        # fully masked rows would divide 0/0: give them probability 0
        total = torch.where(total == 0.0, 1.0, total)
    return e, total


def masked_softmax(x: torch.Tensor, mask: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """The forward without autograd; mask is boolean [..., M]."""
    e, total = _masked_exp_parts(x, mask)
    return e / total


def softmax_backward(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """p * (g - sum(p * g)) over the last axis."""
    return p * (g - (p * g).sum(-1, keepdim=True))


class _MaskedSoftmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mask):
        p = masked_softmax(x, mask)
        ctx.save_for_backward(p)
        return p

    @staticmethod
    def backward(ctx, g):
        (p,) = ctx.saved_tensors
        return softmax_backward(p, g), None


def softmax(x: torch.Tensor, mask: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """Masked softmax (exp variant); mask is boolean [..., M]."""
    return _MaskedSoftmax.apply(x, mask)


def shift_softmax_forward(x: torch.Tensor,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """exp(x - max) over round(log2(sum)), half to even; a divisor of 0
    (a total of at most sqrt(2), or a fully masked row) becomes 1."""
    e, total = _masked_exp_parts(x, mask)
    divisor = torch.round(torch.log2(total))
    return e / torch.where(divisor == 0.0, 1.0, divisor)


class _ShiftSoftmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mask):
        out = shift_softmax_forward(x, mask)
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, g):
        (out,) = ctx.saved_tensors
        s = (out * g).sum(-1, keepdim=True)
        return 0.7 * out * (g - s), None


def shift_softmax(x: torch.Tensor, mask: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """The shift-based softmax, with the reference's backward
    0.7 * out * (g - sum(out * g))."""
    return _ShiftSoftmax.apply(x, mask)


# the piecewise-linear exp's segments (w_i, b_i)
_EXP_PLAN_W = (0.597226, 0.141642, 0.070265, 0.0)
_EXP_PLAN_B = (0.933989, 0.43981, 0.10888, 0.0)


def exp_plan(x: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear approximation of exp: max over the segments
    w_i * x + b_i."""
    out = _EXP_PLAN_W[0] * x + _EXP_PLAN_B[0]
    for w, b in zip(_EXP_PLAN_W[1:], _EXP_PLAN_B[1:]):
        out = torch.maximum(out, w * x + b)
    return out


def exp_plan_softmax(x: torch.Tensor, mask: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """The softmax with the piecewise-linear exp."""
    e, total = _masked_exp_parts(x, mask, exp_plan)
    return e / total


def exp2_softmax(x: torch.Tensor, mask: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """2^(x - max) over its sum."""
    e, total = _masked_exp_parts(x, mask, torch.exp2)
    return e / total


def apply_softmax(x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                  shift_based: bool = False, use_exp_plan: bool = False,
                  remove: bool = False) -> torch.Tensor:
    """The softmax dispatch.  remove=True is linear start: no softmax, the
    scores pass through with the padded rows zeroed."""
    if remove:
        return torch.where(mask, x, 0.0) if mask is not None else x
    if use_exp_plan:
        return exp_plan_softmax(x, mask)
    if shift_based:
        return shift_softmax(x, mask)
    return softmax(x, mask)
