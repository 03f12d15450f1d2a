"""Masked softmax (counterpart of ``qmann_tpu/ops/softmax.py``).

Only the plain exp variant is ported: max-subtracted exp with sum
normalization, with padded memory rows masked before max/exp so that they
get exactly zero probability.  The shift-based, exp_plan and exp2 variants
and the linear-start bypass are not ported yet (see ROADMAP.md).

The backward is the reference's p*(g - sum(p*g)) (_cuda_softmax_bwd),
written out: padded entries have p == 0, so a row with no live entry (a
padded sample of the last partial batch) gets p = 0 and a zero gradient,
never NaN.  JAX differentiates its composition instead; the two agree to
float32 rounding.
"""
from __future__ import annotations

from typing import Optional

import torch

_NEG_LARGE = -1e30


def _masked_exp_parts(x: torch.Tensor, mask: Optional[torch.Tensor]):
    if mask is not None:
        x = torch.where(mask, x, _NEG_LARGE)
    m = x.amax(-1, keepdim=True)
    e = torch.exp(x - m)
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
