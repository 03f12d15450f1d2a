"""Masked softmax (counterpart of ``qmann_tpu/ops/softmax.py``).

Only the plain exp variant is ported: max-subtracted exp with sum
normalization, with padded memory rows masked before max/exp so that they
get exactly zero probability.  The shift-based, exp_plan and exp2 variants
and the linear-start bypass are not ported yet (see ROADMAP.md).
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


def softmax(x: torch.Tensor, mask: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """Masked softmax (exp variant); mask is boolean [..., M]."""
    e, total = _masked_exp_parts(x, mask)
    return e / total
