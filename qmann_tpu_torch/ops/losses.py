"""Cross-entropy metrics and the ties-to-last argmax (counterpart of
``qmann_tpu/ops/losses.py``; forward only).

The reference's prediction is the argmax with ties going to the LAST
maximal index.  ``torch.argmax`` returns the first maximal index, so
``argmax_last`` flips the axis first.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class CEMetrics(NamedTuple):
    loss: torch.Tensor      # scalar: standard CE summed over batch
    cost: torch.Tensor      # scalar: reference-style sum of -p[y]
    matches: torch.Tensor   # scalar int32: number of correct predictions
    pred: torch.Tensor      # [...]: predicted class indices


def argmax_last(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Argmax with ties going to the last maximal index."""
    n = x.shape[dim]
    return n - 1 - torch.argmax(torch.flip(x, dims=(dim,)), dim=dim)


def cross_entropy(logits: torch.Tensor, y_onehot: torch.Tensor) -> CEMetrics:
    """logits, y_onehot: [..., K]."""
    logp = torch.log_softmax(logits, dim=-1)
    loss = -(y_onehot * logp).sum()
    cost = -(y_onehot * torch.exp(logp)).sum()
    pred = argmax_last(logits.detach(), dim=-1)
    hit = torch.gather(y_onehot, -1, pred[..., None])[..., 0]
    matches = (hit == 1.0).sum().to(torch.int32)
    return CEMetrics(loss=loss, cost=cost, matches=matches, pred=pred)
