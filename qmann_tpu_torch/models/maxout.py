"""Maxout attention (counterpart of ``qmann_tpu/models/maxout.py``): the
reference's experimental trial replaces the attention softmax with a
learned scalar maxout unit on each score (1 input, 5 pieces, 1 output),
normalized by the plain sum of its outputs over the live rows."""
from __future__ import annotations

from typing import Tuple

import torch


def maxout_unit(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Scalar maxout over pieces: max_k(w_k * x + b_k); x [...], w and b
    [pieces].  ``amax`` splits the gradient between tied pieces, as JAX's
    max does."""
    return (x[..., None] * w + b).amax(-1)


def maxout_attention(scores: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """The maxout of each score over the sum of the live rows' maxouts;
    padded rows get 0, and a row whose sum is 0 keeps its values over 1."""
    a = torch.where(mask, maxout_unit(scores, w, b), 0.0)
    total = a.sum(-1, keepdim=True)
    return a / torch.where(total == 0.0, 1.0, total)


def init_maxout_params(generator: torch.Generator, pieces: int = 5
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gaussian(0, 0.1) (w, b) of ``pieces`` each, drawn from a CPU
    generator, like every other weight."""
    return tuple(0.1 * torch.randn((pieces,), generator=generator,
                                   dtype=torch.float32) for _ in range(2))
