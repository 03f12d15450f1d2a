"""Element-wise forwards (counterpart of ``qmann_tpu/ops/elementwise.py``):
the hop residual sum and the NULL/RELU activation."""
from __future__ import annotations

from typing import Optional

import torch

from qmann_tpu_torch.numerics import QFormat, float_quant


def qsum(a: torch.Tensor, b: torch.Tensor, fmt: QFormat,
         quantized: bool = True) -> torch.Tensor:
    """sum_vec forward: Q(Q(a)+Q(b)) when fixed, a+b otherwise."""
    if not quantized:
        return a + b
    return float_quant(float_quant(a, fmt) + float_quant(b, fmt), fmt)


def activation(x: torch.Tensor, kind: str, fmt: Optional[QFormat],
               quantized: bool = False) -> torch.Tensor:
    """'NULL' (bypass) or 'RELU'; when quantized the output is requantized
    (the bypass quantizes too).  SIGMOID is not ported yet."""
    if kind == "RELU":
        out = torch.clamp_min(x, 0.0)
    elif kind == "NULL":
        out = x
    else:
        raise NotImplementedError(
            f"activation {kind!r} is not ported yet (ROADMAP.md, Queue 1)")
    if quantized and fmt is not None:
        out = float_quant(out, fmt)
    return out
