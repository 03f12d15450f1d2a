"""Element-wise ops with the reference's backwards (counterpart of
``qmann_tpu/ops/elementwise.py``): the hop residual sum, the
NULL/SIGMOID/RELU activation, the learnable scale (EN_SC_ATT), the
element-wise multiply and maxout."""
from __future__ import annotations

from typing import Optional

import torch

from qmann_tpu_torch.numerics import QFormat, float_quant


class _QSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, fmt, quantized):
        if not quantized:
            return a + b
        return float_quant(float_quant(a, fmt) + float_quant(b, fmt), fmt)

    @staticmethod
    def backward(ctx, g):
        # sum_vec_bwd passes the gradient to both inputs unchanged
        return g, g, None, None


def qsum(a: torch.Tensor, b: torch.Tensor, fmt: QFormat,
         quantized: bool = True) -> torch.Tensor:
    """sum_vec: Q(Q(a)+Q(b)) when fixed, a+b otherwise; the backward
    passes the gradient through to both inputs."""
    return _QSum.apply(a, b, fmt, quantized)


def _activation_forward(x: torch.Tensor, kind: str, fmt: Optional[QFormat],
                        quantized: bool) -> torch.Tensor:
    if kind == "SIGMOID":
        out = torch.sigmoid(x)
    elif kind == "RELU":
        out = torch.clamp_min(x, 0.0)
    elif kind == "NULL":
        out = x
    else:
        raise ValueError(f"unknown activation {kind!r}")
    if quantized and fmt is not None:
        out = float_quant(out, fmt)   # the bypass quantizes too
    return out


class _Activation(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kind, fmt, quantized, grad_quantized):
        out = _activation_forward(x, kind, fmt, quantized)
        ctx.save_for_backward(out)
        ctx.kind, ctx.fmt, ctx.grad_quantized = kind, fmt, grad_quantized
        return out

    @staticmethod
    def backward(ctx, g):
        (out,) = ctx.saved_tensors
        kind, fmt = ctx.kind, ctx.fmt
        # the derivative is taken on the OUTPUT
        if kind == "SIGMOID":
            dg = g * out * (1.0 - out)
        elif kind == "RELU":
            dg = torch.where(out > 0.0, g, 0.0)
        else:
            dg = g
        if ctx.grad_quantized and fmt is not None and kind != "NULL":
            dg = float_quant(dg, fmt)
        return dg, None, None, None, None


def activation(x: torch.Tensor, kind: str, fmt: Optional[QFormat],
               quantized: bool = False,
               grad_quantized: bool = False) -> torch.Tensor:
    """'NULL' (bypass), 'SIGMOID' or 'RELU'; when quantized the output is
    requantized (the bypass quantizes too).  The backward derivative is
    quantized only under grad_quantized (EN_GRAD_QUANT): without it the
    derivative stays float even in a fixed-point run."""
    return _Activation.apply(x, kind, fmt, quantized, grad_quantized)


def scale_apply(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """out = w * x with a scalar w, or a family's per-run scale w [R]
    against x [R, ...].  Plain autograd gives the reference's backward:
    dw = sum(g * x), dx = w * g.  The scale's SGD divisor (batch size times
    the score length) is ``train.optim``'s."""
    if w.dim() == 1:
        return w.reshape((-1,) + (1,) * (x.dim() - 1)) * x
    return w * x


class _QMult(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, fmt, quantized):
        ctx.save_for_backward(a, b)
        if not quantized:
            return a * b
        return float_quant(float_quant(a, fmt) * float_quant(b, fmt), fmt)

    @staticmethod
    def backward(ctx, g):
        # float cross-gradients on the raw inputs
        a, b = ctx.saved_tensors
        return g * b, g * a, None, None


def qmult(a: torch.Tensor, b: torch.Tensor, fmt: QFormat,
          quantized: bool = True) -> torch.Tensor:
    """Element-wise multiply: Q(Q(a) * Q(b)) when fixed, a * b otherwise;
    the backward is the float g * b, g * a on the raw inputs."""
    return _QMult.apply(a, b, fmt, quantized)


def maxout(x: torch.Tensor, num_pieces: int) -> torch.Tensor:
    """Maxout over groups of num_pieces consecutive features: [...,
    K * num_pieces] -> [..., K].  ``amax`` splits the gradient evenly
    between tied maxima, as JAX's max does."""
    *lead, d = x.shape
    if d % num_pieces:
        raise ValueError("the feature dim must be divisible by num_pieces")
    return x.reshape(*lead, d // num_pieces, num_pieces).amax(-1)
