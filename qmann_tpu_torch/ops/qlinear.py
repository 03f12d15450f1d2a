"""Quantized linear-algebra forwards (counterpart of ``qmann_tpu/ops/qlinear.py``).

Forward semantics (f_fixed=true): each operand is fake-quantized in its own
Q-format, each *product* is re-quantized to the first operand's format,
products are summed in float32, and the row sum is re-quantized to the
output format.  The quantized products lie on the 2^-frac grid and the
partial sums stay under 2^24 grid units, so every lattice sum here is exact
in float32 and independent of summation order.

The JAX ops decide their exact-GEMM fast paths per call with ``lax.cond``;
here the forwards always take the lattice route, and the exact GEMM is a
host-side decision made once against frozen weights
(``models.memn2n.prepare_inference``).  Both routes give the same result.

Forward only: the raw-float custom backwards come with training.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from qmann_tpu_torch.numerics import QFormat, float_quant


def _qproducts(a: torch.Tensor, b: torch.Tensor, fmt_a: QFormat,
               fmt_b: QFormat, fmt_prod: QFormat) -> torch.Tensor:
    """Per-product quantized multiply Q(Q(a, fmt_a) * Q(b, fmt_b), fmt_prod)
    on broadcast-compatible operands."""
    return float_quant(float_quant(a, fmt_a) * float_quant(b, fmt_b),
                       fmt_prod)


def exact_matmul(x: torch.Tensor, wq_t: torch.Tensor) -> torch.Tensor:
    """out = x @ wq_t in float32 (the GEMM of JAX's ``_mxu_matmul``).

    Exact under prepare_inference's bounds: integer inputs times grid
    weights, every partial sum under 2^24 grid units.  JAX runs it as one
    bf16 pass with an f32 accumulator; a bf16 ``torch.matmul`` would round
    its output back to bf16, so the port multiplies float32 operands with
    TF32 off (``qmann_tpu_torch._numerics_settings``)."""
    return torch.matmul(x.to(torch.float32), wq_t.to(torch.float32))


def qmatvec(w: torch.Tensor, x: torch.Tensor, fmt_w: QFormat,
            fmt_x: QFormat, quantized: bool = True) -> torch.Tensor:
    """out[..., o] = Q(sum_i Q(Q(w[o,i]) * Q(x[..., i])));  w [O, I],
    x [..., I] -> [..., O].  quantized=False is the plain float product
    (the float output layer, attention mode 1).  A binary weight format
    applies the XNOR-net scale sum(w)/(O*I) (raw sum, no abs)."""
    if not quantized:
        return torch.matmul(x, w.transpose(0, 1))
    prod = _qproducts(w, x[..., None, :], fmt_w, fmt_x, fmt_w)
    out = float_quant(prod.sum(-1), fmt_w)
    if fmt_w.is_binary:
        out = out * (w.sum() / float(w.shape[0] * w.shape[1]))
    return out


def qembed_mat(s: torch.Tensor, a: torch.Tensor, fmt: QFormat,
               quantized: bool = True) -> torch.Tensor:
    """Memory embedding s [..., M, I] x a [D, I] -> [..., M, D] with one
    Q-format for both operands, each product and the output."""
    if not quantized:
        return torch.matmul(s, a.transpose(0, 1))
    prod = _qproducts(s[..., :, None, :], a, fmt, fmt, fmt)   # [..., M, D, I]
    return float_quant(prod.sum(-1), fmt)


def qembed_mat_multi(s: torch.Tensor, weights: Sequence[torch.Tensor],
                     fmts: Sequence[QFormat],
                     quantized: bool = True) -> Tuple[torch.Tensor, ...]:
    """K qembed_mat calls sharing one input, one per (weight, fmt) pair.
    The stacked exact GEMM that JAX takes when its bounds hold is the
    serving route of ``models.memn2n.forward_prepared``."""
    assert len(weights) == len(fmts)
    return tuple(qembed_mat(s, w, f, quantized) for w, f in zip(weights, fmts))


def qscore(m: torch.Tensor, u: torch.Tensor, fmt_m: QFormat, fmt_u: QFormat,
           quantized: bool = True) -> torch.Tensor:
    """Attention score m [..., M, D] x u [..., D] -> [..., M]: per-product
    requant to fmt_m, row-sum requant to fmt_m (mode 2); the float dot
    product when quantized=False (mode 1).  Only score_mod="none"."""
    if not quantized:
        return torch.einsum("...md,...d->...m", m, u)
    prod = _qproducts(m, u[..., None, :], fmt_m, fmt_u, fmt_m)
    return float_quant(prod.sum(-1), fmt_m)


def qweighted_sum(c: torch.Tensor, p: torch.Tensor, row_mask: torch.Tensor,
                  fmt: QFormat, quantized: bool = True) -> torch.Tensor:
    """Weighted memory sum c [..., M, D] x p [..., M] -> [..., D].  row_mask
    [..., M] (1 live / 0 padded) zeroes padded rows after the per-product
    quantization (the binary format maps 0 to +1)."""
    if not quantized:
        return torch.einsum("...md,...m->...d", c, p * row_mask)
    prod = _qproducts(p[..., :, None], c, fmt, fmt, fmt)
    prod = prod * row_mask[..., :, None]
    return float_quant(prod.sum(-2), fmt)
