"""The weighted sum's quantized backward: a hand-written CUDA kernel for
Hopper and its plain PyTorch version.

No Pallas kernel stands behind it: the JAX package computes the quantized
branch of ``_qweighted_sum_bwd`` (``qmann_tpu/ops/qlinear.py``) as plain
jnp, which XLA fuses under ``jit``.  The kernel is the port of that
fusion, so that a step on the kernel route runs one launch per hop for
this backward instead of some 80 eager ops.  Fixed-point attention mode 3
always takes it (``QmannConfig.wsum_grad_quantized``), EN_GRAD_QUANT's
backward placement in the other modes.  Three backwards call it on the
kernel route: ``ops.fused._FusedAttentionRead`` (the read, ``use_pallas``),
``ops.qlinear._QWeightedSum`` (the unfused weighted sum,
``use_pallas_hamming`` and EN_GRAD_QUANT's unfused chain) and, through
it, the mesh's shard-local ``qweighted_partial_sum``.

The kernel source is ``qmann_tpu_torch/csrc/qweighted_sum_bwd.cu`` (the
quantizers from ``csrc/qformat.cuh``).  Built with nvcc at first use
(``ops/cuda/_build.py``) and bound with ctypes.

``qweighted_sum_backward_kernel`` dispatches on the device of ``c``: a CPU
tensor takes ``ops.qlinear.qweighted_sum_backward(...,
grad_quantized=True)``; a CUDA tensor launches the kernel or raises.
Leading dims before [B, M, D] (a family's runs) fold into B.
``qweighted_sum_backward_kernel.launches`` counts kernel launches.

dc is bit for bit the plain version's.  dp sums D products on the 2^-frac
grid: where ``sums_exact`` holds (word lengths up to 16 bits at D <= 256,
and the binary format) every order gives the same float32 sum and dp is
bit for bit too; at wider words the kernel sums in another order than
torch, and dp lies in ``dp_interval``, the values a float32 sum in any
order can give after the requant.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import torch

from qmann_tpu_torch.numerics import (QFormat, fixed_max_float,
                                      float_quant)
from qmann_tpu_torch.ops.cuda import _build
from qmann_tpu_torch.ops.cuda.geometry import MAX_THREADS, check_shape
from qmann_tpu_torch.ops.qlinear import (_grad_out_fmt, _qproducts,
                                         qweighted_sum_backward)

SOURCE = _build.CSRC / "qweighted_sum_bwd.cu"
NAME = "qweighted_sum_backward_kernel"


def backward_threads(M: int) -> int:
    """The block size of one query's launch: one warp per memory row, at
    most MAX_THREADS (a warp then takes several rows)."""
    return min(MAX_THREADS, 32 * M)


def build() -> Tuple[Path, str]:
    """Compile the kernel library unless it is built (see ``_build``)."""
    return _build.build(SOURCE)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    return _build.load(SOURCE, "qmann_qweighted_sum_backward",
                       [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])


def check_format(fmt: QFormat) -> None:
    """The formats the kernel takes (csrc/qformat.cuh's make_qfmt)."""
    if not (fmt.iwl >= 0 and fmt.frac >= 0 and fmt.iwl + fmt.frac <= 31
            and 0 <= fmt.mode <= 3):
        raise ValueError(f"{NAME}: format {tuple(fmt)} outside iwl, frac "
                         ">= 0, iwl+frac <= 31, mode in 0..3")


def sums_exact(fmt: QFormat, D: int) -> bool:
    """Whether every partial sum of dp's D products is an exact float32:
    each product is at most 2^(iwl+frac)-1 grid units (a sign for the
    binary format), so the sums stay below 2^24 units."""
    return fmt.is_binary or ((1 << (fmt.iwl + fmt.frac)) - 1) * D < 1 << 24


def dp_interval(c: torch.Tensor, row_mask: torch.Tensor, g: torch.Tensor,
                fmt: QFormat):
    """(lo, hi) of dp's shape: the values that a float32 sum of dp's
    products in any order gives after the Q_fo requant and the mask.  The
    exact sum (float64: at most 2^31 grid units a product, D <= 256) moves
    by at most D * 2^-24 * sum_d |product| in float32; the ends are
    widened by one float32 step each and requantized.  Q_fo is monotone
    but at a 31-bit word's -2^iwl, which it maps to 0 (the INT_MIN wrap of
    ``numerics.float_quant``): there hi takes in 0."""
    terms = _qproducts(c, g[..., None, :], fmt, fmt, fmt).double()
    exact = terms.sum(-1)
    slack = c.shape[-1] * 2.0 ** -24 * terms.abs().sum(-1)
    v_lo, v_hi = ((exact + s).float() for s in (-slack, slack))
    v_lo = torch.nextafter(v_lo, torch.full_like(v_lo, -torch.inf))
    v_hi = torch.nextafter(v_hi, torch.full_like(v_hi, torch.inf))
    fo = _grad_out_fmt(fmt)
    lo, hi = float_quant(v_lo, fo), float_quant(v_hi, fo)
    if fo.iwl + fo.frac == 31:
        edge = -fixed_max_float(fo.iwl, fo.frac)
        lo = torch.where(v_lo == edge, edge, lo)
        hi = torch.where(v_hi == edge, edge, hi)
        hi = torch.where((v_lo <= edge) & (edge <= v_hi), hi.clamp(min=0.0),
                         hi)
    return lo * row_mask, hi * row_mask


def qweighted_sum_backward_kernel(c: torch.Tensor, p: torch.Tensor,
                                  row_mask: torch.Tensor, g: torch.Tensor,
                                  fmt: QFormat):
    """c [..., M, D], p and row_mask [..., M], upstream g [..., D] ->
    (dc, dp) of c's and p's shapes: ``qweighted_sum_backward`` with
    ``grad_quantized=True``, the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  The format, shapes, devices and dtypes are
    checked on every device, so that the plain version covers the
    kernel's domain."""
    check_format(fmt)
    if (c.dim() < 2 or p.shape != c.shape[:-1] or row_mask.shape != p.shape
            or g.shape != c.shape[:-2] + c.shape[-1:]):
        raise ValueError(f"{NAME}: shapes c {tuple(c.shape)}, p "
                         f"{tuple(p.shape)}, row_mask "
                         f"{tuple(row_mask.shape)}, g {tuple(g.shape)}, "
                         "expected [..., M, D], [..., M], [..., M] and "
                         "[..., D]")
    M, D = c.shape[-2:]
    B = c.numel() // (M * D) if c.numel() else 0
    check_shape(NAME, B, M, D)
    if any(t.device != c.device for t in (p, row_mask, g)):
        raise ValueError(f"{NAME}: inputs on different devices")
    if any(t.dtype != torch.float32 for t in (c, p, row_mask, g)):
        raise TypeError(f"{NAME}: float32 inputs expected")
    if c.device.type == "cpu":
        return qweighted_sum_backward(c, p, row_mask, g, fmt,
                                      grad_quantized=True)
    if c.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {c.device}")
    c, p, row_mask, g = (t.contiguous() for t in (c, p, row_mask, g))
    dc = torch.empty_like(c)
    dp = torch.empty_like(p)
    lib = load_library()
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream(c.device).cuda_stream
        rc = lib.qmann_qweighted_sum_backward(
            c.data_ptr(), p.data_ptr(), row_mask.data_ptr(), g.data_ptr(),
            dc.data_ptr(), dp.data_ptr(), B, M, D, fmt.iwl, fmt.frac,
            fmt.mode, backward_threads(M), stream)
    if rc != 0:
        raise RuntimeError(f"qweighted_sum backward kernel launch failed: "
                           f"CUDA error {rc}")
    qweighted_sum_backward_kernel.launches += 1
    return dc, dp


qweighted_sum_backward_kernel.launches = 0
