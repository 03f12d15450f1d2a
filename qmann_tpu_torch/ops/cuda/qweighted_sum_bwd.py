"""The weighted sum's backward, with the fused read's softmax backward as an
epilogue: a hand-written CUDA kernel for Hopper and its plain PyTorch
version.

No Pallas kernel stands behind it: the JAX package computes the branches
of ``_qweighted_sum_bwd`` (``qmann_tpu/ops/qlinear.py``) and the fused
read's ``_fused_bwd`` (``qmann_tpu/ops/fused.py``) as plain jnp, which XLA
fuses under ``jit``.  The kernel is the port of those fusions, so that a
step on the kernel route runs one launch per hop for them.  One source,
two entry points:

* ``weighted_sum_softmax_backward_kernel`` -> (dc, ds): the weighted-sum
  backward, quantized (fixed-point mode 3, ``QmannConfig.
  wsum_grad_quantized``) or float (modes 1 and 2), then dp + dp_in and
  the softmax backward p * (dp - sum(p * dp)) + ds_in.  The fused read's
  backward (``ops.fused._FusedAttentionRead``, ``use_pallas``) calls it
  once per hop.
* ``qweighted_sum_backward_kernel`` -> (dc, dp): the quantized weighted-sum
  backward alone, for the unfused weighted sum (``ops.qlinear.
  _QWeightedSum``: ``use_pallas_hamming``, EN_GRAD_QUANT's unfused chain)
  and, through it, the mesh's shard-local ``qweighted_partial_sum``.

The kernel source is ``qmann_tpu_torch/csrc/qweighted_sum_bwd.cu`` (the
quantizers from ``csrc/qformat.cuh``).  Built with nvcc at first use
(``ops/cuda/_build.py``) and bound with ctypes.

Both wrappers dispatch on the device of ``c``: a CPU tensor takes the
plain version (``ops.qlinear.qweighted_sum_backward``, then
``ops.softmax.softmax_backward`` for the ds entry); a CUDA tensor launches
the kernel or raises.  Leading dims before [B, M, D] (a family's runs)
fold into B.  Each wrapper's ``.launches`` counts its kernel launches.

dc is bit for bit the plain version's.  Quantized dp sums D products on
the 2^-frac grid: where ``sums_exact`` holds (word lengths up to 16 bits at
D <= 256, and the binary format) every order gives the same float32 sum
and dp is bit for bit too; at wider words the kernel sums in another order
than torch, and dp lies in ``dp_interval``.  Float dp lies within
``dp_error`` of the plain einsum, and ds within ``ds_bound`` of the plain
softmax backward.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import torch

from qmann_tpu_torch.numerics import (QFormat, fixed_max_float,
                                      float_quant)
from qmann_tpu_torch.ops.cuda import _build
from qmann_tpu_torch.ops.cuda.geometry import SMS, check_shape
from qmann_tpu_torch.ops.qlinear import (_grad_out_fmt, _qproducts,
                                         qweighted_sum_backward)
from qmann_tpu_torch.ops.softmax import softmax_backward

SOURCE = _build.CSRC / "qweighted_sum_bwd.cu"
NAME = "qweighted_sum_backward_kernel"
DS_NAME = "weighted_sum_softmax_backward_kernel"
MAX_WARPS = 8     # kMaxWarps in the source: warps a block
MAX_GROUPS = 2    # kMaxGroups in the source: column groups of 4 a lane
# warps a query from SMS queries on, chosen by a sweep on the H100 (PERF.md,
# section 6): at 1280, 5120 and 6400 queries of 50 x 60, 3 warps a query
# (two queries a block) beat 2, 4 and 8 by 2-20%
WIDE_WARPS = 3
U = 2.0 ** -24    # float32's unit roundoff


class Geometry(NamedTuple):
    lanes_log2: int   # 2^lanes_log2 lanes a memory row
    warps: int        # warps a query (its rows split over them)
    queries: int      # queries a block
    blocks: int
    threads: int


def backward_geometry(B: int, M: int, D: int) -> Geometry:
    """The launch geometry over B queries of M rows of D columns: the
    fewest lanes a row that leave a lane at most MAX_GROUPS column groups
    of 4 (at D=60: 8 lanes, 4 rows a warp step); a query's rows split over
    WIDE_WARPS warps, or over MAX_WARPS while there are fewer queries than
    SMs, never more than its steps; as many queries a block as fit in
    MAX_WARPS warps, halved while the grid has fewer blocks than SMs."""
    groups = -(-D // 4)
    lanes_log2 = 0
    while MAX_GROUPS << lanes_log2 < groups:
        lanes_log2 += 1
    steps = -(-M // (32 >> lanes_log2))
    warps = min(steps, MAX_WARPS if B < SMS else WIDE_WARPS)
    queries = MAX_WARPS // warps
    while queries > 1 and -(-B // queries) < SMS:
        queries //= 2
    return Geometry(lanes_log2, warps, queries, -(-B // queries),
                    32 * warps * queries)


def build() -> Tuple[Path, str]:
    """Compile the kernel library unless it is built (see ``_build``)."""
    return _build.build(SOURCE)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    return _build.load(SOURCE, "qmann_weighted_sum_backward",
                       [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11
                       + [ctypes.c_void_p])


def check_format(fmt: QFormat, name: str = NAME) -> None:
    """The formats the kernel takes (csrc/qformat.cuh's make_qfmt)."""
    if not (fmt.iwl >= 0 and fmt.frac >= 0 and fmt.iwl + fmt.frac <= 31
            and 0 <= fmt.mode <= 3):
        raise ValueError(f"{name}: format {tuple(fmt)} outside iwl, frac "
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
    slack = c.shape[-1] * U * terms.abs().sum(-1)
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


def dp_error(c: torch.Tensor, row_mask: torch.Tensor, g: torch.Tensor,
             fmt: QFormat, quantized: bool,
             dp_in: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A float64 bound of |dp_kernel - dp_plain| per row, dp_in added when
    given: 0 for quantized words where ``sums_exact`` holds (bit for bit),
    hi - lo of ``dp_interval`` at wider words, 2*D*2^-24*sum_d|c*g| for the
    float instance (two D-term float32 sums in other orders); the add of
    dp_in rounds each side once more, by 2^-24 of its result."""
    mask = row_mask.double().abs()
    if not quantized:
        cg = (c.double() * g.double()[..., None, :]).abs().sum(-1)
        err = 2 * c.shape[-1] * U * cg * mask
    elif sums_exact(fmt, c.shape[-1]):
        err = torch.zeros_like(mask)
    else:
        lo, hi = dp_interval(c, row_mask, g, fmt)
        err = (hi.double() - lo.double()).abs()
    if dp_in is not None and bool((err > 0).any()):
        # the add's rounding scales with |dp_o| + |dp_in|
        _, dp = qweighted_sum_backward(c, torch.zeros_like(row_mask),
                                       row_mask, g, fmt, quantized)
        top = dp.double().abs() + err + dp_in.double().abs()
        err = (err + 2 * U * top) * (1 + 2.0 ** -18)
    return err


def ds_bound(p: torch.Tensor, dp: torch.Tensor, dp_err: torch.Tensor,
             ds_in: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A float64 bound of |ds_kernel - ds_plain| per element, where ds =
    p * (dp - S) (+ ds_in) and S = sum_m p_m dp_m: dp is the plain
    version's (dp_in added), dp_err bounds the kernel's dp against it
    (``dp_error``).  Each side's float32 S lies within M*2^-24*A of its
    exact sum, A = sum_m |p_m| (|dp_m| + dp_err_m) (M products and M - 1
    adds, u/(1-Mu) <= u (1 + 2^-17) at M <= 64), and the exact sums differ
    by at most E = sum_m |p_m| dp_err_m: |S - S'| <= dS = 2*M*2^-24*A + E.
    Through the subtraction and the product, each rounding by 2^-24 of
    its result, |dp - S| <= Dm = |dp| + |S_exact| + dS:
        |p| * ((dp_err + dS) (1 + 2u) + 4u Dm),
    and the add of ds_in rounds each side once more.  Every bound is
    widened by 2^-18 of itself for the second-order terms."""
    p64, dp64, e = p.double(), dp.double(), dp_err.double()
    M = p.shape[-1]
    ap = p64.abs()
    A = (ap * (dp64.abs() + e)).sum(-1, keepdim=True)
    E = (ap * e).sum(-1, keepdim=True)
    k = 1 + 2.0 ** -18
    dS = (2 * M * U * A + E) * k
    Dm = dp64.abs() + (p64 * dp64).sum(-1, keepdim=True).abs() + dS
    bound = ap * ((e + dS) * (1 + 2 * U) + 4 * U * Dm) * k
    if ds_in is not None:
        top = ap * (Dm + e) * (1 + 2 * U) + ds_in.double().abs()
        bound = (bound * (1 + 2 * U) + 2 * U * top) * k
    return bound


def _check(name: str, c, p, row_mask, g, extra=()):
    """Shapes, devices and dtypes the kernel takes, on every device, so
    that the plain version covers the kernel's domain.  Returns B, M, D
    with leading dims folded into B."""
    if (c.dim() < 2 or p.shape != c.shape[:-1] or row_mask.shape != p.shape
            or g.shape != c.shape[:-2] + c.shape[-1:]
            or any(t.shape != p.shape for t in extra)):
        raise ValueError(f"{name}: shapes c {tuple(c.shape)}, p "
                         f"{tuple(p.shape)}, row_mask "
                         f"{tuple(row_mask.shape)}, g {tuple(g.shape)}"
                         + "".join(f", {tuple(t.shape)}" for t in extra)
                         + ", expected [..., M, D], [..., M], [..., M], "
                         "[..., D] and cotangents of p's shape")
    M, D = c.shape[-2:]
    B = c.numel() // (M * D) if c.numel() else 0
    check_shape(name, B, M, D)
    tensors = (p, row_mask, g, *extra)
    if any(t.device != c.device for t in tensors):
        raise ValueError(f"{name}: inputs on different devices")
    if any(t.dtype != torch.float32 for t in (c, *tensors)):
        raise TypeError(f"{name}: float32 inputs expected")
    if c.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {c.device}")
    return B, M, D


def _launch(c, p, row_mask, g, dp_in, ds_in, fmt, quantized, softmax, B,
            M, D):
    """One launch of the kernel on CUDA tensors -> (dc, dp or ds)."""
    c, p, row_mask, g = (t.contiguous() for t in (c, p, row_mask, g))
    dp_in, ds_in = (None if t is None else t.contiguous()
                    for t in (dp_in, ds_in))
    dc = torch.empty_like(c)
    out = torch.empty_like(p)
    geo = backward_geometry(B, M, D)
    lib = load_library()
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream(c.device).cuda_stream
        rc = lib.qmann_weighted_sum_backward(
            c.data_ptr(), p.data_ptr(), row_mask.data_ptr(), g.data_ptr(),
            None if dp_in is None else dp_in.data_ptr(),
            None if ds_in is None else ds_in.data_ptr(),
            dc.data_ptr(), out.data_ptr(), B, M, D, fmt.iwl, fmt.frac,
            fmt.mode, int(quantized), int(softmax), geo.lanes_log2,
            geo.warps, geo.queries, stream)
    if rc != 0:
        raise RuntimeError(f"weighted-sum backward kernel launch failed: "
                           f"CUDA error {rc}")
    return dc, out


def qweighted_sum_backward_kernel(c: torch.Tensor, p: torch.Tensor,
                                  row_mask: torch.Tensor, g: torch.Tensor,
                                  fmt: QFormat):
    """c [..., M, D], p and row_mask [..., M], upstream g [..., D] ->
    (dc, dp) of c's and p's shapes: ``qweighted_sum_backward`` with
    ``grad_quantized=True``, the CUDA kernel's dp epilogue for CUDA
    tensors, the plain version for CPU tensors.  The format, shapes,
    devices and dtypes are checked on every device."""
    check_format(fmt)
    B, M, D = _check(NAME, c, p, row_mask, g)
    if c.device.type == "cpu":
        return qweighted_sum_backward(c, p, row_mask, g, fmt,
                                      grad_quantized=True)
    out = _launch(c, p, row_mask, g, None, None, fmt, True, False, B, M, D)
    qweighted_sum_backward_kernel.launches += 1
    return out


qweighted_sum_backward_kernel.launches = 0


def weighted_sum_softmax_backward_plain(c, p, row_mask, g, dp_in, ds_in,
                                        fmt, quantized):
    """The ds entry's plain version: ``qweighted_sum_backward``, dp_o +
    dp_in, the softmax backward, ds_p + ds_in (JAX's ``_fused_bwd``)."""
    dc, dp = qweighted_sum_backward(c, p, row_mask, g, fmt,
                                    grad_quantized=quantized)
    if dp_in is not None:
        dp = dp + dp_in
    ds = softmax_backward(p, dp)   # padded entries have p == 0
    return dc, ds if ds_in is None else ds + ds_in


def weighted_sum_softmax_backward_kernel(c: torch.Tensor, p: torch.Tensor,
                                         row_mask: torch.Tensor,
                                         g: torch.Tensor,
                                         dp_in: Optional[torch.Tensor],
                                         ds_in: Optional[torch.Tensor],
                                         fmt: QFormat, quantized: bool):
    """c [..., M, D], p and row_mask [..., M], upstream g [..., D], the
    cotangents dp_in of p and ds_in of the scores ([..., M] or None) ->
    (dc, ds) of c's and p's shapes: the weighted-sum backward (quantized:
    the contractions at fmt and its gradient-output format; float: the
    raw products, fmt unread), then ds = p * (dp - sum(p * dp)) with dp_in
    added to dp and ds_in to ds.  The CUDA kernel's ds epilogue for CUDA
    tensors, ``weighted_sum_softmax_backward_plain`` for CPU tensors."""
    if quantized:
        check_format(fmt, DS_NAME)
    extra = tuple(t for t in (dp_in, ds_in) if t is not None)
    B, M, D = _check(DS_NAME, c, p, row_mask, g, extra)
    if c.device.type == "cpu":
        return weighted_sum_softmax_backward_plain(c, p, row_mask, g, dp_in,
                                                   ds_in, fmt, quantized)
    out = _launch(c, p, row_mask, g, dp_in, ds_in, fmt, quantized, True, B,
                  M, D)
    weighted_sum_softmax_backward_kernel.launches += 1
    return out


weighted_sum_softmax_backward_kernel.launches = 0
