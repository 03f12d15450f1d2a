"""Quantized linear-algebra ops with the reference's raw-float backwards
(counterpart of ``qmann_tpu/ops/qlinear.py``).

Forward semantics (f_fixed=true): each operand is fake-quantized in its own
Q-format, each *product* is re-quantized to the first operand's format,
products are summed in float32, and the row sum is re-quantized to the
output format.  The quantized products lie on the 2^-frac grid and the
partial sums stay under 2^24 grid units, so every lattice sum here is exact
in float32 and independent of summation order.

Backward semantics: a straight-through estimator *through the whole op*.
The backward products use the raw ``w``, ``x``, ``m``, ``u``, ``c``, ``p``,
not their quantized values, so every op is a ``torch.autograd.Function``:
left as plain torch code, the ``trunc``/``round`` inside ``float_quant``
would give zero gradients.  Under EN_GRAD_QUANT's "backward" placement the
score and weighted-sum backwards quantize their contractions and requant
the outputs at (1, iwl+frac-1) (``_grad_out_fmt``).  The backward products
are plain float32 einsums (TF32 off, ``qmann_tpu_torch._numerics_settings``),
as JAX runs them at HIGHEST precision outside any kernel.

``backend="kernel"`` (``QmannConfig.use_pallas``) routes the quantized
forwards of ``qmatvec``, ``qembed_mat`` and ``qembed_mat_multi`` through
the lattice kernel (``ops/cuda/qmatvec.py``), and the quantized backward
of ``qweighted_sum`` and ``qweighted_partial_sum`` through its kernel
(``ops/cuda/qweighted_sum_bwd.py``, XLA's fusion of that backward in
JAX); ``"plain"`` is plain PyTorch.  Both give the same results.

The family axis.  A weight with one more leading axis, w [R, O, I] (and
x [R, ..., I]), is a stack of R independent runs (the family trainer,
``train/multi.py``; JAX's vmap): the lattice launches once for all runs,
a binary format's XNOR scale is per run, and the weight gradients keep R
(``r...o,r...i->roi``).

The integer fast path (JAX's ``integer_inputs``, ``lax.cond`` per call,
a select per run under vmap).  On the plain route, ``fast`` gives per run
(a host bool, or a bool array [R] for a family) whether JAX's exactness
predicate holds (``integer_fast_ok``, computed on the device; the caller
reads all of a step's predicates in one host sync): those runs take the
exact GEMM, Q(x @ Q(w)^T), the others the lattice, which equals the GEMM
bit for bit wherever the predicate holds.  ``models.memn2n.forward``
decides it from ``cfg.en_integer_fast_path``; the serving path decides its
exact GEMM once in ``models.memn2n.prepare_inference``.

``qscore``'s ``score_mod`` ("shift", "clip") adjusts the raw score sums
before the output requant and changes only the forward.
``qscore_partial_sum`` / ``qweighted_partial_sum`` are the two ops
without their output requant, the building blocks of memory-sharded
execution, with the same backwards.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from qmann_tpu_torch.numerics import (QFormat, fixed_max_float, float_quant,
                                      float_quant_blocks)

BACKENDS = ("plain", "kernel")


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")


def _qproducts(a: torch.Tensor, b: torch.Tensor, fmt_a: QFormat,
               fmt_b: QFormat, fmt_prod: QFormat) -> torch.Tensor:
    """Per-product quantized multiply Q(Q(a, fmt_a) * Q(b, fmt_b), fmt_prod)
    on broadcast-compatible operands."""
    return float_quant(float_quant(a, fmt_a) * float_quant(b, fmt_b),
                       fmt_prod)


def _grad_out_fmt(fmt: QFormat) -> QFormat:
    """Output format of the EN_GRAD_QUANT backward contractions: the
    reference's (1, iwl+frac-1), the same word length shifted to one
    integer bit."""
    return QFormat(1, fmt.iwl + fmt.frac - 1, fmt.mode)


def exact_matmul(x: torch.Tensor, wq_t: torch.Tensor) -> torch.Tensor:
    """out = x @ wq_t in float32 (the GEMM of JAX's ``_mxu_matmul``).

    Exact under prepare_inference's bounds: integer inputs times grid
    weights, every partial sum under 2^24 grid units.  JAX runs it as one
    bf16 pass with an f32 accumulator; a bf16 ``torch.matmul`` would round
    its output back to bf16, so the port multiplies float32 operands with
    TF32 off (``qmann_tpu_torch._numerics_settings``)."""
    return torch.matmul(x.to(torch.float32), wq_t.to(torch.float32))


def _rows(x: torch.Tensor, family: bool) -> torch.Tensor:
    """x's leading dims as rows: [N, I], or [R, N, I] for a family."""
    return (x.reshape(x.shape[0], -1, x.shape[-1]) if family
            else x.reshape(-1, x.shape[-1]))


def _lattice_rows(w: torch.Tensor, x: torch.Tensor, fmt_w: QFormat,
                  fmt_x: QFormat, backend: str) -> torch.Tensor:
    """Q(sum_i Q(Q(w[o,i], fmt_w) * Q(x[..., i], fmt_x), fmt_w), fmt_w)
    over any leading dims of x (after the run axis of a family w
    [R, O, I]), flattened into the lattice's rows: the kernel, or its
    plain version."""
    _check_backend(backend)
    from qmann_tpu_torch.ops.cuda.qmatvec import (quantized_matvec,
                                                  quantized_matvec_reference)
    lattice = quantized_matvec if backend == "kernel" \
        else quantized_matvec_reference
    out = lattice(w, _rows(x, w.dim() == 3), fmt_w, fmt_x)
    return out.reshape(*x.shape[:-1], w.shape[-2])


def integer_fast_ok(x: torch.Tensor, w: torch.Tensor, fmt_w: QFormat,
                    fmt_x: QFormat) -> torch.Tensor:
    """JAX's exactness predicate of the integer fast path
    (``_qmatvec_integer_fast_ok``; ``_integer_input_fast_path_ok`` is the
    case fmt_x = fmt_w), per run: Q(x, fmt_x) == x, no product Q(x)Q(w)
    saturates in fmt_w, and every row sum stays under 2^24 grid units.  A
    0-d bool on the device, or [R] for a family w [R, O, I]; no host
    sync."""
    ax = _rows(x, w.dim() == 3).abs()               # [N, I] or [R, N, I]
    max_x = ax.flatten(-2).amax(-1)
    max_row = ax.sum(-1).amax(-1)
    max_wq = float_quant(w, fmt_w).abs().flatten(-2).amax(-1)
    units = max_row * max_wq * float(2.0 ** fmt_w.frac)
    return ((max_x <= fixed_max_float(fmt_x.iwl, fmt_x.frac))
            & (max_x * max_wq <= fixed_max_float(fmt_w.iwl, fmt_w.frac))
            & (units < float(2 ** 24)))


def _fast_lattice(x: torch.Tensor, weights: Sequence[torch.Tensor],
                  fmts: Sequence[QFormat], fast,
                  fmt_x: Optional[QFormat] = None
                  ) -> Tuple[torch.Tensor, ...]:
    """The plain route's lattices under the integer fast path: one exact
    GEMM against the stacked Q(w)^T of every weight that some run may take
    it for, requantized per block (JAX's stacked fast branch), and the
    lattice for each (weight, run) whose predicate fails.  fast[k] is
    weight k's per-run decision (a bool, or [R] for a family); x's format
    is fmt_x, else each weight's own (the memory embeddings)."""
    family = weights[0].dim() == 3
    fast = [np.asarray(f, bool) for f in fast]
    gemm = [k for k, f in enumerate(fast) if f.any()]
    outs = [None] * len(weights)
    if gemm:
        wq_t = torch.cat([float_quant(weights[k], fmts[k]).transpose(-2, -1)
                          for k in gemm], dim=-1)
        widths = [weights[k].shape[-2] for k in gemm]
        flat = float_quant_blocks(exact_matmul(_rows(x, family), wq_t),
                                  [fmts[k] for k in gemm], widths)
        for k, blk in zip(gemm, torch.split(flat, widths, dim=-1)):
            outs[k] = blk.reshape(*x.shape[:-1], blk.shape[-1]).contiguous()
    for k, (w, fmt) in enumerate(zip(weights, fmts)):
        fx = fmt if fmt_x is None else fmt_x
        if outs[k] is None:
            outs[k] = _lattice_rows(w, x, fmt, fx, "plain")
        elif not fast[k].all():
            slow = torch.from_numpy(np.flatnonzero(~fast[k])).to(x.device)
            outs[k][slow] = _lattice_rows(w[slow], x[slow], fmt, fx, "plain")
    return tuple(outs)


def _xnor_scale(out: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """out times the binary format's XNOR-net scale sum(w) / (O * I) (raw
    sum, no abs), per run for a family w [R, O, I]."""
    if w.dim() == 2:
        return out * (w.sum() / float(w.shape[0] * w.shape[1]))
    scale = w.sum(dim=(-2, -1)) / float(w.shape[-2] * w.shape[-1])
    return out * scale.reshape((-1,) + (1,) * (out.dim() - 1))


# ---------------------------------------------------------------------------
# qmatvec: out = W @ x   (dense layer)
# ---------------------------------------------------------------------------

def qmatvec_forward(w: torch.Tensor, x: torch.Tensor, fmt_w: QFormat,
                    fmt_x: QFormat, quantized: bool = True,
                    backend: str = "plain", fast=None) -> torch.Tensor:
    """qmatvec's forward without autograd (see ``qmatvec``)."""
    if not quantized:
        return torch.matmul(x, w.transpose(-2, -1))
    if fast is not None and backend == "plain":
        out = _fast_lattice(x, (w,), (fmt_w,), (fast,), fmt_x)[0]
    else:
        out = _lattice_rows(w, x, fmt_w, fmt_x, backend)
    if fmt_w.is_binary:
        out = _xnor_scale(out, w)
    return out


class _QMatVec(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, x, fmt_w, fmt_x, quantized, backend, fast):
        ctx.save_for_backward(w, x)
        return qmatvec_forward(w, x, fmt_w, fmt_x, quantized, backend, fast)

    @staticmethod
    def backward(ctx, g):
        # raw-float gradients, float under every EN_GRAD_QUANT placement:
        # w_del += g x^T ; grad_x = W^T g (per run for a family)
        w, x = ctx.saved_tensors
        eq = ("r...o,r...i->roi", "roi,r...o->r...i") if w.dim() == 3 \
            else ("...o,...i->oi", "oi,...o->...i")
        dw = torch.einsum(eq[0], g, x) if ctx.needs_input_grad[0] else None
        dx = torch.einsum(eq[1], w, g) if ctx.needs_input_grad[1] else None
        return dw, dx, None, None, None, None, None


def qmatvec(w: torch.Tensor, x: torch.Tensor, fmt_w: QFormat,
            fmt_x: QFormat, quantized: bool = True,
            backend: str = "plain", fast=None) -> torch.Tensor:
    """out[..., o] = Q(sum_i Q(Q(w[o,i]) * Q(x[..., i])));  w [O, I],
    x [..., I] -> [..., O], or per run of a family w [R, O, I], x
    [R, ..., I].  quantized=False is the plain float product (the float
    output layer, attention mode 1).  A binary weight format applies the
    XNOR-net scale sum(w)/(O*I) (raw sum, no abs).  fast: the integer fast
    path's per-run decision on the plain route (module docstring)."""
    return _QMatVec.apply(w, x, fmt_w, fmt_x, quantized, backend, fast)


# ---------------------------------------------------------------------------
# qembed_mat: M = S @ A^T  (memory embedding)
# ---------------------------------------------------------------------------

def qembed_mat_forward(s: torch.Tensor, a: torch.Tensor, fmt: QFormat,
                       quantized: bool = True,
                       backend: str = "plain") -> torch.Tensor:
    """qembed_mat's forward without autograd (see ``qembed_mat``)."""
    if not quantized:
        if a.dim() == 3:   # a family: [R, ..., M, I] x [R, D, I]
            out = torch.matmul(_rows(s, True), a.transpose(-2, -1))
            return out.reshape(*s.shape[:-1], a.shape[-2])
        return torch.matmul(s, a.transpose(0, 1))
    # Q(Q(a)Q(s)) == Q(Q(s)Q(a)): the lattice with a as the weight
    return _lattice_rows(a, s, fmt, fmt, backend)


def _qembed_grads(ctx, g, s, a, s_slot, a_slot):
    eq = ("r...md,r...mi->rdi", "r...md,rdi->r...mi") if a.dim() == 3 \
        else ("...md,...mi->di", "...md,di->...mi")
    da = torch.einsum(eq[0], g, s) if ctx.needs_input_grad[a_slot] else None
    ds = torch.einsum(eq[1], g, a) if ctx.needs_input_grad[s_slot] else None
    return ds, da


class _QEmbedMat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, s, a, fmt, quantized, backend):
        ctx.save_for_backward(s, a)
        return qembed_mat_forward(s, a, fmt, quantized, backend)

    @staticmethod
    def backward(ctx, g):
        # dense_mat_bwd in float: A_del += grad^T S ; grad_S = grad A
        s, a = ctx.saved_tensors
        ds, da = _qembed_grads(ctx, g, s, a, 0, 1)
        return ds, da, None, None, None


def qembed_mat(s: torch.Tensor, a: torch.Tensor, fmt: QFormat,
               quantized: bool = True, backend: str = "plain") -> torch.Tensor:
    """Memory embedding s [..., M, I] x a [D, I] -> [..., M, D] with one
    Q-format for both operands, each product and the output."""
    return _QEmbedMat.apply(s, a, fmt, quantized, backend)


class _QEmbedMatMulti(torch.autograd.Function):
    @staticmethod
    def forward(ctx, s, fmts, quantized, backend, fast, *weights):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(s, *weights)
        if fast is not None and quantized and backend == "plain":
            return _fast_lattice(s, weights, fmts, fast)
        return tuple(qembed_mat_forward(s, w, f, quantized, backend)
                     for w, f in zip(weights, fmts))

    @staticmethod
    def backward(ctx, *gs):
        # per-entry raw-float VJPs; the input gradients are summed, and a
        # weight in several slots (tying type 2) has its slots summed by
        # autograd
        s, *weights = ctx.saved_tensors
        dws, ds = [], None
        for k, (g, w) in enumerate(zip(gs, weights)):
            if g is None:
                dws.append(None)
                continue
            dsk, dw = _qembed_grads(ctx, g, s, w, 0, 5 + k)
            dws.append(dw)
            if dsk is not None:
                ds = dsk if ds is None else ds + dsk
        return (ds, None, None, None, None, *dws)


def qembed_mat_multi(s: torch.Tensor, weights: Sequence[torch.Tensor],
                     fmts: Sequence[QFormat], quantized: bool = True,
                     backend: str = "plain",
                     fast: Optional[Sequence] = None
                     ) -> Tuple[torch.Tensor, ...]:
    """K qembed_mat calls sharing one input, one per (weight, fmt) pair, as
    one autograd node; weights [D, I], or [R, D, I] against s [R, ..., I]
    for a family.  fast: the integer fast path's per-run decision for each
    weight on the plain route (module docstring); the serving route's
    exact GEMM is ``models.memn2n.forward_prepared``'s."""
    if len(weights) != len(fmts):
        raise ValueError("qembed_mat_multi: one format per weight expected")
    return _QEmbedMatMulti.apply(s, tuple(fmts), quantized, backend,
                                 None if fast is None else tuple(fast),
                                 *weights)


# ---------------------------------------------------------------------------
# qscore: scores = M @ u  (attention modes 1/2)
# ---------------------------------------------------------------------------

SCORE_MODS = ("none", "shift", "clip")


def _apply_score_mod(raw: torch.Tensor, fmt: QFormat,
                     score_mod: str) -> torch.Tensor:
    """The pre-requant adjustment of the raw score sums: "shift" subtracts
    the row max over all rows (padded ones included), "clip" clips at
    +-(maxf - 2^-frac)."""
    if score_mod == "shift":
        return raw - raw.amax(-1, keepdim=True)
    if score_mod == "clip":
        bound = fixed_max_float(fmt.iwl, fmt.frac) - 2.0 ** (-fmt.frac)
        return torch.clamp(raw, -bound, bound)
    if score_mod != "none":
        raise ValueError(f"unknown score_mod {score_mod!r}; expected one of "
                         f"{SCORE_MODS}")
    return raw


def qscore_partial_forward(m: torch.Tensor, u: torch.Tensor, fmt_m: QFormat,
                           fmt_u: QFormat,
                           quantized: bool = True) -> torch.Tensor:
    """The score's raw sums: the quantized products summed in float32, no
    output requant (the float dot product when quantized=False)."""
    if not quantized:
        return torch.einsum("...md,...d->...m", m, u)
    return _qproducts(m, u[..., None, :], fmt_m, fmt_u, fmt_m).sum(-1)


def qscore_forward(m: torch.Tensor, u: torch.Tensor, fmt_m: QFormat,
                   fmt_u: QFormat, quantized: bool = True,
                   score_mod: str = "none") -> torch.Tensor:
    """qscore's forward without autograd (see ``qscore``)."""
    raw = qscore_partial_forward(m, u, fmt_m, fmt_u, quantized)
    if not quantized:
        return raw
    return float_quant(_apply_score_mod(raw, fmt_m, score_mod), fmt_m)


def qscore_backward(m: torch.Tensor, u: torch.Tensor, g: torch.Tensor,
                    fmt_m: QFormat, grad_quantized: bool = False):
    """(dm, du) of the score on the raw m, u.  The gate is grad_quantized
    alone: the reference's backward f_fixed is the layer's flag, whatever
    the forward dispatch (a mode-1 float forward still quantizes its
    EN_GRAD_QUANT backward when the layer is fixed)."""
    if grad_quantized:
        # per-product requant at (fmt_m, fmt_m), outputs at (1, iwl+frac-1)
        fo = _grad_out_fmt(fmt_m)
        dm = float_quant(_qproducts(g[..., :, None], u[..., None, :], fmt_m,
                                    fmt_m, fmt_m), fo)
        du = float_quant(_qproducts(g[..., :, None], m, fmt_m, fmt_m,
                                    fmt_m).sum(-2), fo)
        return dm, du
    # float: grad_M = g (x) u ; grad_u = M^T g
    dm = g[..., :, None] * u[..., None, :]
    du = torch.einsum("...md,...m->...d", m, g)
    return dm, du


class _QScore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, m, u, fmt_m, fmt_u, quantized, score_mod,
                grad_quantized, partial):
        ctx.save_for_backward(m, u)
        ctx.fmt_m, ctx.grad_quantized = fmt_m, grad_quantized
        if partial:
            return qscore_partial_forward(m, u, fmt_m, fmt_u, quantized)
        return qscore_forward(m, u, fmt_m, fmt_u, quantized, score_mod)

    @staticmethod
    def backward(ctx, g):
        m, u = ctx.saved_tensors
        dm, du = qscore_backward(m, u, g, ctx.fmt_m, ctx.grad_quantized)
        return dm, du, None, None, None, None, None, None


def qscore(m: torch.Tensor, u: torch.Tensor, fmt_m: QFormat, fmt_u: QFormat,
           quantized: bool = True, score_mod: str = "none",
           grad_quantized: bool = False) -> torch.Tensor:
    """Attention score m [..., M, D] x u [..., D] -> [..., M]: per-product
    requant to fmt_m, row-sum requant to fmt_m (mode 2); the float dot
    product when quantized=False (mode 1).  score_mod "shift" / "clip"
    adjusts the raw sums before the requant (quantized path only); the
    backward is the same raw-float one either way.  grad_quantized selects
    the EN_GRAD_QUANT backward."""
    return _QScore.apply(m, u, fmt_m, fmt_u, quantized, score_mod,
                         grad_quantized, False)


def qscore_partial_sum(m: torch.Tensor, u: torch.Tensor, fmt_m: QFormat,
                       fmt_u: QFormat, quantized: bool = True
                       ) -> torch.Tensor:
    """qscore without the output requant: each memory shard's sum of
    quantized products (exact on the 2^-frac grid), for a global shift and
    requant after the shards are combined.  The float backward of
    qscore."""
    return _QScore.apply(m, u, fmt_m, fmt_u, quantized, "none", False, True)


# ---------------------------------------------------------------------------
# qweighted_sum: o = C^T p  (memory read)
# ---------------------------------------------------------------------------

def qweighted_partial_forward(c: torch.Tensor, p: torch.Tensor,
                              row_mask: torch.Tensor, fmt: QFormat,
                              quantized: bool = True) -> torch.Tensor:
    """The weighted sum's raw sums: the masked quantized products summed
    in float32, no output requant (the float product when
    quantized=False)."""
    if not quantized:
        return torch.einsum("...md,...m->...d", c, p * row_mask)
    prod = _qproducts(p[..., :, None], c, fmt, fmt, fmt)
    return (prod * row_mask[..., :, None]).sum(-2)


def qweighted_sum_forward(c: torch.Tensor, p: torch.Tensor,
                          row_mask: torch.Tensor, fmt: QFormat,
                          quantized: bool = True) -> torch.Tensor:
    """qweighted_sum's forward without autograd (see ``qweighted_sum``)."""
    raw = qweighted_partial_forward(c, p, row_mask, fmt, quantized)
    return float_quant(raw, fmt) if quantized else raw


def qweighted_sum_backward(c: torch.Tensor, p: torch.Tensor,
                           row_mask: torch.Tensor, g: torch.Tensor,
                           fmt: QFormat, grad_quantized: bool = False):
    """(dc, dp) of the weighted sum on the raw c, p; the padded-row mask is
    applied after, as in the forward."""
    if grad_quantized:
        # grad_C[r,d] = Q(FIXED_MUL(p_r, g_d)); grad_p[r] =
        # Q(sum_d FIXED_MUL(C_rd, g_d)), both at (1, iwl+frac-1)
        fo = _grad_out_fmt(fmt)
        dc = float_quant(_qproducts(p[..., :, None], g[..., None, :], fmt,
                                    fmt, fmt), fo) * row_mask[..., :, None]
        dp = float_quant(_qproducts(c, g[..., None, :], fmt, fmt,
                                    fmt).sum(-1), fo) * row_mask
        return dc, dp
    # float: grad_C = p (x) g ; grad_p = C g
    dc = (p * row_mask)[..., :, None] * g[..., None, :]
    dp = torch.einsum("...md,...d->...m", c, g) * row_mask
    return dc, dp


class _QWeightedSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, c, p, row_mask, fmt, quantized, grad_quantized,
                partial, backend):
        _check_backend(backend)
        ctx.save_for_backward(c, p, row_mask)
        ctx.fmt, ctx.grad_quantized = fmt, grad_quantized
        ctx.kernel = backend == "kernel" and grad_quantized
        if partial:
            return qweighted_partial_forward(c, p, row_mask, fmt, quantized)
        return qweighted_sum_forward(c, p, row_mask, fmt, quantized)

    @staticmethod
    def backward(ctx, g):
        c, p, row_mask = ctx.saved_tensors
        if ctx.kernel:   # the quantized backward on the kernel route
            from qmann_tpu_torch.ops.cuda.qweighted_sum_bwd import (
                qweighted_sum_backward_kernel)
            dc, dp = qweighted_sum_backward_kernel(
                c, p, row_mask.expand_as(p), g, ctx.fmt)
        else:
            dc, dp = qweighted_sum_backward(c, p, row_mask, g, ctx.fmt,
                                            ctx.grad_quantized)
        return dc, dp, None, None, None, None, None, None


def qweighted_sum(c: torch.Tensor, p: torch.Tensor, row_mask: torch.Tensor,
                  fmt: QFormat, quantized: bool = True,
                  grad_quantized: bool = False,
                  backend: str = "plain") -> torch.Tensor:
    """Weighted memory sum c [..., M, D] x p [..., M] -> [..., D].  row_mask
    [..., M] float (1 live / 0 padded) zeroes padded rows after the
    per-product quantization (the binary format maps 0 to +1).
    grad_quantized selects the quantized backward contractions (the
    EN_GRAD_QUANT placement, and always in fixed-point mode 3);
    backend="kernel" runs them as one CUDA kernel (bit-identical at word
    lengths up to 16 bits; see ``ops/cuda/qweighted_sum_bwd.py``)."""
    return _QWeightedSum.apply(c, p, row_mask, fmt, quantized, grad_quantized,
                               False, backend)


def qweighted_partial_sum(c: torch.Tensor, p: torch.Tensor,
                          row_mask: torch.Tensor, fmt: QFormat,
                          quantized: bool = True,
                          grad_quantized: bool = False,
                          backend: str = "plain") -> torch.Tensor:
    """qweighted_sum without the output requant: each memory shard's sum
    of masked quantized products, for one requant after the shards are
    added.  The backward of qweighted_sum (backend as there): dc is per
    memory row and dp reduces over the unsharded D axis, so it is
    shard-local."""
    return _QWeightedSum.apply(c, p, row_mask, fmt, quantized, grad_quantized,
                               True, backend)
