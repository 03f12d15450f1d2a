"""Attention score ops: the four attention modes, including the paper's
bit-weighted Hamming-similarity attention with its hand-crafted surrogate
gradient (counterpart of ``qmann_tpu/ops/attention.py``).

Mode 1: float dot product                 (``qlinear.qscore``, quantized=False)
Mode 2: quantized fixed-point dot product (``qlinear.qscore``)
Mode 3: Hamming-similarity attention      (``hamming_score``)
Mode 4: binary attention: binarize both operands, then the float dot product

The Hamming forward, per (m, u) element pair:
  1. encode both as 32-bit sign-magnitude words at the full-width format
     (iwl, 31-iwl);
  2. the common-mode preprocess: with n = min(|a|, |b|), same signs
     subtract n from both magnitudes; different signs add n to the larger
     magnitude (wrapping in 32 bits) and zero the smaller;
  3. the weighted similarity: sum of 2^(-i-weight_para) over the matching
     bits i in [1, num_bit) counted from the MSB, negated if the
     preprocessed words' sign bits differ (or the unweighted count);
  4. scale by 2^const_scale;
  5. requantize each term and the row sum at (iwl, 31-iwl).

``backend="kernel"`` runs the forward of a [..., B, M, D] x [..., B, D]
score through the hand-written CUDA kernel (``ops/cuda/hamming.py``), the
leading dims (a family's runs) folded into B, as JAX's vmap batches the
Pallas kernel; on a CPU tensor it takes the plain version, and so do
other ranks, as the JAX package's Pallas route does.  The surrogate
backward re-encodes and re-preprocesses the inputs, reads the operand
signs from the original words, and keeps the reference's stale-accumulate
quirk in the query gradient.  In JAX it is a loop of jnp ops that XLA
fuses under jit; here the kernel route's backward runs it as one
hand-written CUDA kernel (``ops/cuda/hamming_bwd.py``) and the plain
route as ``hamming_backward``, the kernel's plain version.
"""
from __future__ import annotations

import torch

from qmann_tpu_torch.numerics import (QFormat, bin2gray,
                                      encode_sign_magnitude, float_quant)
from qmann_tpu_torch.ops.qlinear import _check_backend, qscore

INT32_SIGN_BIT = -(2 ** 31)   # 0x80000000 as int32
_MAG_MASK = 0x7FFFFFFF

# ATTENTION_CONST_SCALE of the reference
DEFAULT_CONST_SCALE = -3


def _encode_words(x: torch.Tensor, iwl: int, mode: int) -> torch.Tensor:
    """float32 -> 32-bit sign-magnitude word (int32) at (iwl, 31-iwl)."""
    sign, mag = encode_sign_magnitude(x, QFormat(iwl, 31 - iwl, mode))
    return torch.where(sign > 0, mag | INT32_SIGN_BIT, mag)


def _common_mode_preprocess(wm: torch.Tensor, wu: torch.Tensor):
    """The common-mode preprocess on int32 sign-magnitude words; the
    int32 addition mm + mn wraps, and the wrapped word's sign bit is part
    of the result."""
    sm_bit = wm & INT32_SIGN_BIT
    su_bit = wu & INT32_SIGN_BIT
    mm = wm & _MAG_MASK
    mu = wu & _MAG_MASK
    mn = torch.minimum(mm, mu)
    same = sm_bit == su_bit
    m_ge = mm >= mu
    new_mm = torch.where(same, mm - mn, torch.where(m_ge, mm + mn, 0))
    new_mu = torch.where(same, mu - mn, torch.where(m_ge, 0, mu + mn))
    return sm_bit | new_mm, su_bit | new_mu


def _bit(word: torch.Tensor, i: int) -> torch.Tensor:
    """Bit i counted from the MSB, as 0/1: an arithmetic shift masked
    with 1."""
    return (word >> (31 - i)) & 1


def _weighted_similarity(wa: torch.Tensor, wb: torch.Tensor, num_bit: int,
                         weight_para: int = 0) -> torch.Tensor:
    """Sum of 2^(-i-weight_para) over the matching bits i in [1, num_bit),
    summed in that order in float32; negated where the sign bits of the
    (preprocessed) words differ."""
    sim = torch.zeros(torch.broadcast_shapes(wa.shape, wb.shape),
                      dtype=torch.float32, device=wa.device)
    for i in range(1, num_bit):
        match = (_bit(wa, i) == _bit(wb, i)).to(torch.float32)
        sim = sim + match * float(2.0 ** (-i - weight_para))
    sign_differs = (wa & INT32_SIGN_BIT) != (wb & INT32_SIGN_BIT)
    return torch.where(sign_differs, -sim, sim)


def unweighted_similarity(wa: torch.Tensor, wb: torch.Tensor,
                          num_bit: int) -> torch.Tensor:
    """The plain count of matching bits i in [1, num_bit)."""
    sim = torch.zeros(torch.broadcast_shapes(wa.shape, wb.shape),
                      dtype=torch.float32, device=wa.device)
    for i in range(1, num_bit):
        sim = sim + (_bit(wa, i) == _bit(wb, i)).to(torch.float32)
    return sim


def gray_hamming_score(m: torch.Tensor, u: torch.Tensor, iwl: int,
                       num_bit: int, round_mode: int = 3) -> torch.Tensor:
    """The reference's gray-code Hamming experiment: each magnitude through
    bin2gray over bits [30-num_bit+2, 30], the unweighted similarity over
    the top num_bit bits, summed over the embedding dimension.  Forward
    only (the reference has no backward for it)."""
    wm = _encode_words(m, iwl, round_mode)
    wu = _encode_words(u, iwl, round_mode)[..., None, :]
    lo, hi = 30 - num_bit + 2, 30
    gm = bin2gray(wm & _MAG_MASK, lo, hi)
    gu = bin2gray(wu & _MAG_MASK, lo, hi)
    return unweighted_similarity(gm, gu, num_bit).sum(-1)


def hamming_score_reference(m: torch.Tensor, u: torch.Tensor, iwl: int,
                            num_bit: int,
                            const_scale: int = DEFAULT_CONST_SCALE,
                            round_mode: int = 3, weight_para: int = 0,
                            weighted: bool = True) -> torch.Tensor:
    """The Hamming forward in plain PyTorch (no autograd): m [..., M, D],
    u [..., D] -> [..., M]."""
    fmt_full = QFormat(iwl, 31 - iwl, round_mode)
    wm = _encode_words(m, iwl, round_mode)
    wu = _encode_words(u, iwl, round_mode)[..., None, :]
    pm, pu = _common_mode_preprocess(wm, wu)
    if weighted:
        sim = _weighted_similarity(pm, pu, num_bit, weight_para)
    else:
        sim = unweighted_similarity(pm, pu, num_bit)
    term = float_quant(sim * float(2.0 ** const_scale), fmt_full)
    return float_quant(term.sum(-1), fmt_full)


def surrogate_terms(m: torch.Tensor, u: torch.Tensor, iwl: int,
                    num_bit: int, const_scale: int = DEFAULT_CONST_SCALE,
                    round_mode: int = 3):
    """The surrogate's per-element factors (tmp_a, grad_appx), each
    [..., M, D], before the upstream gradient multiplies them.

    Per bit i in [0, num_bit) where the preprocessed bits differ (diff =
    mb - ub): tmp_a accumulates diff * sign_m * 2^ACS at i == 0 and
    -diff * sign_u * 2^ACS above; tmp_v is assigned -diff * sign_u * 2^ACS
    at i == 0 and diff * sign_m * 2^ACS above, but added into grad_appx at
    every bit, so a stale value is re-added where the bits match.  The
    signs are those of the original words (word >= 0), not of the
    preprocessed ones."""
    scale = float(2.0 ** const_scale)
    wm = _encode_words(m, iwl, round_mode)
    wu = _encode_words(u, iwl, round_mode)[..., None, :]
    sign_m = torch.where(wm >= 0, 1.0, -1.0)
    sign_u = torch.where(wu >= 0, 1.0, -1.0)
    pm, pu = _common_mode_preprocess(wm, wu)
    tmp_a = torch.zeros(pm.shape, dtype=torch.float32, device=pm.device)
    tmp_v = torch.zeros_like(tmp_a)
    grad_appx = torch.zeros_like(tmp_a)
    for i in range(num_bit):
        mb = _bit(pm, i).to(torch.float32)
        ub = _bit(pu, i).to(torch.float32)
        differ = mb != ub
        diff = mb - ub
        if i == 0:
            contrib_m = diff * sign_m * scale
            assign_v = -diff * sign_u * scale
        else:
            contrib_m = -diff * sign_u * scale
            assign_v = diff * sign_m * scale
        tmp_a = tmp_a + torch.where(differ, contrib_m, 0.0)
        tmp_v = torch.where(differ, assign_v, tmp_v)
        grad_appx = grad_appx + tmp_v
    return tmp_a, grad_appx


def hamming_backward(m: torch.Tensor, u: torch.Tensor, g: torch.Tensor,
                     iwl: int, num_bit: int,
                     const_scale: int = DEFAULT_CONST_SCALE,
                     round_mode: int = 3):
    """The reference's surrogate gradients (dm, du) for upstream g
    [..., M]: dm = tmp_a * g, du = sum over the memory rows of
    grad_appx * g (``surrogate_terms``).  The weight_para and unweighted
    variants change the forward only.  The plain version of
    ``ops/cuda/hamming_bwd.py``'s kernel."""
    tmp_a, grad_appx = surrogate_terms(m, u, iwl, num_bit, const_scale,
                                       round_mode)
    g_row = g[..., :, None]
    return tmp_a * g_row, (grad_appx * g_row).sum(-2)


def _kernel_route(m, u, backend) -> bool:
    """Whether the score and its backward take the kernels: a
    [..., B, M, D] x [..., B, D] score with backend="kernel"."""
    _check_backend(backend)
    return backend == "kernel" and m.dim() >= 3 and u.dim() == m.dim() - 1


def _hamming_forward(m, u, iwl, num_bit, const_scale, round_mode, backend,
                     weight_para, weighted):
    if _kernel_route(m, u, backend):
        # leading dims before [B, M, D] (a family's runs) fold into B
        from qmann_tpu_torch.ops.cuda.hamming import hamming_score_kernel
        M, D = m.shape[-2:]
        s = hamming_score_kernel(m.reshape(-1, M, D), u.reshape(-1, D), iwl,
                                 num_bit, const_scale, round_mode,
                                 weight_para, weighted)
        return s.reshape(m.shape[:-1])
    return hamming_score_reference(m, u, iwl, num_bit, const_scale,
                                   round_mode, weight_para, weighted)


class _HammingScore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, m, u, iwl, num_bit, const_scale, round_mode, backend,
                weight_para, weighted):
        ctx.save_for_backward(m, u)
        ctx.knobs = (iwl, num_bit, const_scale, round_mode)
        ctx.kernel = _kernel_route(m, u, backend)
        return _hamming_forward(m, u, iwl, num_bit, const_scale, round_mode,
                                backend, weight_para, weighted)

    @staticmethod
    def backward(ctx, g):
        m, u = ctx.saved_tensors
        if ctx.kernel:   # the surrogate on the route the forward took
            from qmann_tpu_torch.ops.cuda.hamming_bwd import (
                hamming_backward_kernel)
            dm, du = hamming_backward_kernel(m, u, g, *ctx.knobs)
        else:
            dm, du = hamming_backward(m, u, g, *ctx.knobs)
        return (dm, du) + (None,) * 7


def hamming_score(m: torch.Tensor, u: torch.Tensor, iwl: int, num_bit: int,
                  const_scale: int = DEFAULT_CONST_SCALE,
                  round_mode: int = 3, backend: str = "plain",
                  weight_para: int = 0, weighted: bool = True
                  ) -> torch.Tensor:
    """Hamming-similarity attention score, m [..., M, D] x u [..., D] ->
    [..., M], differentiable through the surrogate backward.

    num_bit: the compared bits, 1 + iwl + frac of the layer's nominal
    format.  backend="kernel" runs a [..., B, M, D] x [..., B, D] forward
    and its surrogate backward through the CUDA kernels (bit-identical,
    but the query gradient's sum over the memory rows).  weight_para
    offsets the bit-weight exponent; weighted=False selects the unweighted
    bit-match count."""
    return _HammingScore.apply(m, u, iwl, num_bit, const_scale, round_mode,
                               backend, weight_para, weighted)


def binarize(x: torch.Tensor) -> torch.Tensor:
    """sign(x) with 0 -> +1."""
    return torch.where(x >= 0.0, 1.0, -1.0).to(torch.float32)


def binary_score(m: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Attention mode 4: binarize both operands, then the float dot
    product (exact: +-1 operands, integer partial sums).  No gradient
    flows through the binarization."""
    return torch.einsum("...md,...d->...m", binarize(m), binarize(u))


def attention_score(m: torch.Tensor, u: torch.Tensor, attention_mode: int,
                    fmt_att: QFormat, fmt_bin: QFormat,
                    num_bit: int | None = None,
                    const_scale: int = DEFAULT_CONST_SCALE,
                    backend: str = "plain", score_mod: str = "none",
                    hamming_weight_para: int = 0,
                    hamming_weighted: bool = True,
                    grad_quantized: bool = False) -> torch.Tensor:
    """Dispatch over the four attention modes.  Mode 3 takes its iwl and
    rounding mode from fmt_att and, by default, num_bit = 1 + iwl + frac;
    backend selects the Hamming forward's route.  score_mod ("none",
    "shift", "clip", see ``qlinear.qscore``) applies to the quantized dot
    of mode 2 only: mode 1 is float (the softmax is shift-invariant and
    nothing saturates) and the scores of modes 3 and 4 are bounded far
    below the format's bound."""
    if attention_mode == 1:
        return qscore(m, u, fmt_att, fmt_bin, quantized=False,
                      grad_quantized=grad_quantized)
    if attention_mode == 2:
        return qscore(m, u, fmt_att, fmt_bin, quantized=True,
                      score_mod=score_mod, grad_quantized=grad_quantized)
    if attention_mode == 3:
        nb = num_bit if num_bit is not None else 1 + fmt_att.iwl + fmt_att.frac
        return hamming_score(m, u, fmt_att.iwl, nb, const_scale,
                             fmt_att.mode, backend, hamming_weight_para,
                             hamming_weighted)
    if attention_mode == 4:
        return binary_score(m, u)
    raise ValueError(f"unknown attention mode {attention_mode}")
