"""The fused attention read as a differentiable op (counterpart of
``qmann_tpu/ops/fused.py``).

Forward: ``ops/cuda/attention_read.py`` — one hand-written CUDA kernel for
the whole hop read (score -> masked softmax -> weighted sum) on CUDA
tensors, its plain PyTorch version on CPU tensors.

Backward: the raw-float composition of the three ops' reference backwards,
in plain PyTorch as in JAX (no kernel is owed: the TPU package has none):
the weighted-sum backward (float, or the quantized contractions under
``sum_grad_quantized``), then the softmax backward p*(dp - sum(p*dp)),
then the score backward on the raw m and u: the float qscore backward in
modes 1 and 2, the reference's Hamming surrogate in mode 3
(``ops.attention.hamming_backward``).  So training through the kernel is
gradient-identical to the unfused op chain.
"""
from __future__ import annotations

import torch

from qmann_tpu_torch.numerics import QFormat
from qmann_tpu_torch.ops.attention import hamming_backward
from qmann_tpu_torch.ops.cuda.attention_read import fused_read
from qmann_tpu_torch.ops.qlinear import qweighted_sum_backward
from qmann_tpu_torch.ops.softmax import softmax_backward


class _FusedAttentionRead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, m, c, u, mask_f, fmt_att, fmt_bin, fmt_act,
                score_quantized, sum_quantized, attention_mode,
                sum_grad_quantized, ham_num_bit, ham_const_scale,
                ham_weight_para, ham_weighted):
        # leading dims before [B, M, D] (a family's run axis) fold into
        # the kernel's queries: the read takes only per-query operands
        lead, (M, D) = m.shape[:-2], m.shape[-2:]
        o, p, scores = fused_read(
            m.reshape(-1, M, D), c.reshape(-1, M, D), u.reshape(-1, D),
            mask_f.reshape(-1, M), fmt_att, fmt_bin, fmt_act,
            score_quantized, sum_quantized, attention_mode, ham_num_bit,
            ham_const_scale, ham_weight_para, ham_weighted)
        o, p, scores = (o.reshape(*lead, D), p.reshape(*lead, M),
                        scores.reshape(*lead, M))
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(m, c, u, mask_f, p)
        ctx.fmt_act, ctx.sum_grad_quantized = fmt_act, sum_grad_quantized
        # the surrogate's knobs: weight_para and weighted change the
        # forward only
        ctx.hamming = ((fmt_att.iwl, ham_num_bit, ham_const_scale,
                        fmt_att.mode) if attention_mode == 3 else None)
        return o, p, scores

    @staticmethod
    def backward(ctx, do, dp_in, ds_in):
        # cotangents of unused outputs arrive as None
        m, c, u, mask_f, p = ctx.saved_tensors
        dm = dc = du = None
        dp = dp_in
        if do is not None:
            dc, dp_o = qweighted_sum_backward(c, p, mask_f, do, ctx.fmt_act,
                                              ctx.sum_grad_quantized)
            dp = dp_o if dp is None else dp_o + dp
        ds = ds_in
        if dp is not None:
            ds_p = softmax_backward(p, dp)   # padded entries have p == 0
            ds = ds_p if ds is None else ds_p + ds
        if ds is not None and ctx.hamming is not None:
            dm, du = hamming_backward(m, u, ds, *ctx.hamming)
        elif ds is not None:
            # the float qscore backward on the raw m, u (the fused read's
            # VJP is raw-float: EN_GRAD_QUANT keeps the unfused chain)
            dm = ds[..., :, None] * u[..., None, :]
            du = torch.einsum("...md,...m->...d", m, ds)
        return (dm, dc, du) + (None,) * 12


def fused_attention_read(m: torch.Tensor, c: torch.Tensor, u: torch.Tensor,
                         mask_f: torch.Tensor, fmt_att: QFormat,
                         fmt_bin: QFormat, fmt_act: QFormat,
                         score_quantized: bool = True,
                         sum_quantized: bool = True,
                         attention_mode: int = 2,
                         sum_grad_quantized: bool = False,
                         ham_num_bit: int = 8, ham_const_scale: int = -3,
                         ham_weight_para: int = 0,
                         ham_weighted: bool = True):
    """m, c: [B, M, D]; u: [B, D]; mask_f: [B, M] float (1 live / 0 pad)
    -> (o [B, D], p [B, M], scores [B, M]); leading dims before B (a
    family's runs [R, B, ...]) fold into the kernel's batch.

    Equal to attention_score (mode 1, 2 or 3) -> softmax -> qweighted_sum
    (scores raw, before the mask, as the unfused path reports them);
    sum_grad_quantized selects the weighted sum's quantized backward
    contractions (always, in fixed-point mode 3); the ham_* knobs are
    the mode-3 score's."""
    return _FusedAttentionRead.apply(m, c, u, mask_f, fmt_att, fmt_bin,
                                     fmt_act, score_quantized, sum_quantized,
                                     attention_mode, sum_grad_quantized,
                                     ham_num_bit, ham_const_scale,
                                     ham_weight_para, ham_weighted)
