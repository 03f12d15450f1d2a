"""Collectives with JAX's autograd semantics, and the memory-sharded
attention read (counterpart of ``qmann_tpu/parallel/distributed.py``).

Each rank holds a shard of the memory sentences [B, M/s, ...] and:
  1. scores its rows against the query;
  2. takes the global row max (``pmax``) and the global exp-sum
     (``psum``): one pair of numbers per row crosses the group;
  3. sums its quantized weighted-sum products, ``psum``s them and
     re-quantizes once.
The products lie on the 2^-frac grid, so their distributed sum is exact
in any order, and the single output requant after the psum keeps the
reference's semantics (lib/layer_cuda.cu:573).

``torch.distributed.all_reduce`` has no gradient, and
``torch.distributed.nn.functional.all_reduce`` all-reduces the cotangent
in its backward, which multiplies a replicated cotangent by the axis size
(the bug ``qmann_tpu/parallel/distributed.py`` documents).  So the port
writes JAX's pair, each an ``autograd.Function``:
  * ``psum``: forward all_reduce(SUM) (per-shard -> replicated),
    backward the identity;
  * ``vary`` (JAX's ``pcast(..., to="varying")``): forward the identity
    (replicated -> per-shard), backward all_reduce(SUM), which adds the
    shards' partial cotangents.
A caller that computes a replicated copy of one loss on every rank of a
group differentiates that loss divided by the number of copies
(``parallel/sharding.py``); the transposes then give each gradient
exactly once.  With no group (an axis of size 1) all three are the
identity.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from qmann_tpu_torch.config import QmannConfig
from qmann_tpu_torch.models import memn2n
from qmann_tpu_torch.numerics import fixed_max_float, quantize_ste
from qmann_tpu_torch.ops import activation, qmatvec, qsum
from qmann_tpu_torch.ops.attention import attention_score
from qmann_tpu_torch.ops.qlinear import (qscore_partial_sum,
                                         qweighted_partial_sum)
from qmann_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh

_NEG_LARGE = -1e30


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """all_reduce of a copy of x over group (x itself when group is
    None), outside autograd."""
    if group is None:
        return x
    y = x.detach().contiguous().clone()
    dist.all_reduce(y, op=op, group=group)
    return y


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Vary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group's ranks; the backward passes the (replicated)
    cotangent to each rank's summand."""
    return x if group is None else _PSum.apply(x, group)


def vary(x: torch.Tensor, group) -> torch.Tensor:
    """A replicated value entering per-rank work; the backward sums the
    ranks' cotangents."""
    return x if group is None else _Vary.apply(x, group)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """Max over the group's ranks of a value with no gradient."""
    return all_reduce(x.detach(), group, dist.ReduceOp.MAX)


def _attention_read_local(m_l, c_l, u, mask_l, cfg: QmannConfig, hop: int,
                          group):
    """One rank's share of the attention read over its memory rows.
    Returns (o, replicated over ``group``; p_l, this rank's rows).

    Under ``use_pallas`` (and ``use_pallas_hamming`` in mode 3) the mode-3
    score runs on the Hamming kernel, and its surrogate backward on the
    backward kernel (``ops.attention._HammingScore``); the weighted sum's
    quantized backward runs on its kernel (``ops.qlinear._QWeightedSum``);
    the read kernel fuses the softmax, which needs global statistics here,
    so the rest is the plain ops."""
    fmt_att, fmt_act = cfg.fmt_att[hop], cfg.fmt_act[hop]
    mask_l = mask_l.to(torch.bool)
    backend = "kernel" if (cfg.use_pallas or (
        cfg.attention_mode == 3 and cfg.use_pallas_hamming)) else "plain"
    if cfg.att_score_mod != "none" and cfg.attention_mode == 2:
        # the shift needs the GLOBAL row max of the raw product sums: each
        # shard's sum of quantized products without the output requant
        # (exact on the 2^-frac grid), the raw row maxima pmax'ed, then one
        # shift/clip and output requant per shard, bit-identical to the
        # dense qscore(score_mod); mode-2 dot forwards are quantized
        # whatever EN_FIXED_POINT says (lib/layer.c:205)
        raw_l = qscore_partial_sum(m_l, u, fmt_att, cfg.fmt_bin, True)
        if cfg.att_score_mod == "shift":
            raw_l = raw_l - pmax(raw_l.amax(-1), group)[..., None]
        else:   # clip: per element, no cross-shard statistic
            bound = torch.tensor(fixed_max_float(fmt_att.iwl, fmt_att.frac)
                                 - 2.0 ** (-fmt_att.frac),
                                 dtype=raw_l.dtype, device=raw_l.device)
            # JAX's clip: the gradient halves at a tie with the bound
            raw_l = torch.minimum(torch.maximum(raw_l, -bound), bound)
        scores_l = quantize_ste(raw_l, fmt_att)
    else:
        scores_l = attention_score(
            m_l, u, cfg.attention_mode, fmt_att, cfg.fmt_bin,
            num_bit=cfg.num_bits_attention,
            const_scale=cfg.attention_const_scale, backend=backend,
            hamming_weight_para=cfg.hamming_weight_para,
            hamming_weighted=cfg.hamming_weighted,
            grad_quantized=cfg.grad_quant_backward)
    scores_l = torch.where(mask_l, scores_l, _NEG_LARGE)

    # the softmax statistics: the max carries no gradient (it cancels in
    # the softmax's), the exp-sum is psum'ed and re-enters per rank
    gmax = pmax(scores_l.amax(-1), group)
    e = torch.where(mask_l, torch.exp(scores_l - gmax[..., None]), 0.0)
    total = psum(e.sum(-1), group)
    total = torch.where(total == 0.0, 1.0, total)
    p_l = e / vary(total, group)[..., None]

    # weighted sum: local partials on the exact 2^-frac grid, psum, one
    # output requant; the quantized backward is shard-local
    partial = qweighted_partial_sum(c_l, p_l, mask_l.to(torch.float32),
                                    fmt_act, cfg.wsum_quantized,
                                    cfg.wsum_grad_quantized, backend)
    o = psum(partial, group)
    if cfg.wsum_quantized:
        o = quantize_ste(o, fmt_act)
    return o, p_l


def memory_sharded_attention_read(mesh: Mesh, m, c, u, mask,
                                  cfg: QmannConfig, hop: int = 0):
    """The attention read over this rank's shard: m, c [B/d, M/s, D] and
    mask [B/d, M/s] (its rows of the batch over "data" and of the memory
    over "model"), u [B/d, D].  Returns (o [B/d, D], the same on every
    rank of the "model" axis; p [B/d, M/s], this rank's rows)."""
    group = mesh.group(MODEL_AXIS)
    return _attention_read_local(m, c, vary(u, group), mask, cfg, hop, group)


def memory_sharded_logits(model, memory, question, mask, cfg: QmannConfig,
                          mesh: Mesh) -> torch.Tensor:
    """The K-hop forward's logits over this rank's memory rows, each hop's
    read the distributed one (JAX's explicit step,
    ``qmann_tpu/parallel/explicit.py``).  ``model`` is a parameter dict, or
    a ``PreparedInference`` whose exact route gives the embeddings.  The
    lattices take the kernel under ``use_pallas``, on the local rows.
    Covers the default wiring (``sharding.reads_split_memory``), either
    tying."""
    group = mesh.group(MODEL_AXIS)
    backend = "kernel" if cfg.use_pallas else "plain"
    if isinstance(model, memn2n.PreparedInference):
        params = model.raw
        u, embeds = (memn2n.prepared_embed(model, memory, question, cfg)
                     if model.fast else
                     memn2n.embed(params, memory, question, cfg, backend))
    else:
        params = model
        u, embeds = memn2n.embed(params, memory, question, cfg, backend)
    q, K = cfg.en_fixed_point, cfg.num_hops
    for h in range(K):
        _, _, h_w = memn2n._hop_weights(params, cfg, h)
        o, _ = _attention_read_local(embeds[h], embeds[K + h], u, mask, cfg,
                                     h, group)
        o = vary(o, group)
        u_mapped = (qmatvec(h_w, u, cfg.fmt_w[h], cfg.fmt_bin, quantized=q,
                            backend=backend)
                    if cfg.en_linear_mapping else u)
        u = qsum(u_mapped, o, cfg.fmt_act[h], quantized=q)
        if cfg.en_non_linearity:
            u = activation(u, "RELU", cfg.fmt_act[h], q)
    return qmatvec(memn2n._output_weight(params, cfg), u, cfg.fmt_ds_ans,
                   cfg.fmt_ds_ans, quantized=False)
