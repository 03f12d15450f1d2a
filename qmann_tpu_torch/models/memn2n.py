"""MemN2N forward and serving-prepared forward on torch tensors
(counterpart of ``qmann_tpu/models/memn2n.py``; forward only).

The parameter layout is the JAX package's (float32 master weights):

  tying type 2 (layer-wise, default):
    A, C, B [D, I]; W [I, D]; H [D, D] when the linear map is on
  tying type 1 (adjacent):
    E [K+1, D, I] with A_h = E[h], C_h = E[h+1], B = E[0], W = E[K]^T;
    H [K, D, D] when the linear map is on
  scale [K] with EN_SC_ATT

``params_from_jax`` / ``params_to_jax`` carry weights across, so the port
computes exactly what JAX computes on the same weights.

Ported: attention modes 1 and 2 with no feature head.  Mode 3 (Hamming),
EN_SC_ATT, maxout, cosine similarity, shift-based and exp_plan softmax,
the score mitigations and linear start raise NotImplementedError; they wait
for later PRs (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional

import numpy as np
import torch

from qmann_tpu_torch.config import QmannConfig
from qmann_tpu_torch.numerics import (fixed_max_float, float_quant,
                                      float_quant_blocks)
from qmann_tpu_torch.ops import (activation, exact_matmul, qembed_mat_multi,
                                 qmatvec, qscore, qsum, qweighted_sum,
                                 softmax)
from qmann_tpu_torch.ops.cuda import fused_hop_chain

Params = Dict[str, torch.Tensor]


class ForwardResult(NamedTuple):
    logits: torch.Tensor         # [B, dim_input]
    attention: torch.Tensor      # [K, B, M] per-hop attention probabilities
    scores: torch.Tensor         # [K, B, M] per-hop pre-softmax scores


def _check_supported(cfg: QmannConfig) -> None:
    missing = [name for name, on in (
        (f"attention mode {cfg.attention_mode}",
         cfg.attention_mode not in (1, 2)),
        ("en_sc_att", cfg.en_sc_att),
        ("test_maxout", cfg.test_maxout),
        ("en_cosine_sim", cfg.en_cosine_sim),
        ("en_shift_based_sm", cfg.en_shift_based_sm),
        ("en_exp_table_based", cfg.en_exp_table_based),
        (f"score_mod {cfg.att_score_mod!r}", cfg.att_score_mod != "none"),
    ) if on]
    if missing:
        raise NotImplementedError(
            f"not ported to qmann_tpu_torch yet: {', '.join(missing)} "
            "(ROADMAP.md, Queue 1)")


def param_shapes(cfg: QmannConfig, dim_input: int) -> Dict[str, tuple]:
    """Expected parameter keys and shapes for ``cfg`` (JAX layout)."""
    D, I, K = cfg.dim_emb, dim_input, cfg.num_hops
    if cfg.type_weight_tying == 1:
        shapes = {"E": (K + 1, D, I)}
        if cfg.en_linear_mapping:
            shapes["H"] = (K, D, D)
    else:
        shapes = {"A": (D, I), "C": (D, I), "B": (D, I), "W": (I, D)}
        if cfg.en_linear_mapping:
            shapes["H"] = (D, D)
    if cfg.en_sc_att:
        shapes["scale"] = (K,)
    return shapes


def init_params(cfg: QmannConfig, dims, generator: torch.Generator,
                device="cpu") -> Params:
    """Gaussian(0, 0.1) init of every weight matrix, drawn from
    ``generator`` (a CPU generator) and moved to ``device``.  The draws
    differ from jax.random's; tests carry JAX weights over with
    ``params_from_jax``."""
    _check_supported(cfg)
    return {k: (0.1 * torch.randn(shape, generator=generator,
                                  dtype=torch.float32)).to(device)
            for k, shape in param_shapes(cfg, dims.dim_input).items()}


def params_from_jax(params: Mapping[str, np.ndarray], cfg: QmannConfig,
                    device="cpu") -> Params:
    """JAX-layout parameters (numpy arrays) -> float32 tensors on
    ``device``; keys and shapes are checked against ``cfg``."""
    if "A" in params:
        dim_input = np.shape(params["A"])[1]
    elif "E" in params:
        dim_input = np.shape(params["E"])[2]
    else:
        raise ValueError("params hold neither 'A' nor 'E'")
    want = param_shapes(cfg, dim_input)
    if set(params) != set(want):
        raise ValueError(f"parameter keys {sorted(params)} do not match the "
                         f"config's {sorted(want)}")
    for k, shape in want.items():
        if tuple(np.shape(params[k])) != shape:
            raise ValueError(f"parameter {k!r} has shape "
                             f"{tuple(np.shape(params[k]))}, expected {shape}")
    return {k: torch.as_tensor(np.asarray(params[k], np.float32)).to(device)
            for k in want}


def params_to_jax(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Inverse of ``params_from_jax``: float32 numpy arrays."""
    return {k: v.detach().to("cpu", torch.float32).numpy()
            for k, v in params.items()}


def _hop_weights(params: Params, cfg: QmannConfig, h: int):
    if cfg.type_weight_tying == 1:
        hmat = params["H"][h] if cfg.en_linear_mapping else None
        return params["E"][h], params["E"][h + 1], hmat
    hmat = params["H"] if cfg.en_linear_mapping else None
    return params["A"], params["C"], hmat


def _query_weight(params: Params, cfg: QmannConfig):
    return params["E"][0] if cfg.type_weight_tying == 1 else params["B"]


def _output_weight(params: Params, cfg: QmannConfig):
    if cfg.type_weight_tying == 1:
        return params["E"][cfg.num_hops].transpose(0, 1)
    return params["W"]


def forward(params: Params, memory: torch.Tensor, question: torch.Tensor,
            mask: torch.Tensor, cfg: QmannConfig,
            remove_softmax: bool = False) -> ForwardResult:
    """Batched K-hop forward on the lattice route.

    memory [B, M, dim_input] bag-of-words rows; question [B, dim_input];
    mask [B, M] bool validity of memory rows."""
    if remove_softmax:
        raise NotImplementedError(
            "linear start (remove_softmax) is not ported yet "
            "(ROADMAP.md, Queue 1)")
    _check_supported(cfg)
    q = cfg.en_fixed_point
    fmt_w = cfg.fmt_w
    K = cfg.num_hops
    u = qmatvec(_query_weight(params, cfg), question, fmt_w[0], fmt_w[0],
                quantized=q)
    hop_w = [_hop_weights(params, cfg, h) for h in range(K)]
    embeds = qembed_mat_multi(
        memory, [w[0] for w in hop_w] + [w[1] for w in hop_w],
        [fmt_w[h] for h in range(K)] * 2, quantized=q)
    return _hop_stack(params, cfg, u, embeds, mask)


def _hop_stack(params: Params, cfg: QmannConfig, u: torch.Tensor, embeds,
               mask: torch.Tensor) -> ForwardResult:
    """The K-hop controller loop given the query embedding u and the 2K
    memory embeddings (A_0..A_{K-1}, C_0..C_{K-1})."""
    q = cfg.en_fixed_point
    fmt_w, fmt_act, fmt_att = cfg.fmt_w, cfg.fmt_act, cfg.fmt_att
    mask = mask.to(torch.bool)
    mask_f = mask.to(torch.float32)
    K = cfg.num_hops
    attn, scores_all = [], []
    for h in range(K):
        _, _, h_w = _hop_weights(params, cfg, h)
        m, c = embeds[h], embeds[K + h]
        scores = qscore(m, u, fmt_att[h], cfg.fmt_bin,
                        quantized=cfg.attention_mode == 2)
        p = softmax(scores, mask)
        o = qweighted_sum(c, p, mask_f, fmt_act[h],
                          quantized=cfg.wsum_quantized)
        if cfg.en_linear_mapping:
            u_mapped = qmatvec(h_w, u, fmt_w[h], cfg.fmt_bin, quantized=q)
        else:
            u_mapped = u
        u = qsum(u_mapped, o, fmt_act[h], quantized=q)
        if cfg.en_non_linearity:
            u = activation(u, "RELU", fmt_act[h], q)
        attn.append(p)
        scores_all.append(scores)
    # the output layer runs float
    logits = qmatvec(_output_weight(params, cfg), u, cfg.fmt_ds_ans,
                     cfg.fmt_ds_ans, quantized=False)
    return ForwardResult(logits, torch.stack(attn), torch.stack(scores_all))


# ---------------------------------------------------------------------------
# Serving-prepared inference
# ---------------------------------------------------------------------------

class PreparedInference(NamedTuple):
    """Inference-layout parameters produced by prepare_inference."""
    raw: Params                         # original parameters (fallback path)
    fast: bool                          # static exact-GEMM route decision
    query_wt: Optional[torch.Tensor]    # [I, D] quantized emb_q, transposed
    embed_wt: Optional[torch.Tensor]    # [I, 2K*D] stacked quantized A/C
    hmats: Optional[torch.Tensor]       # [K, D, D] raw lin maps for the chain


def prepare_inference(params: Params, cfg: QmannConfig,
                      max_count: float = 16.0,
                      max_rowsum: float = 128.0) -> PreparedInference:
    """Freeze params into serving layout, on the params' device.

    max_count / max_rowsum bound the incoming bag-of-words features (the
    largest single count and the largest per-row count sum).  The exact
    GEMM route is enabled only if, under these bounds, every per-product
    re-quantization of the embeddings is the identity and every partial
    sum is f32-exact; the check runs once, on the host, against the frozen
    weights."""
    _check_supported(cfg)
    K = cfg.num_hops
    fmt_w = cfg.fmt_w
    fmts = tuple(fmt_w[h] for h in range(K)) * 2 + (fmt_w[0],)
    hop_w = [_hop_weights(params, cfg, h) for h in range(K)]
    mats = ([w[0] for w in hop_w] + [w[1] for w in hop_w]
            + [_query_weight(params, cfg)])
    fast = (cfg.en_fixed_point and not cfg.en_pe
            and not any(f.is_binary for f in fmts))
    quantized = [float_quant(w, f) for w, f in zip(mats, fmts)] if fast else []
    for wq, fmt in zip(quantized, fmts):
        maxf = fixed_max_float(fmt.iwl, fmt.frac)
        max_wq = float(wq.abs().max())
        if not (max_count <= maxf and max_count * max_wq <= maxf
                and max_rowsum * max_wq * 2.0 ** fmt.frac < 2.0 ** 24):
            fast = False
            break
    if not fast:
        return PreparedInference(params, False, None, None, None)
    embed_wt = torch.cat([wq.transpose(0, 1) for wq in quantized[:-1]],
                         dim=1).contiguous()
    query_wt = quantized[-1].transpose(0, 1).contiguous()
    D = cfg.dim_emb
    if not cfg.en_linear_mapping:
        hmats = torch.zeros((K, D, D), dtype=torch.float32,
                            device=query_wt.device)
    elif cfg.type_weight_tying == 1:
        hmats = params["H"].contiguous()
    else:
        hmats = params["H"].expand(K, D, D).contiguous()
    return PreparedInference(params, True, query_wt, embed_wt, hmats)


def _use_chain(cfg: QmannConfig) -> bool:
    """The chain kernel's envelope: mode 2, quantized, no feature heads or
    score mitigations, no binary formats.  Mode 3 stays out until its
    in-chain Hamming score is ported."""
    return (cfg.use_fused_chain and cfg.attention_mode == 2
            and cfg.en_fixed_point and cfg.att_score_mod == "none"
            and not (cfg.en_sc_att or cfg.test_maxout or cfg.en_cosine_sim
                     or cfg.en_shift_based_sm or cfg.en_exp_table_based)
            and not cfg.fmt_bin.is_binary
            and not any(f.is_binary for f in cfg.fmt_w))


def forward_prepared(prep: PreparedInference, memory: torch.Tensor,
                     question: torch.Tensor, mask: torch.Tensor,
                     cfg: QmannConfig) -> ForwardResult:
    """Equal to forward() under prepare_inference's bounds, with no per-call
    weight processing."""
    if not prep.fast:
        return forward(prep.raw, memory, question, mask, cfg)
    K = cfg.num_hops
    fmt_w = cfg.fmt_w
    D = prep.query_wt.shape[1]
    # u = B q and all 2K hop embeddings: exact f32 GEMMs on the cached
    # quantized transposes
    u = float_quant(exact_matmul(question, prep.query_wt), fmt_w[0])
    flat = exact_matmul(memory, prep.embed_wt)                # [B, M, 2K*D]
    if _use_chain(cfg):
        u_fin, p, s = fused_hop_chain(
            flat, u, prep.hmats, mask, fmt_w, cfg.fmt_att, cfg.fmt_bin,
            cfg.fmt_act, linear_mapping=cfg.en_linear_mapping,
            non_linearity=cfg.en_non_linearity,
            attention_mode=cfg.attention_mode)
        logits = qmatvec(_output_weight(prep.raw, cfg), u_fin,
                         cfg.fmt_ds_ans, cfg.fmt_ds_ans, quantized=False)
        return ForwardResult(logits, p, s)
    flatq = float_quant_blocks(
        flat, tuple(fmt_w[i % K] for i in range(2 * K)), (D,) * (2 * K))
    embeds = torch.split(flatq, D, dim=-1)
    return _hop_stack(prep.raw, cfg, u, embeds, mask)
