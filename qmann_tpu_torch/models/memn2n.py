"""MemN2N forward, loss and serving-prepared forward on torch tensors
(counterpart of ``qmann_tpu/models/memn2n.py``).

The parameter layout is the JAX package's (float32 master weights):

  tying type 2 (layer-wise, default):
    A, C, B [D, I]; W [I, D]; H [D, D] when the linear map is on
  tying type 1 (adjacent):
    E [K+1, D, I] with A_h = E[h], C_h = E[h+1], B = E[0], W = E[K]^T;
    H [K, D, D] when the linear map is on
  scale [K] with EN_SC_ATT (starts at ones)
  maxout_w, maxout_b [5] with the maxout attention trial (test_maxout)

``params_from_jax`` / ``params_to_jax`` carry weights across, so the port
computes exactly what JAX computes on the same weights.

The forward is differentiable: every quantized op is an
``autograd.Function`` with the reference's raw-float backward
(``ops/qlinear.py``).  ``cfg.use_pallas`` selects the kernel backend: the
quantized embeddings and linear maps go through the lattice kernel
(``ops/cuda/qmatvec.py``) and each hop's read through the fused read
(``ops/fused.py``, kernel ``ops/cuda/attention_read.py``), as the JAX
package's Pallas backend does.  In attention mode 3 (the Hamming
similarity, ``ops/attention.py``) ``cfg.use_pallas_hamming`` sends the
score alone through the Hamming kernel (``ops/cuda/hamming.py``), as does
``use_pallas`` wherever the fused read is not used.

Every model feature of the JAX package runs: attention modes 1 to 4,
EN_SC_ATT (a learnable scale per hop before the softmax), the maxout
attention, cosine similarity, the shift-based and exp_plan softmax, the
score mitigations ("shift", "clip") and linear start (``remove_softmax``:
no softmax).  As in JAX, the fused read takes only the plain mode-1/2/3
hop with a softmax; a feature head, a score mitigation or linear start
runs the unfused hop, where the lattice kernel still carries the
embeddings and linear maps and, in mode 3, the Hamming kernel the score.
Under cosine similarity a zero memory row (every padded one) gets a zero
gradient through its norm, where JAX's gives NaN (ROADMAP.md, Queue 3).

Stacked parameters [R, ...] (``is_family``: the family trainer's,
``train/multi.py``) run R independent runs in one pass over inputs
[R, B, ...], as JAX's vmap does: the ops take the run axis (the lattice
kernel in its grid, the read and the Hamming kernel folded into their
batch), the weight pickers index a tying-type-1 stack's hop axis after
it, and ``loss_and_metrics`` keeps cost and matches per run.

Off ``use_pallas``, ``forward`` takes JAX's integer fast path where
``cfg.en_integer_fast_path`` is on, as JAX's does: the exact GEMM for each
run whose exactness predicate holds (bit-identical to the lattice).  The
single-run training step turns it off, as JAX's ``train_epoch`` does by
default.
"""
from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional

import numpy as np
import torch

from qmann_tpu_torch.config import QmannConfig
from qmann_tpu_torch.device import resolve_device
from qmann_tpu_torch.numerics import (fixed_max_float, float_quant,
                                      float_quant_blocks)
from qmann_tpu_torch.models.maxout import (init_maxout_params,
                                           maxout_attention)
from qmann_tpu_torch.ops import (CEMetrics, activation, apply_softmax,
                                 exact_matmul, qembed_mat_multi, qmatvec,
                                 qsum, qweighted_sum, scale_apply)
from qmann_tpu_torch.ops.attention import attention_score
from qmann_tpu_torch.ops.cuda import fused_hop_chain
from qmann_tpu_torch.ops.fused import fused_attention_read
from qmann_tpu_torch.ops.losses import argmax_last
from qmann_tpu_torch.ops.qlinear import integer_fast_ok

Params = Dict[str, torch.Tensor]


class ForwardResult(NamedTuple):
    logits: torch.Tensor         # [B, dim_input]
    attention: torch.Tensor      # [K, B, M] per-hop attention probabilities
    scores: torch.Tensor         # [K, B, M] per-hop pre-softmax scores


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
    if cfg.test_maxout:
        shapes["maxout_w"] = shapes["maxout_b"] = (5,)
    return shapes


def init_params(cfg: QmannConfig, dims, generator: torch.Generator,
                device="cuda") -> Params:
    """Gaussian(0, 0.1) init of every weight matrix and of the maxout
    pieces, drawn from ``generator`` (a CPU generator) and moved to
    ``device``; the scales start at 1.  The draws differ from jax.random's;
    tests carry JAX weights over with ``params_from_jax``."""
    dev = resolve_device(device)
    params = {}
    for k, shape in param_shapes(cfg, dims.dim_input).items():
        if k == "scale":
            params[k] = torch.ones(shape, dtype=torch.float32)
        elif not k.startswith("maxout"):
            params[k] = 0.1 * torch.randn(shape, generator=generator,
                                          dtype=torch.float32)
    if cfg.test_maxout:
        params["maxout_w"], params["maxout_b"] = init_maxout_params(generator)
    return {k: v.to(dev) for k, v in params.items()}


def params_from_jax(params: Mapping[str, np.ndarray], cfg: QmannConfig,
                    device="cuda") -> Params:
    """JAX-layout parameters (numpy arrays) -> float32 tensors on
    ``device``, copied (the trainer updates its tensors in place); keys and
    shapes are checked against ``cfg``."""
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
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(params[k], np.float32), device=dev)
            for k in want}


def params_to_jax(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Inverse of ``params_from_jax``: float32 numpy arrays."""
    return {k: v.detach().to("cpu", torch.float32).numpy()
            for k, v in params.items()}


def is_family(params: Params) -> bool:
    """True for stacked parameters [R, ...] (the family trainer's): the
    query embedding has one more leading axis than its [D, I] layout."""
    return (params["B"].dim() == 3 if "B" in params
            else params["E"].dim() == 4)


def _hop(params: Params, name: str, h: int) -> torch.Tensor:
    """Hop h of a tying-type-1 stack (E, H): its hop axis follows a
    family's run axis."""
    return params[name].select(1 if is_family(params) else 0, h)


def _hop_weights(params: Params, cfg: QmannConfig, h: int):
    if cfg.type_weight_tying == 1:
        hmat = _hop(params, "H", h) if cfg.en_linear_mapping else None
        return _hop(params, "E", h), _hop(params, "E", h + 1), hmat
    hmat = params["H"] if cfg.en_linear_mapping else None
    return params["A"], params["C"], hmat


def _query_weight(params: Params, cfg: QmannConfig):
    return _hop(params, "E", 0) if cfg.type_weight_tying == 1 else params["B"]


def _output_weight(params: Params, cfg: QmannConfig):
    if cfg.type_weight_tying == 1:
        return _hop(params, "E", cfg.num_hops).transpose(-2, -1)
    return params["W"]


def _integer_fast_decisions(cfg: QmannConfig, question, query_w, memory,
                            mem_ws, mem_fmts):
    """JAX's integer fast path on the plain route: per weight and run,
    whether its exactness predicate holds (the query embedding's needs
    integer questions, so not under EN_PE; a binary format never takes
    it), all read in one host sync.  Returns (the query's decision, or None
    for the lattice; one decision per memory weight, False for a binary
    one)."""
    f0 = cfg.fmt_w[0]
    slots = []
    if not cfg.en_pe and not f0.is_binary:
        slots.append(("q", integer_fast_ok(question, query_w, f0, f0)))
    slots += [(k, integer_fast_ok(memory, w, f, f))
              for k, (w, f) in enumerate(zip(mem_ws, mem_fmts))
              if not f.is_binary]
    if not slots:
        return None, None
    host = dict(zip([k for k, _ in slots],
                    torch.stack([p for _, p in slots]).cpu().numpy()))
    mem = [host.get(k, False) for k in range(len(mem_ws))]
    return host.get("q"), mem


def fast_path_reads_host(cfg: QmannConfig) -> bool:
    """Whether ``forward`` under cfg reads the integer fast path's
    decisions on the host (``_integer_fast_decisions``): on the plain
    route with the fast path on.  No CUDA graph can hold that read."""
    return (cfg.en_integer_fast_path and cfg.en_fixed_point
            and not cfg.use_pallas)


def forward(params: Params, memory: torch.Tensor, question: torch.Tensor,
            mask: torch.Tensor, cfg: QmannConfig,
            remove_softmax: bool = False) -> ForwardResult:
    """Batched K-hop forward on the lattice route (differentiable).

    memory [B, M, dim_input] bag-of-words rows; question [B, dim_input];
    mask [B, M] bool validity of memory rows; remove_softmax is linear
    start (the attention softmax bypassed).  Stacked parameters [R, ...]
    (``is_family``) take inputs [R, B, ...]: R independent runs in one
    pass.  ``cfg.en_integer_fast_path`` takes JAX's integer fast path on
    the plain route (module docstring; bit-identical either way)."""
    backend = "kernel" if cfg.use_pallas else "plain"
    u, embeds = embed(params, memory, question, cfg, backend)
    return _hop_stack(params, cfg, u, embeds, mask, remove_softmax, backend)


def embed(params: Params, memory: torch.Tensor, question: torch.Tensor,
          cfg: QmannConfig, backend: str):
    """The query embedding u and the 2K memory embeddings (A_0..A_{K-1},
    C_0..C_{K-1}) on ``backend``'s lattice, each memory row on its own:
    ``forward``'s first half."""
    q = cfg.en_fixed_point
    fmt_w = cfg.fmt_w
    K = cfg.num_hops
    hop_w = [_hop_weights(params, cfg, h) for h in range(K)]
    mem_ws = [w[0] for w in hop_w] + [w[1] for w in hop_w]
    mem_fmts = [fmt_w[h] for h in range(K)] * 2
    fast_q = fast_m = None
    if fast_path_reads_host(cfg) and backend == "plain":
        fast_q, fast_m = _integer_fast_decisions(
            cfg, question, _query_weight(params, cfg), memory, mem_ws,
            mem_fmts)
    u = qmatvec(_query_weight(params, cfg), question, fmt_w[0], fmt_w[0],
                quantized=q, backend=backend, fast=fast_q)
    embeds = qembed_mat_multi(memory, mem_ws, mem_fmts, quantized=q,
                              backend=backend, fast=fast_m)
    return u, embeds


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """x over its L2 norm on the last axis, floored at 1e-12.  The norm's
    backward at 0 is 0, so a zero row gets a zero gradient."""
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp_min(norm, 1e-12)


def _hop_stack(params: Params, cfg: QmannConfig, u: torch.Tensor, embeds,
               mask: torch.Tensor, remove_softmax: bool = False,
               backend: str = "plain") -> ForwardResult:
    """The K-hop controller loop given the query embedding u and the 2K
    memory embeddings (A_0..A_{K-1}, C_0..C_{K-1})."""
    q = cfg.en_fixed_point
    fmt_w, fmt_act, fmt_att = cfg.fmt_w, cfg.fmt_act, cfg.fmt_att
    mask = mask.to(torch.bool)
    mask_f = mask.to(torch.float32)
    K = cfg.num_hops
    # the dot_mat_vec family's quantization rules (QmannConfig's dispatch
    # properties)
    gq = cfg.grad_quant_backward
    wsum_q = cfg.wsum_quantized
    wsum_gq = cfg.wsum_grad_quantized
    # the fused read covers the plain mode-1/2/3 hop chain; feature heads,
    # softmax variants, linear start and the EN_GRAD_QUANT backward
    # placement (the fused backward is raw-float) keep the unfused chain,
    # as in qmann_tpu/models/memn2n.py
    use_fused = (backend == "kernel" and cfg.attention_mode in (1, 2, 3)
                 and not remove_softmax and not gq
                 and cfg.att_score_mod == "none"
                 and not (cfg.en_sc_att or cfg.test_maxout
                          or cfg.en_cosine_sim or cfg.en_shift_based_sm
                          or cfg.en_exp_table_based))
    # the unfused chain's score route: use_pallas_hamming sends the mode-3
    # score alone through the Hamming kernel
    att_backend = "kernel" if (cfg.attention_mode == 3
                               and cfg.use_pallas_hamming) else backend
    ham = dict(ham_num_bit=cfg.num_bits_attention,
               ham_const_scale=cfg.attention_const_scale,
               ham_weight_para=cfg.hamming_weight_para,
               ham_weighted=cfg.hamming_weighted)
    attn, scores_all = [], []
    for h in range(K):
        _, _, h_w = _hop_weights(params, cfg, h)
        m, c = embeds[h], embeds[K + h]
        if use_fused:
            o, p, scores = fused_attention_read(
                m, c, u, mask_f, fmt_att[h], cfg.fmt_bin, fmt_act[h],
                score_quantized=cfg.attention_mode == 2,
                sum_quantized=wsum_q, attention_mode=cfg.attention_mode,
                sum_grad_quantized=wsum_gq, **ham)
        else:
            if cfg.en_cosine_sim and cfg.attention_mode in (1, 2):
                m_sc, u_sc = _l2_normalize(m), _l2_normalize(u)
            else:
                m_sc, u_sc = m, u
            scores = attention_score(
                m_sc, u_sc, cfg.attention_mode, fmt_att[h], cfg.fmt_bin,
                num_bit=cfg.num_bits_attention,
                const_scale=cfg.attention_const_scale, backend=att_backend,
                score_mod=cfg.att_score_mod,
                hamming_weight_para=cfg.hamming_weight_para,
                hamming_weighted=cfg.hamming_weighted, grad_quantized=gq)
            if cfg.en_sc_att and not remove_softmax:
                # scale [K], or [R, K] for a family
                scores = scale_apply(params["scale"][..., h], scores)
            if cfg.test_maxout:
                mw, mb = params["maxout_w"], params["maxout_b"]
                if mw.dim() == 2:   # a family's pieces [R, 5]
                    mw, mb = mw[:, None, None], mb[:, None, None]
                p = maxout_attention(scores, mw, mb, mask)
            else:
                p = apply_softmax(scores, mask,
                                  shift_based=cfg.en_shift_based_sm,
                                  use_exp_plan=cfg.en_exp_table_based,
                                  remove=remove_softmax)
            o = qweighted_sum(c, p, mask_f, fmt_act[h], quantized=wsum_q,
                              grad_quantized=wsum_gq)
        if cfg.en_linear_mapping:
            u_mapped = qmatvec(h_w, u, fmt_w[h], cfg.fmt_bin, quantized=q,
                               backend=backend)
        else:
            u_mapped = u
        u = qsum(u_mapped, o, fmt_act[h], quantized=q)
        if cfg.en_non_linearity:
            u = activation(u, "RELU", fmt_act[h], q, grad_quantized=gq)
        attn.append(p)
        scores_all.append(scores)
    # the output layer runs float
    logits = qmatvec(_output_weight(params, cfg), u, cfg.fmt_ds_ans,
                     cfg.fmt_ds_ans, quantized=False)
    return ForwardResult(logits, torch.stack(attn), torch.stack(scores_all))


def loss_and_metrics(params: Params, memory: torch.Tensor,
                     question: torch.Tensor, answer: torch.Tensor,
                     mask: torch.Tensor, sample_mask: Optional[torch.Tensor],
                     cfg: QmannConfig, remove_softmax: bool = False):
    """Total (summed) loss over the valid samples of a batch and the
    reference's metrics.  sample_mask [B] (1 valid / 0 padding) covers the
    final partial batch; the cost is taken on detached probabilities and
    the prediction ties to the last index.  Returns (loss, CEMetrics).
    For a family (stacked parameters, inputs [R, B, ...], sample_mask
    [R, B]) the loss is the sum of the runs' losses, whose gradient is each
    run's own, and the cost and matches are per run [R]."""
    out = forward(params, memory, question, mask, cfg, remove_softmax)
    return loss_from_logits(out.logits, answer, sample_mask,
                            is_family(params))


def loss_from_logits(logits: torch.Tensor, answer: torch.Tensor,
                     sample_mask: Optional[torch.Tensor],
                     family: bool = False):
    """``loss_and_metrics`` given the logits: (loss, CEMetrics)."""
    logp = torch.log_softmax(logits, dim=-1)
    per_sample = -(answer * logp).sum(-1)
    probs = torch.exp(logp.detach())
    pred = argmax_last(logits.detach(), dim=-1)
    hit = torch.gather(answer, -1, pred[..., None])[..., 0]
    hits = (hit == 1.0).to(torch.float32)
    if family:
        sm = 1.0 if sample_mask is None else sample_mask
        loss_r = (per_sample * sm).sum(-1)
        cost = -((answer * probs).sum(-1) * sm).sum(-1)
        matches = (hits * sm).sum(-1)
        return loss_r.sum(), CEMetrics(loss=loss_r, cost=cost,
                                       matches=matches.to(torch.int32),
                                       pred=pred)
    if sample_mask is None:
        loss = per_sample.sum()
        cost = -(answer * probs).sum()
        matches = hits.sum()
    else:
        loss = (per_sample * sample_mask).sum()
        cost = -((answer * probs).sum(-1) * sample_mask).sum()
        matches = (hits * sample_mask).sum()
    return loss, CEMetrics(loss=loss, cost=cost,
                           matches=matches.to(torch.int32), pred=pred)


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
    # [K, D, D] Q(H[h], fmt_w[h]) for the chain kernel, where float_quant
    # is idempotent (every fmt_w of at most 30 bits), else None
    hmats_q: Optional[torch.Tensor] = None


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
    hmats_q = None
    if all(f.iwl + f.frac <= 30 for f in fmt_w):
        hmats_q = torch.stack([float_quant(hmats[h], fmt_w[h])
                               for h in range(K)])
    return PreparedInference(params, True, query_wt, embed_wt, hmats,
                             hmats_q)


def _use_chain(cfg: QmannConfig) -> bool:
    """The chain kernel's envelope: mode 2 or 3, quantized, no feature
    heads or score mitigations, no binary formats."""
    return (cfg.use_fused_chain and cfg.attention_mode in (2, 3)
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
    fmt_w = cfg.fmt_w
    u, flat = _prepared_gemms(prep, memory, question, cfg)
    if _use_chain(cfg):
        cached = prep.hmats_q is not None
        u_fin, p, s = fused_hop_chain(
            flat, u, prep.hmats_q if cached else prep.hmats, mask, fmt_w,
            cfg.fmt_att, cfg.fmt_bin,
            cfg.fmt_act, linear_mapping=cfg.en_linear_mapping,
            non_linearity=cfg.en_non_linearity,
            attention_mode=cfg.attention_mode,
            ham_num_bit=cfg.num_bits_attention,
            ham_const_scale=cfg.attention_const_scale,
            ham_weight_para=cfg.hamming_weight_para,
            ham_weighted=cfg.hamming_weighted, hmats_quantized=cached)
        logits = qmatvec(_output_weight(prep.raw, cfg), u_fin,
                         cfg.fmt_ds_ans, cfg.fmt_ds_ans, quantized=False)
        return ForwardResult(logits, p, s)
    return _hop_stack(prep.raw, cfg, u, _split_embeddings(flat, cfg), mask,
                      False, "kernel" if cfg.use_pallas else "plain")


def _split_embeddings(flat: torch.Tensor, cfg: QmannConfig):
    """The stacked GEMM output [..., 2K*D] -> the 2K quantized hop
    embeddings, each [..., D] in its hop's format."""
    K, D = cfg.num_hops, cfg.dim_emb
    flatq = float_quant_blocks(
        flat, tuple(cfg.fmt_w[i % K] for i in range(2 * K)), (D,) * (2 * K))
    return torch.split(flatq, D, dim=-1)


def _prepared_gemms(prep: PreparedInference, memory: torch.Tensor,
                    question: torch.Tensor, cfg: QmannConfig):
    """u = Q(B q) and the stacked 2K hop embeddings [B, M, 2K*D]: exact
    f32 GEMMs on the cached quantized transposes."""
    return (float_quant(exact_matmul(question, prep.query_wt), cfg.fmt_w[0]),
            exact_matmul(memory, prep.embed_wt))


def prepared_embed(prep: PreparedInference, memory: torch.Tensor,
                   question: torch.Tensor, cfg: QmannConfig):
    """``embed`` on the prepared exact route (``prep.fast``)."""
    u, flat = _prepared_gemms(prep, memory, question, cfg)
    return u, _split_embeddings(flat, cfg)
