"""SGD with the reference's per-matrix gradient clipping and schedule
(counterpart of ``qmann_tpu/train/optim.py``).

Update rule (float master weights):

    norm = "L2 norm" of the accumulated batch gradient
    w = w - lr/size_b * g * min(1, max_norm/norm) + lr * lambda * w

with the reference's quirks kept as they are:
  * the clip metric is the SUM OF PER-ROW L2 NORMS, not the Frobenius
    norm (``rowsum_l2_norm``); a stacked [K, D, I] parameter (tying type 1)
    is clipped per matrix;
  * the lin_map H gets half the clip threshold, and lr*0.1 under
    layer-wise tying (type 2);
  * the weight-decay term has the growth sign +lr*lambda*w;
  * the divisor is the batch's live sample count size_b;
  * EN_GRAD_QUANT's "update" placement quantizes the summed gradient once
    at the weight's format before the update (the "backward" placement
    lives in the ops' backwards, so nothing happens here);
  * the EN_SC_ATT scale is divided by batch_size * scale_dim (the score
    length), with no clip and no "update" quantization; the maxout pieces
    take plain SGD with no clip.

``sgd_update`` runs in place on the parameter tensors, under
``torch.no_grad()``, and never reads a value back to the host.  The
reference's commented-out alternatives, momentum SGD, RMSprop and AdaMax,
are functions over the params dict that return the new parameters and
state; the trainer does not call them.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple, Union

import torch

from qmann_tpu_torch.config import QmannConfig
from qmann_tpu_torch.numerics import float_quant

Params = Dict[str, torch.Tensor]
Scalar = Union[float, torch.Tensor]


def rowsum_l2_norm(g: torch.Tensor) -> torch.Tensor:
    """Sum of per-row L2 norms over the last axis, per matrix of the
    leading axes (a scalar for a matrix, [K] for a [K, D, I] stack, [R] or
    [R, K] for a family's)."""
    return torch.sqrt((g * g).sum(-1)).sum(-1)


def _clip_scale(g: torch.Tensor, max_norm: float) -> torch.Tensor:
    norm = rowsum_l2_norm(g)
    return torch.where(norm > max_norm, max_norm / norm, 1.0)


@torch.no_grad()
def sgd_update(params: Params, grads: Mapping[str, torch.Tensor], lr: Scalar,
               batch_size: Scalar, cfg: QmannConfig,
               scale_dim: int = 1) -> Params:
    """One reference SGD step on every parameter, in place; returns params.

    grads are summed over the batch; batch_size is the live sample count
    of the batch (the last batch divides by its remainder).  lr and
    batch_size may be float32 tensors on the parameters' device, so the
    step never synchronizes with the host.  scale_dim is the attention
    score length in the scale's batch_size * dim divisor.  For a family
    (stacked parameters [R, ...]) batch_size is per run [R], and each run's
    matrices are clipped on their own."""
    lam = float(cfg.lambda_)
    per_run = isinstance(batch_size, torch.Tensor) and batch_size.dim() == 1
    for name, w in params.items():
        g = grads[name]
        if (cfg.en_grad_quant and cfg.grad_quant_placement == "update"
                and name != "scale"):
            fmt = cfg.fmt_ds_ans if name == "W" else cfg.fmt_w[0]
            g = float_quant(g, fmt)
        div, max_norm, lr_eff = batch_size, cfg.max_grad_l2_norm, lr
        if name == "scale":
            # no clip; the divisor is batch_size * dim
            div, max_norm = batch_size * float(scale_dim), None
        elif name in ("maxout_w", "maxout_b"):
            max_norm = None
        elif name == "H":
            max_norm = cfg.max_grad_l2_norm / 2.0
            # the 0.1 lin_map factor belongs to the layer-wise tying branch
            lr_eff = lr * 0.1 if cfg.type_weight_tying == 2 else lr
        if cfg.en_max_grad_l2_norm and max_norm is not None:
            # one clip per matrix of the last two axes
            scale = _clip_scale(g, max_norm)
            g = g * (scale[..., None, None] if g.dim() >= 3 else scale)
        if per_run:
            div = div.reshape((-1,) + (1,) * (w.dim() - 1))
        # w - lr_eff/div * g + lr_eff*lambda*w, in the reference's order
        decay = w * (lr_eff * lam)
        w.sub_(g * (lr_eff / div)).add_(decay)
    return params


@torch.no_grad()
def zero_null_columns(params: Params, cfg: QmannConfig) -> Params:
    """ZEROING_NULL_WEIGHT: after every batch update the NULL-word (index 0)
    input column of the memory embeddings is zeroed in place (emb_m and
    emb_c only, not emb_q or ds_ans); the last axis is the input, also
    for a family's stacked parameters."""
    if not cfg.zeroing_null_weight:
        return params
    if cfg.type_weight_tying == 1:
        # emb_m[h] = E[0..K-1], emb_c[h] = E[1..K] -> all chain matrices
        params["E"][..., 0] = 0.0
    else:
        params["A"][..., 0] = 0.0
        params["C"][..., 0] = 0.0
    return params


def _f32(x: Scalar, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def sgd_momentum_update(params: Mapping[str, torch.Tensor],
                        grads: Mapping[str, torch.Tensor],
                        velocity: Mapping[str, torch.Tensor], lr: Scalar,
                        batch_size: Scalar, cfg: QmannConfig,
                        momentum: float = 0.9) -> Tuple[Params, Params]:
    """Momentum SGD, the reference's commented-out alternative:
    v = momentum * v + lr / size_b * g; w = w - v + lr * lambda * w.  The
    lr sits inside the velocity and there is no clip.  Returns (params,
    velocity), new tensors."""
    lam = float(cfg.lambda_)
    new_p, new_v = {}, {}
    for k, w in params.items():
        lr_t, bs = _f32(lr, w), _f32(batch_size, w)
        new_v[k] = momentum * velocity[k] + lr_t / bs * grads[k]
        new_p[k] = w - new_v[k] + lr_t * lam * w
    return new_p, new_v


def rmsprop_update(params: Mapping[str, torch.Tensor],
                   grads: Mapping[str, torch.Tensor],
                   second_moment: Mapping[str, torch.Tensor], lr: Scalar,
                   batch_size: Scalar, cfg: QmannConfig, decay: float = 0.9,
                   eps: float = 1e-8) -> Tuple[Params, Params]:
    """RMSprop, the reference's commented-out alternative:
    a = decay * a + (1 - decay) * g^2;
    w = w - lr / size_b * g / (sqrt(a) + eps) + lr * lambda * w (eps
    guards the division the reference leaves unguarded).  Returns (params,
    second moment)."""
    lam = float(cfg.lambda_)
    new_p, new_m = {}, {}
    for k, w in params.items():
        lr_t, bs, g = _f32(lr, w), _f32(batch_size, w), grads[k]
        new_m[k] = decay * second_moment[k] + (1 - decay) * g * g
        new_p[k] = (w - lr_t / bs * g / (torch.sqrt(new_m[k]) + eps)
                    + lr_t * lam * w)
    return new_p, new_m


def adamax_update(params: Mapping[str, torch.Tensor],
                  grads: Mapping[str, torch.Tensor],
                  state: Tuple[Mapping[str, torch.Tensor],
                               Mapping[str, torch.Tensor]],
                  lr: Scalar, batch_size: Scalar, cfg: QmannConfig, t=None,
                  b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
                  ) -> Tuple[Params, Tuple[Params, Params]]:
    """AdaMax, the reference's commented-out alternative:
    m = b1 * m + (1 - b1) * g; v = max(b2 * v, |g|);
    w = w - lr / (1 - b1) * m / (v + eps).  The denominator is the constant
    1 - b1, not the b1^t bias correction of the published AdaMax (t is
    accepted and ignored), and batch_size and lambda are unused, as in the
    reference.  Returns (params, (m, v))."""
    m, v = state
    new_p, new_m, new_v = {}, {}, {}
    for k, w in params.items():
        g = grads[k]
        new_m[k] = b1 * m[k] + (1 - b1) * g
        new_v[k] = torch.maximum(b2 * v[k], g.abs())
        new_p[k] = w - _f32(lr, w) / (1.0 - b1) * new_m[k] / (new_v[k] + eps)
    return new_p, (new_m, new_v)


def lr_schedule(cfg: QmannConfig):
    """Generator of (epoch, lr, remove_softmax) replicating
    MemN2N/MemN2N.c:1078-1099: during linear start (the first
    num_itr_linear_start epochs when enabled) the softmax is removed and
    lr = LR/2; afterwards lr restarts at LR and halves every
    RATE_DECAY_STEP epochs (counted from the linear-start boundary,
    excluding the boundary itself).  With linear start the run is extended
    to NUM_ITR + NUM_ITR_LINEAR_START epochs."""
    nls = cfg.num_itr_linear_start if cfg.en_linear_start else 0
    lr = cfg.learning_rate
    was_removed = False
    for itr in range(cfg.num_itr + nls):
        if cfg.en_linear_start and itr < nls:
            yield itr, cfg.learning_rate / 2.0, True
            was_removed = True
            continue
        if was_removed:
            lr = cfg.learning_rate
            was_removed = False
        if (itr - nls) % cfg.rate_decay_step == 0 and itr != nls:
            lr = lr / 2.0
        yield itr, lr, False
