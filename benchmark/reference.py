"""The plain reference of the benchmark's MemN2N: Q-MANN's K-hop memory
network with Q-format fake quantization, its raw-float (straight-through)
backward and the reference's SGD step, in plain PyTorch.

It imports nothing of the program under test and takes nothing the program
made: it reads a configuration file's ``model`` fields, the weights the
benchmark drew and the stories the benchmark generated, and works out
again whatever the program's set-up derives from them (the per-hop
formats, the serving route's frozen weights).  It follows the semantics of
the reference C code as the repository's packages document them
(``qmann_tpu/ops/qlinear.py``, ``ops/attention.py``, ``train/optim.py``):

* forward: each operand quantized in its format, each product requantized
  to the first operand's, the products summed in float32, the sum
  requantized; the sums are exact on the 2^-frac grid, so their order
  does not matter.  Attention mode 2 is the quantized dot product, mode 3
  the Hamming similarity of the 32-bit sign-magnitude words; the softmax
  is masked; the output layer is a float32 product;
* backward: through every quantized op as if it were the float op, on the
  raw operands (mode 3: the reference's surrogate gradient, and the
  weighted sum's quantized contractions);
* SGD: the clip on the sum of row L2 norms (the linear map at half the
  threshold and a tenth of the rate under layer-wise tying), the live
  sample count as the divisor, the NULL columns of A and C zeroed after
  each step, and a family's all-padding batch leaving its run unchanged.

Everything runs on stacked parameters [R, ...] (a single run is R = 1),
in float32 with TF32 off, in blocks of rows that fit the card.
``Reference(control=True)`` is the benchmark's control: the same
computation with every matrix product's operands rounded to TF32 (10
significand bits, to nearest), the precision just below the float32 that
the configurations state.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

ROUND_DOWN, ROUND_UP, ROUND_NEAREST_EVEN, ROUND_TOWARD_ZERO = 0, 1, 2, 3
_INT32_SAT = 2147483648.0
_SIGN = -(2 ** 31)
_MAG = 0x7FFFFFFF
# elements of a lattice block's product tensor
BLOCK_ELEMENTS = 1 << 27
# the model fields the reference takes as these values
SUPPORTED = {"en_fixed_point": True, "binary_mode": False,
             "en_grad_quant": False, "en_time": True, "en_pe": False,
             "type_weight_tying": 2, "en_linear_mapping": True,
             "en_non_linearity": False, "en_sc_att": False,
             "test_maxout": False, "en_cosine_sim": False,
             "en_shift_based_sm": False, "en_exp_table_based": False,
             "en_linear_start": False}


class Fmt(NamedTuple):
    iwl: int
    frac: int
    mode: int = ROUND_TOWARD_ZERO


def fmax(f: Fmt) -> float:
    """The saturation bound (2^(iwl+frac) - 1) / 2^frac in float32."""
    return float(np.float32(np.float32((1 << (f.iwl + f.frac)) - 1)
                            / np.float32(1 << f.frac)))


def _round(x: torch.Tensor, mode: int) -> torch.Tensor:
    if mode == ROUND_DOWN:
        return torch.floor(x)
    if mode == ROUND_UP:
        return torch.ceil(x)
    if mode == ROUND_NEAREST_EVEN:
        return torch.round(x)
    return torch.trunc(x)


def fq(x: torch.Tensor, f: Fmt) -> torch.Tensor:
    """Float -> sign-magnitude Q(iwl.frac) -> float, saturating at
    +-fmax; iwl+frac == 0 binarizes (0 -> +1)."""
    if f.iwl + f.frac == 0:
        return torch.where(x >= 0.0, 1.0, -1.0)
    m = fmax(f)
    scaled = x * (2.0 ** f.frac)
    q = _round(scaled, f.mode).clamp(-_INT32_SAT, _INT32_SAT)
    deq = q * (2.0 ** -f.frac)
    if f.iwl + f.frac == 31:
        deq = torch.where(scaled <= -_INT32_SAT, 0.0, deq)
    return torch.where(x > m, m, torch.where(x < -m, -m, deq))


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 significand bits), to nearest, ties to
    even."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


class Formats(NamedTuple):
    w: tuple        # per hop
    act: Fmt
    att: Fmt
    bin: Fmt
    num_bit: int


def formats(model: dict) -> Formats:
    """The per-hop formats a configuration's fields give (MemN2N.c's
    wiring): activations, attention and the dot's second operand at (iwl,
    frac = bw_wl - 1 - iwl); EN_MQ moves hop 0's weights one bit up and
    hop 2's one bit down where the format allows."""
    iwl, mode, K = model["iwl"], model["quant_mode"], model["num_hops"]
    frac = model["bw_wl"] - 1 - iwl
    w = [[iwl, frac] for _ in range(K)]
    if model["en_mq"] and K >= 3:
        if w[0][1] >= 1:
            w[0] = [iwl + 1, frac - 1]
        if w[2][0] >= 1:
            w[2] = [iwl - 1, frac + 1]
    base = Fmt(iwl, frac, mode)
    return Formats(tuple(Fmt(a, b, mode) for a, b in w), base, base, base,
                   1 + iwl + frac)


# ---------------------------------------------------------------------------
# Hamming similarity (attention mode 3)
# ---------------------------------------------------------------------------

def _words(x: torch.Tensor, iwl: int, mode: int) -> torch.Tensor:
    """float32 -> 32-bit sign-magnitude word at (iwl, 31 - iwl)."""
    frac = 31 - iwl
    m = fmax(Fmt(iwl, frac))
    neg = x < 0.0
    a = x.abs()
    ac = torch.clamp(a, max=m)

    def conv(s):
        if mode == ROUND_TOWARD_ZERO:
            return torch.trunc(s)
        if mode == ROUND_NEAREST_EVEN:
            return torch.round(s)
        if mode == ROUND_DOWN:
            return torch.where(neg, torch.ceil(s), torch.floor(s))
        return torch.where(neg, torch.floor(s), torch.ceil(s))

    hi_s = ac * (2.0 ** (frac - 16))
    hi = torch.trunc(hi_s)
    lo = conv((hi_s - hi) * 65536.0)
    mag = (hi.to(torch.int64) << 16) + lo.to(torch.int64)
    top = (hi >= 32768.0) | ((hi == 32767.0) & (lo >= 65536.0))
    mag = torch.where(top, torch.where(neg, 0, 2 ** 31 - 1), mag)
    mag = torch.where(a > m, 2 ** 31 - 1, mag).to(torch.int32)
    return torch.where(neg, mag | _SIGN, mag)


def _preprocess(wm, wu):
    sm, su = wm & _SIGN, wu & _SIGN
    mm, mu = wm & _MAG, wu & _MAG
    mn = torch.minimum(mm, mu)
    same = sm == su
    ge = mm >= mu
    new_m = torch.where(same, mm - mn, torch.where(ge, mm + mn, 0))
    new_u = torch.where(same, mu - mn, torch.where(ge, 0, mu + mn))
    return sm | new_m, su | new_u


def _bit(w, i):
    return (w >> (31 - i)) & 1


def hamming_forward(m, u, iwl, num_bit, const_scale, mode, weight_para,
                    weighted):
    """m [..., M, D], u [..., D] -> the bit-weighted similarity [..., M]."""
    full = Fmt(iwl, 31 - iwl, mode)
    pm, pu = _preprocess(_words(m, iwl, mode),
                         _words(u, iwl, mode)[..., None, :])
    sim = torch.zeros(pm.shape, dtype=torch.float32, device=m.device)
    for i in range(1, num_bit):
        match = (_bit(pm, i) == _bit(pu, i)).to(torch.float32)
        sim = sim + match * (float(2.0 ** (-i - weight_para)) if weighted
                             else 1.0)
    if weighted:
        sim = torch.where((pm & _SIGN) != (pu & _SIGN), -sim, sim)
    term = fq(sim * float(2.0 ** const_scale), full)
    return fq(term.sum(-1), full)


def hamming_backward(m, u, g, iwl, num_bit, const_scale, mode):
    """The reference's surrogate (dm, du), its stale-accumulate quirk in
    the query gradient kept."""
    scale = float(2.0 ** const_scale)
    wm = _words(m, iwl, mode)
    wu = _words(u, iwl, mode)[..., None, :]
    sign_m = torch.where(wm >= 0, 1.0, -1.0)
    sign_u = torch.where(wu >= 0, 1.0, -1.0)
    pm, pu = _preprocess(wm, wu)
    tmp_a = torch.zeros(pm.shape, dtype=torch.float32, device=m.device)
    tmp_v = torch.zeros_like(tmp_a)
    appx = torch.zeros_like(tmp_a)
    for i in range(num_bit):
        mb = _bit(pm, i).to(torch.float32)
        ub = _bit(pu, i).to(torch.float32)
        differ = mb != ub
        diff = mb - ub
        if i == 0:
            cm, av = diff * sign_m * scale, -diff * sign_u * scale
        else:
            cm, av = -diff * sign_u * scale, diff * sign_m * scale
        tmp_a = tmp_a + torch.where(differ, cm, 0.0)
        tmp_v = torch.where(differ, av, tmp_v)
        appx = appx + tmp_v
    gr = g[..., :, None]
    return tmp_a * gr, (appx * gr).sum(-2)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

class Reference:
    """The reference computation under one configuration's ``model``
    fields; ``control=True`` rounds every matrix product's operands to
    TF32."""

    def __init__(self, model: dict, control: bool = False):
        unsupported = [k for k, v in SUPPORTED.items() if model[k] != v]
        if model["attention_mode"] not in (2, 3) or unsupported:
            raise ValueError(f"the reference does not implement "
                             f"{unsupported or 'this attention mode'}")
        self.model = model
        self.f = formats(model)
        self.control = control
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    # -- matrix products (the only place the control differs) ---------
    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor):
        if self.control:
            a, b = to_tf32(a), to_tf32(b)
        return torch.einsum(eq, a, b)

    # -- ops as autograd functions ---------------------------------------
    def lattice(self, w: torch.Tensor, x: torch.Tensor, fw: Fmt, fx: Fmt):
        """out[r, ..., o] = Q(sum_i Q(Q(w[r, o, i]) Q(x[r, ..., i]), fw),
        fw), w [R, O, I], x [R, ..., I]; the float backward."""
        return _Lattice.apply(w, x, fw, fx, self)

    def forward(self, p: Dict[str, torch.Tensor], memory, question, mask):
        """Stacked parameters [R, ...] and inputs [R, B, ...] -> logits
        [R, B, I]."""
        md, f = self.model, self.f
        K = md["num_hops"]
        u = self.lattice(p["B"], question, f.w[0], f.w[0])
        mem = [self.lattice(p["A"], memory, f.w[h], f.w[h]) for h in range(K)]
        cmem = [self.lattice(p["C"], memory, f.w[h], f.w[h])
                for h in range(K)]
        mask_f = mask.to(torch.float32)
        for h in range(K):
            if md["attention_mode"] == 2:
                s = _Score.apply(mem[h], u, f.att, f.bin, self)
            else:
                s = _Hamming.apply(mem[h], u, f.att, f.num_bit, md)
            prob = _Softmax.apply(s, mask)
            o = _WSum.apply(cmem[h], prob, mask_f, f.act,
                            md["attention_mode"] == 3, self)
            um = self.lattice(p["H"], u, f.w[h], f.bin)
            u = _QSum.apply(um, o, f.act)
        return _Output.apply(p["W"], u, self)

    def loss(self, p, batch):
        """(summed loss, the reference's cost per run [R])."""
        logits = self.forward(p, batch["memory"], batch["question"],
                              batch["mask"])
        logp = torch.log_softmax(logits, -1)
        ans, sm = batch["answer"], batch["sample_mask"]
        per = -(ans * logp).sum(-1)
        cost = -((ans * torch.exp(logp.detach())).sum(-1) * sm).sum(-1)
        return (per * sm).sum(), cost

    def sgd_step(self, p: Dict[str, torch.Tensor], batch, lr: float,
                 fault: Optional[str] = None):
        """One SGD step in place: returns the step's cost per run [R].
        ``fault="half_batch"`` leaves the second half of the batch out and
        takes the mean over the rest (the loss over the first half, twice)."""
        md = self.model
        if fault == "half_batch":
            sm = batch["sample_mask"].clone()
            sm[:, sm.shape[1] // 2:] = 0.0
            batch = dict(batch, sample_mask=sm)
        leaves = {k: v.detach().clone().requires_grad_() for k, v in p.items()}
        loss, cost = self.loss(leaves, batch)
        if fault == "half_batch":
            loss = 2.0 * loss
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(
            leaves.values()))))
        lr_t = torch.tensor(lr, dtype=torch.float32, device=loss.device)
        size_b = batch["size_b"]
        live = size_b > 0
        div = torch.clamp_min(size_b, 1.0).reshape(-1, 1, 1)
        with torch.no_grad():
            for k, w in p.items():
                g = grads[k]
                max_norm, lr_eff = md["max_grad_l2_norm"], lr_t
                if k == "H":
                    max_norm = md["max_grad_l2_norm"] / 2.0
                    if md["type_weight_tying"] == 2:
                        lr_eff = lr_t * 0.1
                if md["en_max_grad_l2_norm"]:
                    norm = torch.sqrt((g * g).sum(-1)).sum(-1)
                    g = g * torch.where(norm > max_norm, max_norm / norm,
                                        1.0)[:, None, None]
                decay = w * (lr_eff * md["lambda_"])
                new = (w - g * (lr_eff / div)) + decay
                if md["zeroing_null_weight"] and k in ("A", "C"):
                    new[..., 0] = 0.0
                w.copy_(torch.where(live[:, None, None], new, w))
        return cost.detach()

    def logits(self, p, memory, question, mask, rows: int = 2048):
        """Forward-only logits of a single run's p over [N, ...] inputs,
        in blocks of ``rows`` queries."""
        out = []
        with torch.no_grad():
            for s in range(0, memory.shape[0], rows):
                e = s + rows
                out.append(self.forward(
                    {k: v[None] for k, v in p.items()}, memory[None, s:e],
                    question[None, s:e], mask[None, s:e])[0])
        return torch.cat(out)


class _Lattice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, x, fw, fx, ref):
        ctx.save_for_backward(w, x)
        ctx.ref = ref
        R, O, I = w.shape
        rows = x.reshape(R, -1, I)
        N = rows.shape[1]
        wq = fq(w, fw)
        out = torch.empty((R, N, O), dtype=torch.float32, device=x.device)
        per_run = N * O * I
        if per_run <= BLOCK_ELEMENTS:
            r_blk, n_blk = max(1, BLOCK_ELEMENTS // per_run), N
        else:
            r_blk, n_blk = 1, max(1, BLOCK_ELEMENTS // (O * I))
        for r0 in range(0, R, r_blk):
            for n0 in range(0, N, n_blk):
                xq = fq(rows[r0:r0 + r_blk, n0:n0 + n_blk], fx)
                prod = fq(wq[r0:r0 + r_blk, None] * xq[:, :, None, :], fw)
                out[r0:r0 + r_blk, n0:n0 + n_blk] = fq(prod.sum(-1), fw)
        return out.reshape(*x.shape[:-1], O)

    @staticmethod
    def backward(ctx, g):
        w, x = ctx.saved_tensors
        ref = ctx.ref
        dw = ref.einsum("r...o,r...i->roi", g, x)
        dx = ref.einsum("roi,r...o->r...i", w, g) if ctx.needs_input_grad[1] \
            else None
        return dw, dx, None, None, None


class _Score(torch.autograd.Function):
    """Mode 2: Q(sum_d Q(Q(m, fm) Q(u, fu), fm), fm)."""

    @staticmethod
    def forward(ctx, m, u, fm, fu, ref):
        ctx.save_for_backward(m, u)
        ctx.ref = ref
        prod = fq(fq(m, fm) * fq(u, fu)[..., None, :], fm)
        return fq(prod.sum(-1), fm)

    @staticmethod
    def backward(ctx, g):
        m, u = ctx.saved_tensors
        dm = g[..., :, None] * u[..., None, :]
        du = ctx.ref.einsum("rbmd,rbm->rbd", m, g)
        return dm, du, None, None, None


class _Hamming(torch.autograd.Function):
    @staticmethod
    def forward(ctx, m, u, fa, num_bit, md):
        ctx.save_for_backward(m, u)
        ctx.knobs = (fa.iwl, num_bit, md["attention_const_scale"], fa.mode)
        return hamming_forward(m, u, fa.iwl, num_bit,
                               md["attention_const_scale"], fa.mode,
                               md["hamming_weight_para"],
                               md["hamming_weighted"])

    @staticmethod
    def backward(ctx, g):
        m, u = ctx.saved_tensors
        dm, du = hamming_backward(m, u, g, *ctx.knobs)
        return dm, du, None, None, None


class _Softmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, s, mask):
        x = torch.where(mask, s, -1e30)
        e = torch.where(mask, torch.exp(x - x.amax(-1, keepdim=True)), 0.0)
        tot = e.sum(-1, keepdim=True)
        p = e / torch.where(tot == 0.0, 1.0, tot)
        ctx.save_for_backward(p)
        return p

    @staticmethod
    def backward(ctx, g):
        (p,) = ctx.saved_tensors
        return p * (g - (p * g).sum(-1, keepdim=True)), None


class _WSum(torch.autograd.Function):
    """o = Q(sum_m Q(Q(p) Q(c)) * mask); the backward float, or in
    fixed-point mode 3 quantized at (1, iwl + frac - 1)."""

    @staticmethod
    def forward(ctx, c, p, mask_f, f, grad_q, ref):
        ctx.save_for_backward(c, p, mask_f)
        ctx.f, ctx.grad_q, ctx.ref = f, grad_q, ref
        prod = fq(fq(p, f)[..., :, None] * fq(c, f), f)
        return fq((prod * mask_f[..., :, None]).sum(-2), f)

    @staticmethod
    def backward(ctx, g):
        c, p, mask_f = ctx.saved_tensors
        f = ctx.f
        if ctx.grad_q:
            fo = Fmt(1, f.iwl + f.frac - 1, f.mode)
            dc = fq(fq(fq(p, f)[..., :, None] * fq(g, f)[..., None, :], f),
                    fo) * mask_f[..., :, None]
            dp = fq(fq(fq(c, f) * fq(g, f)[..., None, :], f).sum(-1),
                    fo) * mask_f
        else:
            dc = (p * mask_f)[..., :, None] * g[..., None, :]
            dp = ctx.ref.einsum("rbmd,rbd->rbm", c, g) * mask_f
        return dc, dp, None, None, None, None


class _QSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, f):
        return fq(fq(a, f) + fq(b, f), f)

    @staticmethod
    def backward(ctx, g):
        return g, g, None


class _Output(torch.autograd.Function):
    """The float output layer logits = u W^T, W [R, I, D]."""

    @staticmethod
    def forward(ctx, w, u, ref):
        ctx.save_for_backward(w, u)
        ctx.ref = ref
        return ref.einsum("rbd,rid->rbi", u, w)

    @staticmethod
    def backward(ctx, g):
        w, u = ctx.saved_tensors
        ref = ctx.ref
        return (ref.einsum("rbi,rbd->rid", g, u),
                ref.einsum("rbi,rid->rbd", g, w), None)
