"""Cross-verification utilities (counterpart of
``qmann_tpu/utils/verification.py``), the analog of the reference's
HW_MODE 21 CPU<->GPU verification mode (MemN2N/define.h:96,108-111), whose
verification_point blocks compare two paths element-wise against
TH_ERROR_FLOAT = 1e-6 (lib/common.h:178).

Here the paired paths are:
  * the four hand-written CUDA kernels against their plain PyTorch
    versions (``verify_kernels``), bit for bit where the port is exact;
    on the CPU every wrapper takes its plain version, so there it checks
    only its own plumbing;
  * the quantized model against its float counterpart
    (``verify_model_quantization``, a report, not a gate);
  * saturation/overflow statistics per tensor (``overflow_stats``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from qmann_tpu_torch.config import QmannConfig
from qmann_tpu_torch.device import resolve_device, to_numpy
from qmann_tpu_torch.numerics import QFormat, fixed_max_float, float_quant
from qmann_tpu_torch.ops.attention import surrogate_terms
from qmann_tpu_torch.ops.qlinear import qweighted_sum_backward

TH_ERROR_FLOAT = 1e-6  # lib/common.h:178


@dataclasses.dataclass
class VerificationResult:
    name: str
    max_abs_err: float
    num_mismatch: int
    total: int
    threshold: float = TH_ERROR_FLOAT

    @property
    def ok(self) -> bool:
        return self.max_abs_err <= self.threshold

    def __str__(self):
        status = "OK " if self.ok else "FAIL"
        return (f"[{status}] {self.name}: max|err|={self.max_abs_err:.3e} "
                f"mismatches {self.num_mismatch}/{self.total}")



def compare(name: str, a, b, threshold: float = TH_ERROR_FLOAT
            ) -> VerificationResult:
    a, b = to_numpy(a), to_numpy(b)
    err = np.abs(a - b)
    return VerificationResult(name, float(err.max()) if err.size else 0.0,
                              int((err > threshold).sum()), int(err.size),
                              threshold)


def overflow_stats(x, fmt: QFormat) -> Dict[str, float]:
    """Fraction of values that would saturate / quantize to zero in fmt —
    the observability the reference's f_overflow buffers were meant for
    (CUDA_FIXED_OVERFLOW_F, lib/layer_cuda.h:214)."""
    x = to_numpy(x)
    maxf = float(fixed_max_float(fmt.iwl, fmt.frac))
    step = 2.0 ** (-fmt.frac)
    n = max(x.size, 1)
    return {
        "saturated": float((np.abs(x) > maxf).sum()) / n,
        "underflow_to_zero": float(((np.abs(x) < step) & (x != 0)).sum()) / n,
        "max_abs": float(np.abs(x).max()) if x.size else 0.0,
    }


def _unflipped(p_got, p_want, fmts_act) -> torch.Tensor:
    """[B] queries in which no Q(p, act) requant flipped: elsewhere exp and
    the softmax sum may differ by an ulp between two implementations and
    move one requant by a grid step, which then carries on."""
    p_got, p_want = p_got.reshape(-1, *p_got.shape[-2:]), \
        p_want.reshape(-1, *p_want.shape[-2:])
    flipped = torch.zeros(p_got.shape[1], dtype=torch.bool,
                          device=p_got.device)
    for h, fmt in enumerate(fmts_act[:p_got.shape[0]]):
        flipped |= (float_quant(p_got[h], fmt)
                    != float_quant(p_want[h], fmt)).any(-1)
    return ~flipped


def _flips(name: str, keep: torch.Tensor) -> VerificationResult:
    """Passes while at most one query's Q(p, act) flipped."""
    n = int((~keep).sum())
    return VerificationResult(f"{name} flipped Q(p) queries (at most 1)",
                              float(max(0, n - 1)), n, keep.numel(), 0.0)


def verify_kernels(rng: Optional[np.random.Generator] = None,
                   device="cuda") -> List[VerificationResult]:
    """The six hand-written kernels against their plain versions on
    ``device``, on small seeded inputs: the lattice (whole-row and tiled
    over I) and the Hamming score bit for bit; the Hamming surrogate
    backward's dm bit for bit and du within the rounding of a sum over the
    memory rows in another order; the attention read (mode 2)
    and the hop chain (embedding a bag-of-words memory) with their scores
    bit for bit, p within
    TH_ERROR_FLOAT, and the output bit for bit in every query whose
    Q(p, act) did not flip (at most one may); the weighted sum's
    quantized backward bit for bit (8-bit words: every sum exact), and its
    ds entry (the fused read's backward, quantized and float): dc bit for
    bit, ds within ds_bound."""
    from qmann_tpu_torch.ops.cuda import attention_read as ar
    from qmann_tpu_torch.ops.cuda import hamming as ham
    from qmann_tpu_torch.ops.cuda import hamming_bwd as hbwd
    from qmann_tpu_torch.ops.cuda import hop_chain
    from qmann_tpu_torch.ops.cuda import qmatvec as qmv
    from qmann_tpu_torch.ops.cuda import qweighted_sum_bwd as wsb
    dev = resolve_device(device)
    rng = rng or np.random.default_rng(0)
    cfg = QmannConfig()

    def t(*shape, sd=1.5):
        return torch.from_numpy(
            rng.normal(0.0, sd, shape).astype(np.float32)).to(dev)

    results = []
    fmt = QFormat(5, 2)
    for label, (O, I) in (("whole-row", (16, 24)), ("tiled", (60, 256))):
        w, x = t(O, I), t(9, I)
        results.append(compare(
            f"qmatvec {label} O={O} I={I} kernel-vs-plain",
            qmv.quantized_matvec(w, x, fmt, fmt),
            qmv.quantized_matvec_reference(w, x, fmt, fmt), threshold=0.0))

    act = QFormat(5, 2)
    m, u = float_quant(t(8, 6, 5, sd=2.0), act), float_quant(t(8, 5, sd=2.0),
                                                            act)
    ham_args = (m, u, 5, 8, -3, act.mode)
    results.append(compare("hamming kernel-vs-plain",
                           ham.hamming_score_kernel(*ham_args),
                           ham.hamming_score_reference(*ham_args),
                           threshold=0.0))
    g = t(8, 6)
    bwd_args = (m, u, g, 5, 8, -3, act.mode)
    (dm_g, du_g), (dm_w, du_w) = (hbwd.hamming_backward_kernel(*bwd_args),
                                  hbwd.hamming_backward(*bwd_args))
    # du: two 6-term float32 sums in different orders
    _, grad_appx = surrogate_terms(m, u, 5, 8, -3, act.mode)
    du_bound = 2 * 6 * 2.0 ** -24 * float(
        (grad_appx * g[..., None]).abs().sum(-2).max())
    results += [compare("hamming_backward dm kernel-vs-plain", dm_g, dm_w,
                        threshold=0.0),
                compare("hamming_backward du kernel-vs-plain", du_g, du_w,
                        threshold=du_bound)]

    B, M, D = 8, 10, 12
    mask = (torch.arange(M)[None, :]
            < torch.from_numpy(rng.integers(0, M + 1, B))[:, None])
    mask_f = mask.to(dev, torch.float32)
    read_args = (float_quant(t(B, M, D), fmt), float_quant(t(B, M, D), fmt),
                 float_quant(t(B, D), fmt), mask_f, cfg.fmt_att[0],
                 cfg.fmt_bin, cfg.fmt_act[0])
    (o_g, p_g, s_g) = ar.fused_read(*read_args)
    (o_w, p_w, s_w) = ar.fused_read_reference(*read_args)
    keep = _unflipped(p_g, p_w, cfg.fmt_act)
    results += [compare("attention_read scores kernel-vs-plain", s_g, s_w,
                        threshold=0.0),
                compare("attention_read p kernel-vs-plain", p_g, p_w),
                compare("attention_read o kernel-vs-plain (queries without "
                        "a flipped Q(p))", o_g[keep], o_w[keep],
                        threshold=0.0),
                _flips("attention_read", keep)]
    wsum_args = (read_args[1], p_w, mask_f, t(B, D), cfg.fmt_act[0])
    (dc_g, dp_g), (dc_w, dp_w) = (
        wsb.qweighted_sum_backward_kernel(*wsum_args),
        qweighted_sum_backward(*wsum_args, grad_quantized=True))
    results += [compare("qweighted_sum_backward dc kernel-vs-plain", dc_g,
                        dc_w, threshold=0.0),
                compare("qweighted_sum_backward dp kernel-vs-plain", dp_g,
                        dp_w, threshold=0.0)]
    # its ds entry in both instances: ds within the rounding of the
    # softmax sum (and of float dp) taken in another order
    for quantized in (True, False):
        ds_args = wsum_args[:4] + (None, None, wsum_args[4], quantized)
        (dc_g, ds_g), (dc_w, ds_w) = (
            wsb.weighted_sum_softmax_backward_kernel(*ds_args),
            wsb.weighted_sum_softmax_backward_plain(*ds_args))
        _, dp_w = qweighted_sum_backward(*wsum_args,
                                         grad_quantized=quantized)
        ds_tol = float(wsb.ds_bound(p_w, dp_w, wsb.dp_error(
            read_args[1], mask_f, wsum_args[3], wsum_args[4],
            quantized)).max())
        name = ("weighted_sum_softmax_backward "
                + ("quantized" if quantized else "float"))
        results += [compare(f"{name} dc kernel-vs-plain", dc_g, dc_w,
                            threshold=0.0),
                    compare(f"{name} ds kernel-vs-plain", ds_g, ds_w,
                            threshold=ds_tol)]

    # the chain from a bag-of-words memory (counts 0..2, I=24) and Q(A|C)
    # on the fmt_w lattice: every embedding sum exact
    K, I = cfg.num_hops, 24
    memory = torch.from_numpy(
        rng.integers(0, 3, (B, M, I)).astype(np.float32)).to(dev)
    chain_args = (memory, float_quant(t(I, 2 * K * D), cfg.fmt_w[0]),
                  float_quant(t(B, D), cfg.fmt_w[0]), t(K, D, D, sd=0.3),
                  mask.to(dev), cfg.fmt_w, cfg.fmt_att, cfg.fmt_bin,
                  cfg.fmt_act)
    (u_g, p_g, s_g) = hop_chain.fused_hop_chain_from_memory(*chain_args)
    (u_w, p_w, s_w) = hop_chain.fused_hop_chain_from_memory_reference(
        *chain_args)
    keep = _unflipped(p_g, p_w, cfg.fmt_act)
    results += [compare("hop_chain hop-0 scores kernel-vs-plain", s_g[0],
                        s_w[0], threshold=0.0),
                compare("hop_chain p kernel-vs-plain", p_g, p_w),
                compare("hop_chain u_final kernel-vs-plain (queries without "
                        "a flipped Q(p))", u_g[keep], u_w[keep],
                        threshold=0.0),
                _flips("hop_chain", keep)]
    return results


def verify_model_quantization(cfg: QmannConfig, dims, batch,
                              generator: Optional[torch.Generator] = None,
                              device="cuda") -> List[VerificationResult]:
    """Quantized vs float forward on the same weights — reports where the
    Q-format changes predictions (expected to differ; the report is the
    point, as in the reference's similarity-analysis dumps).  batch:
    (memory, question, mask) numpy arrays or tensors."""
    from qmann_tpu_torch.models import memn2n
    dev = resolve_device(device)
    generator = generator or torch.Generator().manual_seed(0)
    params = memn2n.init_params(cfg, dims, generator, device=dev)
    memory, question, mask = (torch.as_tensor(a).to(dev) for a in batch)
    with torch.no_grad():
        out_q = memn2n.forward(params, memory, question, mask, cfg)
        cfg_f = cfg.replace(en_fixed_point=False, attention_mode=1)
        out_f = memn2n.forward(params, memory, question, mask, cfg_f)
    pred_q = to_numpy(out_q.logits).argmax(-1)
    pred_f = to_numpy(out_f.logits).argmax(-1)
    return [
        compare("logits quant-vs-float", out_q.logits, out_f.logits,
                threshold=np.inf),
        VerificationResult("pred agreement", 0.0,
                           int((pred_q != pred_f).sum()), len(pred_q)),
    ]
