"""Q-format fake quantization on torch tensors.

The counterpart of ``qmann_tpu/numerics/fixed.py`` (its ``QFormat``,
``fixed_max_float``, ``float_quant`` and ``float_quant_blocks``), with the
same semantics bit for bit on float32 inputs:

  * saturation bound max = (2^(iwl+frac)-1) / 2^frac computed in float32,
    min = -max (sign-magnitude);
  * conversion by mode: truncation toward zero by default, or floor, ceil,
    round-half-even;
  * the saturating float->int32 conversion clamps at +/-2^31;
  * at iwl+frac == 31, x == -2^iwl converts to INT_MIN whose magnitude
    wraps to 0;
  * saturation is decided on the pre-conversion value;
  * iwl+frac == 0 binarizes to +/-1 with 0 -> +1.

The sign-magnitude encode/decode, the straight-through quantizer and the
gray-code helpers are not ported yet (see ROADMAP.md).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch

ROUND_DOWN = 0          # floor
ROUND_UP = 1            # ceil
ROUND_NEAREST_EVEN = 2  # round half to even
ROUND_TOWARD_ZERO = 3   # truncate (C cast; the default)

# f32 value of INT32_MAX after float rounding: the saturating float->int
# conversion clamps here
_INT32_SAT_F32 = 2147483648.0


class QFormat(NamedTuple):
    """A Q(iwl).(frac) fixed-point format: 1 sign bit + iwl integer bits +
    frac fractional bits, with rounding ``mode``."""
    iwl: int
    frac: int
    mode: int = ROUND_TOWARD_ZERO

    @property
    def is_binary(self) -> bool:
        return (self.iwl + self.frac) == 0


@functools.lru_cache(maxsize=None)
def fixed_max_float(iwl: int, frac: int) -> float:
    """Saturation upper bound (float)((1<<(iwl+frac))-1) / (float)(1<<frac)
    with C float rounding; at iwl+frac == 31 the numerator rounds up to
    2^31, so the bound is exactly 2^iwl."""
    assert 0 <= iwl and 0 <= frac and iwl + frac <= 31
    num = np.float32((1 << (iwl + frac)) - 1)
    den = np.float32(1 << frac)
    return float(np.float32(num / den))


def _convert(scaled: torch.Tensor, mode: int) -> torch.Tensor:
    if mode == ROUND_DOWN:
        return torch.floor(scaled)
    if mode == ROUND_UP:
        return torch.ceil(scaled)
    if mode == ROUND_NEAREST_EVEN:
        return torch.round(scaled)  # round half to even
    return torch.trunc(scaled)


def float_quant(x: torch.Tensor, fmt: QFormat) -> torch.Tensor:
    """Round-trip float -> sign-magnitude fixed -> float, with saturation."""
    x = torch.as_tensor(x, dtype=torch.float32)
    if fmt.is_binary:
        return torch.where(x >= 0.0, 1.0, -1.0).to(torch.float32)
    maxf = fixed_max_float(fmt.iwl, fmt.frac)
    # powers of two: every scaling below is exact in f32
    scaled = x * (2.0 ** fmt.frac)
    q = _convert(scaled, fmt.mode).clamp(-_INT32_SAT_F32, _INT32_SAT_F32)
    deq = q * (2.0 ** -fmt.frac)
    if fmt.iwl + fmt.frac == 31:
        deq = torch.where(scaled <= -_INT32_SAT_F32, 0.0, deq)
    return torch.where(x > maxf, maxf, torch.where(x < -maxf, -maxf, deq))


def float_quant_blocks(x: torch.Tensor, fmts: Sequence[QFormat],
                       widths: Sequence[int]) -> torch.Tensor:
    """float_quant with a per-column-block QFormat on the last axis:
    columns of block k are quantized in fmts[k].  Bit-identical to
    concatenating per-block float_quant calls."""
    assert len(fmts) == len(widths) and x.shape[-1] == sum(widths)
    if len(set(fmts)) == 1:
        return float_quant(x, fmts[0])
    if len({f.mode for f in fmts}) > 1 or any(f.is_binary for f in fmts):
        return torch.cat([float_quant(blk, f) for blk, f in
                          zip(torch.split(x, list(widths), dim=-1), fmts)],
                         dim=-1)
    x = torch.as_tensor(x, dtype=torch.float32)

    def cols(vals, dtype=torch.float32):
        return torch.repeat_interleave(
            torch.tensor(vals, dtype=dtype),
            torch.tensor(list(widths))).to(x.device)

    maxf = cols([fixed_max_float(f.iwl, f.frac) for f in fmts])
    scaled = x * cols([2.0 ** f.frac for f in fmts])
    q = _convert(scaled, fmts[0].mode).clamp(-_INT32_SAT_F32, _INT32_SAT_F32)
    deq = q * cols([2.0 ** -f.frac for f in fmts])
    full31 = [(f.iwl + f.frac) == 31 for f in fmts]
    if any(full31):
        wrap = cols(full31, torch.bool)
        deq = torch.where(wrap & (scaled <= -_INT32_SAT_F32), 0.0, deq)
    return torch.where(x > maxf, maxf, torch.where(x < -maxf, -maxf, deq))
