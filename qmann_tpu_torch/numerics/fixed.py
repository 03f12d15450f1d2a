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

It also holds the fixed-point arithmetic macros (``fixed_mul``,
``fixed_add``, ``fixed_mac``), the straight-through quantizer
(``quantize_ste``: float_quant forward, identity backward), the 32-bit
sign-magnitude encode/decode that the Hamming attention compares bit by
bit (``encode_sign_magnitude``, ``decode_sign_magnitude``) and the
gray-code helpers (``bin2gray``, ``gray2bin``).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Sequence, Tuple

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


def qformat_from_wl(iwl: int, wl: int = 8,
                    mode: int = ROUND_TOWARD_ZERO) -> QFormat:
    """BW_WL-style format: frac = wl - 1 - iwl."""
    return QFormat(iwl, wl - 1 - iwl, mode)


@functools.lru_cache(maxsize=None)
def fixed_max_float(iwl: int, frac: int) -> float:
    """Saturation upper bound (float)((1<<(iwl+frac))-1) / (float)(1<<frac)
    with C float rounding; at iwl+frac == 31 the numerator rounds up to
    2^31, so the bound is exactly 2^iwl."""
    assert 0 <= iwl and 0 <= frac and iwl + frac <= 31
    num = np.float32((1 << (iwl + frac)) - 1)
    den = np.float32(1 << frac)
    return float(np.float32(num / den))


def fixed_min_float(iwl: int, frac: int) -> float:
    """The symmetric lower bound -max (sign-magnitude)."""
    return -fixed_max_float(iwl, frac)


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


def fixed_mul(a: torch.Tensor, b: torch.Tensor, fmt_a: QFormat,
              fmt_b: QFormat) -> torch.Tensor:
    """Quantize each operand in its own format, multiply in float,
    requantize the product to fmt_a (the first operand's format)."""
    return float_quant(float_quant(a, fmt_a) * float_quant(b, fmt_b), fmt_a)


def fixed_add(a: torch.Tensor, b: torch.Tensor, fmt_a: QFormat,
              fmt_b: QFormat) -> torch.Tensor:
    """Q(Q(a, fmt_a) + Q(b, fmt_b), fmt_a)."""
    return float_quant(float_quant(a, fmt_a) + float_quant(b, fmt_b), fmt_a)


def fixed_mac(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
              fmt_a: QFormat, fmt_b: QFormat) -> torch.Tensor:
    """Float accumulate of the per-product-quantized multiply."""
    return acc + fixed_mul(a, b, fmt_a, fmt_b)


class _QuantizeSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fmt):
        return float_quant(x, fmt)

    @staticmethod
    def backward(ctx, g):
        return g, None


def quantize_ste(x: torch.Tensor, fmt: QFormat) -> torch.Tensor:
    """float_quant with the identity (straight-through) gradient: the
    reference's backward passes see raw float tensors."""
    return _QuantizeSTE.apply(x, fmt)


# ---------------------------------------------------------------------------
# Sign-magnitude bit-level encoding (for the Hamming attention)
# ---------------------------------------------------------------------------

def encode_sign_magnitude(x: torch.Tensor, fmt: QFormat
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 -> (sign, magnitude) of the 32-bit sign-magnitude fixed word.

    sign: int32 in {0, 1}, 1 iff x < 0 (so -0.0 has sign 0).  magnitude:
    int32, the low 31 bits of the word: conv(|x| * 2^frac) by rounding mode,
    where floor and ceil swap for negatives (the conversion acts on the
    signed value); |x| > max (strictly) saturates to all ones.

    Past 24 bits the magnitude is rebuilt from a hi/lo split in which every
    step is exact in float32; under ROUND_UP the low half can round to 2^16
    and carry into the high half.  At iwl+frac == 31 the magnitude can
    reach exactly 2^31 (|x| == 2^iwl, whose float32 bound maxf is exactly
    2^iwl and does not saturate): a positive value then gives 2^31-1, a
    negative one magnitude 0 with the sign set."""
    x = torch.as_tensor(x, dtype=torch.float32)
    iwl, frac = fmt.iwl, fmt.frac
    n = iwl + frac
    assert n <= 31
    neg = x < 0.0
    sign = neg.to(torch.int32)
    maxf = fixed_max_float(iwl, frac)
    absx = x.abs()
    sat_fixed = (1 << n) - 1 if n < 31 else 2 ** 31 - 1
    absx_c = torch.clamp(absx, max=maxf)

    def conv_mag(scaled_abs):
        if fmt.mode == ROUND_TOWARD_ZERO:
            return torch.trunc(scaled_abs)
        if fmt.mode == ROUND_NEAREST_EVEN:
            return torch.round(scaled_abs)
        if fmt.mode == ROUND_DOWN:
            return torch.where(neg, torch.ceil(scaled_abs),
                               torch.floor(scaled_abs))
        return torch.where(neg, torch.floor(scaled_abs),
                           torch.ceil(scaled_abs))

    if n <= 24:
        mag = conv_mag(absx_c * (2.0 ** frac)).to(torch.int64)
    else:
        hi_scaled = absx_c * (2.0 ** (frac - 16))
        hi = torch.trunc(hi_scaled)
        lo = conv_mag((hi_scaled - hi) * 65536.0)
        # add, not or: the low half may carry
        mag = (hi.to(torch.int64) << 16) + lo.to(torch.int64)
        if n == 31:
            reach31 = (hi >= 32768.0) | ((hi == 32767.0) & (lo >= 65536.0))
            mag = torch.where(reach31, torch.where(neg, 0, 2 ** 31 - 1), mag)
    mag = torch.where(absx > maxf, sat_fixed, mag)
    return sign, mag.to(torch.int32)


def decode_sign_magnitude(sign: torch.Tensor, mag: torch.Tensor,
                          fmt: QFormat) -> torch.Tensor:
    """(sign, magnitude) -> float32: (float)mag / 2^frac with the sign
    applied; the int32 rounds to float32 first, as in C."""
    val = mag.to(torch.float32) * (2.0 ** -fmt.frac)
    return torch.where(sign > 0, -val, val)


# ---------------------------------------------------------------------------
# Gray code helpers
# ---------------------------------------------------------------------------

def bin2gray(bin_val: torch.Tensor, idx_bit_low: int,
             idx_bit_high: int) -> torch.Tensor:
    """Binary -> Gray code over the bit range [idx_bit_low, idx_bit_high]
    (inclusive), other bits zeroed: gray[high] = bin[high];
    gray[i] = bin[i+1] ^ bin[i] for i in [low, high)."""
    b = torch.as_tensor(bin_val, dtype=torch.int32)
    gray = b & (1 << idx_bit_high)
    for i in range(idx_bit_high - 1, idx_bit_low - 1, -1):
        gray = gray | ((((b >> (i + 1)) ^ (b >> i)) & 1) << i)
    return gray


def gray2bin(gray_val: torch.Tensor, idx_bit_low: int,
             idx_bit_high: int) -> torch.Tensor:
    """Gray -> binary, the inverse of bin2gray: bin[high] = gray[high];
    bin[i] = bin[i+1] ^ gray[i]."""
    g = torch.as_tensor(gray_val, dtype=torch.int32)
    binv = g & (1 << idx_bit_high)
    for i in range(idx_bit_high - 1, idx_bit_low - 1, -1):
        binv = binv | ((((binv >> (i + 1)) ^ (g >> i)) & 1) << i)
    return binv
