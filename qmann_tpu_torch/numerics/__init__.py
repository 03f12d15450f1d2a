from qmann_tpu_torch.numerics.fixed import (
    QFormat,
    ROUND_DOWN,
    ROUND_UP,
    ROUND_NEAREST_EVEN,
    ROUND_TOWARD_ZERO,
    bin2gray,
    decode_sign_magnitude,
    encode_sign_magnitude,
    fixed_add,
    fixed_mac,
    fixed_max_float,
    fixed_min_float,
    fixed_mul,
    float_quant,
    float_quant_blocks,
    gray2bin,
    qformat_from_wl,
    quantize_ste,
)

__all__ = [
    "QFormat", "ROUND_DOWN", "ROUND_UP", "ROUND_NEAREST_EVEN",
    "ROUND_TOWARD_ZERO", "bin2gray", "decode_sign_magnitude",
    "encode_sign_magnitude", "fixed_add", "fixed_mac", "fixed_max_float",
    "fixed_min_float", "fixed_mul", "float_quant", "float_quant_blocks",
    "gray2bin", "qformat_from_wl", "quantize_ste",
]
