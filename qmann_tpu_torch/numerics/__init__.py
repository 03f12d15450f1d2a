from qmann_tpu_torch.numerics.fixed import (
    QFormat,
    ROUND_DOWN,
    ROUND_UP,
    ROUND_NEAREST_EVEN,
    ROUND_TOWARD_ZERO,
    fixed_max_float,
    float_quant,
    float_quant_blocks,
)

__all__ = [
    "QFormat", "ROUND_DOWN", "ROUND_UP", "ROUND_NEAREST_EVEN",
    "ROUND_TOWARD_ZERO", "fixed_max_float", "float_quant",
    "float_quant_blocks",
]
