"""qmann_tpu_torch — the PyTorch/CUDA port of qmann_tpu.

The serving slice: Q-format numerics, the quantized forward ops, the
MemN2N forward and its serving-prepared forward, the fused K-hop chain as a
hand-written CUDA kernel for Hopper (sm_90a), and the continuous-batching
inference engine.  The layout mirrors ``qmann_tpu/``; ``qmann_tpu`` stays
the reference the tests compare against.  This package never imports jax.

Layering (bottom-up):
    numerics  — the Q-format fake-quantization contract
    data      — vocabulary, data shapes, synthetic qa1-shaped batches
    ops       — quantized forward ops; ops/cuda holds the chain kernel
    models    — MemN2N forward and serving-prepared forward
    serve     — batched inference engine
"""
from qmann_tpu_torch import _numerics_settings  # noqa: F401  (sets switches)

__version__ = "0.1.0"
