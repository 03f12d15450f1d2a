"""qmann_tpu_torch — the PyTorch/CUDA port of qmann_tpu.

The serving slice and the training slice: Q-format numerics, the
quantized ops with their raw-float backwards, the MemN2N forward, loss and
serving-prepared forward, the SGD trainer, and the continuous-batching
inference engine, with three hand-written CUDA kernels for Hopper (sm_90a):
the fused K-hop chain (serving), the quantized mat-vec lattice and the
attention read (the training forward under ``use_pallas``).  The layout
mirrors ``qmann_tpu/``; ``qmann_tpu`` stays the reference the tests compare
against.  This package never imports jax.  Its entry points run on the
card unless the caller passes ``device="cpu"``.

Layering (bottom-up):
    numerics  — the Q-format fake-quantization contract
    data      — vocabulary, vectorizer, synthetic qa1-shaped data
    ops       — quantized ops and backwards; ops/cuda holds the kernels
    models    — MemN2N forward, loss and serving-prepared forward
    train     — SGD, schedule and the per-task trainer
    serve     — batched inference engine
"""
from qmann_tpu_torch import _numerics_settings  # noqa: F401  (sets switches)

__version__ = "0.1.0"
