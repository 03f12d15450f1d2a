"""qmann_tpu_torch — the PyTorch/CUDA port of qmann_tpu.

The serving slice, the training slice and the command-line run: Q-format
numerics, the quantized ops with their raw-float backwards, the MemN2N
forward, loss and serving-prepared forward, the SGD trainer, the
continuous-batching inference engine, the bAbI loaders, checkpoints and
result CSVs, with four hand-written CUDA kernels for Hopper (sm_90a): the
fused K-hop chain (serving), the quantized mat-vec lattice and the
attention read (the training forward under ``use_pallas``), and the
Hamming score (attention mode 3).  ``python -m qmann_tpu_torch`` is the
CLI.  The layout
mirrors ``qmann_tpu/``; ``qmann_tpu`` stays the reference the tests compare
against.  This package never imports jax.  Its entry points run on the
card unless the caller passes ``device="cpu"``.

Layering (bottom-up):
    numerics  — the Q-format fake-quantization contract
    data      — bAbI parsers and loaders (Python and the native C++
                parser), vocabulary, vectorizer, synthetic qa1-shaped data
    ops       — quantized ops and backwards; ops/cuda holds the kernels
    models    — MemN2N forward, loss and serving-prepared forward
    train     — SGD, schedule and the per-task trainer
    serve     — batched inference engine
    utils     — checkpoints, result CSVs, phase profiler and traces, the
                similarity dump, kernel verification
    bench     — throughput (bench/qps.py)
    cli       — python -m qmann_tpu_torch <loops> <task_s> <task_e> <iwl>
"""
from qmann_tpu_torch import _numerics_settings  # noqa: F401  (sets switches)

__version__ = "0.1.0"
