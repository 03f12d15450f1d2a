"""The mode-3 Hamming score's surrogate backward: a hand-written CUDA kernel
for Hopper and its plain PyTorch version.

No Pallas kernel stands behind it: the JAX package computes the surrogate
(``_hamming_bwd``, ``qmann_tpu/ops/attention.py``) as a loop of elementwise
jnp ops that XLA fuses under ``jit``.  The kernel is the port of that
fusion, so that a mode-3 training step on the kernel route runs one launch
per hop for the surrogate instead of some 300 eager ops.  Two backwards
call it: ``ops.attention._HammingScore`` (the unfused score on the kernel
route: ``use_pallas_hamming``, or ``use_pallas`` under EN_GRAD_QUANT's
"backward" placement, and the mesh's local scores) and
``ops.fused._FusedAttentionRead`` (the mode-3 read, ``use_pallas``).

The kernel source is ``qmann_tpu_torch/csrc/hamming_bwd.cu`` (the encode
and preprocess from ``csrc/hamming.cuh``).  Built with nvcc at first use
(``ops/cuda/_build.py``) and bound with ctypes.

``hamming_backward_kernel`` dispatches on the device of ``m``: a CPU tensor
takes ``ops.attention.hamming_backward``; a CUDA tensor launches the kernel
or raises.  Leading dims before [B, M, D] (a family's runs) fold into B.
The kernel runs one thread per (query, d) column; ``backward_launch`` gives
the launch's blocks and threads.
``hamming_backward_kernel.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import torch

from qmann_tpu_torch.ops.attention import hamming_backward
from qmann_tpu_torch.ops.cuda import _build
from qmann_tpu_torch.ops.cuda.geometry import SMS, check_shape
from qmann_tpu_torch.ops.cuda.hamming import check_knobs

SOURCE = _build.CSRC / "hamming_bwd.cu"
MAX_THREADS = 128      # kMaxThreads in the source


@functools.lru_cache(maxsize=None)
def backward_launch(B: int, D: int) -> Tuple[int, int]:
    """(blocks, threads per block) of the kernel for B queries of width D:
    one thread per (query, d) column, MAX_THREADS a block, halved (down to
    one warp) while the grid would have fewer blocks than the card has
    SMs.  Each thread walks all of its column's memory rows."""
    cols = B * D
    threads = MAX_THREADS
    while threads > 32 and -(-cols // threads) < SMS:
        threads //= 2
    return -(-cols // threads), threads


def build() -> Tuple[Path, str]:
    """Compile the kernel library unless it is built (see ``_build``)."""
    return _build.build(SOURCE)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    return _build.load(SOURCE, "qmann_hamming_backward",
                       [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])


def hamming_backward_kernel(m: torch.Tensor, u: torch.Tensor,
                            g: torch.Tensor, iwl: int, num_bit: int,
                            const_scale: int = -3, round_mode: int = 3):
    """m [..., M, D], u [..., D], upstream g [..., M] -> (dm, du) of m's
    and u's shapes (the arguments of ``hamming_backward``): the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors.  The
    knobs and shapes are checked on every device, so that the plain
    version covers the kernel's domain."""
    check_knobs(iwl, num_bit, const_scale, round_mode, 0)
    if (m.dim() < 2 or u.shape != m.shape[:-2] + m.shape[-1:]
            or g.shape != m.shape[:-1]):
        raise ValueError(f"hamming_backward_kernel: shapes m "
                         f"{tuple(m.shape)}, u {tuple(u.shape)}, g "
                         f"{tuple(g.shape)}, expected [..., M, D], "
                         "[..., D] and [..., M]")
    M, D = m.shape[-2:]
    B = m.numel() // (M * D) if m.numel() else 0
    check_shape("hamming_backward_kernel", B, M, D)
    if m.device.type == "cpu":
        return hamming_backward(m, u, g, iwl, num_bit, const_scale,
                                round_mode)
    if m.device.type != "cuda":
        raise ValueError(f"hamming_backward_kernel: unsupported device "
                         f"{m.device}")
    if u.device != m.device or g.device != m.device:
        raise ValueError("hamming_backward_kernel: inputs on different "
                         "devices")
    if (m.dtype, u.dtype, g.dtype) != (torch.float32,) * 3:
        raise TypeError("hamming_backward_kernel: float32 inputs expected")
    m, u, g = m.contiguous(), u.contiguous(), g.contiguous()
    dm = torch.empty_like(m)
    du = torch.empty_like(u)
    _, threads = backward_launch(B, D)
    lib = load_library()
    with torch.cuda.device(m.device):
        stream = torch.cuda.current_stream(m.device).cuda_stream
        rc = lib.qmann_hamming_backward(
            m.data_ptr(), u.data_ptr(), g.data_ptr(), dm.data_ptr(),
            du.data_ptr(), B, M, D, iwl, round_mode, num_bit, const_scale,
            threads, stream)
    if rc != 0:
        raise RuntimeError(f"hamming backward kernel launch failed: CUDA "
                           f"error {rc}")
    hamming_backward_kernel.launches += 1
    return dm, du


hamming_backward_kernel.launches = 0
