"""The mode-3 Hamming-similarity attention score: a hand-written CUDA kernel
for Hopper and its plain PyTorch version.

Replaces the TPU kernel ``hamming_score_pallas`` (``_hamming_kernel``,
``qmann_tpu/ops/pallas/qkernels.py``), which the model's forward runs once
per hop when only the score takes the kernel route: ``use_pallas_hamming``,
or ``use_pallas`` under the EN_GRAD_QUANT "backward" placement, which keeps
the unfused hop chain (``ops.attention.hamming_score`` with
``backend="kernel"``).

The kernel source is ``qmann_tpu_torch/csrc/hamming.cu``; the per-pair term
lives in ``csrc/hamming.cuh``, which the read and chain kernels include for
their mode-3 scores.  Built with nvcc at first use (``ops/cuda/_build.py``)
and bound with ctypes.

``hamming_score_kernel`` dispatches on the device of ``m``: a CPU tensor
takes ``hamming_score_reference``; a CUDA tensor launches the kernel or
raises.  ``hamming_geometry`` gives the launch's queries per block,
threads, lanes per memory row and shared memory, by the rule it shares
with the read kernel (``geometry.block_geometry``).
``hamming_score_kernel.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import torch

from qmann_tpu_torch.ops.attention import hamming_score_reference
from qmann_tpu_torch.ops.cuda import _build
from qmann_tpu_torch.ops.cuda.geometry import (
    BlockGeometry, block_geometry, check_shape,
)

SOURCE = _build.CSRC / "hamming.cu"


def hamming_smem_bytes(qpb: int, M: int, D: int) -> int:
    """Dynamic shared memory of one block (csrc/hamming.cu's smem_floats):
    the block's rows of m and each query's encoded u."""
    return 4 * (qpb * M * D + qpb * D)


@functools.lru_cache(maxsize=None)
def hamming_geometry(B: int, M: int, D: int) -> BlockGeometry:
    """The launch geometry of the kernel for an [B, M, D] score."""
    return block_geometry(B, M, D,
                          lambda qpb, _: hamming_smem_bytes(qpb, M, D))


def build() -> Tuple[Path, str]:
    """Compile the kernel library unless it is built (see ``_build``)."""
    return _build.build(SOURCE)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    return _build.load(SOURCE, "qmann_hamming_score",
                       [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p] * 2)


@functools.lru_cache(maxsize=None)
def _geometry_array(B: int, M: int, D: int):
    """The launch's geometry as the C entry reads it (only on the host),
    built once per shape."""
    geo = hamming_geometry(B, M, D)
    return (ctypes.c_int * 3)(geo.queries_per_block, geo.threads,
                              geo.lanes_per_row)


def check_knobs(iwl: int, num_bit: int, const_scale: int, round_mode: int,
                weight_para: int) -> None:
    """The ranges the kernels take (csrc/hamming.cuh: make_hamfmt), checked
    on every device so that the plain version covers the same domain."""
    if not (0 <= iwl <= 31 and 1 <= num_bit <= 32
            and -64 <= const_scale <= 64 and round_mode in (0, 1, 2, 3)
            and -32 <= weight_para <= 32):
        raise ValueError(
            f"Hamming score: iwl={iwl}, num_bit={num_bit}, const_scale="
            f"{const_scale}, round_mode={round_mode}, weight_para="
            f"{weight_para} outside iwl in [0, 31], num_bit in [1, 32], "
            "const_scale in [-64, 64], round_mode in 0..3, weight_para in "
            "[-32, 32]")


def hamming_score_kernel(m: torch.Tensor, u: torch.Tensor, iwl: int,
                         num_bit: int, const_scale: int = -3,
                         round_mode: int = 3, weight_para: int = 0,
                         weighted: bool = True) -> torch.Tensor:
    """m [B, M, D], u [B, D] -> scores [B, M] (the arguments of
    ``hamming_score_reference``): the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    check_knobs(iwl, num_bit, const_scale, round_mode, weight_para)
    if m.device.type == "cpu":
        return hamming_score_reference(m, u, iwl, num_bit, const_scale,
                                       round_mode, weight_para, weighted)
    if m.device.type != "cuda":
        raise ValueError(f"hamming_score_kernel: unsupported device "
                         f"{m.device}")
    if m.dim() != 3 or u.dim() != 2 or u.shape != (m.shape[0], m.shape[2]):
        raise ValueError(f"hamming_score_kernel: shapes m {tuple(m.shape)}, "
                         f"u {tuple(u.shape)}, expected [B, M, D] and [B, D]")
    B, M, D = m.shape
    check_shape("hamming_score_kernel", B, M, D)
    if u.device != m.device:
        raise ValueError("hamming_score_kernel: inputs on different devices")
    if m.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError("hamming_score_kernel: float32 inputs expected")
    m, u = m.contiguous(), u.contiguous()
    s = torch.empty((B, M), dtype=torch.float32, device=m.device)
    geometry = _geometry_array(B, M, D)
    lib = load_library()
    with torch.cuda.device(m.device):
        stream = torch.cuda.current_stream(m.device).cuda_stream
        rc = lib.qmann_hamming_score(
            m.data_ptr(), u.data_ptr(), s.data_ptr(), B, M, D, iwl,
            round_mode, num_bit, const_scale, weight_para, int(weighted),
            geometry, stream)
    if rc != 0:
        raise RuntimeError(f"hamming kernel launch failed: CUDA error {rc}")
    hamming_score_kernel.launches += 1
    return s


hamming_score_kernel.launches = 0
