"""The quantized mat-vec lattice: a hand-written CUDA kernel for Hopper and
its plain PyTorch version.

Replaces the TPU kernel ``qmatvec_pallas`` (``_qmatvec_kernel``,
``qmann_tpu/ops/pallas/qkernels.py``), which the training forward runs
under ``use_pallas`` for the query embedding, the 2K memory embeddings and
the per-hop linear map (``ops.qlinear``'s kernel backend).  Like the TPU
kernel it leaves a binary weight format's XNOR scale to the caller.

The kernel source is ``qmann_tpu_torch/csrc/qmatvec.cu``; its header says
what bounds it on the card and what the design does about that.  It is
built with nvcc at first use (``ops/cuda/_build.py``) and bound with
ctypes.

``quantized_matvec`` dispatches on the device of ``x``: a CPU tensor takes
``quantized_matvec_reference``; a CUDA tensor launches the kernel or
raises (also when fmt_w and fmt_x mix rounding modes: the kernel fixes the
mode at compile time).  ``qmatvec_geometry`` gives the launch's rows per
block, blocks and shared memory.
``quantized_matvec.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple, Tuple

import torch

from qmann_tpu_torch.numerics import QFormat, float_quant
from qmann_tpu_torch.ops.cuda import _build

SOURCE = _build.CSRC / "qmatvec.cu"

# the kernel's operand limit, O*I + I <= 12288 floats, and its shared
# memory, O*I + rows*I <= 12288 floats (48 KB: csrc/qmatvec.cu,
# kSmemFloats); 256 threads per block
MAX_SMEM_FLOATS = 12288
THREADS = 256
# geometry, chosen by measurement on the H100 (PERF.md, section 6): a base
# tile of as many rows as one round of the threads covers, one output each
# (at most 32 rows); doubled while the grid holds more blocks than the card
# runs at once (132 SMs x 8 resident blocks of 256 threads), up to
# MAX_TILES base tiles: w's requant is then paid fewer times
RESIDENT_BLOCKS = 132 * 8
MAX_TILES = 4


class QmatvecGeometry(NamedTuple):
    rows_per_block: int
    blocks: int
    smem_bytes: int       # dynamic shared memory of one block


@functools.lru_cache(maxsize=None)
def qmatvec_geometry(B: int, O: int, I: int) -> QmatvecGeometry:
    """Rows of x per block (the kernel's grid is ceil(B / rows)): the base
    tile, doubled as above, and no more than shared memory holds beside
    Q(w)."""
    base = max(1, min(32, THREADS // O))
    rows = base
    while rows < MAX_TILES * base and -(-B // rows) > RESIDENT_BLOCKS:
        rows *= 2
    rows = min(rows, (MAX_SMEM_FLOATS - O * I) // I)
    return QmatvecGeometry(rows, -(-B // rows), 4 * (O * I + rows * I))


def build() -> Tuple[Path, str]:
    """Compile the kernel library unless it is built (see ``_build``)."""
    return _build.build(SOURCE)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    return _build.load(SOURCE, "qmann_qmatvec",
                       [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])


def quantized_matvec_reference(w: torch.Tensor, x: torch.Tensor,
                               fmt_w: QFormat, fmt_x: QFormat) -> torch.Tensor:
    """out[b, o] = Q(sum_i Q(Q(w[o,i], fmt_w) * Q(x[b,i], fmt_x), fmt_w),
    fmt_w) in plain PyTorch; w [O, I], x [B, I] -> [B, O]."""
    prod = float_quant(float_quant(w, fmt_w) * float_quant(x[:, None, :], fmt_x),
                       fmt_w)
    return float_quant(prod.sum(-1), fmt_w)


def quantized_matvec(w: torch.Tensor, x: torch.Tensor, fmt_w: QFormat,
                     fmt_x: QFormat) -> torch.Tensor:
    """The lattice (same arguments and result as
    ``quantized_matvec_reference``): the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if x.device.type == "cpu":
        return quantized_matvec_reference(w, x, fmt_w, fmt_x)
    if x.device.type != "cuda":
        raise ValueError(f"quantized_matvec: unsupported device {x.device}")
    if w.device != x.device:
        raise ValueError("quantized_matvec: inputs on different devices")
    if w.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError("quantized_matvec: float32 inputs expected")
    if w.dim() != 2 or x.dim() != 2 or w.shape[1] != x.shape[1]:
        raise ValueError(f"quantized_matvec: shapes w {tuple(w.shape)}, x "
                         f"{tuple(x.shape)} do not form [O, I] x [B, I]")
    B, I = x.shape
    O = w.shape[0]
    if not (B >= 1 and O >= 1 and I >= 1
            and O * I + I <= MAX_SMEM_FLOATS):
        raise ValueError(
            f"quantized_matvec: B={B}, O={O}, I={I} outside the kernel's "
            f"bounds B, O, I >= 1 and O*I + I <= {MAX_SMEM_FLOATS}")
    _build.check_one_rounding_mode((fmt_w, fmt_x), "quantized_matvec")
    w, x = w.contiguous(), x.contiguous()
    geo = qmatvec_geometry(B, O, I)
    out = torch.empty((B, O), dtype=torch.float32, device=x.device)
    fmts = (ctypes.c_int * 6)(fmt_w.iwl, fmt_w.frac, fmt_w.mode,
                              fmt_x.iwl, fmt_x.frac, fmt_x.mode)
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.qmann_qmatvec(w.data_ptr(), x.data_ptr(), out.data_ptr(),
                               B, O, I, fmts, geo.rows_per_block, stream)
    if rc != 0:
        raise RuntimeError(f"qmatvec kernel launch failed: CUDA error {rc}")
    quantized_matvec.launches += 1
    return out


quantized_matvec.launches = 0
