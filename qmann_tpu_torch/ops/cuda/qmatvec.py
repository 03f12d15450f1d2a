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
mode at compile time).  It takes any O, I >= 1: shapes with
O*I + I <= 12288 run the whole-row kernel, wider ones the kernel tiled over
I and O.  ``qmatvec_geometry`` gives the launch's rows per block, tiles,
blocks and shared memory.  ``quantized_matvec.launches`` counts kernel
launches (one per call).
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

# the whole-row kernel's operand limit, O*I + I <= 12288 floats, and its
# shared memory, O*I + rows*I <= 12288 floats (48 KB: csrc/qmatvec.cu,
# kSmemFloats); 256 threads per block.  Past the limit the tiled kernel
# takes O in tiles of at most THREADS outputs and I in tiles of at most
# MAX_I_TILE, with (o_tile + rows) * (i_tile | 1) floats of shared memory
# (about 20 KB at O=60: 8 blocks of 256 threads stay resident per SM), and
# keeps up to MAX_OUTPUTS raw sums per thread in registers (kMaxOutputs)
MAX_SMEM_FLOATS = 12288
THREADS = 256
MAX_I_TILE = 64
MAX_OUTPUTS = 4
# geometry, chosen by measurement on the H100 (PERF.md, section 6): a base
# tile of as many rows as one round of the threads covers, one output each
# (at most 32 rows); doubled while the grid holds more blocks than the card
# runs at once (132 SMs x 8 resident blocks of 256 threads), up to
# MAX_TILES base tiles: w's requant is then paid fewer times
RESIDENT_BLOCKS = 132 * 8
MAX_TILES = 4


class QmatvecGeometry(NamedTuple):
    rows_per_block: int
    o_tile: int           # O and I for the whole-row kernel
    i_tile: int
    blocks: int
    smem_bytes: int       # dynamic shared memory of one block


def _rows(B: int, o_tile: int, o_blocks: int) -> int:
    """The base tile of rows (one round of the threads over o_tile
    outputs, at most 32 rows), doubled up to MAX_TILES times while the grid
    holds more blocks than the card runs at once."""
    base = max(1, min(32, THREADS // o_tile))
    rows = base
    while (rows < MAX_TILES * base
           and -(-B // rows) * o_blocks > RESIDENT_BLOCKS):
        rows *= 2
    return rows


@functools.lru_cache(maxsize=None)
def qmatvec_geometry(B: int, O: int, I: int) -> QmatvecGeometry:
    """The launch: whole rows (o_tile = O, i_tile = I; grid ceil(B / rows))
    while Q(w) and one row of x fit in shared memory, rows no more than fit
    beside Q(w); else tiles of O (at most THREADS outputs) and I (at most
    MAX_I_TILE, and what shared memory holds beside the row tile), grid
    ceil(B / rows) x ceil(O / o_tile)."""
    if O * I + I <= MAX_SMEM_FLOATS:
        rows = min(_rows(B, O, 1), (MAX_SMEM_FLOATS - O * I) // I)
        return QmatvecGeometry(rows, O, I, -(-B // rows),
                               4 * (O * I + rows * I))
    o_tile = min(O, THREADS)
    o_blocks = -(-O // o_tile)
    rows = _rows(B, o_tile, o_blocks)
    i_tile = min(I, MAX_I_TILE, MAX_SMEM_FLOATS // (o_tile + rows) - 1)
    return QmatvecGeometry(rows, o_tile, i_tile, -(-B // rows) * o_blocks,
                           4 * (o_tile + rows) * (i_tile | 1))


def build() -> Tuple[Path, str]:
    """Compile the kernel library unless it is built (see ``_build``)."""
    return _build.build(SOURCE)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    return _build.load(SOURCE, "qmann_qmatvec",
                       [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])


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
    if not (B >= 1 and O >= 1 and I >= 1):
        raise ValueError(f"quantized_matvec: B={B}, O={O}, I={I} outside the "
                         "kernel's bounds B, O, I >= 1")
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
                               B, O, I, fmts, geo.rows_per_block, geo.o_tile,
                               geo.i_tile, stream)
    if rc != 0:
        raise RuntimeError(f"qmatvec kernel launch failed: CUDA error {rc}")
    quantized_matvec.launches += 1
    return out


quantized_matvec.launches = 0
