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
O*I + I <= 12288 run the whole-row kernel, which forms only the products
whose Q(x) entry is nonzero (``skips_zeros``: not for a binary or 31-bit
format), wider ones the kernel tiled over I and O.  Both take a family
axis: w [R, O, I] against x [R, B, I] gives [R, B, O], each run's rows
against its own weights, in one launch (the family trainer,
``train/multi.py``; JAX's vmap of the TPU kernel).  ``qmatvec_geometry``
gives the launch's rows per block, tiles, blocks and shared memory.
``quantized_matvec.launches`` counts kernel launches (one per call),
``quantized_matvec.sparse_launches`` those that skip the zero entries.
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

# the whole-row kernel's operand limit, O*I + I <= 12288 floats
# (csrc/qmatvec.cu, kSmemFloats); its shared memory is Q(w) transposed, I
# rows of wq_stride(O, I) floats, a NaN bit per column and each warp's list
# of the entries it takes (``whole_row_smem_bytes``: past 48 KB only at
# the widest O*I); 256 threads (WARPS warps) per block, one warp a row of
# x, taken in pieces of CHUNKS x 32 entries.  Past the limit the tiled
# kernel takes O in tiles of at most THREADS outputs and I in tiles of at
# most MAX_I_TILE, with (o_tile + rows) * (i_tile | 1) floats of shared
# memory (about 20 KB at O=60: 8 blocks of 256 threads stay resident per
# SM), and keeps up to MAX_OUTPUTS raw sums per thread in registers
# (kMaxOutputs)
MAX_SMEM_FLOATS = 12288
THREADS = 256
WARPS = THREADS // 32
CHUNKS = 4            # a warp takes a row in pieces of CHUNKS x 32 entries
MAX_RUNS = 65535      # the family axis is the grid's z extent
MAX_I_TILE = 64
MAX_OUTPUTS = 4
# the blocks the card runs at once (132 SMs x 8 resident blocks of 256
# threads).  Whole rows: one row a warp while every run's blocks fit in
# one wave, else as many blocks a run as one wave holds, the rows shared
# evenly, but for MAX_ROWS rows a block (the fastest of 96 to 640 at the
# family's shapes, PERF.md), so that each block pays its run's Q(w) once
# for many rows.  Tiled: a base tile of as many rows as one round of the
# threads covers, one output each (at most 32 rows), doubled while the
# grid holds more blocks than the card runs at once, up to MAX_TILES base
# tiles
RESIDENT_BLOCKS = 132 * 8
MAX_ROWS = 160
MAX_TILES = 4
# products per piece of the plain version, which takes its rows in pieces
# so that a family's lattice (R x B x O x I products) fits in memory
PLAIN_CHUNK = 1 << 26


class QmatvecGeometry(NamedTuple):
    rows_per_block: int
    o_tile: int           # O and I for the whole-row kernel
    i_tile: int
    blocks: int
    smem_bytes: int       # dynamic shared memory of one block


def _rows(B: int, o_tile: int, o_blocks: int) -> int:
    """The tiled kernel's rows: the base tile (one round of the threads
    over o_tile outputs, at most 32 rows), doubled up to MAX_TILES times
    while the grid holds more blocks than the card runs at once (o_blocks:
    the blocks beside each tile of rows, over O and the runs)."""
    base = max(1, min(32, THREADS // o_tile))
    rows = base
    while (rows < MAX_TILES * base
           and -(-B // rows) * o_blocks > RESIDENT_BLOCKS):
        rows *= 2
    return rows


def wq_stride(O: int, I: int) -> int:
    """The row stride of the whole-row kernel's staged Q(w)^T: O, made odd
    where the padded layout fits (csrc/qmatvec.cu, wq_stride)."""
    odd = I * (O | 1) + -(-I // 32)
    return O | 1 if odd <= MAX_SMEM_FLOATS else O


def whole_row_smem_bytes(O: int, I: int) -> int:
    """The whole-row kernel's shared memory: Q(w)^T, a NaN bit per column,
    then (8-byte aligned) each warp's list of the (offset, value) pairs it
    takes from a piece of CHUNKS x 32 entries of a row."""
    floats = (I * wq_stride(O, I) + -(-I // 32) + 1) & ~1
    return 4 * (floats + WARPS * 32 * CHUNKS * 2)


@functools.lru_cache(maxsize=None)
def qmatvec_geometry(B: int, O: int, I: int, R: int = 1) -> QmatvecGeometry:
    """The launch of R runs of B rows: whole rows (o_tile = O, i_tile = I;
    grid ceil(B / rows) x 1 x R) while Q(w) and one row of x fit in shared
    memory, rows a multiple of WARPS, as few as keep the grid within the
    card's resident blocks but for MAX_ROWS; else tiles of O (at most
    THREADS outputs) and I (at most MAX_I_TILE, and what shared memory
    holds beside the row tile), grid ceil(B / rows) x ceil(O / o_tile) x
    R.  R = 1 is the 2-D call."""
    if O * I + I <= MAX_SMEM_FLOATS:
        warp_rows = -(-B // WARPS)
        per_run = max(1, min(warp_rows, max(RESIDENT_BLOCKS // R,
                                            -(-B // MAX_ROWS))))
        rows = WARPS * -(-warp_rows // per_run)
        return QmatvecGeometry(rows, O, I, -(-B // rows) * R,
                               whole_row_smem_bytes(O, I))
    o_tile = min(O, THREADS)
    o_blocks = -(-O // o_tile)
    rows = _rows(B, o_tile, o_blocks * R)
    i_tile = min(I, MAX_I_TILE, MAX_SMEM_FLOATS // (o_tile + rows) - 1)
    return QmatvecGeometry(rows, o_tile, i_tile,
                           -(-B // rows) * o_blocks * R,
                           4 * (o_tile + rows) * (i_tile | 1))


def skips_zeros(geo: QmatvecGeometry, O: int, I: int, fmt_w: QFormat,
                fmt_x: QFormat) -> bool:
    """Whether the launch takes the route that skips the zero entries of
    Q(x): the whole-row kernel with both formats on the compile-time
    quantizer (FastQ: non-binary, at most 30 bits, one rounding mode)."""
    fast = all(not f.is_binary and f.iwl + f.frac <= 30
               for f in (fmt_w, fmt_x)) and fmt_w.mode == fmt_x.mode
    return fast and (geo.o_tile, geo.i_tile) == (O, I)


def build() -> Tuple[Path, str]:
    """Compile the kernel library unless it is built (see ``_build``)."""
    return _build.build(SOURCE)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    return _build.load(SOURCE, "qmann_qmatvec",
                       [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])


def _check_shapes(w: torch.Tensor, x: torch.Tensor) -> None:
    if not ((w.dim() == 2 and x.dim() == 2
             or w.dim() == 3 and x.dim() == 3 and w.shape[0] == x.shape[0])
            and w.shape[-1] == x.shape[-1]):
        raise ValueError(f"quantized_matvec: shapes w {tuple(w.shape)}, x "
                         f"{tuple(x.shape)} do not form [O, I] x [B, I] or "
                         "[R, O, I] x [R, B, I]")


def quantized_matvec_reference(w: torch.Tensor, x: torch.Tensor,
                               fmt_w: QFormat, fmt_x: QFormat) -> torch.Tensor:
    """out[b, o] = Q(sum_i Q(Q(w[o,i], fmt_w) * Q(x[b,i], fmt_x), fmt_w),
    fmt_w) in plain PyTorch; w [O, I], x [B, I] -> [B, O], or per run of
    the family axis, w [R, O, I], x [R, B, I] -> [R, B, O].  The products
    are formed in pieces of at most PLAIN_CHUNK (every output is its own
    exact sum, so the pieces change no bit)."""
    _check_shapes(w, x)
    if w.dim() == 2:
        return quantized_matvec_reference(w[None], x[None], fmt_w, fmt_x)[0]
    R, B, _ = x.shape
    O, I = w.shape[1:]
    wq = float_quant(w, fmt_w)[:, None]                     # [R, 1, O, I]
    rows = max(1, min(B, PLAIN_CHUNK // (O * I)))
    runs = max(1, PLAIN_CHUNK // (rows * O * I))
    out = torch.empty((R, B, O), dtype=torch.float32, device=x.device)
    for r in range(0, R, runs):
        for b in range(0, B, rows):
            xq = float_quant(x[r:r + runs, b:b + rows, None, :], fmt_x)
            prod = float_quant(wq[r:r + runs] * xq, fmt_w)
            out[r:r + runs, b:b + rows] = float_quant(prod.sum(-1), fmt_w)
    return out


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
    _check_shapes(w, x)
    R = w.shape[0] if w.dim() == 3 else 1
    B, I = x.shape[-2:]
    O = w.shape[-2]
    if not (1 <= R <= MAX_RUNS and B >= 1 and O >= 1 and I >= 1):
        raise ValueError(f"quantized_matvec: R={R}, B={B}, O={O}, I={I} "
                         "outside the kernel's bounds 1 <= R <= "
                         f"{MAX_RUNS}, B, O, I >= 1")
    _build.check_one_rounding_mode((fmt_w, fmt_x), "quantized_matvec")
    w, x = w.contiguous(), x.contiguous()
    geo = qmatvec_geometry(B, O, I, R)
    out = torch.empty(tuple(x.shape[:-1]) + (O,), dtype=torch.float32,
                      device=x.device)
    fmts = (ctypes.c_int * 6)(fmt_w.iwl, fmt_w.frac, fmt_w.mode,
                              fmt_x.iwl, fmt_x.frac, fmt_x.mode)
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.qmann_qmatvec(w.data_ptr(), x.data_ptr(), out.data_ptr(),
                               R, B, O, I, fmts, geo.rows_per_block,
                               geo.o_tile, geo.i_tile, stream)
    if rc != 0:
        raise RuntimeError(f"qmatvec kernel launch failed: CUDA error {rc}")
    quantized_matvec.launches += 1
    quantized_matvec.sparse_launches += skips_zeros(geo, O, I, fmt_w, fmt_x)
    return out


quantized_matvec.launches = 0
quantized_matvec.sparse_launches = 0
