"""One hop's attention read (score -> masked softmax -> weighted sum): a
hand-written CUDA kernel for Hopper and its plain PyTorch version.

Replaces the TPU kernel ``fused_attention_read_pallas``
(``_fused_read_kernel``, ``qmann_tpu/ops/pallas/qkernels.py``), which the
training forward runs once per hop under ``use_pallas``
(``ops.fused.fused_attention_read``).  Attention modes 1, 2 and 3: the
mode-3 score is the Hamming similarity of the raw m and u at the
full-width format of fmt_att (``ops.attention``), with the ``ham_*``
knobs; the kernel computes it in its own body through
``csrc/hamming.cuh``.

The kernel source is ``qmann_tpu_torch/csrc/attention_read.cu``; its header
says what bounds it on the card and what the design does about that.  It
is built with nvcc at first use (``ops/cuda/_build.py``) and bound with
ctypes.

``fused_read`` dispatches on the device of ``m``: a CPU tensor takes
``fused_read_reference``; a CUDA tensor launches the kernel or raises
(also when the formats it quantizes with mix rounding modes: the kernel
fixes the mode at compile time).  ``read_geometry`` gives the launch's
queries per block, threads, lanes per memory row, row groups of the
weighted sum and shared memory.  ``fused_read.launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import torch

from qmann_tpu_torch.numerics import QFormat
from qmann_tpu_torch.ops.attention import hamming_score_reference
from qmann_tpu_torch.ops.cuda import _build
from qmann_tpu_torch.ops.cuda.geometry import (
    BlockGeometry, block_geometry, check_shape,
)
from qmann_tpu_torch.ops.cuda.hamming import check_knobs
from qmann_tpu_torch.ops.qlinear import qscore_forward, qweighted_sum_forward
from qmann_tpu_torch.ops.softmax import masked_softmax

SOURCE = _build.CSRC / "attention_read.cu"


def read_smem_bytes(qpb: int, M: int, D: int, threads: int) -> int:
    """Dynamic shared memory of one block (csrc/attention_read.cu's
    smem_floats): the block's rows of m and of c, u prepared per query,
    the scores, the weights and the live flags per query, and one partial
    sum per thread."""
    return 4 * (2 * qpb * M * D + qpb * D + 3 * qpb * M + threads)


@functools.lru_cache(maxsize=None)
def read_geometry(B: int, M: int, D: int) -> BlockGeometry:
    """The launch geometry of the kernel for an [B, M, D] read
    (``geometry.block_geometry``)."""
    return block_geometry(B, M, D,
                          lambda qpb, t: read_smem_bytes(qpb, M, D, t))


def build() -> Tuple[Path, str]:
    """Compile the kernel library unless it is built (see ``_build``)."""
    return _build.build(SOURCE)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    return _build.load(SOURCE, "qmann_attention_read",
                       [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int] + [ctypes.c_void_p] * 3)


def _check_mode(attention_mode: int, fmt_att: QFormat, ham_num_bit: int,
                ham_const_scale: int, ham_weight_para: int) -> None:
    if attention_mode not in (1, 2, 3):
        raise ValueError(f"the attention read covers modes 1, 2 and 3, not "
                         f"mode {attention_mode}")
    if attention_mode == 3:
        check_knobs(fmt_att.iwl, ham_num_bit, ham_const_scale, fmt_att.mode,
                    ham_weight_para)


@functools.lru_cache(maxsize=None)
def _launch_arrays(B: int, M: int, D: int, fmt_att: QFormat,
                   fmt_bin: QFormat, fmt_act: QFormat, score_quantized: bool,
                   sum_quantized: bool, attention_mode: int, ham: tuple):
    """The host arrays of a launch (formats, Hamming knobs, geometry),
    built once per distinct launch (the C entry only reads them), after
    the check that the formats whose rounding mode the launch compiles in
    share one."""
    fixed = [fmt_act] if sum_quantized else []
    if attention_mode == 3:
        fixed.append(QFormat(fmt_att.iwl, 31 - fmt_att.iwl, fmt_att.mode))
    elif score_quantized:
        fixed.append(fmt_att)
    _build.check_one_rounding_mode(fixed, "fused_read")
    fmts = (ctypes.c_int * 9)(*[v for f in (fmt_att, fmt_bin, fmt_act)
                                for v in (f.iwl, f.frac, f.mode)])
    knobs = (ctypes.c_int * 4)(*(int(v) for v in ham))
    geo = read_geometry(B, M, D)
    geometry = (ctypes.c_int * 4)(geo.queries_per_block, geo.threads,
                                  geo.lanes_per_row, geo.row_groups)
    return fmts, knobs, geometry


def fused_read_reference(m: torch.Tensor, c: torch.Tensor, u: torch.Tensor,
                         mask: torch.Tensor, fmt_att: QFormat,
                         fmt_bin: QFormat, fmt_act: QFormat,
                         score_quantized: bool = True,
                         sum_quantized: bool = True, attention_mode: int = 2,
                         ham_num_bit: int = 8, ham_const_scale: int = -3,
                         ham_weight_para: int = 0, ham_weighted: bool = True):
    """The read in plain PyTorch, from the ported forwards.

    m, c [B, M, D]; u [B, D]; mask [B, M] (nonzero live) ->
    (o [B, D], p [B, M], scores [B, M]); the scores are returned raw
    (before the mask), as the unfused path reports them.  Mode 3 ignores
    score_quantized."""
    _check_mode(attention_mode, fmt_att, ham_num_bit, ham_const_scale,
                ham_weight_para)
    live = mask != 0
    if attention_mode == 3:
        scores = hamming_score_reference(
            m, u, fmt_att.iwl, ham_num_bit, ham_const_scale, fmt_att.mode,
            ham_weight_para, ham_weighted)
    else:
        scores = qscore_forward(m, u, fmt_att, fmt_bin, score_quantized)
    p = masked_softmax(scores, live)
    o = qweighted_sum_forward(c, p, live.to(torch.float32), fmt_act,
                              sum_quantized)
    return o, p, scores


def fused_read(m: torch.Tensor, c: torch.Tensor, u: torch.Tensor,
               mask: torch.Tensor, fmt_att: QFormat, fmt_bin: QFormat,
               fmt_act: QFormat, score_quantized: bool = True,
               sum_quantized: bool = True, attention_mode: int = 2,
               ham_num_bit: int = 8, ham_const_scale: int = -3,
               ham_weight_para: int = 0, ham_weighted: bool = True):
    """The read (same arguments and results as ``fused_read_reference``):
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    ham = (ham_num_bit, ham_const_scale, ham_weight_para, ham_weighted)
    _check_mode(attention_mode, fmt_att, *ham[:3])
    if m.device.type == "cpu":
        return fused_read_reference(m, c, u, mask, fmt_att, fmt_bin,
                                    fmt_act, score_quantized, sum_quantized,
                                    attention_mode, *ham)
    if m.device.type != "cuda":
        raise ValueError(f"fused_read: unsupported device {m.device}")
    if m.dim() != 3:
        raise ValueError(f"fused_read: m has shape {tuple(m.shape)}, "
                         "expected [B, M, D]")
    B, M, D = m.shape
    if c.shape != m.shape or u.shape != (B, D) or mask.shape != (B, M):
        raise ValueError(
            f"fused_read: shapes m {tuple(m.shape)}, c {tuple(c.shape)}, "
            f"u {tuple(u.shape)}, mask {tuple(mask.shape)} do not form one "
            "read")
    check_shape("fused_read", B, M, D)
    fmts, knobs, geometry = _launch_arrays(
        B, M, D, fmt_att, fmt_bin, fmt_act, bool(score_quantized),
        bool(sum_quantized), attention_mode, ham)
    for t in (c, u, mask):
        if t.device != m.device:
            raise ValueError("fused_read: inputs on different devices")
    for t in (m, c, u):
        if t.dtype != torch.float32:
            raise TypeError("fused_read: float32 inputs expected")
    m, c, u = m.contiguous(), c.contiguous(), u.contiguous()
    mask_f = mask.to(torch.float32).contiguous()
    o = torch.empty((B, D), dtype=torch.float32, device=m.device)
    p = torch.empty((B, M), dtype=torch.float32, device=m.device)
    s = torch.empty((B, M), dtype=torch.float32, device=m.device)
    lib = load_library()
    with torch.cuda.device(m.device):
        stream = torch.cuda.current_stream(m.device).cuda_stream
        rc = lib.qmann_attention_read(
            m.data_ptr(), c.data_ptr(), u.data_ptr(), mask_f.data_ptr(),
            o.data_ptr(), p.data_ptr(), s.data_ptr(), B, M, D, fmts,
            int(score_quantized), int(sum_quantized), attention_mode, knobs,
            geometry, stream)
    if rc != 0:
        raise RuntimeError(
            f"attention_read kernel launch failed: CUDA error {rc}")
    fused_read.launches += 1
    return o, p, s


fused_read.launches = 0
