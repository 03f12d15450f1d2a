"""The fused K-hop chain: a hand-written CUDA kernel for Hopper and its plain
PyTorch version.

Replaces the TPU kernel ``fused_hop_chain_pallas`` (``_fused_chain_kernel``,
``qmann_tpu/ops/pallas/qkernels.py``) on the serving path
(``models.memn2n.forward_prepared`` with ``use_fused_chain``), attention
mode 2 only; the mode-3 in-chain Hamming score is not ported yet.

The kernel source is ``qmann_tpu_torch/csrc/hop_chain.cu``; its header says
what bounds it on the card and what the design does about that.  It is
compiled with nvcc into a shared library with a plain C interface at first
use, into ``qmann_tpu_torch/_build/`` (keyed by a hash of the source and
flags), and bound with ctypes.

``fused_hop_chain`` dispatches on the device of ``flat``: a CPU tensor takes
``fused_hop_chain_reference``; a CUDA tensor launches the kernel or raises.
``fused_hop_chain.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Sequence, Tuple

import torch

from qmann_tpu_torch.numerics import QFormat, float_quant
from qmann_tpu_torch.ops.elementwise import activation, qsum
from qmann_tpu_torch.ops.qlinear import qmatvec, qscore, qweighted_sum
from qmann_tpu_torch.ops.softmax import softmax

_PKG = Path(__file__).resolve().parents[2]
SOURCE = _PKG / "csrc" / "hop_chain.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# bounds of the kernel (csrc/hop_chain.cu: kMaxHops, kMaxMem, kMaxDim)
MAX_HOPS, MAX_MEM, MAX_DIM = 8, 64, 128


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: the chain kernel needs nvcc")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build() -> Tuple[Path, str]:
    """Compile the kernel library unless a build of the same source and
    flags exists.  Returns the library path and the compiler's log ("" when
    the library was already built)."""
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libhop_chain_{key}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n{proc.stderr}")
    os.replace(tmp, lib)   # atomic: concurrent builders race harmlessly
    return lib, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    lib.qmann_hop_chain.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib.qmann_hop_chain.restype = ctypes.c_int
    return lib


def fused_hop_chain_reference(flat: torch.Tensor, u: torch.Tensor,
                              hmats: torch.Tensor, mask: torch.Tensor,
                              fmts_w: Sequence[QFormat],
                              fmts_att: Sequence[QFormat], fmt_bin: QFormat,
                              fmts_act: Sequence[QFormat],
                              linear_mapping: bool = True,
                              non_linearity: bool = False):
    """The chain in plain PyTorch, from the ported ops.

    flat [B, M, 2K*D] raw stacked-GEMM output; u [B, D] (quantized at
    fmt_w[0]); hmats [K, D, D] raw; mask [B, M] -> (u_final [B, D],
    p [K, B, M], scores [K, B, M])."""
    K = hmats.shape[0]
    D = u.shape[-1]
    live = mask != 0
    live_f = live.to(torch.float32)
    ps, ss = [], []
    for h in range(K):
        m = float_quant(flat[..., h * D:(h + 1) * D], fmts_w[h])
        c = float_quant(flat[..., (K + h) * D:(K + h + 1) * D], fmts_w[h])
        s = qscore(m, u, fmts_att[h], fmt_bin)
        p = softmax(s, live)
        o = qweighted_sum(c, p, live_f, fmts_act[h])
        u_m = qmatvec(hmats[h], u, fmts_w[h], fmt_bin) if linear_mapping else u
        u = qsum(u_m, o, fmts_act[h])
        if non_linearity:
            u = activation(u, "RELU", fmts_act[h], quantized=True)
        ps.append(p)
        ss.append(s)
    return u, torch.stack(ps), torch.stack(ss)


def fused_hop_chain(flat: torch.Tensor, u: torch.Tensor, hmats: torch.Tensor,
                    mask: torch.Tensor, fmts_w: Sequence[QFormat],
                    fmts_att: Sequence[QFormat], fmt_bin: QFormat,
                    fmts_act: Sequence[QFormat], linear_mapping: bool = True,
                    non_linearity: bool = False, attention_mode: int = 2):
    """The K-hop chain (same arguments and results as
    ``fused_hop_chain_reference``): the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if attention_mode != 2:
        raise NotImplementedError(
            "the chain kernel covers attention mode 2; the mode-3 in-chain "
            "Hamming score is not ported yet (ROADMAP.md, Queue 2)")
    if flat.device.type == "cpu":
        return fused_hop_chain_reference(flat, u, hmats, mask, fmts_w,
                                         fmts_att, fmt_bin, fmts_act,
                                         linear_mapping, non_linearity)
    if flat.device.type != "cuda":
        raise ValueError(f"fused_hop_chain: unsupported device {flat.device}")
    B, M, KD2 = flat.shape
    K = hmats.shape[0]
    D = u.shape[-1]
    if KD2 != 2 * K * D or u.shape != (B, D) or hmats.shape != (K, D, D) \
            or mask.shape != (B, M):
        raise ValueError(
            f"fused_hop_chain: shapes flat {tuple(flat.shape)}, u "
            f"{tuple(u.shape)}, hmats {tuple(hmats.shape)}, mask "
            f"{tuple(mask.shape)} do not form one chain")
    if not (1 <= K <= MAX_HOPS and 1 <= M <= MAX_MEM and 1 <= D <= MAX_DIM
            and B >= 1):
        raise ValueError(
            f"fused_hop_chain: K={K}, M={M}, D={D}, B={B} outside the "
            f"kernel's bounds K<={MAX_HOPS}, M<={MAX_MEM}, D<={MAX_DIM}")
    if len(fmts_w) != K or len(fmts_att) != K or len(fmts_act) != K:
        raise ValueError("fused_hop_chain: one format per hop expected")
    for t in (u, hmats, mask):
        if t.device != flat.device:
            raise ValueError("fused_hop_chain: inputs on different devices")
    for t in (flat, u, hmats):
        if t.dtype != torch.float32:
            raise TypeError("fused_hop_chain: float32 inputs expected")
    flat, u, hmats = flat.contiguous(), u.contiguous(), hmats.contiguous()
    mask_i = mask.to(torch.int32).contiguous()
    u_out = torch.empty((B, D), dtype=torch.float32, device=flat.device)
    p = torch.empty((K, B, M), dtype=torch.float32, device=flat.device)
    s = torch.empty((K, B, M), dtype=torch.float32, device=flat.device)
    slots = [*fmts_w, *fmts_att, *fmts_act, fmt_bin]
    fmts = (ctypes.c_int * (3 * len(slots)))(
        *[v for f in slots for v in (f.iwl, f.frac, f.mode)])
    lib = load_library()
    with torch.cuda.device(flat.device):
        stream = torch.cuda.current_stream(flat.device).cuda_stream
        rc = lib.qmann_hop_chain(
            flat.data_ptr(), u.data_ptr(), hmats.data_ptr(),
            mask_i.data_ptr(), u_out.data_ptr(), p.data_ptr(), s.data_ptr(),
            B, M, D, K, fmts, int(linear_mapping), int(non_linearity),
            stream)
    if rc != 0:
        raise RuntimeError(f"hop_chain kernel launch failed: CUDA error {rc}")
    fused_hop_chain.launches += 1
    return u_out, p, s


fused_hop_chain.launches = 0
