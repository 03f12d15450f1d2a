"""The fused K-hop chain: a hand-written CUDA kernel for Hopper and its plain
PyTorch version.

Replaces the TPU kernel ``fused_hop_chain_pallas`` (``_fused_chain_kernel``,
``qmann_tpu/ops/pallas/qkernels.py``), and the embedding GEMM before it, on
the serving path (``models.memn2n.forward_prepared`` with
``use_fused_chain``), attention modes 2 and 3.  In mode 3 each hop scores
the Hamming similarity of its requanted m and the raw current u
(``ops.attention``) with the ``ham_*`` knobs; the kernel computes it in its
own body through ``csrc/hamming.cuh``.

The kernel source is ``qmann_tpu_torch/csrc/hop_chain.cu``; its header says
what bounds it on the card and what the design does about that.  It is
compiled with nvcc into a shared library with a plain C interface at first
use, into ``qmann_tpu_torch/_build/`` (``ops/cuda/_build.py``), and bound
with ctypes.

The entry, ``fused_hop_chain_from_memory``, takes the bag-of-words memory
[B, M, I] and the stacked quantized embeddings Q(A|C) [I, 2K*D], and the
kernel builds each hop's slices itself, so the product flat [B, M, 2K*D]
is never written or read.  It dispatches on the device of the memory: a
CPU tensor takes the plain version
(``fused_hop_chain_from_memory_reference``: the exact GEMM, then the plain
chain ``fused_hop_chain_reference`` on flat); a CUDA tensor launches the
kernel or raises (also when the formats mix rounding modes: the kernel
fixes the mode at compile time).  ``chain_geometry`` gives the launch's
queries per block, threads, shared memory and whether each hop's weight
slices are staged in shared memory.  ``fused_hop_chain_from_memory.launches``
counts its launches.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple, Sequence, Tuple

import torch

from qmann_tpu_torch.numerics import QFormat, float_quant
from qmann_tpu_torch.ops.attention import attention_score
from qmann_tpu_torch.ops.cuda import _build
from qmann_tpu_torch.ops.cuda.hamming import check_knobs
from qmann_tpu_torch.ops.elementwise import activation, qsum
from qmann_tpu_torch.ops.qlinear import exact_matmul, qmatvec, qweighted_sum
from qmann_tpu_torch.ops.softmax import softmax

SOURCE = _build.CSRC / "hop_chain.cu"

# bounds of the kernel (csrc/hop_chain.cu: kMaxHops, kMaxMem, kMaxDim,
# kMaxThreads, kSmemLimit: 227 KB of shared memory less 1 KB of static
# formats)
MAX_HOPS, MAX_MEM, MAX_DIM = 8, 64, 128
MAX_THREADS = 512
SMEM_LIMIT = 232448 - 1024
SMEM_OPT_IN = 48 * 1024    # above this the launch opts in to more
LIST_ENTRIES = 8           # kList: nonzero entries of x listed a row
# geometry, chosen by measurement on the H100 (PERF.md, section 6): up to
# QUERIES_PER_BLOCK queries per block while at least MIN_BLOCKS blocks (one
# per SM) remain and two blocks fit an SM's shared memory; 512 threads
QUERIES_PER_BLOCK = 4
MIN_BLOCKS = 132


class ChainGeometry(NamedTuple):
    queries_per_block: int
    threads: int
    blocks: int
    smem_bytes: int       # dynamic shared memory of one block
    opt_in: bool          # the launch raises the 48 KB default
    weights_staged: bool  # hop h's Q(A|C) slices staged in shared memory


def chain_smem_bytes(qpb: int, M: int, D: int, I: int,
                     weights_staged: bool) -> int:
    """Dynamic shared memory of one block (csrc/hop_chain.cu's
    smem_floats) for a memory of I entries a row: Q(H[h]) with a row
    stride of D+1, in a buffer that also holds hop h's weight slices
    [I, 2D] when they are staged (a 16-byte multiple); each row's list of
    LIST_ENTRIES nonzero entries of x with its count, and one stage of the
    hop's A and C slices; u, Q(u, bin) and u_map per query, the scores,
    Q(p) and the live mask per query."""
    hbuf = max(D * (D + 1), 2 * I * D if weights_staged else 0)
    slices = -(-hbuf // 4) * 4 + qpb * M * (2 * D + 2 * LIST_ENTRIES + 1)
    return 4 * (slices + 3 * qpb * D + 3 * qpb * M)


def list_slots(qpb: int, rows: int, M: int, D: int, I: int,
               weights_staged: bool) -> int:
    """The slots a row's list of x gets (csrc/hop_chain.cu's L) in a block
    of `rows` rows with a row of more than LIST_ENTRIES nonzero entries:
    where the weight slices are staged, the lists take their room too
    (the weights are then read through the cache); else LIST_ENTRIES."""
    h0 = -(-D * (D + 1) // 4) * 4
    hbuf = max(h0, -(-2 * I * D // 4) * 4 if weights_staged else 0)
    if hbuf == h0:
        return LIST_ENTRIES
    return ((hbuf - h0) // 2 + qpb * M * LIST_ENTRIES) // rows & ~1


@functools.lru_cache(maxsize=None)
def chain_geometry(B: int, M: int, D: int, K: int, I: int) -> ChainGeometry:
    """The launch geometry of the kernel for a chain of B queries of M
    rows from a memory of I entries a row, with each hop's weight slices
    staged in shared memory wherever they fit beside one query's block."""
    del K   # the hops run inside the block; the geometry does not see them
    staged = chain_smem_bytes(1, M, D, I, True) <= SMEM_LIMIT
    qpb = QUERIES_PER_BLOCK
    while qpb > 1 and (-(-B // qpb) < MIN_BLOCKS
                       or chain_smem_bytes(qpb, M, D, I, staged)
                       > SMEM_LIMIT // 2):
        qpb //= 2
    # 512 threads at every qpb (one thread a column of the slices and a
    # group of rows, the more groups the shorter each walk)
    threads = MAX_THREADS
    smem = chain_smem_bytes(qpb, M, D, I, staged)
    return ChainGeometry(qpb, threads, -(-B // qpb), smem,
                         smem > SMEM_OPT_IN, staged)


def build() -> Tuple[Path, str]:
    """Compile the kernel library unless it is built (see ``_build``)."""
    return _build.build(SOURCE)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    return _build.load(SOURCE, "qmann_hop_chain",
                       [ctypes.c_void_p] * 2 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p] + [ctypes.c_int] * 4
                       + [ctypes.c_void_p] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])


def _check_mode(attention_mode: int, fmts_att: Sequence[QFormat],
                ham_num_bit: int, ham_const_scale: int,
                ham_weight_para: int) -> None:
    if attention_mode not in (2, 3):
        raise ValueError(f"the chain covers attention modes 2 and 3, not "
                         f"mode {attention_mode}")
    if attention_mode == 3:
        for f in fmts_att:
            check_knobs(f.iwl, ham_num_bit, ham_const_scale, f.mode,
                        ham_weight_para)


def fused_hop_chain_reference(flat: torch.Tensor, u: torch.Tensor,
                              hmats: torch.Tensor, mask: torch.Tensor,
                              fmts_w: Sequence[QFormat],
                              fmts_att: Sequence[QFormat], fmt_bin: QFormat,
                              fmts_act: Sequence[QFormat],
                              linear_mapping: bool = True,
                              non_linearity: bool = False,
                              attention_mode: int = 2, ham_num_bit: int = 8,
                              ham_const_scale: int = -3,
                              ham_weight_para: int = 0,
                              ham_weighted: bool = True):
    """The chain in plain PyTorch, from the ported ops.

    flat [B, M, 2K*D] raw stacked-GEMM output; u [B, D] (quantized at
    fmt_w[0]); hmats [K, D, D] raw; mask [B, M] -> (u_final [B, D],
    p [K, B, M], scores [K, B, M])."""
    _check_mode(attention_mode, fmts_att, ham_num_bit, ham_const_scale,
                ham_weight_para)
    K = hmats.shape[0]
    D = u.shape[-1]
    live = mask != 0
    live_f = live.to(torch.float32)
    ps, ss = [], []
    for h in range(K):
        m = float_quant(flat[..., h * D:(h + 1) * D], fmts_w[h])
        c = float_quant(flat[..., (K + h) * D:(K + h + 1) * D], fmts_w[h])
        s = attention_score(m, u, attention_mode, fmts_att[h], fmt_bin,
                            num_bit=ham_num_bit, const_scale=ham_const_scale,
                            hamming_weight_para=ham_weight_para,
                            hamming_weighted=ham_weighted)
        p = softmax(s, live)
        o = qweighted_sum(c, p, live_f, fmts_act[h])
        u_m = qmatvec(hmats[h], u, fmts_w[h], fmt_bin) if linear_mapping else u
        u = qsum(u_m, o, fmts_act[h])
        if non_linearity:
            u = activation(u, "RELU", fmts_act[h], quantized=True)
        ps.append(p)
        ss.append(s)
    return u, torch.stack(ps), torch.stack(ss)


def fused_hop_chain_from_memory_reference(memory: torch.Tensor,
                                          embed_wt: torch.Tensor,
                                          u: torch.Tensor,
                                          hmats: torch.Tensor,
                                          mask: torch.Tensor, *args,
                                          **kwargs):
    """``fused_hop_chain_from_memory`` in plain PyTorch: the exact stacked
    GEMM, then ``fused_hop_chain_reference`` (same further arguments)."""
    return fused_hop_chain_reference(exact_matmul(memory, embed_wt), u,
                                     hmats, mask, *args, **kwargs)


def fused_hop_chain_from_memory(memory: torch.Tensor,
                                embed_wt: torch.Tensor, u: torch.Tensor,
                                hmats: torch.Tensor, mask: torch.Tensor,
                                fmts_w: Sequence[QFormat],
                                fmts_att: Sequence[QFormat],
                                fmt_bin: QFormat,
                                fmts_act: Sequence[QFormat],
                                linear_mapping: bool = True,
                                non_linearity: bool = False,
                                attention_mode: int = 2,
                                ham_num_bit: int = 8,
                                ham_const_scale: int = -3,
                                ham_weight_para: int = 0,
                                ham_weighted: bool = True,
                                hmats_quantized: bool = False):
    """The K-hop chain from the bag-of-words memory [B, M, I] and the
    stacked quantized embeddings embed_wt = Q(A|C) [I, 2K*D] (u [B, D]
    quantized at fmt_w[0]; hmats [K, D, D]; mask [B, M]) -> (u_final
    [B, D], p [K, B, M], scores [K, B, M]): on a CUDA tensor the kernel,
    which builds each hop's slices itself; a CPU tensor takes
    ``fused_hop_chain_from_memory_reference``.  The kernel's results are
    the plain chain's on ``exact_matmul(memory, embed_wt)`` where that
    product is exact (``prepare_inference``'s bounds), up to the softmax's
    exp (tests/test_torch_cuda.py's tolerances).

    ``hmats_quantized`` says that hmats already holds Q(H[h], fmts_w[h])
    (``prepare_inference`` caches it for formats of at most 30 bits, where
    float_quant is idempotent): the kernel then skips its requant of H.
    The results are the same; only the work differs."""
    name = "fused_hop_chain_from_memory"
    ham = (ham_num_bit, ham_const_scale, ham_weight_para, ham_weighted)
    _check_mode(attention_mode, fmts_att, *ham[:3])
    if memory.device.type == "cpu":
        return fused_hop_chain_from_memory_reference(
            memory, embed_wt, u, hmats, mask, fmts_w, fmts_att, fmt_bin,
            fmts_act, linear_mapping, non_linearity, attention_mode, *ham)
    if memory.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {memory.device}")
    B, M, I = memory.shape
    K = hmats.shape[0]
    D = u.shape[-1]
    if tuple(embed_wt.shape) != (I, 2 * K * D) or u.shape != (B, D) \
            or hmats.shape != (K, D, D) or mask.shape != (B, M):
        raise ValueError(
            f"{name}: shapes memory {tuple(memory.shape)}, embed_wt "
            f"{tuple(embed_wt.shape)}, u {tuple(u.shape)}, hmats "
            f"{tuple(hmats.shape)}, mask {tuple(mask.shape)} do not form "
            f"one chain")
    if not (1 <= K <= MAX_HOPS and 1 <= M <= MAX_MEM and 1 <= D <= MAX_DIM
            and B >= 1):
        raise ValueError(
            f"{name}: K={K}, M={M}, D={D}, B={B} outside the "
            f"kernel's bounds K<={MAX_HOPS}, M<={MAX_MEM}, D<={MAX_DIM}")
    if len(fmts_w) != K or len(fmts_att) != K or len(fmts_act) != K:
        raise ValueError(f"{name}: one format per hop expected")
    slots = [*fmts_w, *fmts_att, *fmts_act, fmt_bin]
    # mode 3: each hop's Hamming format (iwl, 31-iwl) takes its att mode
    hams = [QFormat(f.iwl, 31 - f.iwl, f.mode) for f in fmts_att] \
        if attention_mode == 3 else []
    _build.check_one_rounding_mode(slots + hams, name)
    for t in (embed_wt, u, hmats, mask):
        if t.device != memory.device:
            raise ValueError(f"{name}: inputs on different devices")
    for t in (embed_wt, u, hmats):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: float32 inputs expected")
    memory = memory.to(torch.float32).contiguous()
    wt, u, hmats = embed_wt.contiguous(), u.contiguous(), hmats.contiguous()
    mask_i = mask.to(torch.int32).contiguous()
    u_out = torch.empty((B, D), dtype=torch.float32, device=memory.device)
    p = torch.empty((K, B, M), dtype=torch.float32, device=memory.device)
    s = torch.empty((K, B, M), dtype=torch.float32, device=memory.device)
    fmts = (ctypes.c_int * (3 * len(slots)))(
        *[v for f in slots for v in (f.iwl, f.frac, f.mode)])
    knobs = (ctypes.c_int * 4)(*(int(v) for v in ham))
    geo = chain_geometry(B, M, D, K, I)
    lib = load_library()
    with torch.cuda.device(memory.device):
        stream = torch.cuda.current_stream(memory.device).cuda_stream
        rc = lib.qmann_hop_chain(
            memory.data_ptr(), wt.data_ptr(), I, u.data_ptr(),
            hmats.data_ptr(), mask_i.data_ptr(), u_out.data_ptr(),
            p.data_ptr(), s.data_ptr(), B, M, D, K, fmts,
            int(linear_mapping), int(hmats_quantized), int(non_linearity),
            attention_mode, knobs, geo.queries_per_block, geo.threads,
            int(geo.weights_staged), stream)
    if rc != 0:
        raise RuntimeError(f"hop_chain kernel launch failed: CUDA error {rc}")
    fused_hop_chain_from_memory.launches += 1
    return u_out, p, s


fused_hop_chain_from_memory.launches = 0
