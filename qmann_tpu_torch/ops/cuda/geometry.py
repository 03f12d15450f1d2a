"""The launch rule and shape limits shared by the read kernel
(``csrc/attention_read.cu``) and the Hamming kernel (``csrc/hamming.cu``):
each takes up to ``MAX_QUERIES_PER_BLOCK`` queries per block and stages the
block's rows in dynamic shared memory; the two scores give each score row G
lanes.  Their wrappers (``attention_read.read_geometry``,
``hamming.hamming_geometry``) pass in their kernel's shared-memory size.
The surrogate backward (``csrc/hamming_bwd.cu``) shares the shape limits
and ``SMS`` only: it takes one thread per column and no shared memory.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

# bounds of the kernels (kMaxMem, kMaxDim, kMaxThreads in their sources)
MAX_MEM, MAX_DIM = 64, 256
MAX_THREADS = 512
SMEM_LIMIT = 232448        # 227 KB; the kernels take no static shared memory
SMEM_OPT_IN = 48 * 1024    # above this the launch opts in to more
# geometry, chosen by a sweep on the H100 (PERF.md, section 6): a query
# takes THREADS_PER_QUERY threads, twice as many from M > 16 memory rows on
# (the score's rows need them), and twice that again while it has its
# block to itself; queries share a block, up to MAX_QUERIES_PER_BLOCK, only
# while at least SMS blocks (one per streaming multiprocessor) remain
SMS = 132
THREADS_PER_QUERY = 128
MAX_QUERIES_PER_BLOCK = 2


class BlockGeometry(NamedTuple):
    queries_per_block: int
    threads: int
    lanes_per_row: int    # G: the score's lanes per (query, memory row)
    row_groups: int       # R: the read's weighted sum splits M rows in R
    blocks: int
    smem_bytes: int       # dynamic shared memory of one block
    opt_in: bool          # the launch raises the 48 KB default


def block_geometry(B: int, M: int, D: int,
                   smem_bytes: Callable[[int, int], int]) -> BlockGeometry:
    """The launch geometry of a kernel that takes queries per block;
    smem_bytes(qpb, threads) is the kernel's shared memory.  G is a power
    of two, at most 32 and below 2D, that lets one round of the threads
    cover the block's rows; R is the most row groups the threads cover in
    one round, at most M."""
    per_query = THREADS_PER_QUERY * (2 if M > 16 else 1)
    qpb = 1
    while (qpb < MAX_QUERIES_PER_BLOCK and -(-B // (2 * qpb)) >= SMS
           and smem_bytes(2 * qpb, MAX_THREADS) <= SMEM_LIMIT // 2):
        qpb *= 2
    threads = min(MAX_THREADS, per_query * (2 if qpb == 1 else qpb))
    G = 1
    while G < 32 and G < D and 2 * G * qpb * M <= threads:
        G *= 2
    R = max(1, min(M, threads // (qpb * D)))
    smem = smem_bytes(qpb, threads)
    return BlockGeometry(qpb, threads, G, R, -(-B // qpb), smem,
                         smem > SMEM_OPT_IN)


def check_shape(name: str, B: int, M: int, D: int) -> None:
    """The shapes the kernels take (B >= 1, 1 <= M <= 64, 1 <= D <= 256),
    checked before any launch."""
    if not (B >= 1 and 1 <= M <= MAX_MEM and 1 <= D <= MAX_DIM):
        raise ValueError(f"{name}: B={B}, M={M}, D={D} outside the kernel's "
                         f"bounds B>=1, 1<=M<={MAX_MEM}, 1<=D<={MAX_DIM}")
