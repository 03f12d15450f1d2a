"""Operations and bytes that a cell's work needs, from its inputs and
shapes alone, and the least time the card could take for them.

The counts are the same whatever implements the work, so that no later
change can read above 100% by doing the same work another way:

* bytes: each input byte read once and each output byte written once, in
  the smallest exact form the data takes.  A Q-format word of the
  configurations is 8 bits, so a quantized weight, embedding or
  activation is one byte; a bag-of-words row is its nonzero entries as
  (index, count) byte pairs; a memory mask is one length byte a query.
  Rows a story does not use (past its last sentence) need nothing;
* operations: a multiply and an add for every product the inputs need
  (the nonzero entries of a bag-of-words row, a story's live rows);
* the peak: the card's highest dense rate (``peaks.json``), since
  Q-format products are small integers that the int8 tensor cores compute
  exactly.

``least_s`` is max(bytes / bandwidth, operations / peak).  ``mfu``'s
numerator is the architecture's dense FLOPs over the live samples:
``forward_flops``, three times that for a training step.
"""
from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).parent / "peaks.json").read_text())
PEAK_OPS = float(PEAKS["peak_ops_per_s"])
HBM_BYTES = float(PEAKS["hbm_bytes_per_s"])


def least_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the bandwidth and the operations over the peak."""
    return max(nbytes / HBM_BYTES, ops / PEAK_OPS)


def lattice_call(rows: int, nnz: int, out_dim: int, in_dim: int,
                 runs: int = 1, dense: bool = False):
    """(ops, bytes) of one lattice launch out[r, n, o] = Q(sum_i Q(Q(w[r,
    o, i]) Q(x[r, n, i]))) over ``rows`` live rows of x with ``nnz``
    nonzero entries in all (every entry of a dense x); ``runs`` weight
    matrices [out_dim, in_dim] of one byte an entry."""
    in_bytes = nnz if dense else 2 * nnz
    nbytes = runs * out_dim * in_dim + in_bytes + rows * out_dim
    return 2.0 * nnz * out_dim, float(nbytes)


def forward_lattice_least_s(samples: int, q_nnz: int, rows: int,
                            m_nnz: int, hops: int, dim: int, dim_input: int,
                            runs: int = 1) -> float:
    """The least time of one training-route forward's lattice launches:
    the query embedding, the 2K memory embeddings and the K linear maps,
    over ``samples`` live samples with ``q_nnz`` question nonzeros and
    ``rows`` live memory rows with ``m_nnz`` nonzeros."""
    t = least_s(*lattice_call(samples, q_nnz, dim, dim_input, runs))
    t += 2 * hops * least_s(*lattice_call(rows, m_nnz, dim, dim_input, runs))
    t += hops * least_s(*lattice_call(samples, samples * dim, dim, dim, runs,
                                      dense=True))
    return t


def chain_call(queries: int, rows: int, hops: int, dim: int):
    """(ops, bytes) of one K-hop chain over ``queries`` queries with
    ``rows`` live memory rows in all: their 2K quantized embeddings, u in
    and out, the K linear maps and one length byte a query; the score and
    the weighted sum per live row and hop, the linear map per query and
    hop."""
    nbytes = (rows * 2 * hops * dim + 2 * queries * dim + queries
              + hops * dim * dim)
    ops = hops * (4.0 * rows * dim + 2.0 * queries * dim * dim)
    return ops, float(nbytes)


def forward_flops(samples: int, rows: int, hops: int, dim: int,
                  dim_input: int) -> float:
    """Dense FLOPs of the MemN2N forward over ``samples`` samples with
    ``rows`` live memory rows in all: the query embedding, the 2K memory
    embeddings of each live row, per hop the score and the weighted sum of
    each live row, the linear map and the residual add, and the output
    layer."""
    per_sample = 2 * dim * dim_input * 2 + hops * (2 * dim * dim + dim)
    per_row = 2 * hops * 2 * dim * dim_input + hops * 4 * dim
    return float(samples * per_sample + rows * per_row)


def mfu_percent(flops: float, window_s: float) -> float:
    return 100.0 * flops / (window_s * PEAK_OPS)
