"""Similarity (softmax distribution) analysis.

The reference can dump every attention softmax's inputs and outputs per
(epoch, sample, hop) into CSVs bucketed by 25-epoch ranges
(EN_SIMILARITY_ANALYSIS, MemN2N/MemN2N.c:492-516 setup, :1416-1475 dump)
to study how quantization reshapes the attention distributions.

The port collects the same tensors from the batched forward
(ForwardResult.scores / .attention) and writes the same bucketed CSVs as
``qmann_tpu/utils/analysis.py`` (held equal by tests/test_torch_utils.py).
"""
from __future__ import annotations

import os
from typing import Optional

from qmann_tpu_torch.device import to_numpy



class SimilarityAnalyzer:
    """Accumulates per-hop softmax inputs/outputs and writes
    25-epoch-bucket CSV pairs (the reference hardcodes four buckets for
    its 100-epoch runs, MemN2N/MemN2N.c:492-516; buckets here extend to
    cover any num_itr)."""

    def __init__(self, out_dir: str = ".", num_itr: int = 100):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.buckets = tuple((lo, lo + 24)
                             for lo in range(0, max(num_itr, 1), 25))
        self._files = {}
        for lo, hi in self.buckets:
            for kind in ("input", "output"):
                path = os.path.join(out_dir, f"softmax_{kind}_{lo}to{hi}.csv")
                open(path, "w").close()  # truncate like the reference
                self._files[(kind, lo)] = path

    def _bucket(self, epoch: int) -> Optional[int]:
        for lo, hi in self.buckets:
            if lo <= epoch <= hi:
                return lo
        return None

    def record(self, epoch: int, scores, attention, mask,
               sample_offset: int = 0) -> None:
        """scores/attention: [K, B, M]; mask: [B, M].  One CSV row per
        (sample, hop) with only the live memory rows, matching the
        reference's per-sample dump (MemN2N/MemN2N.c:1416-1475).
        sample_offset shifts the recorded sample indices so a chunked
        full-split dump keeps global sample numbering."""
        lo = self._bucket(epoch)
        if lo is None:
            return
        scores = to_numpy(scores)
        attention = to_numpy(attention)
        mask = to_numpy(mask).astype(bool)
        k, b, _ = scores.shape
        with open(self._files[("input", lo)], "a") as fi, \
                open(self._files[("output", lo)], "a") as fo:
            for bi in range(b):
                live = mask[bi]
                for h in range(k):
                    row_i = ",".join(f"{v:f}" for v in scores[h, bi][live])
                    row_o = ",".join(f"{v:f}" for v in attention[h, bi][live])
                    fi.write(f"{epoch},{sample_offset + bi},{h},{row_i}\n")
                    fo.write(f"{epoch},{sample_offset + bi},{h},{row_o}\n")
