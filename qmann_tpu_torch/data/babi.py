"""bAbI data shapes for the port (counterpart of ``qmann_tpu/data/babi.py``).

Ported so far: ``Dictionary`` and ``DataDims``, which the serving engine
needs, and the synthetic qa1-shaped batch that stands in for the dataset
(the bAbI data is not in the repository).  The parsers, ``compute_dims``,
``vectorize`` and ``load_task`` come with training (ROADMAP.md, Queue 1).
The module is plain numpy: the machine with the GPU has no jax, and
``qmann_tpu``'s package is the reference the tests compare against.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


class Dictionary:
    """Insertion-ordered, case-insensitive vocabulary; index 0 is the NULL
    word (dictionary_constructor, MemN2N/sample.c:849-931)."""

    def __init__(self, null_char: str = "NULL"):
        self.words: List[str] = [null_char]
        self._index = {null_char.lower(): 0}

    def add(self, word: str) -> int:
        key = word.lower()
        idx = self._index.get(key)
        if idx is None:
            idx = len(self.words)
            self.words.append(word)
            self._index[key] = idx
        return idx

    def lookup(self, word: str) -> int:
        """word_idx (MemN2N/sample.c:835-847): -1 when missing."""
        return self._index.get(word.lower(), -1)

    def __len__(self):
        return len(self.words)


@dataclasses.dataclass(frozen=True)
class DataDims:
    dim_dict: int
    max_line: int    # max sentences per (train) story, post-truncation
    max_word: int    # max words per (train) sentence
    dim_word: int    # max_word + 1 with temporal encoding
    dim_input: int   # dim_dict + max_line with temporal encoding


def synthetic_batch(rng: np.random.Generator, B: int, V: int, M: int,
                    W: int):
    """Random qa1-shaped bag-of-words stories (the recipe of
    ``qmann_tpu/bench/backend_ab.py --synthetic``): each of the M memory
    rows holds W random words out of V plus its temporal one-hot, the
    question holds W random words, and each story keeps a random number
    (1..M) of live rows.  Returns (DataDims, memory [B, M, V+M],
    question [B, V+M], mask [B, M] bool), float32 features."""
    mem = np.zeros((B, M, V + M), np.float32)
    np.add.at(mem, (np.arange(B)[:, None, None], np.arange(M)[None, :, None],
                    rng.integers(0, V, (B, M, W))), 1.0)
    mem[:, np.arange(M), V + np.arange(M)] = 1.0
    que = np.zeros((B, V + M), np.float32)
    np.add.at(que, (np.arange(B)[:, None], rng.integers(0, V, (B, W))), 1.0)
    mask = np.arange(M)[None, :] < rng.integers(1, M + 1, B)[:, None]
    mem *= mask[:, :, None]
    return DataDims(V, M, W, W + 1, V + M), mem, que, mask
