"""bAbI data pipeline for the port (counterpart of
``qmann_tpu/data/babi.py``).

Ported: ``Sample``, ``Dictionary``, ``DataDims``, ``compute_dims``,
``VectorizedSplit``, ``vectorize`` (with the temporal encoding, the time
noise and the position-encoding weights) and ``TaskData``, each held equal
to the JAX module's by the tests; and synthetic stand-ins for the dataset,
which is not in the repository: ``synthetic_batch`` (random qa1-shaped
bag-of-words batches for serving) and ``synthetic_task`` (a learnable
qa1-shaped task built through the vectorizer).  The parsers and
``load_task`` come with the CLI (ROADMAP.md, Queue 1).  The module is plain
numpy: the machine with the GPU has no jax, and ``qmann_tpu``'s package is
the reference the tests compare against.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class Sample:
    sentences: List[List[str]]   # most recent `max_sen_len` sentences
    question: List[str]
    answer: List[str]


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

    @classmethod
    def build(cls, samples: Sequence[Sample], null_char: str = "NULL"):
        """Scan order matches the reference: per sample — sentences, then
        question, then answer (MemN2N/sample.c:860-929)."""
        d = cls(null_char)
        for s in samples:
            for sent in s.sentences:
                for w in sent:
                    d.add(w)
            for w in s.question:
                d.add(w)
            for w in s.answer:
                d.add(w)
        return d


@dataclasses.dataclass(frozen=True)
class DataDims:
    dim_dict: int
    max_line: int    # max sentences per (train) story, post-truncation
    max_word: int    # max words per (train) sentence
    dim_word: int    # max_word + 1 with temporal encoding
    dim_input: int   # dim_dict + max_line with temporal encoding


def compute_dims(train_samples: Sequence[Sample], dictionary: Dictionary,
                 enable_time: bool = True, dim_forced: bool = False,
                 max_dict_len: int = 64, max_sen_len: int = 50,
                 max_line_len: int = 7, pad_dict: int = 0,
                 pad_line: int = 0) -> DataDims:
    """Dims from the TRAIN split only (MemN2N/MemN2N.c:544-582).

    pad_dict/pad_line: optional uniform-layout padding (the DIM_FORCED idea)
    so one layout serves every task; vocabulary indices stay below the
    actual dictionary size and the padded columns are always zero."""
    if dim_forced:
        # the forced dims must hold the data: out-of-range word indices
        # would vectorize past dim_dict
        if len(dictionary) > max_dict_len:
            raise ValueError(
                f"dim_forced: dictionary size {len(dictionary)} exceeds "
                f"max_dict_len {max_dict_len}")
        actual_line = max((len(s.sentences) for s in train_samples),
                          default=0)
        if actual_line > max_sen_len:
            raise ValueError(
                f"dim_forced: max sentences/story {actual_line} exceeds "
                f"max_sen_len {max_sen_len}")
        max_word = max_line_len
        dim_word = max_word + 1 if enable_time else max_word
        return DataDims(max_dict_len, max_sen_len, max_word, dim_word,
                        max_dict_len + max_sen_len)
    max_line = max((len(s.sentences) for s in train_samples), default=0)
    max_word = max((len(sent) for s in train_samples for sent in s.sentences),
                   default=0)
    dim_dict = max(len(dictionary), pad_dict)
    max_line = max(max_line, pad_line)
    dim_input = dim_dict + max_line if enable_time else dim_dict
    dim_word = max_word + 1 if enable_time else max_word
    return DataDims(dim_dict, max_line, max_word, dim_word, dim_input)


@dataclasses.dataclass
class VectorizedSplit:
    """Padded arrays for one data split."""
    memory: np.ndarray    # [N, max_line, dim_input] f32 bag-of-words rows
    question: np.ndarray  # [N, dim_input] f32 bag-of-words
    answer: np.ndarray    # [N, dim_input] f32 one/multi-hot
    n_sen: np.ndarray     # [N] int32 live sentence counts
    answer_index: np.ndarray  # [N] int32 first answer word index

    def __len__(self):
        return self.memory.shape[0]

    @property
    def mask(self) -> np.ndarray:
        """[N, max_line] bool validity mask for the padded memory rows."""
        return (np.arange(self.memory.shape[1])[None, :]
                < self.n_sen[:, None])


def position_encoding_weights(dims: DataDims) -> np.ndarray:
    """PE weight table 1 + 4*(i/dim_input - 0.5)*(j/dim_word - 0.5)
    (MemN2N/MemN2N.c:606-617); EN_PE applies it to the question only."""
    i = np.arange(dims.dim_input)[:, None] / dims.dim_input - 0.5
    j = np.arange(dims.dim_word)[None, :] / dims.dim_word - 0.5
    return (1.0 + 4.0 * i * j).astype(np.float32)


def vectorize(samples: Sequence[Sample], dictionary: Dictionary,
              dims: DataDims, enable_time: bool = True,
              rand_noise_time: float = 0.0, is_train: bool = False,
              rng: Optional[np.random.Generator] = None,
              max_sen_len: int = 50, en_pe: bool = False) -> VectorizedSplit:
    """sample_vectorization (MemN2N/sample.c:413-574):
      * word -> index (case-insensitive);
      * temporal-encoding token per sentence j: index
        dim_dict + n_sen - j - 1 — the oldest sentence gets the largest
        time index;
      * optional random time noise during training;
      * index -> bag-of-words COUNT vectors; the TE slot is SET to 1.0,
        question/answer slots are incremented.
    """
    n = len(samples)
    mem = np.zeros((n, dims.max_line, dims.dim_input), np.float32)
    que = np.zeros((n, dims.dim_input), np.float32)
    ans = np.zeros((n, dims.dim_input), np.float32)
    n_sen = np.zeros(n, np.int32)
    ans_idx = np.zeros(n, np.int32)
    use_noise = is_train and rand_noise_time != 0.0
    if use_noise and rng is None:
        rng = np.random.default_rng(0)
    pe_w = position_encoding_weights(dims) if en_pe else None
    n_words = dims.dim_word - 1 if enable_time else dims.dim_word

    for si, s in enumerate(samples):
        # every split keeps the most recent max_line sentences (max_line
        # comes from the TRAIN scan)
        sentences = s.sentences[-dims.max_line:] \
            if len(s.sentences) > dims.max_line else s.sentences
        ns = len(sentences)
        n_sen[si] = ns
        if use_noise:
            n_noise = int(rng.integers(0, int(ns * rand_noise_time) + 1))
            arr_te = rng.permutation(ns + n_noise)
            # clamped to the time slots of the padded layout as well as to
            # MAX_SEN_LEN-1
            arr_te = np.minimum(arr_te, min(max_sen_len, dims.max_line) - 1)
            arr_te.sort()
        for j, sent in enumerate(sentences):
            for w in sent[:n_words]:
                idx = dictionary.lookup(w)
                if idx >= 0:
                    mem[si, j, idx] += 1.0
            if enable_time:
                if use_noise:
                    te = dims.dim_dict + int(arr_te[ns + n_noise - j - 1])
                else:
                    te = dims.dim_dict + ns - j - 1
                mem[si, j, te] = 1.0
        for jq, w in enumerate(s.question[:n_words]):
            idx = dictionary.lookup(w)
            if idx >= 0:
                if pe_w is not None:
                    # EN_PE: the position-encoding weight REPLACES the count
                    que[si, idx] = pe_w[idx, jq]
                else:
                    que[si, idx] += 1.0
        first = True
        for w in s.answer[:n_words]:
            idx = dictionary.lookup(w)
            if idx >= 0:
                ans[si, idx] += 1.0
                if first:
                    ans_idx[si] = idx
                    first = False
    return VectorizedSplit(mem, que, ans, n_sen, ans_idx)


@dataclasses.dataclass
class TaskData:
    train: VectorizedSplit
    valid: VectorizedSplit
    test: VectorizedSplit
    dims: DataDims
    dictionary: Dictionary


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


def synthetic_samples(rng: np.random.Generator, n: int, V: int, M: int,
                      W: int, first_full: bool = False) -> List[Sample]:
    """n learnable qa1-shaped stories over the vocabulary w1..w{V-1}.

    A third of the words are places, the rest actors.  Every sentence holds
    W words: W-1 actors and one place, in random order; a story has 1..M
    sentences (exactly M for the first one when ``first_full``).  The
    question is three actors and the answer is the place of the story's
    most recent sentence, so a model that attends to the newest memory
    row can learn the task."""
    words = [f"w{i}" for i in range(1, V)]
    n_places = max(1, len(words) // 3)
    places, actors = words[:n_places], words[n_places:]
    samples = []
    for k in range(n):
        ns = M if (first_full and k == 0) else int(rng.integers(1, M + 1))
        sentences = []
        for _ in range(ns):
            sent = [actors[i] for i in rng.integers(0, len(actors), W - 1)]
            sent.insert(int(rng.integers(0, W)),
                        places[int(rng.integers(0, n_places))])
            sentences.append(sent)
        question = [actors[i] for i in rng.integers(0, len(actors), 3)]
        answer = [w for w in sentences[-1] if w in places][:1]
        samples.append(Sample(sentences, question, answer))
    return samples


def synthetic_task(rng: np.random.Generator, n_train: int, n_valid: int,
                   n_test: int, V: int, M: int, W: int) -> TaskData:
    """A ``TaskData`` of ``synthetic_samples`` stories at the layout
    dim_dict=V, max_line=M, max_word=W (qa1: V=19, M=10, W=6, so
    dim_input=29), built through the pipeline the dataset takes:
    Dictionary -> Sample -> compute_dims -> vectorize.  The dictionary
    holds every word in a fixed order, so the layout does not depend on
    which words the draw used."""
    train = synthetic_samples(rng, n_train, V, M, W, first_full=True)
    valid = synthetic_samples(rng, n_valid, V, M, W)
    test = synthetic_samples(rng, n_test, V, M, W)
    dictionary = Dictionary()
    for i in range(1, V):
        dictionary.add(f"w{i}")
    dims = compute_dims(train, dictionary)
    return TaskData(vectorize(train, dictionary, dims, is_train=True),
                    vectorize(valid, dictionary, dims),
                    vectorize(test, dictionary, dims), dims, dictionary)
