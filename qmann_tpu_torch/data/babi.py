"""bAbI data pipeline for the port (counterpart of
``qmann_tpu/data/babi.py``).

Ported, each held equal to the JAX module's by the tests: the two parsers
(``parse_parsed_file`` for the reference's '+NS+/+I+/+S+/+Q+/+A+' files,
``parse_raw_file`` for the raw bAbI text, with the tokenization of the
reference's offline parser folded in), ``Sample``, ``Dictionary``,
``DataDims``, ``compute_dims``, ``VectorizedSplit``, ``vectorize`` (with
the temporal encoding, the time noise and the position-encoding weights),
``TaskData``, ``load_task`` (the train/valid split, EN_SAMPLE_SHUFFLED,
DIM_FORCED, EN_JOINT's ``train_task_name``), ``resolve_task_file`` (parsed
-> raw 10k -> sibling raw 'en'), ``load_samples`` (with the ``qa_joint``
synthesis from tasks 1-20) and ``load_test_split``; and synthetic
stand-ins for the dataset, which is not in the repository:
``synthetic_batch`` (random qa1-shaped bag-of-words batches for serving)
and ``synthetic_task`` (a learnable qa1-shaped task built through the
vectorizer).  ``data/native.py`` binds the C++ parser.  The module is
plain numpy: the machine with the GPU has no jax, and ``qmann_tpu``'s
package is the reference the tests compare against.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import List, Optional, Sequence

import numpy as np

from qmann_tpu_torch.config import BABI_TASKS


@dataclasses.dataclass
class Sample:
    sentences: List[List[str]]   # most recent `max_sen_len` sentences
    question: List[str]
    answer: List[str]


def _tokenize(sent: str) -> List[str]:
    """parser.py:16-22: split including punctuation as separate tokens."""
    return [x.strip() for x in re.split(r"(\W+)", sent) if x.strip()]


def parse_parsed_file(path: str, max_sen_len: int = 50,
                      limit: Optional[int] = None) -> List[Sample]:
    """Parse the '+NS+' custom format (MemN2N/sample.c:87-249), keeping
    only the most recent `max_sen_len` sentences per story
    (sample_constructor truncation, sample.c:152-166)."""
    with open(path, "r") as f:
        lines = f.read().split("\n")
    i = 0
    # skip blank, +NS+, count (sample.c:119-121)
    while lines[i].strip() != "+NS+":
        i += 1
    n_samples = int(lines[i + 1])
    if limit is not None:
        n_samples = min(n_samples, limit)
    i += 2
    samples: List[Sample] = []
    while len(samples) < n_samples and i < len(lines):
        while i < len(lines) and lines[i].strip() != "+I+":
            i += 1
        if i >= len(lines):
            break
        i += 2  # +I+, index
        _expect(lines, i, "+S+", path)
        n_sen_ori = int(lines[i + 1])
        i += 2
        sents = []
        for k in range(n_sen_ori):
            sents.append(_split_words(lines[i]))
            i += 1
        if n_sen_ori > max_sen_len:
            sents = sents[n_sen_ori - max_sen_len:]
        _expect(lines, i, "+Q+", path)
        question = _split_words(lines[i + 1])
        i += 2
        _expect(lines, i, "+A+", path)
        answer = _split_words(lines[i + 1])
        i += 2
        samples.append(Sample(sents, question, answer))
    return samples


def _expect(lines: List[str], i: int, tag: str, path: str) -> None:
    """The parsed format's section tags (MemN2N/sample.c:87-249)."""
    if i >= len(lines) or lines[i].strip() != tag:
        raise ValueError(f"{path}: line {i + 1} should be {tag!r}")


def _split_words(line: str) -> List[str]:
    """strtok(line, " ") semantics (sample.c:180-196)."""
    return [w for w in line.strip().split(" ") if w]


def parse_raw_file(path: str, max_sen_len: int = 50,
                   limit: Optional[int] = None) -> List[Sample]:
    """Parse raw bAbI task text directly (folding in parser.py's
    parse_stories + the parsed-format writer's transformations:
    statements lose their trailing '.', questions lose their final token)."""
    samples: List[Sample] = []
    story: List[List[str]] = []
    with open(path, "r") as f:
        for raw in f:
            raw = raw.strip()
            if not raw:
                continue
            nid_str, rest = raw.split(" ", 1)
            if int(nid_str) == 1:
                story = []
            if "\t" in rest:
                fields = rest.split("\t")
                q, a = fields[0], fields[1]  # supporting-fact field optional
                q_tokens = _tokenize(q)[:-1]       # drop trailing '?'
                substory = [s for s in story if s]
                if len(substory) > max_sen_len:
                    substory = substory[len(substory) - max_sen_len:]
                samples.append(Sample([list(s) for s in substory],
                                      list(q_tokens), [a.strip()]))
                story.append([])
                if limit is not None and len(samples) >= limit:
                    break
            else:
                tokens = _tokenize(rest)
                if tokens and tokens[-1] == ".":
                    tokens = tokens[:-1]           # writer drops the period
                story.append(tokens)
    return samples


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


def load_task(task_name: str, data_path: str, *, use_raw: bool = False,
              raw_path: Optional[str] = None, enable_time: bool = True,
              max_sen_len: int = 50, rate_valid: float = 0.1,
              rand_noise_time: float = 0.0,
              limit_train: Optional[int] = None,
              limit_test: Optional[int] = None,
              rng: Optional[np.random.Generator] = None,
              dim_forced: bool = False, max_dict_len: int = 64,
              pad_dict: int = 0, pad_line: int = 0,
              en_pe: bool = False,
              train_task_name: Optional[str] = None,
              shuffle_split: bool = False,
              split_seed: int = 0) -> TaskData:
    """Load one bAbI task end to end.

    The validation split is the LAST rate_valid fraction of the train file
    in file order (MemN2N/MemN2N.c:636-637, :1866-1869 — shuffle is off by
    default, EN_SAMPLE_SHUFFLED=false define.h:172).  With
    shuffle_split=True the reference's EN_SAMPLE_SHUFFLED semantics apply:
    ALL train-file samples are permuted ONCE up front and the valid split
    is the TAIL of that permutation (MemN2N.c:1046-1052 builds the global
    ind_sample_shuffled; :1868 takes valid indices from its tail) — i.e. a
    random 10%, not the last 10% in file order.  This matters for
    EN_JOINT, whose qa_joint train file is the task-ordered concatenation
    of tasks 1-20 (dataset/.../qa_joint_gen.scr): without the shuffle the
    entire validation set comes from qa19/qa20, which is why the
    reference's joint config block sets EN_SAMPLE_SHUFFLED true
    (define.h:177-191).

    train_task_name: for joint mode (EN_JOINT) training reads qa_joint
    while testing reads the per-task file (MemN2N.c:520-533).
    """
    tt = train_task_name or task_name
    train_samples = load_samples(tt, "train", data_path, raw_path=raw_path,
                                 use_raw=use_raw, max_sen_len=max_sen_len,
                                 limit=limit_train)
    test_samples = load_samples(task_name, "test", data_path,
                                raw_path=raw_path, use_raw=use_raw,
                                max_sen_len=max_sen_len, limit=limit_test)

    dictionary = Dictionary.build(train_samples)
    dims = compute_dims(train_samples, dictionary, enable_time,
                        dim_forced=dim_forced, max_dict_len=max_dict_len,
                        max_sen_len=max_sen_len, pad_dict=pad_dict,
                        pad_line=pad_line)

    if shuffle_split:
        # permute AFTER Dictionary.build/compute_dims: the reference
        # builds the dictionary in file order and only then shuffles
        # sample indices (MemN2N.c: sample_init precedes rand_perm)
        perm = np.random.default_rng(split_seed).permutation(
            len(train_samples))
        train_samples = [train_samples[i] for i in perm]
    n_valid = int(len(train_samples) * rate_valid)
    n_train = len(train_samples) - n_valid
    tr = vectorize(train_samples[:n_train], dictionary, dims, enable_time,
                   rand_noise_time, is_train=True, rng=rng,
                   max_sen_len=max_sen_len, en_pe=en_pe)
    va = vectorize(train_samples[n_train:], dictionary, dims, enable_time,
                   en_pe=en_pe)
    te = vectorize(test_samples, dictionary, dims, enable_time, en_pe=en_pe)
    return TaskData(tr, va, te, dims, dictionary)


def resolve_task_file(name: str, split: str, data_path: str, *,
                      raw_path: Optional[str] = None,
                      use_raw: bool = False):
    """Single source of truth for the data fallback chain
    (parsed -> raw 10k -> sibling raw 1k 'en'); returns
    (path, is_raw) or None.  Shared by the Python and native loaders."""
    parsed_path = os.path.join(data_path, f"{name}_{split}_set")
    if not use_raw and os.path.exists(parsed_path):
        return parsed_path, False
    base = raw_path or data_path
    candidates = [os.path.join(base, f"{name}_{split}.txt")]
    if os.path.basename(base) != "en":
        candidates.append(os.path.join(os.path.dirname(base), "en",
                                       f"{name}_{split}.txt"))
    for cand in candidates:
        if os.path.exists(cand):
            return cand, True
    return None


def load_samples(name: str, split: str, data_path: str, *,
                 raw_path: Optional[str] = None, use_raw: bool = False,
                 max_sen_len: int = 50,
                 limit: Optional[int] = None) -> List[Sample]:
    """Resolve and parse one task split.

    Prefers the parsed format; falls back to raw bAbI text when the parsed
    file is absent (the reference dataset ships with several parsed train
    sets missing, e.g. qa2/qa3/qa5) — the two parsers produce identical
    samples (tests/test_torch_data.py).  A further fallback to the sibling 1k
    'en' directory covers qa3, whose 10k raw train file is also absent.

    qa_joint (EN_JOINT, define.h:152): the 1k 'en' directory ships the
    real qa_joint files; if no joint file exists anywhere, the set is
    synthesized by concatenating tasks 1-20 in task order."""
    resolved = resolve_task_file(name, split, data_path, raw_path=raw_path,
                                 use_raw=use_raw)
    if resolved is not None:
        path, is_raw = resolved
        parse = parse_raw_file if is_raw else parse_parsed_file
        return parse(path, max_sen_len, limit)
    if name == "qa_joint":
        joint: List[Sample] = []
        per_task = None if limit is None else max(1, limit // 20)
        for t in BABI_TASKS[:20]:
            joint.extend(load_samples(t, split, data_path, raw_path=raw_path,
                                      use_raw=use_raw,
                                      max_sen_len=max_sen_len,
                                      limit=per_task))
        return joint if limit is None else joint[:limit]
    raise FileNotFoundError(
        f"no parsed or raw data for task {name} ({split}) under "
        f"{data_path} / {raw_path}")


def load_test_split(task_name: str, data_path: str, dictionary: Dictionary,
                    dims: DataDims, *, raw_path: Optional[str] = None,
                    use_raw: bool = False, enable_time: bool = True,
                    max_sen_len: int = 50,
                    limit_test: Optional[int] = None,
                    en_pe: bool = False) -> VectorizedSplit:
    """Vectorize one task's TEST split against an existing (e.g. joint)
    dictionary and dims — the EN_JOINT flow trains once on qa_joint and
    tests every task with that model (MemN2N/MemN2N.c:520-533,
    :2241-2244)."""
    samples = load_samples(task_name, "test", data_path, raw_path=raw_path,
                           use_raw=use_raw, max_sen_len=max_sen_len,
                           limit=limit_test)
    return vectorize(samples, dictionary, dims, enable_time, en_pe=en_pe)


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


# qa1-shaped stories in the dataset's two file formats, for the tests: the
# bAbI files are not in the repository
_QA1_NAMES = ("Mary", "John", "Sandra", "Daniel")
_QA1_PLACES = ("bathroom", "hallway", "kitchen", "office", "garden",
               "bedroom")
_QA1_MOVES = ("moved to the", "went to the", "journeyed to the",
              "travelled to the", "went back to the")


def _synthetic_stories(rng: np.random.Generator, n: int,
                       questions_per_story: int = 5):
    """n qa1-shaped questions, ``questions_per_story`` to a story, each
    after two statements "<name> <move> <place>": the raw file's lines
    and, per question, the story's statements so far, the question and the
    answer (where the asked-about person went last)."""
    lines, samples = [], []
    while len(samples) < n:
        nid, statements, where, support = 0, [], {}, {}
        for _ in range(questions_per_story):
            if len(samples) == n:
                break
            for _ in range(2):
                name = _QA1_NAMES[rng.integers(len(_QA1_NAMES))]
                place = _QA1_PLACES[rng.integers(len(_QA1_PLACES))]
                move = _QA1_MOVES[rng.integers(len(_QA1_MOVES))]
                nid += 1
                lines.append(f"{nid} {name} {move} {place}.")
                statements.append(f"{name} {move} {place}".split())
                where[name], support[name] = place, nid
            name = list(where)[rng.integers(len(where))]
            nid += 1
            lines.append(f"{nid} Where is {name}? \t{where[name]}\t"
                         f"{support[name]}")
            samples.append(([list(s) for s in statements],
                            ["Where", "is", name], [where[name]]))
    return lines, samples


def _write_parsed(path: str, samples) -> None:
    """The reference's parsed format (MemN2N/sample.c:87-249)."""
    out = ["+NS+", str(len(samples))]
    for i, (sents, question, answer) in enumerate(samples):
        out += ["+I+", str(i), "+S+", str(len(sents))]
        out += [" ".join(sent) for sent in sents]
        out += ["+Q+", " ".join(question), "+A+", " ".join(answer)]
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")


def write_synthetic_corpus(root: str, rng: np.random.Generator,
                           tasks: Sequence[int], n_train: int, n_test: int,
                           parsed: Sequence[int] = (), joint: bool = True):
    """Write seeded qa1-shaped stories for the bAbI tasks numbered
    ``tasks`` (1-20) as raw text under root/en-10k, in the parsed format
    too for the tasks in ``parsed`` (root/en_10k_parsed), and, with
    ``joint``, qa_joint's raw files as the task-ordered concatenation of
    the others.  Returns (parsed dir, raw dir): ``load_task``'s data_path
    and raw_path."""
    parsed_dir = os.path.join(root, "en_10k_parsed")
    raw_dir = os.path.join(root, "en-10k")
    os.makedirs(parsed_dir, exist_ok=True)
    os.makedirs(raw_dir, exist_ok=True)
    joint_lines = {"train": [], "test": []}
    for t in tasks:
        name = BABI_TASKS[t - 1]
        for split, n in (("train", n_train), ("test", n_test)):
            lines, samples = _synthetic_stories(rng, n)
            joint_lines[split] += lines
            with open(os.path.join(raw_dir, f"{name}_{split}.txt"), "w") as f:
                f.write("\n".join(lines) + "\n")
            if t in parsed:
                _write_parsed(os.path.join(parsed_dir, f"{name}_{split}_set"),
                              samples)
    if joint:
        for split, lines in joint_lines.items():
            with open(os.path.join(raw_dir, f"qa_joint_{split}.txt"),
                      "w") as f:
                f.write("\n".join(lines) + "\n")
    return parsed_dir, raw_dir
