"""The port's bAbI loaders against the JAX package's, on small files that
each test writes from a numpy seed (the dataset is not in the repository):
the two parsers, ``load_task`` with its options, ``load_test_split``, the
``qa_joint`` synthesis, and the native C++ loader (built with the host
compiler at first use).

Tolerance: none.  Parsing, the dictionary and the vectorizer assign the
same integers and floats, so samples, dims, dictionaries and arrays are
equal.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qmann_tpu.data import babi as jbabi  # noqa: E402
from qmann_tpu_torch.config import BABI_TASKS  # noqa: E402
from qmann_tpu_torch.data import babi  # noqa: E402
from qmann_tpu_torch.data import native  # noqa: E402

QA1, QA2 = BABI_TASKS[0], BABI_TASKS[1]
SPLIT_FIELDS = ("memory", "question", "answer", "n_sen", "answer_index")


@pytest.fixture
def corpus(tmp_path):
    """Tasks 1-2 (120 train, 40 test stories each) as raw text, task 1 also
    parsed, and qa_joint's raw files: (parsed dir, raw dir)."""
    return babi.write_synthetic_corpus(str(tmp_path), np.random.default_rng(7),
                                       [1, 2], 120, 40, parsed=[1])


def _samples_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.sentences, g.question, g.answer) == \
            (w.sentences, w.question, w.answer)


def _tasks_equal(got, want):
    assert dataclasses.asdict(got.dims) == dataclasses.asdict(want.dims)
    assert got.dictionary.words == want.dictionary.words
    for split in ("train", "valid", "test"):
        _splits_equal(getattr(got, split), getattr(want, split))


def _splits_equal(got, want):
    for f in SPLIT_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("max_sen_len,limit", [(50, None), (4, 25)])
def test_parsers_match_jax_and_formats_agree(corpus, max_sen_len, limit):
    """Both parsers give JAX's samples (truncated to the most recent
    max_sen_len sentences, up to limit samples), and the parsed and raw
    forms of the same stories agree."""
    parsed_dir, raw_dir = corpus
    files = {"parsed": (os.path.join(parsed_dir, f"{QA1}_train_set"),
                        babi.parse_parsed_file, jbabi.parse_parsed_file),
             "raw": (os.path.join(raw_dir, f"{QA1}_train.txt"),
                     babi.parse_raw_file, jbabi.parse_raw_file)}
    got = {}
    for fmt, (path, parse, jparse) in files.items():
        got[fmt] = parse(path, max_sen_len, limit)
        _samples_equal(got[fmt], jparse(path, max_sen_len, limit))
    assert len(got["raw"]) == (limit or 120)
    _samples_equal(got["parsed"], got["raw"])
    assert max(len(s.sentences) for s in got["raw"]) == min(max_sen_len, 10)


def test_parsed_file_with_a_bad_tag_raises(tmp_path):
    path = tmp_path / "bad_set"
    path.write_text("+NS+\n1\n+I+\n0\n+X+\n1\nMary went\n")
    with pytest.raises(ValueError, match="'\\+S\\+'"):
        babi.parse_parsed_file(str(path))


@pytest.mark.parametrize("kw", [
    dict(),
    dict(use_raw=True),
    dict(shuffle_split=True, split_seed=3),
    dict(dim_forced=True, max_dict_len=32, max_sen_len=12),
    dict(en_pe=True, enable_time=False),
    dict(limit_train=50, limit_test=9, rate_valid=0.2, pad_dict=40,
         pad_line=14),
])
def test_load_task_matches_jax(corpus, kw):
    parsed_dir, raw_dir = corpus
    for task in (QA1, QA2):   # parsed and raw-only
        got = babi.load_task(task, parsed_dir, raw_path=raw_dir, **kw)
        want = jbabi.load_task(task, parsed_dir, raw_path=raw_dir, **kw)
        _tasks_equal(got, want)


def test_load_task_time_noise_matches_jax(corpus):
    """The training split's temporal noise draws from the caller's numpy
    generator on both sides."""
    parsed_dir, raw_dir = corpus
    got = babi.load_task(QA1, parsed_dir, raw_path=raw_dir,
                         rand_noise_time=0.5, rng=np.random.default_rng(2))
    want = jbabi.load_task(QA1, parsed_dir, raw_path=raw_dir,
                           rand_noise_time=0.5, rng=np.random.default_rng(2))
    _tasks_equal(got, want)


def test_joint_training_and_test_split_match_jax(corpus):
    """EN_JOINT: train on qa_joint's file (the joint block's forced dims),
    test each task against the joint dictionary."""
    parsed_dir, raw_dir = corpus
    kw = dict(raw_path=raw_dir, train_task_name="qa_joint",
              shuffle_split=True, dim_forced=True, max_dict_len=192,
              max_sen_len=64)
    got = babi.load_task(QA1, parsed_dir, **kw)
    want = jbabi.load_task(QA1, parsed_dir, **kw)
    _tasks_equal(got, want)
    assert got.dims.dim_input == 256 and len(got.train) == 216
    for task in (QA1, QA2):
        t_got = babi.load_test_split(task, parsed_dir, got.dictionary,
                                     got.dims, raw_path=raw_dir,
                                     max_sen_len=64, limit_test=30)
        t_want = jbabi.load_test_split(task, parsed_dir, want.dictionary,
                                       want.dims, raw_path=raw_dir,
                                       max_sen_len=64, limit_test=30)
        _splits_equal(t_got, t_want)
        assert len(t_got) == 30


def test_qa_joint_synthesized_from_tasks_1_to_20(tmp_path):
    """With no qa_joint file anywhere, the joint set is tasks 1-20
    concatenated in task order (limit // 20 per task)."""
    parsed_dir, raw_dir = babi.write_synthetic_corpus(
        str(tmp_path), np.random.default_rng(8), range(1, 21), 6, 3,
        joint=False)
    for limit in (None, 40):
        got = babi.load_samples("qa_joint", "train", parsed_dir,
                                raw_path=raw_dir, limit=limit)
        _samples_equal(got, jbabi.load_samples(
            "qa_joint", "train", parsed_dir, raw_path=raw_dir, limit=limit))
        assert len(got) == (120 if limit is None else 40)
    kw = dict(raw_path=raw_dir, train_task_name="qa_joint")
    _tasks_equal(babi.load_task(QA1, parsed_dir, **kw),
                 jbabi.load_task(QA1, parsed_dir, **kw))


def test_resolve_task_file_chain(tmp_path, corpus):
    """parsed -> raw 10k -> the sibling raw 'en' directory, as in JAX."""
    parsed_dir, raw_dir = corpus
    en = os.path.join(os.path.dirname(raw_dir), "en")
    os.makedirs(en)
    with open(os.path.join(en, f"{BABI_TASKS[2]}_train.txt"), "w") as f:
        f.write("1 Mary went to the office.\n2 Where is Mary? \toffice\t1\n")
    cases = [(QA1, False), (QA1, True), (QA2, False), (BABI_TASKS[2], False),
             (BABI_TASKS[3], False)]
    for name, use_raw in cases:
        args = (name, "train", parsed_dir)
        kw = dict(raw_path=raw_dir, use_raw=use_raw)
        assert babi.resolve_task_file(*args, **kw) == \
            jbabi.resolve_task_file(*args, **kw)
    assert babi.resolve_task_file(BABI_TASKS[2], "train", parsed_dir,
                                  raw_path=raw_dir)[0].startswith(en)
    with pytest.raises(FileNotFoundError):
        babi.load_samples(BABI_TASKS[3], "train", parsed_dir,
                          raw_path=raw_dir)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(use_raw=True, limit_train=70, limit_test=11),
    dict(shuffle_split=True, split_seed=5),
    dict(dim_forced=True, max_dict_len=32, max_sen_len=12),
    dict(train_task_name="qa_joint", dim_forced=True, max_dict_len=192,
         max_sen_len=64),
])
def test_native_loader_matches_python_and_jax(corpus, kw):
    """The C++ parser (built here with the host compiler) gives the port's
    Python loader's and JAX's arrays and dictionary.  Under dim_forced the
    C++ library takes max_word from the data where the Python loader
    forces it to 7 (max_line_len), in the JAX package too: there the dims
    compared are the forced ones, as JAX's tests/test_native.py does, and
    the arrays agree while no sentence has more words than the data's
    longest (6 here)."""
    parsed_dir, raw_dir = corpus
    for task in (QA1, QA2):
        got = native.load_task_native(task, parsed_dir, raw_path=raw_dir,
                                      **kw)
        for ref in (babi.load_task(task, parsed_dir, raw_path=raw_dir, **kw),
                    jbabi.load_task(task, parsed_dir, raw_path=raw_dir,
                                    **kw)):
            if not kw.get("dim_forced"):
                _tasks_equal(got, ref)
                continue
            for f in ("dim_dict", "max_line", "dim_input"):
                assert getattr(got.dims, f) == getattr(ref.dims, f), f
            assert (got.dims.max_word, ref.dims.max_word) == (6, 7)
            assert got.dictionary.words == ref.dictionary.words
            for split in ("train", "valid", "test"):
                _splits_equal(getattr(got, split), getattr(ref, split))
    assert native.build().exists()


def test_native_loader_routes_python_only_features(corpus, monkeypatch):
    """en_pe and the time noise go to the Python loader (the library is
    not even loaded); a data-exceeding dim_forced raises, as in JAX."""
    parsed_dir, raw_dir = corpus

    def no_library():
        raise AssertionError("the native library was loaded")

    monkeypatch.setattr(native, "load_library", no_library)
    got = native.load_task_native(QA1, parsed_dir, raw_path=raw_dir,
                                  en_pe=True)
    _tasks_equal(got, jbabi.load_task(QA1, parsed_dir, raw_path=raw_dir,
                                      en_pe=True))
    monkeypatch.undo()
    with pytest.raises(ValueError, match="dim_forced"):
        native.load_task_native(QA1, parsed_dir, raw_path=raw_dir,
                                dim_forced=True, max_dict_len=8)


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A failed compile raises; nothing hands over to Python quietly."""
    bad = tmp_path / "babi_parser.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="failed"):
        native.build()
