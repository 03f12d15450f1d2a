"""ctypes binding for the native C++ bAbI parser and vectorizer
(counterpart of ``qmann_tpu/data/native.py``).

``load_task_native`` computes what ``data.babi.load_task`` computes, with
the parse, the dictionary and the vectorization in C++
(``native/babi_parser.cpp``, the repository's source, bound through the
same ``qm_*`` entry points).  The library is built with the host C++
compiler at first use into ``qmann_tpu_torch/_build/``, keyed by a hash of
the source and the flags; a failed build raises.  The features only the
Python loader implements (``rand_noise_time``, ``en_pe``, and ``qa_joint``
synthesized from tasks 1-20 when no joint file exists) go to
``data.babi.load_task``, as in the JAX package.  tests/test_torch_data.py
holds the two loaders equal.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from qmann_tpu_torch.data.babi import (
    DataDims, Dictionary, TaskData, VectorizedSplit, load_task,
    resolve_task_file,
)

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG.parent / "native" / "babi_parser.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")   # native/Makefile's


def build() -> Path:
    """Compile the parser unless a build of the same source and flags
    exists; returns the library's path.  Raises RuntimeError when there is
    no C++ compiler or the compile fails."""
    if not SOURCE.is_file():
        raise RuntimeError(f"native parser source {SOURCE} is missing")
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or c++) for the native "
                           "bAbI parser")
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    lib = BUILD_DIR / f"libqmann_data_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed on {SOURCE.name}:\n{proc.stderr}")
    os.replace(tmp, lib)   # atomic: concurrent builders race harmlessly
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the parser, with every entry point's
    argument and result types declared."""
    lib = ctypes.CDLL(str(build()))
    lib.qm_load.restype = ctypes.c_void_p
    lib.qm_load.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
                            ctypes.c_int, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int]
    lib.qm_free.restype = None
    lib.qm_free.argtypes = [ctypes.c_void_p]
    for name in ("qm_dim_dict", "qm_max_line", "qm_max_word", "qm_dim_word",
                 "qm_dim_input", "qm_num_train", "qm_num_test",
                 "qm_dict_size"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p]
    lib.qm_dict_word.restype = ctypes.c_char_p
    lib.qm_dict_word.argtypes = [ctypes.c_void_p, ctypes.c_int]
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.qm_fill.restype = None
    lib.qm_fill.argtypes = [ctypes.c_void_p, ctypes.c_int, f32p, f32p, f32p,
                            i32p, i32p]
    return lib


def _split_rows(v: VectorizedSplit, idx) -> VectorizedSplit:
    return VectorizedSplit(v.memory[idx], v.question[idx], v.answer[idx],
                           v.n_sen[idx], v.answer_index[idx])


def load_task_native(task_name: str, data_path: str, *,
                     use_raw: bool = False, raw_path: Optional[str] = None,
                     enable_time: bool = True, max_sen_len: int = 50,
                     rate_valid: float = 0.1,
                     limit_train: Optional[int] = None,
                     limit_test: Optional[int] = None,
                     pad_dict: int = 0, pad_line: int = 0,
                     train_task_name: Optional[str] = None,
                     shuffle_split: bool = False, split_seed: int = 0,
                     dim_forced: bool = False, max_dict_len: int = 64,
                     **py_kwargs) -> TaskData:
    """``load_task``'s arguments and result (``py_kwargs``: its
    ``rand_noise_time``, ``en_pe`` and ``rng``)."""
    if dim_forced:
        # the native library expresses forced dims through its pad knobs:
        # pad-to-at-least equals force-to while the data fits
        pad_dict = max(pad_dict, max_dict_len)
        pad_line = max(pad_line, max_sen_len)
    tt = train_task_name or task_name
    train = resolve_task_file(tt, "train", data_path, raw_path=raw_path,
                              use_raw=use_raw)
    test = resolve_task_file(task_name, "test", data_path, raw_path=raw_path,
                             use_raw=use_raw)
    needs_python = (py_kwargs.get("rand_noise_time", 0.0) != 0.0
                    or py_kwargs.get("en_pe", False))
    if needs_python or train is None or test is None:
        # features only the Python loader has; a missing file raises there,
        # or (qa_joint) is synthesized from tasks 1-20
        return load_task(task_name, data_path, use_raw=use_raw,
                         raw_path=raw_path, enable_time=enable_time,
                         max_sen_len=max_sen_len, rate_valid=rate_valid,
                         limit_train=limit_train, limit_test=limit_test,
                         pad_dict=pad_dict, pad_line=pad_line,
                         train_task_name=train_task_name,
                         shuffle_split=shuffle_split, split_seed=split_seed,
                         dim_forced=dim_forced, max_dict_len=max_dict_len,
                         **py_kwargs)
    lib = load_library()
    (train_file, train_raw), (test_file, test_raw) = train, test
    h = lib.qm_load(train_file.encode(), int(train_raw), test_file.encode(),
                    int(test_raw), max_sen_len, int(enable_time),
                    -1 if limit_train is None else limit_train,
                    -1 if limit_test is None else limit_test,
                    pad_dict, pad_line)
    if not h:
        raise RuntimeError(f"native parser failed for {train_file}")
    try:
        dims = DataDims(dim_dict=lib.qm_dim_dict(h),
                        max_line=lib.qm_max_line(h),
                        max_word=lib.qm_max_word(h),
                        dim_word=lib.qm_dim_word(h),
                        dim_input=lib.qm_dim_input(h))
        if dim_forced and (dims.dim_dict != max_dict_len
                           or dims.max_line != max_sen_len):
            # past the forced dims the two loaders would diverge (the
            # Python loader forces and would index out of range)
            raise ValueError(
                f"dim_forced: data exceeds forced dims "
                f"(dict {dims.dim_dict} vs {max_dict_len}, "
                f"lines {dims.max_line} vs {max_sen_len})")
        dictionary = Dictionary()
        for i in range(1, lib.qm_dict_size(h)):
            dictionary.add(lib.qm_dict_word(h, i).decode())

        def fetch(split_id: int, n: int) -> VectorizedSplit:
            mem = np.zeros((n, dims.max_line, dims.dim_input), np.float32)
            que = np.zeros((n, dims.dim_input), np.float32)
            ans = np.zeros((n, dims.dim_input), np.float32)
            n_sen = np.zeros(n, np.int32)
            aidx = np.zeros(n, np.int32)
            if n:
                lib.qm_fill(h, split_id, mem, que, ans, n_sen, aidx)
            return VectorizedSplit(mem, que, ans, n_sen, aidx)

        full_train = fetch(0, lib.qm_num_train(h))
        test_split = fetch(1, lib.qm_num_test(h))
    finally:
        lib.qm_free(h)

    n_all = len(full_train)
    if shuffle_split:
        # EN_SAMPLE_SHUFFLED: one permutation up front, valid = its tail;
        # vectorization is per sample, so permuting rows equals the Python
        # loader's permutation of the samples
        full_train = _split_rows(
            full_train, np.random.default_rng(split_seed).permutation(n_all))
    n_train = n_all - int(n_all * rate_valid)
    return TaskData(_split_rows(full_train, slice(0, n_train)),
                    _split_rows(full_train, slice(n_train, n_all)),
                    test_split, dims, dictionary)
