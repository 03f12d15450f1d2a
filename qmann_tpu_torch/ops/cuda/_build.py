"""Build and load the port's CUDA kernels.

Each kernel source under ``qmann_tpu_torch/csrc/`` has a plain C interface
and is compiled with nvcc at first use into its own shared library in
``qmann_tpu_torch/_build/``, keyed by a hash of the source, the shared
headers (``csrc/*.cuh``) and the flags, then bound with ctypes by the
kernel's wrapper module.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Sequence, Tuple

from qmann_tpu_torch.numerics import QFormat

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-I", str(CSRC))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: the port's kernels need nvcc")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(source: Path) -> Tuple[Path, str]:
    """Compile ``source`` unless a build of the same source, headers and
    flags exists.  Returns the library path and the compiler's log (""
    when the library was already built)."""
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    # the include path is the checkout's own; keep it out of the key
    digest.update(" ".join(NVCC_FLAGS[:-2]).encode())
    lib = BUILD_DIR / f"lib{source.stem}_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name}:\n{proc.stderr}")
    os.replace(tmp, lib)   # atomic: concurrent builders race harmlessly
    return lib, proc.stdout + proc.stderr


def check_one_rounding_mode(fmts: Sequence[QFormat], name: str) -> None:
    """The kernels fix the rounding mode at compile time: a launch's
    non-binary formats must share one (every QmannConfig's formats do)."""
    modes = {f.mode for f in fmts if not f.is_binary}
    if len(modes) > 1:
        raise ValueError(f"{name}: the kernel takes one rounding mode per "
                         f"launch, got modes {sorted(modes)}")


def load(source: Path, symbol: str, argtypes) -> ctypes.CDLL:
    """Build (if needed) and load ``source``'s library and declare the
    C entry point ``symbol`` (returns int, a CUDA error code)."""
    path, _ = build(source)
    lib = ctypes.CDLL(str(path))
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return lib
