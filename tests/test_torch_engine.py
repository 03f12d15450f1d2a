"""The port's InferenceEngine and data shapes on the CPU against the JAX
package, and the guard that neither the port nor chip_smoke.py imports jax
or the JAX package."""
import ast
import dataclasses
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qmann_tpu.config import QmannConfig as JaxConfig  # noqa: E402
from qmann_tpu.models import memn2n as jmodel  # noqa: E402
from qmann_tpu.ops import argmax_last as j_argmax_last  # noqa: E402
from qmann_tpu_torch.config import QmannConfig  # noqa: E402
from qmann_tpu_torch.data import DataDims, Dictionary  # noqa: E402
from qmann_tpu_torch.models import memn2n  # noqa: E402
from qmann_tpu_torch.serve import InferenceEngine, Request  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def _stories(dictionary, n, rng, max_line, max_word):
    words = dictionary.words[1:]
    out = []
    for _ in range(n):
        story = [[words[i] for i in rng.integers(0, len(words),
                                                 rng.integers(1, max_word + 1))]
                 for _ in range(rng.integers(1, max_line + 3))]
        question = [words[i] for i in rng.integers(0, len(words), 4)]
        out.append((story, question))
    return out


def test_engine_answers_match_jax_forward():
    rng = np.random.default_rng(0)
    dictionary = Dictionary()
    for i in range(18):
        dictionary.add(f"w{i}")
    dims = DataDims(dim_dict=len(dictionary), max_line=10, max_word=6,
                    dim_word=7, dim_input=len(dictionary) + 10)
    kw = dict(dim_emb=16, use_fused_chain=True, verbose=False)
    pj = {k: np.asarray(v) * np.float32(4.0) for k, v in jmodel.init_params(
        JaxConfig(**kw), dims, jax.random.PRNGKey(0)).items()}
    cfg = QmannConfig(**kw)
    engine = InferenceEngine(memn2n.params_from_jax(pj, cfg, device="cpu"),
                             cfg, dims, dictionary, batch_size=8,
                             device="cpu").start()
    assert engine.prepared.fast
    stories = _stories(dictionary, 20, rng, dims.max_line, dims.max_word)
    try:
        futures = [engine.submit(s, q) for s, q in stories]
        answers = [f.result(timeout=60) for f in futures]
    finally:
        engine.stop()
    assert not engine._thread.is_alive()
    assert engine.stats.failed_waves == 0
    assert engine.stats.waves >= 3 and engine.stats.requests == 20

    jcfg = JaxConfig(**kw)
    j_infer = jax.jit(lambda p, *batch: j_argmax_last(
        jmodel.forward(p, *batch, jcfg).logits))
    jp = {k: jnp.asarray(v) for k, v in pj.items()}
    want = []
    for i in range(0, 20, 8):
        reqs = [Request([list(x) for x in s], list(q))
                for s, q in stories[i:i + 8]]
        batch = engine._vectorize(reqs)
        want.extend(np.asarray(j_infer(jp, *batch))[:len(reqs)])
    assert answers == [int(w) for w in want]
    assert len(set(answers)) > 1


def test_dictionary_and_dims_match_jax():
    from qmann_tpu.data import babi as jbabi
    words = ["Mary", "went", "to", "the", "kitchen", "mary", "KITCHEN",
             "where", "is", "NULL", "null", "Daniel"]
    jd, td = jbabi.Dictionary(), Dictionary()
    assert [jd.add(w) for w in words] == [td.add(w) for w in words]
    assert jd.words == td.words and len(jd) == len(td)
    for w in words + ["garden", "DANIEL", ""]:
        assert td.lookup(w) == jd.lookup(w)
    assert [f.name for f in dataclasses.fields(DataDims)] == \
        [f.name for f in dataclasses.fields(jbabi.DataDims)]


@pytest.mark.parametrize("en_time", [True, False])
def test_vectorize_matches_jax_engine(en_time):
    """The engine's wave vectorizer against the JAX engine's: stories
    longer than max_line, sentences longer than max_word, unknown words,
    mixed case, and transmitted temporal indices in and out of range."""
    from qmann_tpu.data import babi as jbabi
    from qmann_tpu.serve.engine import InferenceEngine as JaxEngine
    from qmann_tpu.serve.engine import Request as JaxRequest
    rng = np.random.default_rng(1)
    vocab = [f"w{i}" for i in range(12)]
    jd, td = jbabi.Dictionary(), Dictionary()
    for w in vocab:
        jd.add(w)
        td.add(w)
    dims = DataDims(dim_dict=len(td), max_line=5, max_word=4, dim_word=5,
                    dim_input=len(td) + 5)
    pool = vocab + ["W3", "unknown"]
    reqs = []
    for i in range(7):
        story = [[pool[k] for k in rng.integers(0, len(pool),
                                                rng.integers(1, 8))]
                 for _ in range(rng.integers(1, 9))]
        question = [pool[k] for k in rng.integers(0, len(pool), 6)]
        te = (None if i % 2 else
              [int(t) for t in rng.integers(-2, dims.dim_input + 3,
                                            len(story))])
        reqs.append((story, question, te))
    cfg = SimpleNamespace(en_time=en_time)
    got = InferenceEngine._vectorize(
        SimpleNamespace(dims=dims, batch_size=8, cfg=cfg, dictionary=td),
        [Request(*r) for r in reqs])
    want = JaxEngine._vectorize(
        SimpleNamespace(dims=dims, batch_size=8, cfg=cfg, dictionary=jd),
        [JaxRequest(*r) for r in reqs])
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _imported_roots(path: Path):
    """Top-level package names a Python file imports, anywhere in it."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_never_imports_jax():
    """The machine with the GPU has no jax: importing every module of the
    port loads neither jax nor the JAX package, and chip_smoke.py imports
    neither."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import qmann_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "qmann_tpu_torch.__path__, 'qmann_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert not any(m == 'qmann_tpu' or m.startswith('qmann_tpu.')\n"
        "               for m in sys.modules), 'qmann_tpu was imported'\n"
        "print(*names, len(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.split()[:-1])
    assert int(proc.stdout.split()[-1]) == len(names) >= 20
    assert {"qmann_tpu_torch.device", "qmann_tpu_torch.ops.fused",
            "qmann_tpu_torch.ops.cuda._build",
            "qmann_tpu_torch.ops.cuda.qmatvec",
            "qmann_tpu_torch.ops.cuda.attention_read",
            "qmann_tpu_torch.ops.attention",
            "qmann_tpu_torch.ops.cuda.hamming",
            "qmann_tpu_torch.train.optim",
            "qmann_tpu_torch.train.trainer",
            "qmann_tpu_torch.cli", "qmann_tpu_torch.__main__",
            "qmann_tpu_torch.data.babi", "qmann_tpu_torch.data.native",
            "qmann_tpu_torch.utils", "qmann_tpu_torch.utils.analysis",
            "qmann_tpu_torch.utils.checkpoint",
            "qmann_tpu_torch.utils.profiling",
            "qmann_tpu_torch.utils.reporting",
            "qmann_tpu_torch.utils.verification",
            "qmann_tpu_torch.bench", "qmann_tpu_torch.bench.qps",
            "qmann_tpu_torch.train.multi", "qmann_tpu_torch.bench.sweep",
            "qmann_tpu_torch.bench.megasweep",
            "qmann_tpu_torch.bench.compare",
            "qmann_tpu_torch.serve.packet", "qmann_tpu_torch.serve.server",
            "qmann_tpu_torch.serve.client",
            "qmann_tpu_torch.bench.common",
            "qmann_tpu_torch.bench.engine_bench",
            "qmann_tpu_torch.bench.backend_ab",
            "qmann_tpu_torch.bench.probe_dispatch",
            "qmann_tpu_torch.bench.trace_forward"} <= names
    roots = _imported_roots(REPO / "chip_smoke.py")
    assert "qmann_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "qmann_tpu"}


def test_kernel_times_never_imports_jax():
    """The script that runs on the card's machine imports neither jax nor
    the JAX package."""
    roots = _imported_roots(REPO / "scripts/kernel_times.py")
    assert not roots & {"jax", "jaxlib", "qmann_tpu"}
    assert "qmann_tpu_torch" in roots


@pytest.mark.parametrize("script", ["step_times.py", "scripts/sass_loops.py"])
def test_timing_scripts_never_import_jax(script):
    """The other scripts that run on the card's machine import neither jax
    nor the JAX package, only the port."""
    roots = _imported_roots(REPO / script)
    assert not roots & {"jax", "jaxlib", "qmann_tpu"}
    assert "qmann_tpu_torch" in roots
