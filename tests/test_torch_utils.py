"""The port's utils against the JAX package's: the result CSVs, checkpoints
(written by either package, read by the other), the similarity CSVs and
the trainer's similarity dump, overflow statistics, the phase profiler's
report, and the kernel verification's plumbing on the CPU.

Tolerances: the CSVs and params_fixed.npz byte- or bit-identical (the same
float formatting of the same values; float_quant is exact); checkpoint
arrays and configs equal; overflow statistics equal; the similarity dump of
a training run within rtol 1e-5, atol 1e-6 (softmax inputs and outputs of
forwards after an epoch of SGD, whose float sums run in another order).
"""
import dataclasses
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qmann_tpu.config import QmannConfig as JaxConfig  # noqa: E402
from qmann_tpu.data import babi as jbabi  # noqa: E402
from qmann_tpu.models import memn2n as jmodel  # noqa: E402
from qmann_tpu.numerics import QFormat as JQ  # noqa: E402
from qmann_tpu.train import trainer as jtrainer  # noqa: E402
from qmann_tpu.utils import analysis as janalysis  # noqa: E402
from qmann_tpu.utils import checkpoint as jckpt  # noqa: E402
from qmann_tpu.utils import profiling as jprof  # noqa: E402
from qmann_tpu.utils import reporting as jrep  # noqa: E402
from qmann_tpu.utils import verification as jver  # noqa: E402
from qmann_tpu_torch.config import QmannConfig  # noqa: E402
from qmann_tpu_torch.data import babi  # noqa: E402
from qmann_tpu_torch.models import memn2n  # noqa: E402
from qmann_tpu_torch.numerics import QFormat  # noqa: E402
from qmann_tpu_torch.train import trainer  # noqa: E402
from qmann_tpu_torch.utils import analysis, checkpoint, profiling  # noqa: E402
from qmann_tpu_torch.utils import reporting, verification  # noqa: E402

V, M, W = 19, 10, 6


def _jax_dictionary(words):
    d = jbabi.Dictionary()
    for w in words[1:]:
        d.add(w)
    return d


@pytest.mark.parametrize("n_loops", [1, 3])
def test_write_run_outputs_is_byte_identical(tmp_path, n_loops):
    rng = np.random.default_rng(n_loops)
    kw = dict(iwl=1, attention_mode=3, num_itr=7, dim_emb=24, en_mq=False)

    def results(mod):
        return [mod.TaskResult(t, [mod.TaskLoopResult(*map(float, rng_vals))
                                   for rng_vals in vals])
                for t, vals in zip((1, 4), values)]

    values = [rng.uniform(0, 50, (n_loops, 4)) for _ in range(2)]
    port, jax_dir = tmp_path / "port", tmp_path / "jax"
    for _ in range(2):   # appends, as the reference's files do
        reporting.write_run_outputs(str(port), QmannConfig(**kw),
                                    results(reporting))
        jrep.write_run_outputs(str(jax_dir), JaxConfig(**kw), results(jrep))
    for name in ("result.csv", "result_all.csv"):
        got = (port / name).read_bytes()
        assert got == (jax_dir / name).read_bytes(), name
        assert got.count(b"<config>") == 2
    assert reporting.config_banner(QmannConfig(**kw)) == \
        jrep.config_banner(JaxConfig(**kw))


@pytest.mark.parametrize("kw", [dict(), dict(type_weight_tying=1, iwl=3),
                                dict(attention_mode=3, iwl=1,
                                     en_linear_mapping=False),
                                dict(en_sc_att=True, test_maxout=True)])
def test_checkpoints_load_in_either_package(tmp_path, kw):
    cfg_kw = dict(dim_emb=12, num_hops=2, **kw)
    dims = babi.DataDims(19, 10, 6, 7, 29)
    jparams = {k: np.asarray(v) * np.float32(4.0) for k, v in
               jmodel.init_params(JaxConfig(**cfg_kw), jbabi.DataDims(
                   *dataclasses.astuple(dims)), jax.random.PRNGKey(1)).items()}
    words = ["NULL"] + [f"w{i}" for i in range(1, 19)]
    cfg = QmannConfig(**cfg_kw)
    tparams = memn2n.params_from_jax(jparams, cfg, device="cpu")

    jpath = jckpt.save_checkpoint(str(tmp_path / "j"), jparams,
                                  JaxConfig(**cfg_kw), jbabi.DataDims(
                                      *dataclasses.astuple(dims)),
                                  tag="t", dictionary=_jax_dictionary(words))
    d = babi.Dictionary()
    for w in words[1:]:
        d.add(w)
    tpath = checkpoint.save_checkpoint(str(tmp_path / "t"), tparams, cfg,
                                       dims, tag="t", dictionary=d)
    for name in ("params_fixed.npz", "params.npz"):
        with np.load(os.path.join(jpath, name)) as a, \
                np.load(os.path.join(tpath, name)) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype == np.float32
                assert np.array_equal(a[k].view(np.int32),
                                      b[k].view(np.int32)), (name, k)
    for f in ("meta.json", "dictionary.json"):
        assert open(os.path.join(jpath, f)).read() == \
            open(os.path.join(tpath, f)).read(), f

    for path in (jpath, tpath):        # each package reads both
        for fixed in (False, True):
            p_t, c_t, d_t = checkpoint.load_checkpoint(path, fixed=fixed)
            p_j, c_j, d_j = jckpt.load_checkpoint(path, fixed=fixed)
            assert dataclasses.asdict(c_t) == dataclasses.asdict(c_j) == \
                dataclasses.asdict(cfg)
            assert d_t == d_j == dataclasses.asdict(dims)
            for k in jparams:
                np.testing.assert_array_equal(p_t[k], p_j[k])
            if not fixed:
                back = memn2n.params_from_jax(p_t, c_t, device="cpu")
                for k in jparams:
                    np.testing.assert_array_equal(back[k].numpy(), jparams[k])


def test_similarity_csvs_are_byte_identical(tmp_path):
    rng = np.random.default_rng(3)
    port = analysis.SimilarityAnalyzer(str(tmp_path / "t"), num_itr=60)
    ref = janalysis.SimilarityAnalyzer(str(tmp_path / "j"), num_itr=60)
    for epoch in (0, 3, 24, 25, 59, 60):
        scores = rng.normal(0, 3, (3, 5, 7)).astype(np.float32)
        att = rng.uniform(0, 1, (3, 5, 7)).astype(np.float32)
        mask = np.arange(7)[None, :] < rng.integers(0, 8, 5)[:, None]
        port.record(epoch, torch.from_numpy(scores), torch.from_numpy(att),
                    mask, sample_offset=epoch)
        ref.record(epoch, scores, att, mask, sample_offset=epoch)
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) and len(names) == 6
    for name in names:
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name


def _csv_rows(path):
    rows = []
    for line in open(path).read().splitlines():
        head = line.split(",")
        rows.append((tuple(int(v) for v in head[:3]),
                     np.array([float(v) for v in head[3:] if v])))
    return rows


@pytest.mark.parametrize("probe", [32, 0])
def test_similarity_dump_matches_jax_train_task(tmp_path, probe):
    """train_task's dump (2 epochs, a 40-sample validation split: a probe
    of 32, or all of it) against JAX's, from the same weights."""
    data = babi.synthetic_task(np.random.default_rng(9), 64, 40, 8, V, M, W)
    cfg_kw = dict(dim_emb=16, num_hops=2, num_itr=2, learning_rate=0.1,
                  verbose=False, en_similarity_analysis=True,
                  similarity_probe_size=probe)
    pj = {k: np.asarray(v) * np.float32(4.0) for k, v in jmodel.init_params(
        JaxConfig(**cfg_kw), jbabi.DataDims(*dataclasses.astuple(data.dims)),
        jax.random.PRNGKey(2)).items()}
    jdata = jbabi.TaskData(
        *[jbabi.VectorizedSplit(**dataclasses.asdict(s))
          for s in (data.train, data.valid, data.test)],
        jbabi.DataDims(*dataclasses.astuple(data.dims)),
        _jax_dictionary(data.dictionary.words))
    jtrainer.train_task(JaxConfig(**cfg_kw, similarity_analysis_dir=str(
        tmp_path / "j")), jdata, {k: jnp.asarray(v) for k, v in pj.items()})
    tcfg = QmannConfig(**cfg_kw, similarity_analysis_dir=str(tmp_path / "t"))
    trainer.train_task(tcfg, data, memn2n.params_from_jax(pj, tcfg, "cpu"),
                       device="cpu")
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t"))
    n_rows = 2 * 2 * (40 if probe == 0 else 32)    # epochs x hops x probe
    for name in names:
        got = _csv_rows(tmp_path / "t" / name)
        want = _csv_rows(tmp_path / "j" / name)
        assert len(got) == len(want) == n_rows, name
        for (g_key, g), (w_key, w) in zip(got, want):
            assert g_key == w_key
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                       err_msg=name)


@pytest.mark.parametrize("fmt", [(5, 2), (1, 6), (0, 0)])
def test_overflow_stats_match_jax(fmt):
    x = np.random.default_rng(4).normal(0, 20, (50, 7)).astype(np.float32)
    x[0, :3] = [0.0, 1e-3, -1e-3]
    got = verification.overflow_stats(torch.from_numpy(x), QFormat(*fmt))
    assert got == jver.overflow_stats(x, JQ(*fmt))
    assert verification.overflow_stats(x, QFormat(*fmt)) == got


def test_phase_profiler_report_has_jax_structure():
    port, ref = profiling.PhaseProfiler(), jprof.PhaseProfiler()
    for prof in (port, ref):
        for name in ("train", "data", "train", "eval"):
            with prof.phase(name):
                pass
    mask = re.compile(r"\d+\.\d{3}s")
    assert mask.sub("T", port.report()) == mask.sub("T", ref.report())
    assert dict(port.counts) == {"train": 2, "data": 1, "eval": 1}


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("qmann-region"):
            torch.ones(4).sum()
    text = (tmp_path / "trace.json").read_text()
    assert "qmann-region" in text


def test_verify_kernels_plumbing_on_the_cpu():
    """On the CPU each wrapper takes its plain version, so every entry
    passes; the entries cover all six kernels."""
    results = verification.verify_kernels(device="cpu")
    assert all(r.ok for r in results), [str(r) for r in results]
    names = " ".join(r.name for r in results)
    for kernel in ("qmatvec whole-row", "qmatvec tiled", "hamming",
                   "hamming_backward", "attention_read", "hop_chain",
                   "qweighted_sum_backward"):
        assert kernel in names
    bad = verification.compare("x", np.zeros(3), np.ones(3), threshold=0.0)
    assert not bad.ok and bad.num_mismatch == 3 and "FAIL" in str(bad)
    cfg = QmannConfig(dim_emb=8, num_hops=2)
    dims, mem, que, mask = babi.synthetic_batch(np.random.default_rng(1), 6,
                                                V, M, W)
    rep = verification.verify_model_quantization(cfg, dims, (mem, que, mask),
                                                 device="cpu")
    assert [r.name for r in rep] == ["logits quant-vs-float",
                                     "pred agreement"]
    assert rep[1].total == 6
