"""The training slice of the port against the JAX package on the same numpy
inputs: the vectorizer, the optimizer, the model forward on the kernel
route, the model's gradients, one SGD step, and a 2-epoch train_task.

Tolerances, with their reasons:
  * vectorize / compute_dims / Dictionary.build / lr_schedule /
    zero_null_columns: exact (the same integer and float assignments);
  * sgd_update: rtol 1e-6, atol 1e-7 (the clip norm sums in another order);
  * forward: logits rtol 1e-5, atol 1e-5 (the float output product), hop
    0's scores exact (the lattice), attention atol 1e-6 (exp by an ulp),
    predictions exact;
  * parameters after one step: rtol 1e-5, atol 1e-6 (the backward
    products and the softmax sum in another order);
  * the model's gradients: rtol 1e-5, atol 4e-6 * max|grad| per weight
    (~32 float32 ulps of its largest element: each element is a sum over
    samples, hops and memory rows of terms as large as that, so another
    summation order moves it by a few ulps of the largest term, not of
    itself);
  * a 2-epoch history: error rates exact, costs rtol 1e-4 (per-step float
    differences accumulate over ~10 SGD steps).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qmann_tpu.config import QmannConfig as JaxConfig  # noqa: E402
from qmann_tpu.data import babi as jbabi  # noqa: E402
from qmann_tpu.models import memn2n as jmodel  # noqa: E402
from qmann_tpu.ops import argmax_last as j_argmax_last  # noqa: E402
from qmann_tpu.train import optim as joptim  # noqa: E402
from qmann_tpu.train import trainer as jtrainer  # noqa: E402
from qmann_tpu_torch.config import QmannConfig  # noqa: E402
from qmann_tpu_torch.data import babi  # noqa: E402
from qmann_tpu_torch.models import memn2n  # noqa: E402
from qmann_tpu_torch.ops import argmax_last  # noqa: E402
from qmann_tpu_torch.serve import InferenceEngine  # noqa: E402
from qmann_tpu_torch.train import optim, trainer  # noqa: E402

V, M, W = 19, 10, 6   # qa1 shape: dictionary, memory rows, words per row


def to_jax_samples(samples):
    return [jbabi.Sample(s.sentences, s.question, s.answer) for s in samples]


def to_jax_task(data):
    splits = [jbabi.VectorizedSplit(**dataclasses.asdict(s))
              for s in (data.train, data.valid, data.test)]
    jd = jbabi.Dictionary()
    for w in data.dictionary.words[1:]:
        jd.add(w)
    return jbabi.TaskData(*splits, jbabi.DataDims(
        **dataclasses.asdict(data.dims)), jd)


def jax_params(cfg_kw, dims, seed=0, scale=4.0):
    """JAX init_params scaled x4: unscaled N(0, 0.1) weights quantize to
    almost nothing at Q5.2."""
    p = jmodel.init_params(JaxConfig(**cfg_kw), dims, jax.random.PRNGKey(seed))
    return {k: np.asarray(v) * np.float32(scale) for k, v in p.items()}


def batch_arrays(data, n, dead=0):
    """The first n training samples as a batch, the last `dead` of them
    zeroed into padded samples (no live row, zero answer, sample mask 0)."""
    s = data.train
    mem, que, ans, mask = (np.array(a[:n]) for a in (
        s.memory, s.question, s.answer, s.mask))
    smask = np.ones(n, np.float32)
    for a in (mem, que, ans, mask, smask):
        a[n - dead:] = 0
    return mem, que, ans, mask, smask


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def _samples(rng):
    """Synthetic stories plus the vectorizer's edge cases: a story longer
    than max_line, a sentence longer than max_word, unknown and mixed-case
    words, a multi-word answer."""
    samples = babi.synthetic_samples(rng, 30, 12, 6, 4, first_full=True)
    samples.append(babi.Sample(
        [["w1", "W2", "w3"]] * 9 + [["w4"] * 9], ["W5", "nope", "w6"],
        ["w2", "w3"]))
    return samples


@pytest.mark.parametrize("kw", [dict(), dict(enable_time=False),
                                dict(en_pe=True),
                                dict(rand_noise_time=0.5, is_train=True),
                                dict(dims_kw=dict(dim_forced=True)),
                                dict(dims_kw=dict(pad_dict=20, pad_line=9))])
def test_vectorize_and_compute_dims_match_jax(rng, kw):
    kw = dict(kw)
    dims_kw = kw.pop("dims_kw", {})
    samples = _samples(rng)
    jsamples = to_jax_samples(samples)
    td, jd = babi.Dictionary.build(samples), jbabi.Dictionary.build(jsamples)
    assert td.words == jd.words
    en_time = kw.get("enable_time", True)
    tdims = babi.compute_dims(samples[:20], td, en_time, **dims_kw)
    jdims = jbabi.compute_dims(jsamples[:20], jd, en_time, **dims_kw)
    assert dataclasses.asdict(tdims) == dataclasses.asdict(jdims)
    noisy = "rand_noise_time" in kw
    got = babi.vectorize(samples, td, tdims,
                         rng=np.random.default_rng(5) if noisy else None,
                         **kw)
    want = jbabi.vectorize(jsamples, jd, jdims,
                           rng=np.random.default_rng(5) if noisy else None,
                           **kw)
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        assert g.dtype == w.dtype, f.name
        np.testing.assert_array_equal(g, w, err_msg=f.name)
    np.testing.assert_array_equal(got.mask, want.mask)


def test_synthetic_task_layout_and_answers():
    data = babi.synthetic_task(np.random.default_rng(0), 100, 20, 20, V, M, W)
    assert dataclasses.astuple(data.dims) == (V, M, W, W + 1, V + M)
    for split in (data.train, data.valid, data.test):
        assert (split.answer.sum(-1) == 1).all()
        assert (split.n_sen >= 1).all() and (split.n_sen <= M).all()
        # the answer is a word of the most recent sentence (time slot V)
        newest = split.memory[np.arange(len(split)), split.n_sen - 1]
        assert newest[:, V].all()
        assert newest[np.arange(len(split)), split.answer_index].all()


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(type_weight_tying=1),
                                dict(lambda_=0.01, max_grad_l2_norm=5.0),
                                dict(en_grad_quant=True,
                                     grad_quant_placement="update"),
                                dict(en_max_grad_l2_norm=False),
                                dict(en_sc_att=True, test_maxout=True,
                                     lambda_=0.01),
                                dict(en_sc_att=True, test_maxout=True,
                                     en_grad_quant=True,
                                     grad_quant_placement="update")])
@pytest.mark.parametrize("grad_sd", [0.05, 3.0])
def test_sgd_update_matches_jax(rng, kw, grad_sd):
    """The clip both idle (small gradients) and firing (large ones); the
    scale (divided by batch_size * scale_dim, no clip, no "update"
    quantization) and the maxout pieces (plain SGD) when present."""
    cfg_kw = dict(dim_emb=8, verbose=False, **kw)
    shapes = memn2n.param_shapes(QmannConfig(**cfg_kw), 17)
    params = {k: rng.normal(0, 0.5, s).astype(np.float32)
              for k, s in shapes.items()}
    grads = {k: rng.normal(0, grad_sd, s).astype(np.float32)
             for k, s in shapes.items()}
    want = joptim.sgd_update({k: jnp.asarray(v) for k, v in params.items()},
                             {k: jnp.asarray(v) for k, v in grads.items()},
                             jnp.float32(0.3), jnp.float32(27.0),
                             JaxConfig(**cfg_kw), scale_dim=10)
    got = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    out = optim.sgd_update(got, {k: torch.from_numpy(v)
                                 for k, v in grads.items()},
                           torch.tensor(0.3), torch.tensor(27.0),
                           QmannConfig(**cfg_kw), scale_dim=10)
    assert out is got          # in place
    for k in params:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    # (the "update" grad-quant placement rounds small gradients to 0)
    assert any(not np.array_equal(got[k].numpy(), params[k]) for k in params)


@pytest.mark.parametrize("variant", ["momentum", "rmsprop", "adamax"])
def test_optimizer_variants_match_jax(rng, variant):
    """sgd_momentum_update, rmsprop_update and adamax_update over three
    steps on a params dict with a scale and maxout pieces: parameters and
    state rtol 1e-6, atol 1e-7 (the same float32 operations in the same
    order; XLA may contract a multiply-add)."""
    from qmann_tpu.train.optim import (adamax_update as j_adamax,
                                       rmsprop_update as j_rmsprop,
                                       sgd_momentum_update as j_momentum)
    cfg_kw = dict(dim_emb=8, verbose=False, lambda_=0.01, en_sc_att=True,
                  test_maxout=True)
    shapes = memn2n.param_shapes(QmannConfig(**cfg_kw), 17)
    params = {k: rng.normal(0, 0.5, s).astype(np.float32)
              for k, s in shapes.items()}
    zeros = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    jfn, tfn = {"momentum": (j_momentum, optim.sgd_momentum_update),
                "rmsprop": (j_rmsprop, optim.rmsprop_update),
                "adamax": (j_adamax, optim.adamax_update)}[variant]

    def jax_tree(d):
        return {k: jnp.asarray(v) for k, v in d.items()}

    def torch_tree(d):
        return {k: torch.from_numpy(v) for k, v in d.items()}

    jp, tp = jax_tree(params), torch_tree(params)
    if variant == "adamax":       # (first moment, infinity norm)
        jstate = (jax_tree(zeros), jax_tree(zeros))
        tstate = (torch_tree(zeros), torch_tree(zeros))
    else:
        jstate, tstate = jax_tree(zeros), torch_tree(zeros)
    for _ in range(3):
        grads = {k: rng.normal(0, 1.0, s).astype(np.float32)
                 for k, s in shapes.items()}
        jp, jstate = jfn(jp, jax_tree(grads), jstate, jnp.float32(0.1),
                         jnp.float32(4.0), JaxConfig(**cfg_kw))
        tp, tstate = tfn(tp, torch_tree(grads), tstate, torch.tensor(0.1),
                         torch.tensor(4.0), QmannConfig(**cfg_kw))
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
        assert not np.array_equal(tp[k].numpy(), params[k]), k
    for t_st, j_st in (zip(tstate, jstate) if variant == "adamax"
                       else [(tstate, jstate)]):
        for k in params:      # jax.tree.map returns the keys sorted
            np.testing.assert_allclose(t_st[k].numpy(), np.asarray(j_st[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("tying", [1, 2])
def test_zero_null_columns_and_rowsum_norm_match_jax(rng, tying):
    cfg_kw = dict(dim_emb=8, verbose=False, type_weight_tying=tying)
    shapes = memn2n.param_shapes(QmannConfig(**cfg_kw), 17)
    params = {k: rng.normal(0, 0.5, s).astype(np.float32)
              for k, s in shapes.items()}
    want = joptim.zero_null_columns(
        {k: jnp.asarray(v) for k, v in params.items()}, JaxConfig(**cfg_kw))
    got = optim.zero_null_columns({k: torch.from_numpy(v.copy())
                                   for k, v in params.items()},
                                  QmannConfig(**cfg_kw))
    for k in params:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    g = rng.normal(0, 1, (6, 9)).astype(np.float32)
    np.testing.assert_allclose(float(optim.rowsum_l2_norm(torch.from_numpy(g))),
                               float(joptim.rowsum_l2_norm(jnp.asarray(g))),
                               rtol=1e-6)


@pytest.mark.parametrize("kw", [dict(), dict(en_linear_start=True),
                                dict(num_itr=60, rate_decay_step=7,
                                     en_linear_start=True,
                                     num_itr_linear_start=3)])
def test_lr_schedule_matches_jax(kw):
    assert list(optim.lr_schedule(QmannConfig(**kw))) == \
        list(joptim.lr_schedule(JaxConfig(**kw)))


# ---------------------------------------------------------------------------
# model: the kernel route's forward and gradients
# ---------------------------------------------------------------------------

MODEL_CONFIGS = [dict(), dict(type_weight_tying=1),
                 dict(en_linear_mapping=False, en_non_linearity=True),
                 dict(attention_mode=1)]


@pytest.mark.parametrize("kw", MODEL_CONFIGS)
def test_forward_kernel_route_matches_jax_pallas(kw):
    """The port's forward with use_pallas=True (on the CPU: the kernels'
    plain versions and the fused read's autograd op) against JAX's forward
    with use_pallas=True, its Pallas kernels in interpret mode."""
    from jax.experimental.pallas import tpu as pltpu
    cfg_kw = dict(dim_emb=16, use_pallas=True, verbose=False, **kw)
    data = babi.synthetic_task(np.random.default_rng(1), 24, 1, 1, V, M, W)
    mem, que, _, mask, _ = batch_arrays(data, 24, dead=2)
    pj = jax_params(cfg_kw, data.dims, seed=1)
    with pltpu.force_tpu_interpret_mode():
        want = jmodel.forward({k: jnp.asarray(v) for k, v in pj.items()},
                              jnp.asarray(mem), jnp.asarray(que),
                              jnp.asarray(mask), JaxConfig(**cfg_kw))
    got = memn2n.forward(memn2n.params_from_jax(pj, QmannConfig(**cfg_kw),
                                                device="cpu"),
                         torch.from_numpy(mem), torch.from_numpy(que),
                         torch.from_numpy(mask), QmannConfig(**cfg_kw))
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.scores[0].numpy(),
                                  np.asarray(want.scores[0]))
    np.testing.assert_allclose(got.attention.numpy(),
                               np.asarray(want.attention), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(argmax_last(got.logits).numpy(),
                                  np.asarray(j_argmax_last(want.logits)))
    assert np.isfinite(got.logits.numpy()).all()


@pytest.mark.parametrize("kw", MODEL_CONFIGS + [dict(en_grad_quant=True)])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_loss_gradients_match_jax(kw, use_pallas):
    """d(loss)/d(params) of loss_and_metrics with a sample mask and padded
    samples, on both routes of the port, against jax.grad (JAX's plain
    route, which its own tests hold gradient-identical to its Pallas one).
    EN_GRAD_QUANT's backward placement keeps the unfused chain."""
    cfg_kw = dict(dim_emb=16, verbose=False, **kw)
    data = babi.synthetic_task(np.random.default_rng(2), 20, 1, 1, V, M, W)
    arrays = batch_arrays(data, 20, dead=3)
    pj = jax_params(cfg_kw, data.dims, seed=2)
    jcfg = JaxConfig(**cfg_kw)

    def jloss(p):
        loss, met = jmodel.loss_and_metrics(
            p, *(jnp.asarray(a) for a in arrays), jcfg)
        return loss, met

    want, jmet = jax.grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in pj.items()})
    tcfg = QmannConfig(use_pallas=use_pallas, **cfg_kw)
    pt = memn2n.params_from_jax(pj, tcfg, device="cpu")
    leaves = [pt[k].requires_grad_() for k in pt]
    loss, met = memn2n.loss_and_metrics(
        pt, *(torch.from_numpy(a) for a in arrays), tcfg)
    got = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(met.cost), float(jmet.cost), rtol=1e-5)
    assert int(met.matches) == int(jmet.matches)
    np.testing.assert_array_equal(met.pred.numpy(), np.asarray(jmet.pred))
    for k, g in zip(pt, got):
        g, w = g.numpy(), np.asarray(want[k])
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=4e-6 * np.abs(w).max(), err_msg=k)
        assert np.abs(g).max() > 0 and np.isfinite(g).all(), k


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------

def _one_batch_epoch(data, n, dead, batch_size):
    mem, que, ans, mask, smask = batch_arrays(data, n, dead)
    pad = batch_size - n
    arrays = {"memory": mem, "question": que, "answer": ans, "mask": mask,
              "sample_mask": smask}
    arrays = {k: np.concatenate([v, np.zeros((pad,) + v.shape[1:],
                                             v.dtype)])[None]
              for k, v in arrays.items()}
    arrays["size_b"] = arrays["sample_mask"].sum(1).astype(np.float32)
    return arrays


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("kw", [dict(), dict(type_weight_tying=1,
                                             lambda_=0.01)])
def test_one_sgd_step_matches_jax_train_epoch(kw, use_pallas):
    """A one-batch epoch (a partial batch: 13 live samples of 16, with
    padded samples) through JAX's train_epoch and the port's."""
    cfg_kw = dict(dim_emb=16, size_batch=16, verbose=False, **kw)
    data = babi.synthetic_task(np.random.default_rng(3), 16, 1, 1, V, M, W)
    batches = _one_batch_epoch(data, 13, 0, 16)
    pj = jax_params(cfg_kw, data.dims, seed=3)
    jp, jcost, jmatch = jtrainer.train_epoch(
        {k: jnp.asarray(v) for k, v in pj.items()},
        {k: jnp.asarray(v) for k, v in batches.items()}, jnp.float32(0.3),
        JaxConfig(**cfg_kw))
    tcfg = QmannConfig(use_pallas=use_pallas, **cfg_kw)
    tp = memn2n.params_from_jax(pj, tcfg, device="cpu")
    tp, tcost, tmatch = trainer.train_epoch(
        tp, {k: torch.from_numpy(v) for k, v in batches.items()},
        torch.tensor(0.3), tcfg)
    np.testing.assert_allclose(float(tcost), float(jcost), rtol=1e-5)
    assert int(tmatch) == int(jmatch)
    for k in pj:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
        assert not np.array_equal(tp[k].numpy(), pj[k]), k
        assert not tp[k].requires_grad


@pytest.mark.parametrize("kw", [dict(use_pallas=True),
                                dict(en_sample_shuffled=True,
                                     en_save_best_model=True)])
def test_train_task_history_matches_jax(kw):
    """Two epochs on a tiny synthetic task (70 training stories: two full
    batches and a partial one) from the same weights; the JAX trainer runs
    its plain route (its shuffle permutation comes from the same numpy
    generator)."""
    cfg_kw = dict(dim_emb=16, num_itr=2, learning_rate=0.1, verbose=False)
    data = babi.synthetic_task(np.random.default_rng(4), 70, 20, 20, V, M, W)
    pj = jax_params(cfg_kw, data.dims, seed=4)
    jcfg = JaxConfig(**cfg_kw, **{k: v for k, v in kw.items()
                                  if k != "use_pallas"})
    want = jtrainer.train_task(jcfg, to_jax_task(data),
                               {k: jnp.asarray(v) for k, v in pj.items()})
    tcfg = QmannConfig(**cfg_kw, **kw)
    pt = memn2n.params_from_jax(pj, tcfg, device="cpu")
    got = trainer.train_task(tcfg, data, pt, device="cpu")
    assert len(got.history) == len(want.history) == 2
    for g, w in zip(got.history, want.history):
        assert (g.err_train, g.err_valid, g.lr) == \
            (w.err_train, w.err_valid, w.lr)
        np.testing.assert_allclose([g.cost_train, g.cost_valid],
                                   [w.cost_train, w.cost_valid], rtol=1e-4)
        assert np.isfinite([g.cost_train, g.cost_valid]).all()
    assert got.err_test == want.err_test
    np.testing.assert_allclose(got.cost_test, want.cost_test, rtol=1e-4)
    for k in pj:      # the caller's weights are not touched
        np.testing.assert_array_equal(pt[k].numpy(), pj[k])
    assert (got.best_params is None) == (want.best_params is None)


def test_eval_split_pads_chunks():
    """Chunks zero-padded to a fixed size give the same cost, error and
    predictions as one chunk holding the whole split."""
    cfg = QmannConfig(dim_emb=16, use_pallas=True, verbose=False)
    data = babi.synthetic_task(np.random.default_rng(5), 1, 1, 45, V, M, W)
    pt = memn2n.params_from_jax(jax_params({"dim_emb": 16}, data.dims), cfg,
                                device="cpu")
    whole = trainer.eval_split(pt, data.test, cfg, chunk=64, device="cpu")
    parts = trainer.eval_split(pt, data.test, cfg, chunk=16, device="cpu")
    np.testing.assert_allclose(parts[0], whole[0], rtol=1e-5)
    assert parts[1] == whole[1]
    np.testing.assert_array_equal(parts[2], whole[2])
    assert parts[2].shape == (45,)


@pytest.mark.parametrize("kw", [dict(), dict(use_pallas=True,
                                             attention_mode=3, iwl=1)])
def test_eval_split_matches_jax_over_three_chunks(kw):
    """A 2500-sample split is three 1024-sample chunks (the last padded):
    the port adds the chunk costs in float64 in chunk order, as JAX adds its
    Python floats.  Errors and predictions equal; the cost within rtol 1e-6
    (each chunk's float32 sum runs in another order)."""
    cfg_kw = dict(dim_emb=16, num_hops=2, verbose=False,
                  **{k: v for k, v in kw.items() if k != "use_pallas"})
    data = babi.synthetic_task(np.random.default_rng(6), 1, 1, 2500, V, M, W)
    pj = jax_params(cfg_kw, data.dims, seed=6)
    jcost, jerr, jpred = jtrainer.eval_split(
        {k: jnp.asarray(v) for k, v in pj.items()},
        to_jax_task(data).test, JaxConfig(**cfg_kw))
    tcfg = QmannConfig(**cfg_kw, use_pallas=kw.get("use_pallas", False))
    cost, err, pred = trainer.eval_split(
        memn2n.params_from_jax(pj, tcfg, device="cpu"), data.test, tcfg,
        device="cpu")
    assert isinstance(cost, float) and err == jerr and 0 < err < 1
    np.testing.assert_array_equal(pred, np.asarray(jpred))
    np.testing.assert_allclose(cost, jcost, rtol=1e-6)


@pytest.mark.parametrize("kw,what", [(dict(en_linear_start=True), "linear"),
                                     (dict(en_similarity_analysis=True),
                                      "similarity"),
                                     (dict(), "mesh")])
def test_train_task_linear_start_similarity_and_mesh(kw, what, tmp_path):
    """train_task with linear start, the similarity analysis and a mesh.
    The mesh case trains on a mesh of one rank (a group of this process)
    and gives the single-device run's history and test error exactly (no
    collective crosses an axis of size 1).  The linear case runs a 3-epoch
    train_task (2 linear-start epochs, softmax removed at half the lr,
    then 1) on the kernel route against JAX's history from the same
    weights (errors and lr exact, costs rtol 1e-4, as
    test_train_task_history_matches_jax; the plain route's steps are held
    to JAX in tests/test_torch_features.py); the similarity case checks
    that the run writes the first 25-epoch bucket's two CSVs."""
    data = babi.synthetic_task(np.random.default_rng(0), 4, 1, 1, V, M, W)
    if what == "similarity":
        cfg = QmannConfig(dim_emb=8, num_itr=1, verbose=False,
                          similarity_analysis_dir=str(tmp_path), **kw)
        trainer.train_task(cfg, data, device="cpu")
        assert sorted(p.name for p in tmp_path.iterdir()) == [
            "softmax_input_0to24.csv", "softmax_output_0to24.csv"]
        return
    if what == "linear":
        cfg_kw = dict(dim_emb=8, num_hops=2, num_itr=1,
                      num_itr_linear_start=2, learning_rate=0.1,
                      verbose=False, **kw)
        data = babi.synthetic_task(np.random.default_rng(12), 70, 20, 20, V,
                                   M, W)
        pj = jax_params(cfg_kw, data.dims, seed=12)
        want = jtrainer.train_task(JaxConfig(**cfg_kw), to_jax_task(data),
                                   {k: jnp.asarray(v) for k, v in pj.items()})
        tcfg = QmannConfig(use_pallas=True, **cfg_kw)
        got = trainer.train_task(
            tcfg, data, memn2n.params_from_jax(pj, tcfg, device="cpu"),
            device="cpu")
        assert len(got.history) == len(want.history) == 3
        assert [h.lr for h in got.history] == [0.05, 0.05, 0.1]
        for g, w in zip(got.history, want.history):
            assert (g.err_train, g.err_valid, g.lr) == \
                (w.err_train, w.err_valid, w.lr)
            np.testing.assert_allclose([g.cost_train, g.cost_valid],
                                       [w.cost_train, w.cost_valid],
                                       rtol=1e-4)
            assert np.isfinite([g.cost_train, g.cost_valid]).all()
        assert got.err_test == want.err_test
        np.testing.assert_allclose(got.cost_test, want.cost_test, rtol=1e-4)
        return
    import torch.distributed as dist
    from qmann_tpu_torch.parallel import make_mesh
    from qmann_tpu_torch.parallel.launch import init_single_process
    cfg = QmannConfig(dim_emb=8, num_itr=2, use_pallas=True,
                      en_sample_shuffled=True, verbose=False, **kw)
    data = babi.synthetic_task(np.random.default_rng(3), 70, 20, 20, V, M, W)
    pt = memn2n.params_from_jax(jax_params({"dim_emb": 8}, data.dims), cfg,
                                device="cpu")
    want = trainer.train_task(cfg, data, pt, device="cpu")
    init_single_process("cpu")
    try:
        got = trainer.train_task(cfg, data, pt, mesh=make_mesh(device="cpu"))
    finally:
        dist.destroy_process_group()
    assert [dataclasses.astuple(h) for h in got.history] == \
        [dataclasses.astuple(h) for h in want.history]
    assert (got.err_test, got.cost_test) == (want.err_test, want.cost_test)


def test_similarity_dump_covers_linear_start_epochs(tmp_path, monkeypatch):
    """The analyzer is sized to num_itr + num_itr_linear_start epochs, as
    JAX sizes it (sized to num_itr alone, 24 + 2 epochs would lose epoch
    25, past the last bucket), and records every epoch of a linear-start
    run."""
    sizes = []

    class Spy(trainer.SimilarityAnalyzer):
        def __init__(self, out_dir, num_itr):
            sizes.append(num_itr)
            super().__init__(out_dir, num_itr)

    monkeypatch.setattr(trainer, "SimilarityAnalyzer", Spy)
    data = babi.synthetic_task(np.random.default_rng(0), 4, 2, 1, V, M, W)
    cfg = QmannConfig(dim_emb=8, num_hops=1, num_itr=1,
                      en_linear_start=True, num_itr_linear_start=2,
                      en_similarity_analysis=True, similarity_probe_size=2,
                      similarity_analysis_dir=str(tmp_path), verbose=False)
    trainer.train_task(cfg, data, device="cpu")
    assert sizes == [3]
    epochs = {int(ln.split(",")[0]) for ln in
              (tmp_path / "softmax_input_0to24.csv").read_text().split()}
    assert epochs == {0, 1, 2}


def test_entry_points_default_to_the_card():
    """Without a card, asking for the default device raises; nothing runs
    on the CPU unless the caller passes device='cpu'."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults run on it")
    cfg = QmannConfig(dim_emb=8, verbose=False)
    data = babi.synthetic_task(np.random.default_rng(0), 4, 2, 2, V, M, W)
    pj = jax_params({"dim_emb": 8}, data.dims)
    calls = [
        lambda: memn2n.init_params(cfg, data.dims, torch.Generator()),
        lambda: memn2n.params_from_jax(pj, cfg),
        lambda: InferenceEngine(memn2n.params_from_jax(pj, cfg, device="cpu"),
                                cfg, data.dims, data.dictionary),
        lambda: trainer.train_task(cfg, data),
        lambda: trainer.eval_split(
            memn2n.params_from_jax(pj, cfg, device="cpu"), data.valid, cfg),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
