"""Attention mode 3 (the paper's Hamming attention) through the port's
model and trainer against the JAX package, on a model of 3 hops and
dim_emb 16 over synthetic qa1-shaped stories, at iwl 1 (the paper's
mode-3 point) and iwl 5.  Mode 4 (binary attention) rides along.

Routes: plain; ``use_pallas`` (on the CPU the kernels' plain versions: the
lattice and the mode-3 read with the surrogate backward); and
``use_pallas_hamming`` (the score alone on the Hamming kernel's route).
The JAX side runs its Pallas kernels in interpret mode.

Tolerances, with their reasons:
  * forward: hop 0's scores exact (the Hamming row sums are exact); the
    attention within atol 1e-6 (exp by an ulp); the logits within
    rtol 1e-5, atol 1e-5 and the predictions equal, in every query where
    no Q(p, act) requant flipped (at most one may flip);
  * gradients of every parameter: rtol 1e-5, atol 4e-6 * max|grad| per
    weight, as tests/test_torch_train.py (about 32 float32 ulps of its
    largest element: each element sums terms as large as that over
    samples, hops and rows, so another order moves it by ulps of the
    largest term; at iwl 1 H's gradients reach ~17, where one ulp is
    1.9e-6), and non-zero on A, which only the surrogate reaches;
  * parameters after one SGD step: rtol 1e-5, atol 1e-6;
  * EN_GRAD_QUANT changes nothing in mode 3: bit-identical gradients on
    the plain route; on the kernel route (fused read without it, the
    unfused chain with it) rtol 1e-5, atol 1e-6, the same backward
    products accumulated in another order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qmann_tpu.config import QmannConfig as JaxConfig  # noqa: E402
from qmann_tpu.models import memn2n as jmodel  # noqa: E402
from qmann_tpu.ops import argmax_last as j_argmax_last  # noqa: E402
from qmann_tpu.train import trainer as jtrainer  # noqa: E402
from qmann_tpu_torch.config import QmannConfig  # noqa: E402
from qmann_tpu_torch.data import babi  # noqa: E402
from qmann_tpu_torch.models import memn2n  # noqa: E402
from qmann_tpu_torch.numerics import float_quant  # noqa: E402
from qmann_tpu_torch.ops import argmax_last  # noqa: E402
from qmann_tpu_torch.ops.cuda import attention_read as ar  # noqa: E402
from qmann_tpu_torch.train import trainer  # noqa: E402
from test_torch_train import (  # noqa: E402
    V, M, W, _one_batch_epoch, batch_arrays, jax_params, to_jax_task,
)

ROUTES = [dict(), dict(use_pallas=True), dict(use_pallas_hamming=True)]


def _flipped(cfg, p_w, p_g):
    flipped = np.zeros(p_w.shape[1], bool)
    for h, fmt in enumerate(cfg.fmt_act):
        flipped |= (float_quant(torch.from_numpy(p_w[h]), fmt)
                    != float_quant(torch.from_numpy(p_g[h]), fmt)
                    ).numpy().any(-1)
    return flipped


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("iwl,mode", [(1, 3), (5, 3), (1, 4)])
def test_forward_matches_jax(iwl, mode, route):
    from jax.experimental.pallas import tpu as pltpu
    cfg_kw = dict(dim_emb=16, iwl=iwl, attention_mode=mode, verbose=False,
                  **route)
    data = babi.synthetic_task(np.random.default_rng(1), 24, 1, 1, V, M, W)
    mem, que, _, mask, _ = batch_arrays(data, 24, dead=2)
    pj = jax_params(cfg_kw, data.dims, seed=1)
    with pltpu.force_tpu_interpret_mode():
        want = jmodel.forward({k: jnp.asarray(v) for k, v in pj.items()},
                              jnp.asarray(mem), jnp.asarray(que),
                              jnp.asarray(mask), JaxConfig(**cfg_kw))
    cfg = QmannConfig(**cfg_kw)
    before = ar.fused_read.launches
    got = memn2n.forward(memn2n.params_from_jax(pj, cfg, device="cpu"),
                         torch.from_numpy(mem), torch.from_numpy(que),
                         torch.from_numpy(mask), cfg)
    assert ar.fused_read.launches == before       # CPU: the plain read
    s_w, p_w = np.array(want.scores), np.array(want.attention)
    np.testing.assert_array_equal(got.scores[0].numpy(), s_w[0])
    np.testing.assert_allclose(got.attention.numpy(), p_w, rtol=0, atol=1e-6)
    ok = ~_flipped(cfg, p_w, got.attention.numpy())
    assert ok.sum() >= len(ok) - 1
    lw, lg = np.array(want.logits), got.logits.numpy()
    np.testing.assert_allclose(lg[ok], lw[ok], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        argmax_last(got.logits).numpy()[ok],
        np.asarray(j_argmax_last(want.logits))[ok])
    assert np.isfinite(lg).all()


def _torch_grads(pj, arrays, cfg):
    pt = memn2n.params_from_jax(pj, cfg, device="cpu")
    leaves = [pt[k].requires_grad_() for k in pt]
    loss, met = memn2n.loss_and_metrics(
        pt, *(torch.from_numpy(a) for a in arrays), cfg)
    return dict(zip(pt, torch.autograd.grad(loss, leaves))), met


@pytest.mark.parametrize("extra", ROUTES + [dict(use_pallas=True,
                                                 en_grad_quant=True)])
@pytest.mark.parametrize("iwl", [1, 5])
def test_loss_gradients_match_jax(iwl, extra):
    """d(loss)/d(params) of loss_and_metrics with a sample mask and padded
    samples against jax.grad of JAX's loss_and_metrics (plain route; its
    own tests hold its Pallas routes gradient-identical)."""
    cfg_kw = dict(dim_emb=16, iwl=iwl, attention_mode=3, verbose=False)
    data = babi.synthetic_task(np.random.default_rng(2), 20, 1, 1, V, M, W)
    arrays = batch_arrays(data, 20, dead=3)
    pj = jax_params(cfg_kw, data.dims, seed=2)
    jcfg = JaxConfig(**cfg_kw)

    def jloss(p):
        return jmodel.loss_and_metrics(p, *(jnp.asarray(a) for a in arrays),
                                       jcfg)

    want, jmet = jax.grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in pj.items()})
    got, met = _torch_grads(pj, arrays, QmannConfig(**cfg_kw, **extra))
    np.testing.assert_allclose(float(met.cost), float(jmet.cost), rtol=1e-5)
    np.testing.assert_array_equal(met.pred.numpy(), np.asarray(jmet.pred))
    for k, g in got.items():
        w = np.asarray(want[k])
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=4e-6 * np.abs(w).max(), err_msg=k)
        assert np.isfinite(g.numpy()).all(), k
    assert np.abs(got["A"].numpy()).max() > 0


@pytest.mark.parametrize("use_pallas", [False, True])
def test_gradients_independent_of_en_grad_quant(use_pallas):
    """tests/test_model.py's property of the JAX package: the mode-3
    weighted-sum backward quantizes whenever the layer is fixed, the score
    backward is the surrogate and the dense backwards are float, so
    EN_GRAD_QUANT changes nothing in mode 3."""
    cfg_kw = dict(dim_emb=16, iwl=1, attention_mode=3, verbose=False,
                  use_pallas=use_pallas)
    data = babi.synthetic_task(np.random.default_rng(6), 12, 1, 1, V, M, W)
    arrays = batch_arrays(data, 12, dead=2)
    pj = jax_params(cfg_kw, data.dims, seed=6)
    g0, _ = _torch_grads(pj, arrays, QmannConfig(**cfg_kw))
    g1, _ = _torch_grads(pj, arrays, QmannConfig(en_grad_quant=True,
                                                 **cfg_kw))
    for k in g0:
        if use_pallas:
            torch.testing.assert_close(g1[k], g0[k], rtol=1e-5, atol=1e-6)
        else:
            assert torch.equal(g1[k], g0[k]), k


@pytest.mark.parametrize("route", ROUTES)
def test_one_sgd_step_matches_jax_train_epoch(route):
    """A one-batch epoch (13 live samples of 16) at iwl 1 through JAX's
    train_epoch and the port's."""
    cfg_kw = dict(dim_emb=16, size_batch=16, iwl=1, attention_mode=3,
                  verbose=False)
    data = babi.synthetic_task(np.random.default_rng(3), 16, 1, 1, V, M, W)
    batches = _one_batch_epoch(data, 13, 0, 16)
    pj = jax_params(cfg_kw, data.dims, seed=3)
    jp, jcost, jmatch = jtrainer.train_epoch(
        {k: jnp.asarray(v) for k, v in pj.items()},
        {k: jnp.asarray(v) for k, v in batches.items()}, jnp.float32(0.3),
        JaxConfig(**cfg_kw))
    tcfg = QmannConfig(**cfg_kw, **route)
    tp, tcost, tmatch = trainer.train_epoch(
        memn2n.params_from_jax(pj, tcfg, device="cpu"),
        {k: torch.from_numpy(v) for k, v in batches.items()},
        torch.tensor(0.3), tcfg)
    np.testing.assert_allclose(float(tcost), float(jcost), rtol=1e-5)
    assert int(tmatch) == int(jmatch)
    for k in pj:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
        assert not np.array_equal(tp[k].numpy(), pj[k]), k


def test_train_task_mode3_history_matches_jax():
    """Two epochs at iwl 1 with use_pallas on a tiny task (two full batches
    and a partial one): error rates equal, costs within rtol 1e-4 (per-step
    float differences accumulate)."""
    cfg_kw = dict(dim_emb=16, iwl=1, attention_mode=3, num_itr=2,
                  learning_rate=0.1, verbose=False)
    data = babi.synthetic_task(np.random.default_rng(4), 70, 20, 20, V, M, W)
    pj = jax_params(cfg_kw, data.dims, seed=4)
    want = jtrainer.train_task(JaxConfig(**cfg_kw), to_jax_task(data),
                               {k: jnp.asarray(v) for k, v in pj.items()})
    tcfg = QmannConfig(use_pallas=True, **cfg_kw)
    got = trainer.train_task(tcfg, data,
                             memn2n.params_from_jax(pj, tcfg, device="cpu"),
                             device="cpu")
    for g, w in zip(got.history, want.history):
        assert (g.err_train, g.err_valid) == (w.err_train, w.err_valid)
        np.testing.assert_allclose([g.cost_train, g.cost_valid],
                                   [w.cost_train, w.cost_valid], rtol=1e-4)
    assert got.err_test == want.err_test


def test_serving_at_iwl1_leaves_the_exact_route():
    """At iwl 1 prepare_inference leaves the exact-GEMM route on both sides
    and forward_prepared takes the forward (here on the plain read)."""
    from jax.experimental.pallas import tpu as pltpu
    kw = dict(dim_emb=16, iwl=1, attention_mode=3, use_pallas=True,
              use_fused_chain=True, verbose=False)
    dims, mem, que, mask = babi.synthetic_batch(np.random.default_rng(5), 20,
                                                V, M, W)
    pj = jax_params(kw, dims, seed=5)
    cfg = QmannConfig(**kw)
    prep = memn2n.prepare_inference(memn2n.params_from_jax(pj, cfg,
                                                           device="cpu"), cfg)
    jprep = jmodel.prepare_inference({k: jnp.asarray(v) for k, v in
                                      pj.items()}, JaxConfig(**kw))
    assert not prep.fast and not jprep.fast
    with pltpu.force_tpu_interpret_mode():
        want = jmodel.forward_prepared(jprep, jnp.asarray(mem),
                                       jnp.asarray(que), jnp.asarray(mask),
                                       JaxConfig(**kw))
    got = memn2n.forward_prepared(prep, torch.from_numpy(mem),
                                  torch.from_numpy(que),
                                  torch.from_numpy(mask), cfg)
    np.testing.assert_array_equal(got.scores[0].numpy(),
                                  np.array(want.scores)[0])
    np.testing.assert_array_equal(argmax_last(got.logits).numpy(),
                                  np.asarray(j_argmax_last(want.logits)))
