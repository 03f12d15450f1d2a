"""The model features of the port against the JAX package on the same
numpy inputs: the fixed-point macros and the straight-through quantizer,
the score mitigations, the softmax variants, the scale, the element-wise
multiply, maxout and the maxout attention, the squared error; then each
feature head of the model (EN_SC_ATT, the shift-based and exp_plan
softmax, cosine similarity, maxout, the score clip and shift) and linear
start, forward, gradients and one SGD step, on the plain route and on
``use_pallas`` (on the CPU the kernels' plain versions; JAX runs its
Pallas kernels in interpret mode).

Where JAX gives NaN the port gives what JAX's code intends; the two cases
are pinned at the end of this file (ROADMAP.md, Queue 3), and elsewhere
the port is compared on inputs where JAX is finite:
  * exp_plan_softmax / exp2_softmax on a row with no live entry (a padded
    sample): JAX 0/0, the port probability 0;
  * cosine similarity's gradient on a zero memory row (every padded row):
    JAX sqrt'(0) * 0, the port a zero subgradient of the norm.

Tolerances (per test below): the fixed-point ops, the score mods, the
scale, qmult, maxout and the lattice scores bit for bit; the softmax
variants rtol 1e-6, atol 1e-7 (exp, log2 and the sum by an ulp); the
model as tests/test_torch_train.py: logits rtol 1e-5, atol 1e-5, hop 0's
scores exact, predictions equal, gradients rtol 1e-5, atol 4e-6 *
max|grad| per weight, parameters after one step rtol 1e-5, atol 1e-6.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qmann_tpu.config import QmannConfig as JaxConfig  # noqa: E402
from qmann_tpu.models import maxout as jmaxout  # noqa: E402
from qmann_tpu.models import memn2n as jmodel  # noqa: E402
from qmann_tpu.numerics import fixed as jfixed  # noqa: E402
from qmann_tpu.ops import attention as jatt  # noqa: E402
from qmann_tpu.ops import elementwise as jel  # noqa: E402
from qmann_tpu.ops import losses as jlosses  # noqa: E402
from qmann_tpu.ops.qlinear import qscore as j_qscore  # noqa: E402
from qmann_tpu.train import trainer as jtrainer  # noqa: E402
from qmann_tpu_torch.config import QmannConfig  # noqa: E402
from qmann_tpu_torch.data import babi  # noqa: E402
from qmann_tpu_torch.models import maxout as tmaxout  # noqa: E402
from qmann_tpu_torch.models import memn2n  # noqa: E402
from qmann_tpu_torch.numerics import QFormat  # noqa: E402
from qmann_tpu_torch.numerics import fixed as tfixed  # noqa: E402
from qmann_tpu_torch.ops import attention as tatt  # noqa: E402
from qmann_tpu_torch.ops import elementwise as tel  # noqa: E402
from qmann_tpu_torch.ops import losses as tlosses  # noqa: E402
from qmann_tpu_torch.ops.qlinear import qscore as t_qscore  # noqa: E402
from qmann_tpu_torch.train import trainer  # noqa: E402
from test_torch_train import (  # noqa: E402
    V, M, W, _one_batch_epoch, batch_arrays, jax_params,
)

# the packages' ops/__init__ export the function softmax over the module
jsm = importlib.import_module("qmann_tpu.ops.softmax")
tsm = importlib.import_module("qmann_tpu_torch.ops.softmax")

# the feature heads, in the order of tests/test_torch_slice.py
FEATURES = [dict(en_att_clip=True), dict(en_sc_att=True),
            dict(en_shift_based_sm=True), dict(en_exp_table_based=True),
            dict(en_cosine_sim=True), dict(test_maxout=True),
            dict(en_att_shift=True)]
FEATURE_IDS = ["clip", "sc_att", "shift_sm", "exp_plan", "cosine", "maxout",
               "att_shift"]


def normal(rng, *shape, sd=1.5):
    return rng.normal(0.0, sd, shape).astype(np.float32)


def t(x):
    return torch.from_numpy(np.asarray(x))


def jax_finite_batch(data, n, kw, dead):
    """The first n training samples with the last `dead` padded, where JAX
    is finite for the feature: exp_plan keeps no padded sample (JAX's 0/0),
    cosine keeps no zero memory row (JAX's NaN norm gradient): each dead
    row repeats a live row of its sample and every row is live."""
    if kw.get("en_exp_table_based") or kw.get("en_cosine_sim"):
        dead = 0
    mem, que, ans, mask, smask = batch_arrays(data, n, dead)
    if kw.get("en_cosine_sim"):
        for b in range(n):
            live = int(mask[b].sum())
            for r in range(live, mask.shape[1]):
                mem[b, r] = mem[b, r % live]
        mask[:] = True
    return mem, que, ans, mask, smask


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_fixed_macros_and_ste_match_jax(rng, mode):
    """fixed_mul / fixed_add / fixed_mac bit for bit; quantize_ste's
    forward bit for bit and its gradient the identity."""
    fa = (QFormat(2, 5, mode), jfixed.QFormat(2, 5, mode))
    fb = (QFormat(5, 2, mode), jfixed.QFormat(5, 2, mode))
    a, b, acc = normal(rng, 7, 9), normal(rng, 7, 9, sd=8.0), normal(rng, 9)
    for name in ("fixed_mul", "fixed_add"):
        got = getattr(tfixed, name)(t(a), t(b), fa[0], fb[0])
        want = getattr(jfixed, name)(a, b, fa[1], fb[1])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), name)
    np.testing.assert_array_equal(
        tfixed.fixed_mac(t(acc), t(a), t(b), fa[0], fb[0]).numpy(),
        np.asarray(jfixed.fixed_mac(acc, a, b, fa[1], fb[1])))
    x = torch.tensor(b, requires_grad=True)
    out = tfixed.quantize_ste(x, fb[0])
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(
        jfixed.quantize_ste(jnp.asarray(b), fb[1])))
    ct = normal(rng, 7, 9)
    (g,) = torch.autograd.grad((out * t(ct)).sum(), [x])
    jg = jax.grad(lambda v: jnp.sum(jfixed.quantize_ste(v, fb[1]) * ct))(
        jnp.asarray(b))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(g.numpy(), ct)


def test_qformat_from_wl_and_min_float_match_jax():
    for wl in (1, 8, 16, 32):
        for iwl in range(wl):
            for mode in (0, 3):
                got = tfixed.qformat_from_wl(iwl, wl, mode)
                assert tuple(got) == tuple(jfixed.qformat_from_wl(iwl, wl,
                                                                  mode))
                if got.frac >= 0:
                    assert tfixed.fixed_min_float(iwl, got.frac) == float(
                        jfixed.fixed_min_float(iwl, got.frac))
    assert tfixed.qformat_from_wl(5) == QFormat(5, 2, 3)


# ---------------------------------------------------------------------------
# score mitigations and the mode dispatch
# ---------------------------------------------------------------------------

def saturating(rng, B=4, M=10, D=60):
    """Raw score sums beyond the Q5.2 bound with distinct rows (the
    collapse regime of tests/test_score_mods.py)."""
    m = rng.normal(0, 1.2, (B, M, D)).astype(np.float32)
    u = (4.0 * np.abs(rng.normal(0, 1.0, (B, D)))).astype(np.float32)
    m[:, :6] = np.abs(m[:, :6]) * (1.0 + 0.2 * np.arange(6)[None, :, None])
    return m, u


@pytest.mark.parametrize("score_mod", ["none", "shift", "clip"])
@pytest.mark.parametrize("mode", [3, 0, 2])
def test_qscore_score_mod_forward_matches_jax(rng, score_mod, mode):
    """Bit for bit, in the saturating regime and on small scores."""
    fmt = QFormat(5, 2, mode)
    for m, u in (saturating(rng), (normal(rng, 3, 7, 9),
                                   normal(rng, 3, 9))):
        got = t_qscore(t(m), t(u), fmt, fmt, True, score_mod)
        want = j_qscore(jnp.asarray(m), jnp.asarray(u), jfixed.QFormat(*fmt),
                        jfixed.QFormat(*fmt), True, score_mod)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="score_mod"):
        t_qscore(t(m), t(u), fmt, fmt, True, "bogus")


@pytest.mark.parametrize("attention_mode", [1, 2, 3, 4])
def test_attention_score_passes_score_mod_to_mode_2_only(rng, attention_mode):
    """score_mod="shift" changes mode 2 only, as in JAX: modes 1, 3 and 4
    give their plain scores (bit for bit; mode 1 rtol 1e-6, a float sum
    in another order)."""
    m, u = saturating(rng, B=3, M=6, D=12)
    fa, fb = QFormat(1, 6), QFormat(5, 2)
    if attention_mode == 2:
        fa = fb
    jfa, jfb = jfixed.QFormat(*fa), jfixed.QFormat(*fb)
    got = {mod: tatt.attention_score(t(m), t(u), attention_mode, fa, fb,
                                     score_mod=mod).numpy()
           for mod in ("none", "shift")}
    want = jatt.attention_score(jnp.asarray(m), jnp.asarray(u),
                                attention_mode, jfa, jfb, score_mod="shift")
    if attention_mode == 1:
        np.testing.assert_allclose(got["shift"], np.asarray(want), rtol=1e-6)
    else:
        np.testing.assert_array_equal(got["shift"], np.asarray(want))
    assert np.array_equal(got["none"], got["shift"]) == (attention_mode != 2)


# ---------------------------------------------------------------------------
# softmax variants
# ---------------------------------------------------------------------------

SOFTMAX_VARIANTS = {
    "shift": (tsm.shift_softmax, lambda x, m: jsm.shift_softmax(x, m, 0)),
    "exp_plan": (tsm.exp_plan_softmax, jsm.exp_plan_softmax),
    "exp2": (tsm.exp2_softmax, jsm.exp2_softmax),
}


@pytest.mark.parametrize("variant", sorted(SOFTMAX_VARIANTS))
@pytest.mark.parametrize("masked", [True, False])
def test_softmax_variant_forward_matches_jax(rng, variant, masked):
    """rtol 1e-6, atol 1e-7 (exp, log2 and the sums by an ulp); every row
    keeps a live entry here (a row without one is pinned below).  The
    shift-based divisor takes totals near 1 (divisor 0 -> 1) and large
    ones."""
    tfn, jfn = SOFTMAX_VARIANTS[variant]
    x = normal(rng, 6, 9, sd=3.0)
    x[0] = 0.0                      # total 9: divisor round(log2 9) = 3
    x[1, 1:] = -40.0                # total ~1: divisor 0 -> 1
    mask = np.arange(9)[None, :] < rng.integers(1, 10, 6)[:, None]
    mask[:2] = True
    tm, jm = (t(mask), jnp.asarray(mask)) if masked else (None, None)
    got = tfn(t(x), tm)
    want = np.asarray(jfn(jnp.asarray(x), jm))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    if masked:
        assert (got.numpy()[~mask] == 0).all()


def test_exp_plan_matches_jax(rng):
    """The piecewise-linear exp, over all four segments: bit for bit."""
    x = np.concatenate([normal(rng, 200, sd=4.0),
                        np.float32([0.0, -1.0, -10.0, -1e30])])
    np.testing.assert_array_equal(tsm.exp_plan(t(x)).numpy(),
                                  np.asarray(jsm.exp_plan(jnp.asarray(x))))


@pytest.mark.parametrize("kw", [dict(), dict(shift_based=True),
                                dict(use_exp_plan=True), dict(remove=True),
                                dict(remove=True, shift_based=True)])
def test_apply_softmax_matches_jax(rng, kw):
    """The dispatch, remove (linear start: the masked scores pass through,
    padded rows zeroed) bit for bit, the others rtol 1e-6, atol 1e-7."""
    x = normal(rng, 5, 8, sd=3.0)
    mask = np.arange(8)[None, :] < rng.integers(1, 9, 5)[:, None]
    got = tsm.apply_softmax(t(x), t(mask), **kw).numpy()
    want = np.asarray(jsm.apply_softmax(jnp.asarray(x), jnp.asarray(mask),
                                        **kw))
    if kw.get("remove"):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.where(mask, x, 0.0))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert tsm.apply_softmax(t(x), None, remove=True).numpy() is not None


# ---------------------------------------------------------------------------
# element-wise ops, maxout attention, squared error
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantized", [True, False])
def test_scale_and_qmult_forward_match_jax(rng, quantized):
    """Bit for bit."""
    a, b = normal(rng, 4, 7), normal(rng, 4, 7, sd=6.0)
    w = np.float32(1.75)
    np.testing.assert_array_equal(
        tel.scale_apply(torch.tensor(w), t(a)).numpy(),
        np.asarray(jel.scale_apply(jnp.float32(w), jnp.asarray(a))))
    fmt = QFormat(2, 5)
    np.testing.assert_array_equal(
        tel.qmult(t(a), t(b), fmt, quantized).numpy(),
        np.asarray(jel.qmult(jnp.asarray(a), jnp.asarray(b),
                             jfixed.QFormat(*fmt), quantized)))


def test_maxout_and_maxout_attention_forward_match_jax(rng):
    """maxout over feature groups (ties included) and the maxout attention
    with padded rows and a padded sample, bit for bit; its hand-checked
    values as JAX's tests/test_aux.py."""
    x = normal(rng, 3, 4, 15)
    x[0, 0, :5] = 2.0                                  # a five-way tie
    np.testing.assert_array_equal(tel.maxout(t(x), 5).numpy(),
                                  np.asarray(jel.maxout(jnp.asarray(x), 5)))
    with pytest.raises(ValueError, match="divisible"):
        tel.maxout(t(x), 4)
    w, b = normal(rng, 5, sd=0.5), normal(rng, 5, sd=0.5)
    scores = normal(rng, 6, 8, sd=2.0)
    mask = np.arange(8)[None, :] < rng.integers(1, 9, 6)[:, None]
    mask[-1] = False
    np.testing.assert_array_equal(
        tmaxout.maxout_unit(t(scores), t(w), t(b)).numpy(),
        np.asarray(jmaxout.maxout_unit(jnp.asarray(scores), jnp.asarray(w),
                                       jnp.asarray(b))))
    got = tmaxout.maxout_attention(t(scores), t(w), t(b), t(mask)).numpy()
    want = np.asarray(jmaxout.maxout_attention(
        jnp.asarray(scores), jnp.asarray(w), jnp.asarray(b),
        jnp.asarray(mask)))
    np.testing.assert_array_equal(got, want)
    assert (got[-1] == 0).all()
    p = tmaxout.maxout_attention(torch.tensor([[1.0, 2.0, 3.0]]),
                                 torch.tensor([1.0, -1.0]),
                                 torch.tensor([0.0, 0.5]),
                                 torch.tensor([[True, True, False]]))
    np.testing.assert_allclose(p.numpy(), [[1 / 3, 2 / 3, 0.0]], rtol=1e-6)
    pw, pb = tmaxout.init_maxout_params(torch.Generator().manual_seed(0))
    assert pw.shape == pb.shape == (5,) and not torch.equal(pw, pb)


def test_squared_error_matches_jax(rng):
    """The cost rtol 1e-6 (a float sum); the gradient h - y, as jax.grad,
    bit for bit."""
    h, y = normal(rng, 9), normal(rng, 9)
    ht = torch.tensor(h, requires_grad=True)
    cost = tlosses.squared_error(ht, t(y))
    want = jlosses.squared_error(jnp.asarray(h), jnp.asarray(y))
    np.testing.assert_allclose(float(cost.detach()), float(want), rtol=1e-6)
    (g,) = torch.autograd.grad(cost, [ht])
    np.testing.assert_array_equal(g.numpy(), np.asarray(jax.grad(
        lambda a: jlosses.squared_error(a, jnp.asarray(y)))(jnp.asarray(h))))


# ---------------------------------------------------------------------------
# the model's feature heads and linear start
# ---------------------------------------------------------------------------

def _jax_loss_grads(pj, arrays, jcfg, remove_softmax=False):
    """jax.grad of JAX's loss_and_metrics, compiled once (its eager op by
    op dispatch takes seconds)."""
    def jloss(p, arrays):
        return jmodel.loss_and_metrics(p, *arrays, jcfg, remove_softmax)
    return jax.jit(jax.grad(jloss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in pj.items()},
        tuple(jnp.asarray(a) for a in arrays))


def _assert_grads(got, want, names):
    for k, g in zip(names, got):
        g, w = g.numpy(), np.asarray(want[k])
        assert np.isfinite(w).all(), k
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=4e-6 * np.abs(w).max(), err_msg=k)
        assert np.isfinite(g).all(), k


@pytest.mark.parametrize("kw", FEATURES + [dict(remove_softmax=True)],
                         ids=FEATURE_IDS + ["linear_start"])
def test_feature_forward_and_gradients_match_jax(kw):
    """loss_and_metrics' forward and d(loss)/d(params) with a sample mask,
    on the plain and use_pallas routes of the port, against JAX (forward
    on its use_pallas route in interpret mode, gradients by jax.grad on
    its plain route)."""
    from jax.experimental.pallas import tpu as pltpu
    kw = dict(kw)
    remove = kw.pop("remove_softmax", False)
    cfg_kw = dict(dim_emb=8, num_hops=2, verbose=False, **kw)
    data = babi.synthetic_task(np.random.default_rng(8), 20, 1, 1, V, M, W)
    arrays = jax_finite_batch(data, 20, kw, dead=3)
    pj = jax_params(cfg_kw, data.dims, seed=8)
    want, jmet = _jax_loss_grads(pj, arrays, JaxConfig(**cfg_kw), remove)
    with pltpu.force_tpu_interpret_mode():
        jout = jmodel.forward({k: jnp.asarray(v) for k, v in pj.items()},
                              *(jnp.asarray(a) for a in (arrays[0], arrays[1],
                                                         arrays[3])),
                              JaxConfig(use_pallas=True, **cfg_kw), remove)
    for use_pallas in (False, True):
        tcfg = QmannConfig(use_pallas=use_pallas, **cfg_kw)
        pt = memn2n.params_from_jax(pj, tcfg, device="cpu")
        out = memn2n.forward(pt, t(arrays[0]), t(arrays[1]), t(arrays[3]),
                             tcfg, remove)
        np.testing.assert_allclose(out.logits.numpy(),
                                   np.asarray(jout.logits), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(out.scores[0].numpy(),
                                      np.asarray(jout.scores[0]))
        leaves = [pt[k].requires_grad_() for k in pt]
        loss, met = memn2n.loss_and_metrics(pt, *(t(a) for a in arrays),
                                            tcfg, remove)
        got = torch.autograd.grad(loss, leaves, allow_unused=True)
        got = [torch.zeros_like(p) if g is None else g
               for p, g in zip(leaves, got)]
        np.testing.assert_allclose(float(met.cost), float(jmet.cost),
                                   rtol=1e-5)
        assert int(met.matches) == int(jmet.matches)
        np.testing.assert_array_equal(met.pred.numpy(),
                                      np.asarray(jmet.pred))
        _assert_grads(got, want, list(pt))
    if "en_sc_att" in kw:
        # the scale is reached with the softmax, and not during linear start
        assert np.abs(np.asarray(want["scale"])).max() > 0


@pytest.mark.parametrize("kw", FEATURES, ids=FEATURE_IDS)
def test_feature_sgd_step_matches_jax_train_epoch(kw):
    """A one-batch epoch through JAX's train_epoch and the port's, on both
    routes: a partial batch (13 live samples of 16) where JAX is finite,
    else a full one."""
    cfg_kw = dict(dim_emb=8, num_hops=2, size_batch=16, verbose=False, **kw)
    data = babi.synthetic_task(np.random.default_rng(9), 16, 1, 1, V, M, W)
    n = 16 if (kw.get("en_exp_table_based") or kw.get("en_cosine_sim")) \
        else 13
    batches = _one_batch_epoch(data, n, 0, 16)
    if kw.get("en_cosine_sim"):
        mem, _, _, mask, _ = jax_finite_batch(data, 16, kw, 0)
        batches["memory"], batches["mask"] = mem[None], mask[None]
    pj = jax_params(cfg_kw, data.dims, seed=9)
    jp, jcost, jmatch = jtrainer.train_epoch(
        {k: jnp.asarray(v) for k, v in pj.items()},
        {k: jnp.asarray(v) for k, v in batches.items()}, jnp.float32(0.3),
        JaxConfig(**cfg_kw))
    for use_pallas in (False, True):
        tcfg = QmannConfig(use_pallas=use_pallas, **cfg_kw)
        tp, tcost, tmatch = trainer.train_epoch(
            memn2n.params_from_jax(pj, tcfg, device="cpu"),
            {k: t(v) for k, v in batches.items()}, torch.tensor(0.3), tcfg)
        np.testing.assert_allclose(float(tcost), float(jcost), rtol=1e-5)
        assert int(tmatch) == int(jmatch)
        for k in pj:
            assert np.isfinite(np.asarray(jp[k])).all(), k
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
            assert not np.array_equal(tp[k].numpy(), pj[k]), k


def test_linear_start_step_with_scale_matches_jax_train_epoch():
    """A linear-start epoch (softmax removed) with EN_SC_ATT on: no
    gradient reaches the scale, which gets zeros as under jax.grad, so it
    moves by the weight-decay term alone; both routes against JAX's
    train_epoch(remove_softmax=True)."""
    cfg_kw = dict(dim_emb=8, num_hops=2, size_batch=16, verbose=False,
                  en_sc_att=True, lambda_=0.01)
    data = babi.synthetic_task(np.random.default_rng(13), 16, 1, 1, V, M, W)
    batches = _one_batch_epoch(data, 13, 0, 16)
    pj = jax_params(cfg_kw, data.dims, seed=13)
    jp, jcost, _ = jtrainer.train_epoch(
        {k: jnp.asarray(v) for k, v in pj.items()},
        {k: jnp.asarray(v) for k, v in batches.items()}, jnp.float32(0.3),
        JaxConfig(**cfg_kw), True)
    for use_pallas in (False, True):
        tcfg = QmannConfig(use_pallas=use_pallas, **cfg_kw)
        tp, tcost, _ = trainer.train_epoch(
            memn2n.params_from_jax(pj, tcfg, device="cpu"),
            {k: t(v) for k, v in batches.items()}, torch.tensor(0.3), tcfg,
            True)
        np.testing.assert_allclose(float(tcost), float(jcost), rtol=1e-5)
        for k in pj:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(
            tp["scale"].numpy(), pj["scale"] * np.float32(1 + 0.3 * 0.01),
            rtol=1e-6)


# ---------------------------------------------------------------------------
# the two JAX defects: the port's deliberate values
# ---------------------------------------------------------------------------

def test_jax_nan_pinned_exp_plan_on_a_padded_sample(rng):
    """JAX's exp_plan_softmax and exp2_softmax lack the guard that its
    softmax and shift_softmax carry for a row with no live entry: a padded
    sample of the last partial batch gets 0/0 = NaN probabilities, and
    loss_and_metrics with en_exp_table_based on a batch holding one gives
    loss NaN and NaN gradients.  The port gives that row probability 0, as
    the guard intends, and a finite loss equal to JAX's on the live
    samples alone."""
    x = normal(rng, 4, 6)
    mask = np.ones((4, 6), bool)
    mask[-1] = False
    for tfn, jfn in ((tsm.exp_plan_softmax, jsm.exp_plan_softmax),
                     (tsm.exp2_softmax, jsm.exp2_softmax)):
        want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(mask)))
        assert np.isnan(want[-1]).all() and np.isfinite(want[:-1]).all()
        got = tfn(t(x), t(mask)).numpy()
        assert (got[-1] == 0).all()
        np.testing.assert_allclose(got[:-1], want[:-1], rtol=1e-6, atol=1e-7)

    cfg_kw = dict(dim_emb=8, num_hops=2, verbose=False,
                  en_exp_table_based=True)
    data = babi.synthetic_task(np.random.default_rng(10), 12, 1, 1, V, M, W)
    arrays = batch_arrays(data, 12, dead=1)
    pj = jax_params(cfg_kw, data.dims, seed=10)
    jgrads, jmet = _jax_loss_grads(pj, arrays, JaxConfig(**cfg_kw))
    assert np.isnan(float(jmet.loss))
    assert all(np.isnan(np.asarray(g)).any() for g in jgrads.values())
    live = tuple(a[:-1] for a in arrays)
    jlive, jmet_live = _jax_loss_grads(pj, live, JaxConfig(**cfg_kw))
    tcfg = QmannConfig(**cfg_kw)
    pt = memn2n.params_from_jax(pj, tcfg, device="cpu")
    leaves = [pt[k].requires_grad_() for k in pt]
    loss, met = memn2n.loss_and_metrics(pt, *(t(a) for a in arrays), tcfg)
    got = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jmet_live.loss),
                               rtol=1e-5)
    _assert_grads(got, jlive, list(pt))


def test_jax_nan_pinned_cosine_on_a_padded_memory_row():
    """JAX's en_cosine_sim normalises with jnp.linalg.norm, whose gradient
    at a zero row is sqrt'(0) * 0 = NaN, and a padded memory row is always
    zero: with x4 weights one padded row gives NaN in the gradient of A
    (the forward is finite).  The port takes the norm's subgradient 0 at 0
    (what the 1e-12 floor means, and PyTorch's vector_norm backward):
    finite gradients, equal to JAX's on the weights NaN does not reach."""
    cfg_kw = dict(dim_emb=8, num_hops=2, verbose=False, en_cosine_sim=True)
    data = babi.synthetic_task(np.random.default_rng(11), 12, 1, 1, V, M, W)
    arrays = batch_arrays(data, 12, dead=0)
    assert not arrays[3].all()                 # padded memory rows
    pj = jax_params(cfg_kw, data.dims, seed=11)
    jgrads, jmet = _jax_loss_grads(pj, arrays, JaxConfig(**cfg_kw))
    assert np.isfinite(float(jmet.loss))
    assert np.isnan(np.asarray(jgrads["A"])).any()
    tcfg = QmannConfig(**cfg_kw)
    pt = memn2n.params_from_jax(pj, tcfg, device="cpu")
    leaves = [pt[k].requires_grad_() for k in pt]
    loss, met = memn2n.loss_and_metrics(pt, *(t(a) for a in arrays), tcfg)
    got = dict(zip(pt, torch.autograd.grad(loss, leaves)))
    np.testing.assert_allclose(float(loss.detach()), float(jmet.loss),
                               rtol=1e-5)
    for k, g in got.items():
        assert np.isfinite(g.numpy()).all(), k
        w = np.asarray(jgrads[k])
        if np.isfinite(w).all():
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                       atol=4e-6 * np.abs(w).max(),
                                       err_msg=k)
    assert np.abs(got["A"].numpy()).max() > 0
