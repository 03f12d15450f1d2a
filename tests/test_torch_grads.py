"""Every autograd.Function of the port against jax.grad of the JAX op on the
same numpy inputs, both EN_GRAD_QUANT branches where the op has them; the
feature heads' ops (the score mods, the partial sums, the softmax variants,
the scale, qmult, maxout and the maxout attention) too.

The loss is sum(out * ct) with a seeded random cotangent per output.
Tolerance: rtol 1e-5, atol 1e-6 on every gradient, because the float sums
of the backward products run in another order than XLA's.  Every gradient
must also be non-zero somewhere: left as plain torch code, an op would pass
zero gradients through float_quant's trunc/round.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qmann_tpu.numerics import QFormat as JQ  # noqa: E402
from qmann_tpu.ops import elementwise as jel  # noqa: E402
from qmann_tpu.ops import losses as jlosses  # noqa: E402
from qmann_tpu.ops import qlinear as jq  # noqa: E402
from qmann_tpu.ops.softmax import softmax as j_softmax  # noqa: E402
from qmann_tpu.ops.fused import fused_attention_read as j_fused  # noqa: E402
from qmann_tpu.models import maxout as jmaxout  # noqa: E402
from qmann_tpu_torch.numerics import QFormat  # noqa: E402
from qmann_tpu_torch.ops import elementwise as tel  # noqa: E402
from qmann_tpu_torch.ops import losses as tlosses  # noqa: E402
from qmann_tpu_torch.ops import qlinear as tq  # noqa: E402
from qmann_tpu_torch.ops.softmax import softmax as t_softmax  # noqa: E402
from qmann_tpu_torch.ops.fused import fused_attention_read  # noqa: E402
from qmann_tpu_torch.models import maxout as tmaxout  # noqa: E402
import importlib  # noqa: E402

# the packages' ops/__init__ export the function softmax over the module
jsm = importlib.import_module("qmann_tpu.ops.softmax")
tsm = importlib.import_module("qmann_tpu_torch.ops.softmax")


def check_grads(rng, jfn, tfn, inputs, argnums, used=None):
    """jax.grad and torch autograd of sum_k sum(out_k * ct_k) over the
    outputs in ``used`` (all by default) agree, and are non-zero."""
    jin = [jnp.asarray(x) for x in inputs]
    jout = jfn(*jin)
    single = not isinstance(jout, tuple)
    jout = (jout,) if single else jout
    used = range(len(jout)) if used is None else used
    cts = {k: rng.normal(0.0, 1.0, np.shape(jout[k])).astype(np.float32)
           for k in used}

    def jloss(*a):
        out = jfn(*a)
        out = (out,) if single else out
        return sum(jnp.sum(out[k] * cts[k]) for k in used)

    want = jax.grad(jloss, argnums=tuple(argnums))(*jin)
    tin = [torch.tensor(x, requires_grad=i in argnums)
           for i, x in enumerate(inputs)]
    out = tfn(*tin)
    out = (out,) if single else out
    loss = sum((out[k] * torch.from_numpy(cts[k])).sum() for k in used)
    got = torch.autograd.grad(loss, [tin[i] for i in argnums])
    for i, g, w in zip(argnums, got, want):
        g, w = g.numpy(), np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                   err_msg=f"gradient of input {i}")
        assert np.abs(g).max() > 0, f"gradient of input {i} is zero"
        assert np.isfinite(g).all()


def normal(rng, *shape, sd=1.5):
    return rng.normal(0.0, sd, shape).astype(np.float32)


def live_mask(rng, B, M, dead=1):
    mask = np.arange(M)[None, :] < rng.integers(1, M + 1, B)[:, None]
    mask[B - dead:] = False     # padded samples: no live row
    return mask


@pytest.mark.parametrize("quantized,fw", [(True, (5, 2)), (True, (0, 0)),
                                          (False, (8, 7))])
@pytest.mark.parametrize("backend", ["plain", "kernel"])
def test_qmatvec_grads(rng, quantized, fw, backend):
    fx = (2, 5)
    check_grads(
        rng,
        lambda w, x: jq.qmatvec(w, x, JQ(*fw), JQ(*fx), quantized),
        lambda w, x: tq.qmatvec(w, x, QFormat(*fw), QFormat(*fx), quantized,
                                backend=backend),
        [normal(rng, 7, 11), normal(rng, 3, 4, 11)], (0, 1))


@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("backend", ["plain", "kernel"])
def test_qembed_mat_grads(rng, quantized, backend):
    fmt = (5, 2)
    check_grads(
        rng,
        lambda s, a: jq.qembed_mat(s, a, JQ(*fmt), quantized),
        lambda s, a: tq.qembed_mat(s, a, QFormat(*fmt), quantized,
                                   backend=backend),
        [normal(rng, 3, 5, 9), normal(rng, 6, 9)], (0, 1))


@pytest.mark.parametrize("backend", ["plain", "kernel"])
def test_qembed_mat_multi_grads_with_shared_weights(rng, backend):
    """Layer-wise tying: A and C each fill several slots (EN_MQ formats);
    the slots' gradients sum, and one slot's output is left unused."""
    fmts = [(6, 1), (5, 2), (4, 3)] * 2

    def jfn(s, a, c):
        return jq.qembed_mat_multi(s, (a, a, a, c, c, c),
                                   tuple(JQ(*f) for f in fmts))

    def tfn(s, a, c):
        return tq.qembed_mat_multi(s, [a, a, a, c, c, c],
                                   [QFormat(*f) for f in fmts],
                                   backend=backend)

    check_grads(rng, jfn, tfn,
                [normal(rng, 3, 5, 9), normal(rng, 6, 9), normal(rng, 6, 9)],
                (0, 1, 2), used=(0, 1, 3, 5))


@pytest.mark.parametrize("quantized,grad_quantized",
                         [(True, False), (True, True), (False, False),
                          (False, True)])
def test_qscore_grads(rng, quantized, grad_quantized):
    fm, fu = (5, 2), (5, 2)
    check_grads(
        rng,
        lambda m, u: jq.qscore(m, u, JQ(*fm), JQ(*fu), quantized, "none",
                               grad_quantized),
        lambda m, u: tq.qscore(m, u, QFormat(*fm), QFormat(*fu), quantized,
                               grad_quantized=grad_quantized),
        [normal(rng, 4, 6, 8), normal(rng, 4, 8)], (0, 1))


@pytest.mark.parametrize("quantized,grad_quantized",
                         [(True, False), (True, True), (False, False)])
def test_qweighted_sum_grads(rng, quantized, grad_quantized):
    fmt = (2, 5)
    mask = live_mask(rng, 4, 6).astype(np.float32)
    p = rng.dirichlet(np.ones(6), 4).astype(np.float32) * mask
    check_grads(
        rng,
        lambda c, p_: jq.qweighted_sum(c, p_, jnp.asarray(mask), JQ(*fmt),
                                       quantized, grad_quantized),
        lambda c, p_: tq.qweighted_sum(c, p_, torch.from_numpy(mask),
                                       QFormat(*fmt), quantized,
                                       grad_quantized),
        [normal(rng, 4, 6, 8), p], (0, 1))


@pytest.mark.parametrize("quantized", [True, False])
def test_qsum_grads(rng, quantized):
    fmt = (5, 2)
    check_grads(rng,
                lambda a, b: jel.qsum(a, b, JQ(*fmt), quantized),
                lambda a, b: tel.qsum(a, b, QFormat(*fmt), quantized),
                [normal(rng, 4, 8), normal(rng, 4, 8)], (0, 1))


@pytest.mark.parametrize("kind", ["RELU", "SIGMOID", "NULL"])
@pytest.mark.parametrize("grad_quantized", [False, True])
def test_activation_grads(rng, kind, grad_quantized):
    fmt = (2, 5)
    check_grads(
        rng,
        lambda x: jel.activation(x, kind, JQ(*fmt), True, grad_quantized),
        lambda x: tel.activation(x, kind, QFormat(*fmt), True,
                                 grad_quantized),
        [normal(rng, 5, 8)], (0,))


def test_masked_softmax_grads_nan_free(rng):
    """A row with no live entry (a padded sample) gets p = 0 and a zero
    gradient, never NaN."""
    mask = live_mask(rng, 6, 7, dead=2)
    check_grads(rng,
                lambda x: j_softmax(x, jnp.asarray(mask)),
                lambda x: t_softmax(x, torch.from_numpy(mask)),
                [normal(rng, 6, 7)], (0,))
    x = torch.tensor(normal(rng, 6, 7), requires_grad=True)
    p = t_softmax(x, torch.from_numpy(mask))
    (g,) = torch.autograd.grad((p * torch.arange(7.0)).sum(), [x])
    assert (p[-2:] == 0).all() and (g[-2:] == 0).all()


def test_cross_entropy_loss_grads(rng):
    ans = np.zeros((6, 9), np.float32)
    ans[np.arange(6), rng.integers(0, 9, 6)] = 1.0
    check_grads(rng,
                lambda z: jlosses.cross_entropy(z, jnp.asarray(ans)).loss,
                lambda z: tlosses.cross_entropy(z, torch.from_numpy(ans)).loss,
                [normal(rng, 6, 9)], (0,))


@pytest.mark.parametrize("mode,sum_gq,used", [(2, False, None),
                                              (2, True, None),
                                              (2, False, (0,)),
                                              (1, False, None),
                                              (1, False, (0, 2))])
def test_fused_attention_read_grads(rng, mode, sum_gq, used):
    """Against JAX's fused op (the Pallas kernel in interpret mode, its
    composed VJP): the cotangents of p and the scores may be absent (then
    torch hands the backward None), and samples may have no live row."""
    q = mode == 2
    fmt = (5, 2) if q else (2, 5)
    sd = 1.5 if q else 0.5
    B, M, D = 5, 6, 8
    mask_f = live_mask(rng, B, M).astype(np.float32)

    def jfn(m, c, u):
        return j_fused(m, c, u, jnp.asarray(mask_f), JQ(*fmt), JQ(*fmt),
                       JQ(*fmt), score_quantized=q, sum_quantized=q,
                       interpret=True, attention_mode=mode,
                       sum_grad_quantized=sum_gq)

    def tfn(m, c, u):
        return fused_attention_read(m, c, u, torch.from_numpy(mask_f),
                                    QFormat(*fmt), QFormat(*fmt),
                                    QFormat(*fmt), score_quantized=q,
                                    sum_quantized=q, attention_mode=mode,
                                    sum_grad_quantized=sum_gq)

    check_grads(rng, jfn, tfn,
                [normal(rng, B, M, D, sd=sd), normal(rng, B, M, D, sd=sd),
                 normal(rng, B, D, sd=sd)], (0, 1, 2), used=used)


@pytest.mark.parametrize("score_mod", ["shift", "clip"])
def test_qscore_score_mod_grads(rng, score_mod):
    """The score mods change only the forward: against jax.grad, and equal
    to the port's own "none" gradients bit for bit.  Scores past the Q5.2
    bound, where clip and shift act."""
    fm = (5, 2)
    m, u = normal(rng, 4, 6, 8, sd=3.0), normal(rng, 4, 8, sd=3.0)
    check_grads(
        rng,
        lambda m_, u_: jq.qscore(m_, u_, JQ(*fm), JQ(*fm), True, score_mod),
        lambda m_, u_: tq.qscore(m_, u_, QFormat(*fm), QFormat(*fm), True,
                                 score_mod),
        [m, u], (0, 1))
    ct = torch.from_numpy(normal(rng, 4, 6))
    grads = []
    for mod in ("none", score_mod):
        mt, ut = (torch.tensor(a, requires_grad=True) for a in (m, u))
        out = tq.qscore(mt, ut, QFormat(*fm), QFormat(*fm), True, mod)
        grads.append(torch.autograd.grad((out * ct).sum(), [mt, ut]))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("quantized,grad_quantized",
                         [(True, False), (True, True), (False, False)])
def test_partial_sum_grads(rng, quantized, grad_quantized):
    """qscore_partial_sum and qweighted_partial_sum: forwards bit for bit
    (quantized; float rtol 1e-6) and gradients against jax.grad."""
    fmt = (5, 2) if quantized else (2, 5)
    fmt_c = (2, 5)       # p in [0, 1] quantizes to 0 at Q5.2
    m, u = normal(rng, 4, 6, 8), normal(rng, 4, 8)
    mask = live_mask(rng, 4, 6).astype(np.float32)
    p = rng.dirichlet(np.ones(6), 4).astype(np.float32) * mask
    pairs = [
        (lambda m_, u_: jq.qscore_partial_sum(m_, u_, JQ(*fmt), JQ(*fmt),
                                              quantized),
         lambda m_, u_: tq.qscore_partial_sum(m_, u_, QFormat(*fmt),
                                              QFormat(*fmt), quantized),
         [m, u]),
        (lambda c, p_: jq.qweighted_partial_sum(
            c, p_, jnp.asarray(mask), JQ(*fmt_c), quantized, grad_quantized),
         lambda c, p_: tq.qweighted_partial_sum(
             c, p_, torch.from_numpy(mask), QFormat(*fmt_c), quantized,
             grad_quantized),
         [m, p])]
    for jfn, tfn, inputs in pairs:
        want = np.asarray(jfn(*(jnp.asarray(a) for a in inputs)))
        got = tfn(*(torch.from_numpy(a) for a in inputs)).numpy()
        if quantized:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        if grad_quantized and jfn is pairs[0][0]:
            continue        # the score's partial sum has no such branch
        check_grads(rng, jfn, tfn, inputs, (0, 1))


@pytest.mark.parametrize("variant", ["shift", "exp_plan", "exp2", "remove"])
def test_softmax_variant_grads(rng, variant):
    """The shift-based softmax's 0.7-scaled backward, exp_plan and exp2 as
    compositions, and the linear-start pass-through, against jax.grad.
    exp_plan and exp2 get a live entry in every row (JAX gives a row
    without one NaN, tests/test_torch_features.py); the others a padded
    sample as well."""
    dead = 0 if variant in ("exp_plan", "exp2") else 1
    mask = live_mask(rng, 6, 7, dead=dead) if dead else \
        np.arange(7)[None, :] < rng.integers(1, 8, 6)[:, None]
    fns = {"shift": (lambda x, m: jsm.shift_softmax(x, m, 0),
                     tsm.shift_softmax),
           "exp_plan": (jsm.exp_plan_softmax, tsm.exp_plan_softmax),
           "exp2": (jsm.exp2_softmax, tsm.exp2_softmax),
           "remove": (lambda x, m: jsm.apply_softmax(x, m, remove=True),
                      lambda x, m: tsm.apply_softmax(x, m, remove=True))}
    jfn, tfn = fns[variant]
    check_grads(rng, lambda x: jfn(x, jnp.asarray(mask)),
                lambda x: tfn(x, torch.from_numpy(mask)),
                [normal(rng, 6, 7)], (0,))


@pytest.mark.parametrize("quantized", [True, False])
def test_scale_and_qmult_grads(rng, quantized):
    """scale_apply's plain autodiff (dw = sum(g x), dx = w g) and qmult's
    float cross-gradients on the raw inputs."""
    check_grads(rng, jel.scale_apply, tel.scale_apply,
                [np.float32(1.25), normal(rng, 4, 6)], (0, 1))
    fmt = (2, 5)
    check_grads(rng,
                lambda a, b: jel.qmult(a, b, JQ(*fmt), quantized),
                lambda a, b: tel.qmult(a, b, QFormat(*fmt), quantized),
                [normal(rng, 4, 6), normal(rng, 4, 6)], (0, 1))


def test_maxout_grads_split_between_ties(rng):
    """maxout and the maxout attention: amax splits the gradient between
    tied maxima as JAX's max does (a max(dim) would route it to one)."""
    x = normal(rng, 3, 10)
    x[0, :5] = 1.0                                   # a five-way tie
    x[1, 5:7] = 2.0                                  # a two-way tie
    check_grads(rng, lambda a: jel.maxout(a, 5),
                lambda a: tel.maxout(a, 5), [x], (0,))
    mask = live_mask(rng, 5, 6)
    check_grads(rng,
                lambda s, w, b: jmaxout.maxout_attention(s, w, b,
                                                         jnp.asarray(mask)),
                lambda s, w, b: tmaxout.maxout_attention(
                    s, w, b, torch.from_numpy(mask)),
                [normal(rng, 5, 6, sd=2.0), normal(rng, 5, sd=0.5),
                 np.abs(normal(rng, 5, sd=0.5)) + 0.5], (0, 1, 2))
