"""The weighted sum's quantized backward kernel (csrc/qweighted_sum_bwd.cu)
on the CPU:

(a) the plain version (ops.qlinear.qweighted_sum_backward with
    grad_quantized) against the JAX package's _qweighted_sum_bwd, the
    branch XLA fuses: 8-bit words at iwl 0, 1 and 5 in every rounding
    mode, 16-bit words, the binary format; padded rows, negative products
    (a negative value on a padded row gives -0.0), zero upstream rows;
(b) the wrapper on CPU tensors: the plain version, no build, no launch
    counted, leading dims folded; formats, shapes, dtypes and devices it
    does not take raise on the CPU as on the card;
(c) the exactness argument the kernel's bit identity rests on: dp's
    products summed in float32 in ascending d, and in the kernel's order
    (32 lanes strided over d, then a butterfly of shuffles), equal
    torch's sum wherever sums_exact holds (8- and 16-bit words, D <= 256),
    and lie in dp_interval at 24- and 32-bit words, where they round;
(d) the routing: qweighted_sum and qweighted_partial_sum with
    backend="kernel" reach the wrapper in their quantized backward and
    equal JAX's forward and gradient; the mode-3 fused read's backward
    reaches it and matches jax.grad; one SGD step on the mode-3 use_pallas
    and use_pallas_hamming routes and on EN_GRAD_QUANT's unfused chain
    calls it once per hop and equals JAX's train_epoch.

The kernel against its plain version on the card is in
tests/test_torch_cuda.py.

Tolerances.  (a)-(c) and the weighted sum in (d): bit for bit, compared as
int32 views so that the sign of a zero counts (every sum there is exact).
The fused read and the SGD steps in (d): rtol 1e-5, atol 1e-6, as
tests/test_torch_hamming_bwd.py and tests/test_torch_mode3.py (the softmax
and the other backwards sum in another order than XLA).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qmann_tpu import numerics as jnum  # noqa: E402
from qmann_tpu.config import QmannConfig as JaxConfig  # noqa: E402
from qmann_tpu.ops import qlinear as jql  # noqa: E402
from qmann_tpu.ops.fused import fused_attention_read as j_fused  # noqa: E402
from qmann_tpu.train import trainer as jtrainer  # noqa: E402
from qmann_tpu_torch.config import QmannConfig  # noqa: E402
from qmann_tpu_torch.data import babi  # noqa: E402
from qmann_tpu_torch.models import memn2n  # noqa: E402
from qmann_tpu_torch.numerics import (QFormat, fixed_max_float,  # noqa: E402
                                      float_quant)
from qmann_tpu_torch.ops import fused as tfused  # noqa: E402
from qmann_tpu_torch.ops import qlinear as tql  # noqa: E402
from qmann_tpu_torch.ops.cuda import _build  # noqa: E402
from qmann_tpu_torch.ops.cuda import qweighted_sum_bwd as wsb  # noqa: E402
from qmann_tpu_torch.train import trainer  # noqa: E402
from test_torch_train import (  # noqa: E402
    V, M, W, _one_batch_epoch, jax_params,
)

F32 = np.float32
# (iwl, frac, mode): 8-bit words at iwl 0, 1, 5 in every rounding mode,
# 16-bit words, the binary format
FORMATS = ([(iwl, 7 - iwl, mode) for iwl in (0, 1, 5) for mode in (3, 0, 1, 2)]
           + [(1, 14, mode) for mode in (3, 2)] + [(0, 0, 3), (0, 0, 0)])


@pytest.fixture(autouse=True)
def _one_thread():
    """Many tiny ops: one torch thread keeps them fast under the suite's
    worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(x):
    return np.asarray(x, F32).view(np.int32)


def _inputs(rng, fmt, lead=(), B=5, M=7, D=40):
    """c [..., B, M, D], p and mask [..., B, M], g [..., B, D] as numpy
    float32 around the format's range: sample 0 holds an edge list in c
    (+-0.0, +-the bound, beyond it, half a grid step, tiny values);
    sample 1's upstream row is zero; sample 2's products are all the
    largest negative ones; every sample has padded rows, some with a
    non-zero p (so that a negative value meets the mask's 0)."""
    iwl, frac = fmt[:2]
    top = F32(1.0) if iwl + frac == 0 else F32(fixed_max_float(iwl, frac))
    step = F32(2.0 ** -frac)
    c = rng.normal(0.0, 0.6 * top, lead + (B, M, D)).astype(F32)
    edge = np.array([0.0, -0.0, top, -top, 1.5 * top, -1.5 * top, step,
                     -step, 0.5 * step, -0.5 * step, 1e-7, -1e-7, 3e38,
                     -3e38], F32)
    c[..., 0, 0, :len(edge)] = edge
    p = rng.uniform(0.0, 1.0, lead + (B, M)).astype(F32)
    p[..., 0, :2] = 0.0
    g = rng.normal(0.0, 0.6 * top, lead + (B, D)).astype(F32)
    g[..., 0, :3] = [-0.0, 1e-9, -1e-9]
    g[..., 1, :] = 0.0
    c[..., 2, :, :] = top
    g[..., 2, :] = -top
    n_live = rng.integers(1, M, lead + (B, 1))
    mask = (np.arange(M) < n_live).astype(F32)
    return c, p, mask, g


def _torch(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.mark.parametrize("fmt", FORMATS)
def test_plain_version_equals_jax(rng, fmt):
    """(a) dc and dp bit for bit against JAX's quantized branch."""
    c, p, mask, g = _inputs(rng, fmt)
    want_dc, want_dp, _ = jql._qweighted_sum_bwd(
        jnum.QFormat(*fmt), True, True,
        (jnp.asarray(c), jnp.asarray(p), jnp.asarray(mask)), jnp.asarray(g))
    dc, dp = tql.qweighted_sum_backward(*_torch(c, p, mask), *_torch(g),
                                        QFormat(*fmt), grad_quantized=True)
    np.testing.assert_array_equal(_bits(dc.numpy()), _bits(want_dc))
    np.testing.assert_array_equal(_bits(dp.numpy()), _bits(want_dp))
    neg_zero = (dc.numpy() == 0) & np.signbit(dc.numpy())
    assert neg_zero.any() and (dc.numpy() != 0).any()


@pytest.mark.parametrize("lead", [(), (3,)])
def test_wrapper_on_cpu_is_the_plain_version(rng, monkeypatch, lead):
    """(b) On CPU tensors the wrapper never builds or loads the kernel,
    counts no launch, and equals the plain version at [B, M, D] and at a
    family's [R, B, M, D]."""
    def no_build(*_):
        raise AssertionError("the CPU path must not touch the CUDA build")
    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(wsb, "load_library", no_build)
    fmt = QFormat(1, 6, 3)
    c, p, mask, g = _torch(*_inputs(rng, fmt, lead))
    before = wsb.qweighted_sum_backward_kernel.launches
    dc, dp = wsb.qweighted_sum_backward_kernel(c, p, mask, g, fmt)
    want_dc, want_dp = tql.qweighted_sum_backward(c, p, mask, g, fmt,
                                                  grad_quantized=True)
    assert dc.shape == c.shape and dp.shape == p.shape
    np.testing.assert_array_equal(_bits(dc), _bits(want_dc))
    np.testing.assert_array_equal(_bits(dp), _bits(want_dp))
    assert wsb.qweighted_sum_backward_kernel.launches == before


@pytest.mark.parametrize("fmt", [(1, 31, 3), (-1, 8, 3), (1, -1, 3),
                                 (1, 6, 4)])
def test_formats_out_of_range_raise(fmt):
    """(b) The formats make_qfmt refuses raise on the CPU too."""
    c, p, mask, g = (torch.zeros(s) for s in ((2, 3, 4), (2, 3), (2, 3),
                                              (2, 4)))
    with pytest.raises(ValueError, match="format"):
        wsb.qweighted_sum_backward_kernel(c, p, mask, g, QFormat(*fmt))


@pytest.mark.parametrize("shapes", [
    ((2, 65, 8), (2, 65), (2, 65), (2, 8)),
    ((2, 4, 257), (2, 4), (2, 4), (2, 257)),
    ((2, 4, 8), (2, 5), (2, 5), (2, 8)),
    ((2, 4, 8), (2, 4), (4,), (2, 8)),
    ((2, 4, 8), (2, 4), (2, 4), (2, 7)),
    ((3, 2, 4, 8), (3, 2, 4), (3, 2, 4), (2, 8)),
    ((0, 4, 8), (0, 4), (0, 4), (0, 8)),
    ((8,), (), (), (8,))])
def test_shapes_out_of_range_raise(shapes):
    """(b) M above 64, D above 256, operands that do not agree (a mask
    that would broadcast included) and an empty batch raise on the CPU as
    on the card, before any launch."""
    c, p, mask, g = (torch.zeros(s) for s in shapes)
    before = wsb.qweighted_sum_backward_kernel.launches
    with pytest.raises(ValueError, match="qweighted_sum_backward_kernel"):
        wsb.qweighted_sum_backward_kernel(c, p, mask, g, QFormat(1, 6))
    assert wsb.qweighted_sum_backward_kernel.launches == before


@pytest.mark.parametrize("which", range(4))
def test_dtypes_and_devices_raise(which):
    """(b) A float64 operand, operands on two devices and a device that
    is neither the CPU nor CUDA raise on the CPU too."""
    args = [torch.zeros(s) for s in ((2, 3, 4), (2, 3), (2, 3), (2, 4))]
    if which < 2:
        args[3 * which] = args[3 * which].double()
        err, match = TypeError, "float32"
    elif which == 2:
        args[1] = args[1].to("meta")
        err, match = ValueError, "different devices"
    else:
        args = [a.to("meta") for a in args]
        err, match = ValueError, "unsupported device"
    with pytest.raises(err, match=match):
        wsb.qweighted_sum_backward_kernel(*args, QFormat(1, 6))


def _ascending_sum(terms):
    """float32 sum over the last axis, one term at a time in ascending d."""
    acc = np.zeros(terms.shape[:-1], F32)
    for d in range(terms.shape[-1]):
        acc = acc + terms[..., d]
    return acc


def _kernel_order_sum(terms):
    """csrc/qweighted_sum_bwd.cu's order: lane l sums d = l, l+32, ... in
    ascending d from +0.0, then each lane adds its partner's sum across
    the xor offsets 16, 8, 4, 2, 1 (every lane ends with lane 0's)."""
    lanes = np.zeros(terms.shape[:-1] + (32,), F32)
    for d in range(terms.shape[-1]):
        lanes[..., d % 32] = lanes[..., d % 32] + terms[..., d]
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., np.arange(32) ^ o]
    return lanes[..., 0]


@pytest.mark.parametrize("wl", [8, 16, 24, 32])
@pytest.mark.parametrize("D", [60, 256])
def test_sum_orders_on_the_grid(rng, wl, D):
    """(c) dp's products summed in ascending d and in the kernel's order
    against torch's sum: bit for bit where sums_exact holds (8- and
    16-bit words), within dp_interval after the requant at 24 and 32
    bits (and there the largest products do round)."""
    for iwl in (0, 1, 5):
        fmt = QFormat(iwl, wl - 1 - iwl, 3)
        c, p, mask, g = _torch(*_inputs(rng, fmt, B=6, M=5, D=D))
        terms = tql._qproducts(c, g[..., None, :], fmt, fmt, fmt)
        want = terms.sum(-1)
        _, dp = tql.qweighted_sum_backward(c, p, mask, g, fmt,
                                           grad_quantized=True)
        lo, hi = wsb.dp_interval(c, mask, g, fmt)
        assert bool(((lo <= dp) & (dp <= hi)).all())
        fo = tql._grad_out_fmt(fmt)
        for order in (_ascending_sum, _kernel_order_sum):
            got = order(terms.numpy())
            if wsb.sums_exact(fmt, D):
                np.testing.assert_array_equal(_bits(got), _bits(want))
            dp_got = float_quant(torch.from_numpy(got), fo) * mask
            assert bool(((lo <= dp_got) & (dp_got <= hi)).all())
    # sample 2: D products of the largest magnitude, all negative
    exact = -D * ((1 << (wl - 1)) - 1)
    big = np.full(D, F32(-((1 << (wl - 1)) - 1)))
    assert wsb.sums_exact(QFormat(1, wl - 2), D) == (wl <= 16)
    assert (float(_ascending_sum(big)) == exact) == (wl <= 16)


def test_dp_interval_at_the_31_bit_wrap():
    """(c) At 32-bit words Q_fo maps -2 to 0 (the INT_MIN wrap): an
    interval that reaches -2 takes in 0."""
    fmt = QFormat(1, 30, 3)
    c = torch.full((1, 1, 2), -1.0)
    g = torch.ones(1, 2)
    mask = torch.ones(1, 1)
    lo, hi = wsb.dp_interval(c, mask, g, fmt)
    _, dp = tql.qweighted_sum_backward(c, torch.ones(1, 1), mask, g, fmt,
                                       grad_quantized=True)
    assert float(dp) == 0.0 and float(lo) == -2.0 and float(hi) >= 0.0


def _spy(monkeypatch):
    """Count the wrapper's calls under its name in its module (the
    unfused weighted sum looks it up there at each call) and in
    ops/fused.py."""
    calls = []
    real = wsb.qweighted_sum_backward_kernel

    def spy(*args):
        calls.append(tuple(a.shape for a in args[:4]))
        return real(*args)

    monkeypatch.setattr(wsb, "qweighted_sum_backward_kernel", spy)
    monkeypatch.setattr(tfused, "qweighted_sum_backward_kernel", spy)
    return calls


@pytest.mark.parametrize("partial", [False, True])
@pytest.mark.parametrize("lead", [(), (2,)])
@pytest.mark.parametrize("fmt", [(1, 6, 3), (5, 2, 2), (0, 0, 3)])
def test_weighted_sum_routes_and_matches_jax(rng, monkeypatch, fmt, lead,
                                             partial):
    """(d) qweighted_sum / qweighted_partial_sum with grad_quantized: the
    backend "kernel" backward calls the wrapper once, "plain" never, and
    both give JAX's forward and its vjp bit for bit."""
    calls = _spy(monkeypatch)
    c, p, mask, g = _inputs(rng, fmt, lead)
    jfmt = jnum.QFormat(*fmt)
    jop = jql.qweighted_partial_sum if partial else jql.qweighted_sum
    want, vjp = jax.vjp(lambda c_, p_: jop(c_, p_, jnp.asarray(mask), jfmt,
                                           True, True),
                        jnp.asarray(c), jnp.asarray(p))
    want_dc, want_dp = vjp(jnp.asarray(g))
    op = tql.qweighted_partial_sum if partial else tql.qweighted_sum
    for backend, n_calls in (("kernel", 1), ("plain", 0)):
        calls.clear()
        tc, tp = (torch.tensor(a, requires_grad=True) for a in (c, p))
        out = op(tc, tp, torch.from_numpy(mask), QFormat(*fmt), True, True,
                 backend)
        dc, dp = torch.autograd.grad(out, (tc, tp), torch.from_numpy(g))
        assert len(calls) == n_calls, backend
        np.testing.assert_array_equal(_bits(out.detach()), _bits(want))
        np.testing.assert_array_equal(_bits(dc), _bits(want_dc))
        np.testing.assert_array_equal(_bits(dp), _bits(want_dp))
    with pytest.raises(ValueError, match="unknown backend"):
        op(torch.from_numpy(c), torch.from_numpy(p), torch.from_numpy(mask),
           QFormat(*fmt), True, True, "pallas")


@pytest.mark.parametrize("lead", [(), (2,)])
def test_fused_read_backward_routes_and_matches_jax(rng, monkeypatch, lead):
    """(d) The mode-3 fused read's backward calls the wrapper once per
    call (a family's runs folded by it), and its gradients equal jax.grad
    through the JAX package's fused_attention_read (vmapped over the runs)
    within rtol 1e-5, atol 1e-6."""
    calls = _spy(monkeypatch)
    fmt = (1, 6)
    B, M_, D = 6, 5, 8
    m, c, u = (rng.normal(0.0, 1.6, lead + s).astype(F32)
               for s in ((B, M_, D), (B, M_, D), (B, D)))
    mask_f = (np.arange(M_)[None, :]
              < rng.integers(1, M_ + 1, lead + (B, 1))).astype(F32)
    co = rng.normal(0.0, 1.0, lead + (B, D)).astype(F32)
    kw = dict(score_quantized=False, sum_quantized=True, attention_mode=3,
              sum_grad_quantized=True)
    jq = jnum.QFormat(*fmt)

    def jread(m_, c_, u_, k_):
        return j_fused(m_, c_, u_, k_, jq, jq, jq, interpret=True,
                       **kw)[0]

    read = jax.vmap(jread) if lead else jread

    def jloss(m_, c_, u_):
        return jnp.sum(read(m_, c_, u_, jnp.asarray(mask_f)) * co)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        jnp.asarray(m), jnp.asarray(c), jnp.asarray(u))
    tin = [torch.tensor(a, requires_grad=True) for a in (m, c, u)]
    q = QFormat(*fmt)
    o = tfused.fused_attention_read(*tin, torch.from_numpy(mask_f), q, q, q,
                                    **kw)[0]
    got = torch.autograd.grad((o * torch.from_numpy(co)).sum(), tin)
    assert calls == [(c.shape, c.shape[:-1], c.shape[:-1], u.shape)]
    for a, w, name in zip(got, want, ("dm", "dc", "du")):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    assert np.abs(got[1].numpy()).max() > 0


STEP_ROUTES = {
    "mode 3, use_pallas": (dict(attention_mode=3, iwl=1),
                           dict(use_pallas=True)),
    "mode 3, use_pallas_hamming": (dict(attention_mode=3, iwl=1),
                                   dict(use_pallas_hamming=True)),
    "mode 2, EN_GRAD_QUANT, use_pallas": (dict(en_grad_quant=True),
                                          dict(use_pallas=True)),
}


@pytest.mark.parametrize("route", STEP_ROUTES)
def test_sgd_step_calls_the_kernel_per_hop_and_matches_jax(monkeypatch,
                                                           route):
    """(d) A one-batch epoch (13 live samples of 16) through JAX's
    train_epoch and the port's on a kernel route: the wrapper is called
    once per hop, and the parameters, cost and matches agree."""
    calls = _spy(monkeypatch)
    model_kw, route_kw = STEP_ROUTES[route]
    cfg_kw = dict(dim_emb=16, size_batch=16, verbose=False, **model_kw)
    data = babi.synthetic_task(np.random.default_rng(3), 16, 1, 1, V, M, W)
    batches = _one_batch_epoch(data, 13, 0, 16)
    pj = jax_params(cfg_kw, data.dims, seed=3)
    jp, jcost, jmatch = jtrainer.train_epoch(
        {k: jnp.asarray(v) for k, v in pj.items()},
        {k: jnp.asarray(v) for k, v in batches.items()}, jnp.float32(0.3),
        JaxConfig(**cfg_kw))
    tcfg = QmannConfig(**cfg_kw, **route_kw)
    assert tcfg.wsum_grad_quantized
    tp, tcost, tmatch = trainer.train_epoch(
        memn2n.params_from_jax(pj, tcfg, device="cpu"),
        {k: torch.from_numpy(v) for k, v in batches.items()},
        torch.tensor(0.3), tcfg)
    assert len(calls) == tcfg.num_hops
    np.testing.assert_allclose(float(tcost), float(jcost), rtol=1e-5)
    assert int(tmatch) == int(jmatch)
    for k in pj:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
        assert not np.array_equal(tp[k].numpy(), pj[k]), k
