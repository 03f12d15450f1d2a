"""The weighted sum's backward kernel (csrc/qweighted_sum_bwd.cu) and its
two entries, (dc, dp) and the fused read's (dc, ds), on the CPU:

(a) the plain version (ops.qlinear.qweighted_sum_backward with
    grad_quantized) against the JAX package's _qweighted_sum_bwd, the
    branch XLA fuses: 8-bit words at iwl 0, 1 and 5 in every rounding
    mode, 16-bit words, the binary format; padded rows, negative products
    (a negative value on a padded row gives -0.0), zero upstream rows;
    the ds entry's plain version against JAX's _fused_bwd composition
    (_qweighted_sum_bwd, dp + dp_in, p * (dp - sum(p * dp)) + ds_in) in
    the quantized and float instances, with and without the cotangents,
    with a family's leading dims;
(b) the wrappers on CPU tensors: the plain versions, no build, no launch
    counted, leading dims folded; formats, shapes, dtypes and devices they
    do not take raise on the CPU as on the card; the launch rule;
(c) the exactness arguments: dp's products summed in float32 in
    ascending d, and in the kernel's order (L lanes a row, each summing
    its columns in groups of 4, then a butterfly of shuffles within the
    row's lanes), equal torch's sum wherever sums_exact holds (8- and
    16-bit words, D <= 256), and lie in dp_interval at 24- and 32-bit
    words, where they round; the float instance's dp within dp_error and
    ds in the kernel's order (S by a butterfly over 32 lanes) within
    ds_bound of torch's, both against float64;
(d) the routing: qweighted_sum and qweighted_partial_sum with
    backend="kernel" reach the dp entry in their quantized backward and
    equal JAX's forward and gradient; the fused read's backward reaches
    the ds entry once per call in modes 1, 2 and 3, never
    ops.softmax.softmax_backward, and matches jax.grad; one SGD step on the
    mode-2 and mode-3 use_pallas routes (the ds entry), the mode-3
    use_pallas_hamming route and EN_GRAD_QUANT's unfused chain (the dp
    entry) calls its entry once per hop and equals JAX's train_epoch.

The kernel against its plain version on the card is in
tests/test_torch_cuda.py.

Tolerances.  (a)-(c) dc and quantized dp, and the weighted sum in (d): bit
for bit, compared as int32 views so that the sign of a zero counts (every
sum there is exact).  ds and float dp: ds_bound and dp_error, the rounding
of the M-term and D-term float32 sums in another order (the bounds are
derived in ops/cuda/qweighted_sum_bwd.py).  The fused read and the SGD
steps in (d): rtol 1e-5, atol 1e-6, as tests/test_torch_hamming_bwd.py and
tests/test_torch_mode3.py (the softmax and the other backwards sum in
another order than XLA).
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
from qmann_tpu_torch.ops.softmax import softmax_backward  # noqa: E402
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


def _lanes(D):
    """The kernel's lanes per row: the power of two that covers D's
    column groups of 4, at most 32."""
    lanes = 1
    while lanes < -(-D // 4) and lanes < 32:
        lanes *= 2
    return lanes


def _butterfly(lanes, width):
    """Each lane adds its partner's value across the xor offsets width/2,
    ..., 1 (every lane ends with the same sum)."""
    o = width // 2
    while o:
        lanes = lanes + lanes[..., np.arange(lanes.shape[-1]) ^ o]
        o //= 2
    return lanes


def _kernel_order_sum(terms, fma_with=None):
    """csrc/qweighted_sum_bwd.cu's order for a row of D terms: lane l of
    the row's L lanes sums, from +0.0, its columns 4l..4l+3 and (past 128
    columns) 4(l+L)..4(l+L)+3 in ascending d, then the butterfly over the
    L lanes.  fma_with: the float instance, terms * fma_with added by
    fused multiply-adds (one rounding each, emulated in float64)."""
    D = terms.shape[-1]
    L = _lanes(D)
    lanes = np.zeros(terms.shape[:-1] + (L,), F32)
    for k in range(2 if D > 4 * L else 1):
        for j in range(4):
            for lane in range(L):
                d = 4 * (lane + k * L) + j
                if d >= D:
                    continue
                if fma_with is None:
                    lanes[..., lane] = lanes[..., lane] + terms[..., d]
                else:
                    lanes[..., lane] = (
                        terms[..., d].astype(np.float64)
                        * fma_with[..., d].astype(np.float64)
                        + lanes[..., lane]).astype(F32)
    return _butterfly(lanes, L)[..., 0]


def _kernel_order_softmax(p, dp):
    """The ds epilogue's order: lane j takes rows j and j + 32, t_j =
    p_j dp_j + p_(j+32) dp_(j+32), S by the butterfly over 32 lanes, then
    p * (dp - S), all in float32."""
    M = p.shape[-1]
    pad = [(0, 0)] * (p.ndim - 1) + [(0, 64 - M)]
    pp, dd = np.pad(p, pad), np.pad(dp, pad)
    t = pp[..., :32] * dd[..., :32] + pp[..., 32:] * dd[..., 32:]
    S = _butterfly(t, 32)[..., :1]
    return p * (dp - S)


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
    """Count the two entries' calls: the dp entry under its name in its
    module (the unfused weighted sum looks it up there at each call), the
    ds entry there and in ops/fused.py.  Each call is recorded as (entry,
    the shapes of c, p, mask and g)."""
    calls = []

    def spying(entry, real):
        def spy(*args):
            calls.append((entry,) + tuple(a.shape for a in args[:4]))
            return real(*args)
        return spy

    monkeypatch.setattr(wsb, "qweighted_sum_backward_kernel",
                        spying("dp", wsb.qweighted_sum_backward_kernel))
    ds_spy = spying("ds", wsb.weighted_sum_softmax_backward_kernel)
    monkeypatch.setattr(wsb, "weighted_sum_softmax_backward_kernel", ds_spy)
    monkeypatch.setattr(tfused, "weighted_sum_softmax_backward_kernel",
                        ds_spy)
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
        assert calls == [("dp", c.shape, p.shape, mask.shape,
                          g.shape)] * n_calls, backend
        np.testing.assert_array_equal(_bits(out.detach()), _bits(want))
        np.testing.assert_array_equal(_bits(dc), _bits(want_dc))
        np.testing.assert_array_equal(_bits(dp), _bits(want_dp))
    with pytest.raises(ValueError, match="unknown backend"):
        op(torch.from_numpy(c), torch.from_numpy(p), torch.from_numpy(mask),
           QFormat(*fmt), True, True, "pallas")


FUSED_MODES = {1: dict(score_quantized=False, sum_quantized=False,
                       sum_grad_quantized=False),
               2: dict(score_quantized=True, sum_quantized=True,
                       sum_grad_quantized=False),
               3: dict(score_quantized=False, sum_quantized=True,
                       sum_grad_quantized=True)}


@pytest.mark.parametrize("mode", [3, 2, 1])
@pytest.mark.parametrize("lead", [(), (2,)])
def test_fused_read_backward_routes_and_matches_jax(rng, monkeypatch, lead,
                                                    mode):
    """(d) The fused read's backward calls the ds entry once per call (a
    family's runs folded by it), in the float instance in modes 1 and 2
    and the quantized one in mode 3, and never the softmax backward on
    its own; its gradients equal jax.grad through the JAX package's
    fused_attention_read (vmapped over the runs) within rtol 1e-5, atol
    1e-6."""
    calls = _spy(monkeypatch)

    def no_softmax_backward(*_):
        raise AssertionError("the ds entry takes the softmax backward")

    monkeypatch.setattr(tfused, "softmax_backward", no_softmax_backward)
    fmt = (1, 6) if mode == 3 else (5, 2)
    B, M_, D = 6, 5, 8
    m, c, u = (rng.normal(0.0, 1.6, lead + s).astype(F32)
               for s in ((B, M_, D), (B, M_, D), (B, D)))
    mask_f = (np.arange(M_)[None, :]
              < rng.integers(1, M_ + 1, lead + (B, 1))).astype(F32)
    co = rng.normal(0.0, 1.0, lead + (B, D)).astype(F32)
    kw = dict(attention_mode=mode, **FUSED_MODES[mode])
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
    assert calls == [("ds", c.shape, c.shape[:-1], c.shape[:-1], u.shape)]
    for a, w, name in zip(got, want, ("dm", "dc", "du")):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    assert np.abs(got[1].numpy()).max() > 0


STEP_ROUTES = {
    "mode 3, use_pallas": (dict(attention_mode=3, iwl=1),
                           dict(use_pallas=True), "ds"),
    "mode 2, use_pallas": (dict(), dict(use_pallas=True), "ds"),
    "mode 3, use_pallas_hamming": (dict(attention_mode=3, iwl=1),
                                   dict(use_pallas_hamming=True), "dp"),
    "mode 2, EN_GRAD_QUANT, use_pallas": (dict(en_grad_quant=True),
                                          dict(use_pallas=True), "dp"),
}


@pytest.mark.parametrize("route", STEP_ROUTES)
def test_sgd_step_calls_the_kernel_per_hop_and_matches_jax(monkeypatch,
                                                           route):
    """(d) A one-batch epoch (13 live samples of 16) through JAX's
    train_epoch and the port's on a kernel route: the route's entry is
    called once per hop (the ds entry from the fused read, in mode 2's
    float instance too; the dp entry from the unfused quantized weighted
    sum), the other never, and the parameters, cost and matches agree."""
    calls = _spy(monkeypatch)
    model_kw, route_kw, entry = STEP_ROUTES[route]
    cfg_kw = dict(dim_emb=16, size_batch=16, verbose=False, **model_kw)
    data = babi.synthetic_task(np.random.default_rng(3), 16, 1, 1, V, M, W)
    batches = _one_batch_epoch(data, 13, 0, 16)
    pj = jax_params(cfg_kw, data.dims, seed=3)
    jp, jcost, jmatch = jtrainer.train_epoch(
        {k: jnp.asarray(v) for k, v in pj.items()},
        {k: jnp.asarray(v) for k, v in batches.items()}, jnp.float32(0.3),
        JaxConfig(**cfg_kw))
    tcfg = QmannConfig(**cfg_kw, **route_kw)
    assert tcfg.wsum_grad_quantized == (tcfg.attention_mode == 3
                                        or tcfg.en_grad_quant)
    tp, tcost, tmatch = trainer.train_epoch(
        memn2n.params_from_jax(pj, tcfg, device="cpu"),
        {k: torch.from_numpy(v) for k, v in batches.items()},
        torch.tensor(0.3), tcfg)
    assert [c[0] for c in calls] == [entry] * tcfg.num_hops
    np.testing.assert_allclose(float(tcost), float(jcost), rtol=1e-5)
    assert int(tmatch) == int(jmatch)
    for k in pj:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
        assert not np.array_equal(tp[k].numpy(), pj[k]), k


# ---------------------------------------------------------------------------
# the ds entry: the weighted-sum backward with the softmax backward
# ---------------------------------------------------------------------------

DS_CASES = ([(fmt, True) for fmt in FORMATS]
            + [((5, 2, 3), False), ((1, 6, 0), False)])
COTANGENTS = [(False, False), (True, False), (False, True), (True, True)]


def _cotangents(rng, shape, which):
    return tuple(rng.normal(0.0, 1.0, shape).astype(F32) if on else None
                 for on in which)


@pytest.mark.parametrize("cotangents", COTANGENTS)
@pytest.mark.parametrize("fmt,quantized", DS_CASES)
def test_ds_entry_plain_equals_jax(rng, fmt, quantized, cotangents):
    """(a) The ds entry's plain version against JAX's _fused_bwd
    composition on the same inputs: dc bit for bit; dp (the weighted-sum
    backward's) bit for bit in the quantized instance and within dp_error
    in the float one; ds within ds_bound."""
    lead = (3,) if cotangents == (True, True) else ()
    c, p, mask, g = _inputs(rng, fmt, lead)
    if not quantized:   # unit-range inputs: no product overflows
        c = np.clip(c, -4.0, 4.0)
    dp_in, ds_in = _cotangents(rng, p.shape, cotangents)
    jfmt = jnum.QFormat(*fmt)
    want_dc, want_dp, _ = jql._qweighted_sum_bwd(
        jfmt, True, quantized,
        (jnp.asarray(c), jnp.asarray(p), jnp.asarray(mask)), jnp.asarray(g))
    jdp = want_dp + (0.0 if dp_in is None else jnp.asarray(dp_in))
    want_ds = jnp.asarray(p) * (jdp - jnp.sum(jnp.asarray(p) * jdp, axis=-1,
                                              keepdims=True))
    want_ds = want_ds + (0.0 if ds_in is None else jnp.asarray(ds_in))
    tc, tp, tm, tg = _torch(c, p, mask, g)
    t_dp_in, t_ds_in = (None if a is None else torch.from_numpy(a)
                        for a in (dp_in, ds_in))
    dc, ds = wsb.weighted_sum_softmax_backward_kernel(
        tc, tp, tm, tg, t_dp_in, t_ds_in, QFormat(*fmt), quantized)
    np.testing.assert_array_equal(_bits(dc), _bits(want_dc))
    _, dp = tql.qweighted_sum_backward(tc, tp, tm, tg, QFormat(*fmt),
                                       grad_quantized=quantized)
    err = wsb.dp_error(tc, tm, tg, QFormat(*fmt), quantized)
    if quantized:
        np.testing.assert_array_equal(_bits(dp), _bits(want_dp))
        assert float(err.max()) == 0.0
    else:
        assert (np.abs(dp.numpy().astype(np.float64) - np.asarray(want_dp))
                <= err.numpy()).all()
    if dp_in is not None:
        dp = dp + t_dp_in
    bound = wsb.ds_bound(tp, dp, wsb.dp_error(tc, tm, tg, QFormat(*fmt),
                                              quantized, t_dp_in), t_ds_in)
    diff = np.abs(ds.numpy().astype(np.float64) - np.asarray(want_ds))
    assert (diff <= bound.numpy()).all()
    assert ds.shape == p.shape and dc.shape == c.shape


def test_ds_entry_on_cpu_is_the_plain_version(rng, monkeypatch):
    """(b) On CPU tensors the ds entry never builds or loads the kernel,
    counts no launch, and is the plain composition, at a family's [R, B,
    M, D]; the float instance does not read the format."""
    def no_build(*_):
        raise AssertionError("the CPU path must not touch the CUDA build")
    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(wsb, "load_library", no_build)
    c, p, mask, g = _torch(*_inputs(rng, (1, 6, 3), (2,)))
    dp_in = torch.from_numpy(rng.normal(0.0, 1.0, p.shape).astype(F32))
    before = (wsb.weighted_sum_softmax_backward_kernel.launches,
              wsb.qweighted_sum_backward_kernel.launches)
    for fmt, quantized in ((QFormat(1, 6, 3), True),
                           (QFormat(1, 31, 3), False)):
        dc, ds = wsb.weighted_sum_softmax_backward_kernel(
            c, p, mask, g, dp_in, None, fmt, quantized)
        want_dc, dp = tql.qweighted_sum_backward(c, p, mask, g, fmt,
                                                 grad_quantized=quantized)
        want_ds = softmax_backward(p, dp + dp_in)
        np.testing.assert_array_equal(_bits(dc), _bits(want_dc))
        np.testing.assert_array_equal(_bits(ds), _bits(want_ds))
    assert (wsb.weighted_sum_softmax_backward_kernel.launches,
            wsb.qweighted_sum_backward_kernel.launches) == before


@pytest.mark.parametrize("which", range(5))
def test_ds_entry_refuses_what_the_kernel_cannot_take(which):
    """(b) A cotangent of another shape, device or dtype, a quantized
    format out of range and M above 64 raise on the CPU too, before any
    launch."""
    c, p, mask, g = (torch.zeros(s) for s in ((2, 3, 4), (2, 3), (2, 3),
                                              (2, 4)))
    cot = [torch.zeros(2, 3), None]
    fmt, err, match = QFormat(1, 6), ValueError, "shapes"
    if which == 0:
        cot[0] = torch.zeros(2, 4)
    elif which == 1:
        cot[1] = torch.zeros(2, 3, dtype=torch.float64)
        err, match = TypeError, "float32"
    elif which == 2:
        cot[1] = torch.zeros(2, 3, device="meta")
        match = "different devices"
    elif which == 3:
        fmt, match = QFormat(1, 31), "format"
    else:
        c, p, mask, g = (torch.zeros(s) for s in ((2, 65, 4), (2, 65),
                                                  (2, 65), (2, 4)))
        cot[0] = torch.zeros(2, 65)
        match = "M<=64"
    before = wsb.weighted_sum_softmax_backward_kernel.launches
    with pytest.raises(err, match=match):
        wsb.weighted_sum_softmax_backward_kernel(c, p, mask, g, *cot, fmt,
                                                 True)
    assert wsb.weighted_sum_softmax_backward_kernel.launches == before


@pytest.mark.parametrize("shape,want", [
    ((32, 10, 60), (3, 3, 1, 32, 96)),
    ((32, 50, 60), (3, 8, 1, 32, 256)),
    ((1024, 10, 60), (3, 3, 2, 512, 192)),
    ((1280, 50, 60), (3, 3, 2, 640, 192)),
    ((5120, 50, 60), (3, 3, 2, 2560, 192)),
    ((6400, 50, 60), (3, 3, 2, 3200, 192)),
    ((1, 1, 1), (0, 1, 1, 1, 32)),
    ((7, 64, 256), (5, 8, 1, 7, 256)),
    ((9, 3, 7), (0, 1, 1, 9, 32))])
def test_backward_geometry(shape, want):
    """(b) The launch rule: the fewest lanes a row that leave a lane at
    most 2 column groups of 4, a query's steps over 3 warps from the
    card's 132 SMs' worth of queries on and up to 8 below, never more
    warps than steps, up to 8 warps a block, queries a block halved while
    the grid has fewer blocks than SMs."""
    geo = wsb.backward_geometry(*shape)
    assert tuple(geo) == want
    assert geo.warps * geo.queries <= wsb.MAX_WARPS
    assert -(-shape[-1] // 4) <= wsb.MAX_GROUPS << geo.lanes_log2


@pytest.mark.parametrize("M", [1, 10, 33, 50, 64])
@pytest.mark.parametrize("D", [3, 60, 200])
def test_ds_in_the_kernel_order_within_the_bound(rng, M, D):
    """(c) The float instance's dp summed in the kernel's order (FMAs, L
    lanes a row) lies within dp_error of torch's einsum and of the float64
    sum; ds with S in the kernel's order (a butterfly over 32 lanes)
    within ds_bound of torch's softmax backward and of the float64
    composition, on rows whose dp nearly cancels S (p concentrated on
    one row) and on rows with dp_in and ds_in."""
    B = 4
    c = rng.normal(0.0, 1.0, (B, M, D)).astype(F32)
    g = rng.normal(0.0, 1.0, (B, D)).astype(F32)
    p = rng.dirichlet(np.full(M, 0.3), B).astype(F32)
    p[0] = 0.0
    p[0, 0] = 1.0                    # S == dp_0: ds_0 cancels to 0
    mask = (np.arange(M) < rng.integers(1, M + 1, (B, 1))).astype(F32)
    p *= mask
    dp_in, ds_in = (rng.normal(0.0, 1.0, (B, M)).astype(F32)
                    for _ in range(2))
    tc, tp, tm, tg = _torch(c, p, mask, g)
    fmt = QFormat(5, 2)
    _, dp = tql.qweighted_sum_backward(tc, tp, tm, tg, fmt)
    kernel_dp = _kernel_order_sum(c, fma_with=np.broadcast_to(
        g[:, None, :], c.shape)) * mask
    exact_dp = (c.astype(np.float64) * g[:, None, :]).sum(-1) * mask
    err = wsb.dp_error(tc, tm, tg, fmt, False).numpy()
    for other in (kernel_dp, exact_dp):
        assert (np.abs(dp.numpy() - other) <= err).all()
    for cot in (False, True):
        t_dp_in, t_ds_in = ((torch.from_numpy(dp_in), torch.from_numpy(ds_in))
                            if cot else (None, None))
        d_plain = dp + t_dp_in if cot else dp
        d_kernel = kernel_dp + dp_in if cot else kernel_dp
        ds_plain = softmax_backward(tp, d_plain).numpy()
        ds_kernel = _kernel_order_softmax(p, d_kernel.astype(F32))
        d64 = exact_dp + (dp_in if cot else 0.0)
        p64 = p.astype(np.float64)
        ds_exact = p64 * (d64 - (p64 * d64).sum(-1, keepdims=True))
        if cot:
            ds_plain = ds_plain + ds_in
            ds_kernel = ds_kernel + ds_in
            ds_exact = ds_exact + ds_in
        bound = wsb.ds_bound(tp, d_plain, wsb.dp_error(
            tc, tm, tg, fmt, False, t_dp_in), t_ds_in).numpy()
        for other in (ds_kernel, ds_exact):
            assert (np.abs(ds_plain.astype(np.float64) - other)
                    <= bound).all()
        if not cot:   # ds = p * (...) is exactly 0 on both sides
            assert (bound[p == 0] == 0).all()


@pytest.mark.parametrize("wl", [8, 24, 32])
def test_ds_bound_of_the_quantized_instance(rng, wl):
    """(c) The quantized instance: dp in the kernel's order is the plain
    dp where sums_exact holds (dp_error 0) and within dp_interval's width
    elsewhere; ds with S in the kernel's order lies within ds_bound of
    torch's, and of the float64 composition on the plain dp."""
    fmt = QFormat(1, wl - 2, 3)
    c, p, mask, g = _inputs(rng, fmt, B=6, M=40, D=60)
    tc, tp, tm, tg = _torch(c, p, mask, g)
    _, dp = tql.qweighted_sum_backward(tc, tp, tm, tg, fmt,
                                       grad_quantized=True)
    terms = tql._qproducts(tc, tg[..., None, :], fmt, fmt, fmt).numpy()
    fo = tql._grad_out_fmt(fmt)
    kernel_dp = (float_quant(torch.from_numpy(_kernel_order_sum(terms)), fo)
                 * tm).numpy()
    err = wsb.dp_error(tc, tm, tg, fmt, True).numpy()
    assert (np.abs(dp.numpy().astype(np.float64) - kernel_dp) <= err).all()
    assert (err.max() == 0.0) == wsb.sums_exact(fmt, 60)
    ds_plain = softmax_backward(tp, dp).numpy().astype(np.float64)
    ds_kernel = _kernel_order_softmax(p, kernel_dp)
    d64, p64 = dp.numpy().astype(np.float64), p.astype(np.float64)
    ds_exact = p64 * (d64 - (p64 * d64).sum(-1, keepdims=True))
    bound = wsb.ds_bound(tp, dp, torch.from_numpy(err)).numpy()
    assert (np.abs(ds_plain - ds_kernel) <= bound).all()
    assert (np.abs(ds_plain - ds_exact) <= bound).all()
