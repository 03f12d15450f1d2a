"""The mode-3 surrogate backward kernel (csrc/hamming_bwd.cu) on the CPU:

(a) its integer form, emulated in int64 torch (the preprocess in 32-bit
    words; the closed form: the preprocess leaves magnitude bits in one
    word only, so the differing bits 1 .. num_bit-1 share one diff and
    tmp_a is a signed popcount of them, grad_appx bit 0's run (a
    leading-zero count) and the rest of the compared bits, each with its
    sign; both scaled by 2^const_scale at the end), against the plain
    loop of ops/attention.py (surrogate_terms, hamming_backward) for
    num_bit 1..32, iwl 0/1/5/31 and every rounding mode, on an edge list;
    the closed form against the walk over the differing bits (the
    kernel's earlier form, each value held to the next differing bit) on
    every pair of encoded words within windows of 1..8 bits (the four
    sign pairs among them), preprocessed, and on seeded random 32-bit
    pairs at every num_bit; the scaled float of the integers by the
    1.5 * 2^23 bias and one FMA;
(b) the wrapper on CPU tensors: the plain version, no build, no launch
    counted, leading dims folded; the launch rule (backward_launch);
(c) knobs and shapes out of the kernel's range raise on every device;
(d) the routing: the kernel route's backwards (the unfused score with
    backend="kernel", the mode-3 fused read) reach the wrapper and the
    plain route does not; their gradients against jax.grad through the
    JAX package's hamming_score and fused_attention_read.

The kernel against its plain version on the card is in
tests/test_torch_cuda.py.

Tolerances.  (a), (b): bit for bit, compared as int32 views so that the
sign of a zero counts; the closed form and the walk as equal integers.
(d): dm of the unfused score bit for bit (one product of the same two
floats); du within rtol 1e-5, atol 1e-6 (a float32 sum over the memory
rows in another order than XLA's, as tests/test_torch_hamming.py); the
fused read's gradients within rtol 1e-5, atol 1e-6 (its softmax backward
sums in another order, as tests/test_torch_attention_read.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qmann_tpu import numerics as jnum  # noqa: E402
from qmann_tpu.ops import attention as jatt  # noqa: E402
from qmann_tpu.ops.fused import fused_attention_read as j_fused  # noqa: E402
from qmann_tpu_torch.numerics import QFormat  # noqa: E402
from qmann_tpu_torch.ops import attention as tatt  # noqa: E402
from qmann_tpu_torch.ops import fused as tfused  # noqa: E402
from qmann_tpu_torch.ops.cuda import _build  # noqa: E402
from qmann_tpu_torch.ops.cuda import hamming_bwd as tbwd  # noqa: E402

F32 = np.float32
WORD = 0xFFFFFFFF
SIGN = 0x80000000


@pytest.fixture(autouse=True)
def _one_thread():
    """Many tiny ops: one torch thread keeps them fast under the suite's
    worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _words(x, iwl, mode):
    """The encoded words as unsigned 32-bit values in int64."""
    return tatt._encode_words(x, iwl, mode).to(torch.int64) & WORD


def _popc(x):
    """Population count of 32-bit values in int64 (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & WORD) >> 24


def _clz(x):
    """Leading zeros of 32-bit values in int64 (frexp's exponent is
    exact): the index, from the MSB, of the highest set bit; 32 at 0, as
    CUDA's __clz."""
    return 32 - torch.frexp(x.to(torch.float64)).exponent.to(torch.int64)


def _mask(num_bit):
    """The compared bits 1 .. num_bit-1 (HamFmt.mask)."""
    return 0x7FFFFFFF & ~((1 << (32 - num_bit)) - 1)


def _preprocess(wm, wu):
    """ham_preprocess of encoded words (unsigned 32-bit values in int64):
    (pm, pu); mm + mn < 2^32 may set bit 31."""
    sm, su = wm & SIGN, wu & SIGN
    mm, mu = wm & 0x7FFFFFFF, wu & 0x7FFFFFFF
    mn = torch.minimum(mm, mu)
    same, ge = sm == su, mm >= mu
    zero = torch.zeros_like(mm)
    pm = sm | torch.where(same, mm - mn, torch.where(ge, mm + mn, zero))
    pu = su | torch.where(same, mu - mn, torch.where(ge, zero, mu + mn))
    return pm, pu


def _sign(w):
    """+1 for a word with the sign bit clear, else -1."""
    return torch.where(w & SIGN != 0, -1, 1)


def _closed_form(wm, wu, num_bit):
    """csrc/hamming_bwd.cu's ham_surrogate on encoded words, in int64:
    (ka, kv).  Every differing bit i >= 1 has one diff (dir); bit 0
    differs only where the signs differ."""
    pm, pu = _preprocess(wm, wu)
    x = pm ^ pu
    x1 = x & _mask(num_bit)
    direction = torch.where(pm & x1 != 0, 1, -1)
    e = x >> 31
    c = torch.clamp_max(_clz(x1), num_bit)
    ka = -e - _sign(wu) * direction * _popc(x1)
    kv = -e * c + _sign(wm) * direction * (num_bit - c)
    return ka, kv


def _walk_form(wm, wu, num_bit):
    """The walk over the preprocessed words' differing bits, in int64, as
    the plain loop states it: (ka, kv); tmp_a a signed popcount, each
    value of grad_appx held from its bit to the next differing bit (or
    num_bit)."""
    pm, pu = _preprocess(wm, wu)
    sign_m, sign_u = _sign(wm), _sign(wu)
    mask = _mask(num_bit)
    differ = (pm ^ pu) & (mask | SIGN)
    d0 = torch.where(differ & SIGN != 0,
                     torch.where(pm & SIGN != 0, 1, -1), 0)
    ka = d0 * sign_m - sign_u * (_popc(pm & ~pu & mask)
                                 - _popc(~pm & pu & mask))
    zero = torch.zeros_like(pm)
    acc, held, start = zero.clone(), zero.clone(), zero.clone()
    rest = differ.clone()
    for _ in range(num_bit):
        live = rest != 0
        if not bool(live.any()):
            break
        i = torch.where(live, _clz(torch.where(live, rest, 1)), 0)
        diff = torch.where((pm >> (31 - i)) & 1 != 0, 1, -1)
        acc = torch.where(live, acc + held * (i - start), acc)
        held = torch.where(live, torch.where(i == 0, -diff * sign_u,
                                             diff * sign_m), held)
        start = torch.where(live, i, start)
        rest = torch.where(live, rest & ~(torch.full_like(i, SIGN) >> i),
                           rest)
    return ka, acc + held * (num_bit - start)


def _kernel_form(m, u, iwl, num_bit, const_scale, mode):
    """csrc/hamming_bwd.cu's integers, scaled: (tmp_a, grad_appx) as
    float32, each [..., M, D]."""
    wm = _words(m, iwl, mode)
    wu = _words(u, iwl, mode)[..., None, :].expand_as(wm)
    ka, kv = _closed_form(wm, wu, num_bit)
    assert int(ka.abs().max()) <= 32 and int(kv.abs().max()) <= 32
    scale = float(2.0 ** const_scale)
    return (ka.to(torch.float32) * scale, kv.to(torch.float32) * scale)


def _edge_inputs(rng, iwl, B=4, M=6, D=16):
    """m [B, M, D], u [B, D]: sample 0 pairs the edge list (+-0.0,
    +-2^iwl, the floats beside it, saturating values, tiny values) shifted
    by one place per memory row with its negation; sample 1 the same
    magnitudes with both signs (u = m's row 0, and its negation in the
    second half); sample 2 pairs that wrap in the preprocess (0.625 and
    -0.53 times 2^iwl: the sum of the magnitudes passes 2^31); the rest
    Gaussian around the format's range."""
    top = F32(2.0 ** iwl)
    edge = np.array([0.0, -0.0, top, -top, np.nextafter(top, F32(np.inf)),
                     np.nextafter(top, F32(0)), 1e30, -1e30, 3e38, 1e-7,
                     -3e-9, 0.5 * top, -0.5 * top, 0.25, -0.75 * top, 1e-45],
                    F32)[:D]
    m = rng.normal(0.0, 0.6 * 2.0 ** iwl, (B, M, D)).astype(F32)
    u = rng.normal(0.0, 0.6 * 2.0 ** iwl, (B, D)).astype(F32)
    for r in range(M):
        m[0, r, :len(edge)] = np.roll(edge, r)
    u[0, :len(edge)] = -edge
    u[1] = m[1, 0]
    m[1, :, D // 2:] = -m[1, :, D // 2:]
    m[2, :, :D // 2] = F32(0.625) * top
    u[2, :D // 2] = -F32(0.53) * top
    return torch.from_numpy(m), torch.from_numpy(u)


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("mode", [3, 0, 1, 2])
@pytest.mark.parametrize("iwl", [0, 1, 5, 31])
def test_integer_form_equals_the_plain_loop(rng, iwl, mode):
    """(a) For num_bit 1..32: the kernel's integers, scaled, equal the
    plain loop's tmp_a and grad_appx bit for bit (+0.0 where the loop
    gives +0.0), and dm = tmp_a * g equals hamming_backward's."""
    m, u = _edge_inputs(rng, iwl)
    g = torch.from_numpy(rng.normal(0.0, 1.0, m.shape[:-1]).astype(F32))
    g[0, :3] = torch.tensor([0.0, -0.0, -1.0])
    for num_bit in range(1, 33):
        tmp_a, grad_appx = tatt.surrogate_terms(m, u, iwl, num_bit, -3,
                                                mode)
        ka, kv = _kernel_form(m, u, iwl, num_bit, -3, mode)
        assert torch.equal(_bits(ka), _bits(tmp_a)), num_bit
        assert torch.equal(_bits(kv), _bits(grad_appx)), num_bit
        dm, _ = tatt.hamming_backward(m, u, g, iwl, num_bit, -3, mode)
        assert torch.equal(_bits(ka * g[..., None]), _bits(dm)), num_bit
    assert bool((tmp_a != 0).any()) and bool((grad_appx != 0).any())


@pytest.mark.parametrize("const_scale", [-64, 0, 64])
def test_integer_form_at_the_scale_bounds(rng, const_scale):
    """(a) The scale's range keeps k * 2^const_scale exact (|k| <= 32)."""
    m, u = _edge_inputs(rng, 1)
    for num_bit in (1, 8, 32):
        want = tatt.surrogate_terms(m, u, 1, num_bit, const_scale, 3)
        got = _kernel_form(m, u, 1, num_bit, const_scale, 3)
        for a, b in zip(got, want):
            assert torch.equal(_bits(a), _bits(b))


def test_wrapping_pair_in_the_integer_form():
    """(a) At iwl 5, m=20 and u=-17: 20*2^26 + 17*2^26 passes 2^31, the
    wrapped word's bit 31 enters the comparison (as in
    tests/test_torch_hamming.py)."""
    m, u = torch.tensor([[[20.0]]]), torch.tensor([[-17.0]])
    for num_bit in (1, 2, 8, 32):
        want = tatt.surrogate_terms(m, u, 5, num_bit, -3, 3)
        got = _kernel_form(m, u, 5, num_bit, -3, 3)
        for a, b in zip(got, want):
            assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("num_bit", range(1, 9))
def test_closed_form_equals_the_walk_on_every_window(num_bit):
    """(a) Every pair of encoded words whose top num_bit bits (the sign
    and the compared magnitude bits: the four sign pairs included) take
    all 2^num_bit x 2^num_bit values, once with the bits below zero and
    once seeded (the preprocess's borrows and carries reach the window):
    on the preprocessed pairs the closed form's integers equal the
    walk's."""
    gen = torch.Generator().manual_seed(num_bit)
    v = torch.arange(1 << num_bit, dtype=torch.int64) << (32 - num_bit)
    wm, wu = (a.reshape(-1) for a in torch.meshgrid(v, v, indexing="ij"))
    low = (1 << (32 - num_bit)) - 1
    noise = [torch.randint(0, 1 << 31, wm.shape, generator=gen) & low
             for _ in range(2)]
    wm = torch.cat([wm, wm | noise[0]])
    wu = torch.cat([wu, wu | noise[1]])
    want = _walk_form(wm, wu, num_bit)
    got = _closed_form(wm, wu, num_bit)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool((want[1] != 0).any()) or num_bit == 1


@pytest.mark.parametrize("num_bit", range(1, 33))
def test_closed_form_equals_the_walk_on_random_words(num_bit):
    """(a) Seeded random encoded 32-bit pairs, half of them close (the
    xor with the and of three random words): the closed form's integers
    equal the walk's, and the two facts it rests on hold after the
    preprocess (one word's magnitude bits are zero; bit 0 differs only
    where the signs differ)."""
    gen = torch.Generator().manual_seed(100 + num_bit)
    n = 4096

    def words():
        return torch.randint(0, 1 << 32, (n,), generator=gen) & WORD

    wm, wu = words(), words()
    wu[: n // 2] = wm[: n // 2] ^ (words() & words() & words())[: n // 2]
    want = _walk_form(wm, wu, num_bit)
    got = _closed_form(wm, wu, num_bit)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    pm, pu = _preprocess(wm, wu)
    assert not bool((pm & pu & 0x7FFFFFFF).any())
    assert not bool(((pm ^ pu) & ~(wm ^ wu) & SIGN).any())
    assert bool((want[1] != 0).any())


@pytest.mark.parametrize("const_scale", [-64, -3, 0, 64])
def test_scaled_bias_conversion_is_exact(const_scale):
    """(a) The kernel's scaled_int: the bits of 1.5 * 2^23 plus k, times
    2^const_scale plus the scaled bias in one FMA (emulated in float64,
    where the product and the sum are exact), equal float32(k) *
    2^const_scale bit for bit for |k| <= 32 (+0.0 at 0)."""
    k = np.arange(-32, 33, dtype=np.int32)
    scale = 2.0 ** const_scale
    biased = (np.int32(0x4B400000) + k).view(F32).astype(np.float64)
    got = (biased * scale + (-12582912.0 * scale)).astype(F32)
    want = k.astype(F32) * F32(scale)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("B,D,want", [
    (32, 60, (60, 32)), (128, 60, (240, 32)), (16, 60, (30, 32)),
    (200, 60, (188, 64)), (64, 256, (256, 64)), (300, 60, (141, 128)),
    (1024, 60, (480, 128)), (1280, 60, (600, 128)),
    (5120, 60, (2400, 128)), (1, 1, (1, 32))])
def test_launch_rule(B, D, want):
    """(b) backward_launch: one thread per column, 128 a block, halved
    while the grid has fewer blocks than the card's 132 SMs, down to one
    warp.  The grid covers every column."""
    blocks, threads = tbwd.backward_launch(B, D)
    assert (blocks, threads) == want
    assert blocks * threads >= B * D > (blocks - 1) * threads
    assert threads == 32 or blocks >= tbwd.SMS


@pytest.mark.parametrize("lead", [(), (3,)])
def test_wrapper_on_cpu_is_the_plain_version(rng, monkeypatch, lead):
    """(b) On CPU tensors the wrapper never builds or loads the kernel,
    counts no launch, and equals hamming_backward at [B, M, D] and at a
    family's [R, B, M, D]."""
    def no_build(*_):
        raise AssertionError("the CPU path must not touch the CUDA build")
    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(tbwd, "load_library", no_build)
    m = torch.from_numpy(rng.normal(0.0, 1.2, lead + (5, 6, 12)).astype(F32))
    u = torch.from_numpy(rng.normal(0.0, 1.2, lead + (5, 12)).astype(F32))
    g = torch.from_numpy(rng.normal(0.0, 1.0, lead + (5, 6)).astype(F32))
    before = tbwd.hamming_backward_kernel.launches
    dm, du = tbwd.hamming_backward_kernel(m, u, g, 1, 8, -3, 3)
    want_dm, want_du = tatt.hamming_backward(m, u, g, 1, 8, -3, 3)
    assert dm.shape == m.shape and du.shape == u.shape
    assert torch.equal(_bits(dm), _bits(want_dm))
    assert torch.equal(_bits(du), _bits(want_du))
    assert tbwd.hamming_backward_kernel.launches == before


@pytest.mark.parametrize("knobs,match", [
    (dict(iwl=32), "iwl in"), (dict(iwl=-1), "iwl in"),
    (dict(num_bit=0), "num_bit in"), (dict(num_bit=33), "num_bit in"),
    (dict(const_scale=65), "const_scale in"),
    (dict(const_scale=-65), "const_scale in"),
    (dict(round_mode=4), "round_mode in")])
def test_knobs_out_of_range_raise(rng, knobs, match):
    """(c) The kernel's knob ranges (make_hamfmt) raise on the CPU too."""
    m, u = _edge_inputs(rng, 1)
    g = torch.ones(m.shape[:-1])
    kw = dict(iwl=1, num_bit=8, const_scale=-3, round_mode=3)
    kw.update(knobs)
    with pytest.raises(ValueError, match=match):
        tbwd.hamming_backward_kernel(m, u, g, **kw)


@pytest.mark.parametrize("shapes", [
    ((2, 65, 8), (2, 8), (2, 65)), ((2, 4, 257), (2, 257), (2, 4)),
    ((2, 4, 8), (2, 7), (2, 4)), ((2, 4, 8), (2, 8), (2, 5)),
    ((3, 2, 4, 8), (2, 8), (3, 2, 4)), ((0, 4, 8), (0, 8), (0, 4)),
    ((8,), (8,), ())])
def test_shapes_out_of_range_raise(shapes):
    """(c) M above 64, D above 256, operands that do not agree and an
    empty batch raise on the CPU as on the card, before any launch."""
    m, u, g = (torch.zeros(s) for s in shapes)
    before = tbwd.hamming_backward_kernel.launches
    with pytest.raises(ValueError, match="hamming_backward_kernel"):
        tbwd.hamming_backward_kernel(m, u, g, 1, 8)
    assert tbwd.hamming_backward_kernel.launches == before


def _spy(monkeypatch, module):
    """Count the calls of the wrapper under its name in ``module``."""
    calls = []
    real = tbwd.hamming_backward_kernel

    def spy(*args):
        calls.append(tuple(a.shape for a in args[:3]))
        return real(*args)

    monkeypatch.setattr(module, "hamming_backward_kernel", spy)
    return calls


@pytest.mark.parametrize("lead", [(), (2,)])
@pytest.mark.parametrize("iwl", [1, 5])
def test_score_backward_routes_and_matches_jax(rng, monkeypatch, iwl, lead):
    """(d) hamming_score's backward with backend="kernel" calls the
    wrapper once (leading dims folded by it), with "plain" never; both
    give jax.grad's dm bit for bit and du within rtol 1e-5, atol 1e-6."""
    calls = _spy(monkeypatch, tbwd)
    m = rng.normal(0.0, 0.6 * 2.0 ** iwl, lead + (5, 6, 12)).astype(F32)
    u = rng.normal(0.0, 0.6 * 2.0 ** iwl, lead + (5, 12)).astype(F32)
    g = rng.normal(0.0, 1.0, lead + (5, 6)).astype(F32)

    def jloss(m_, u_):
        return jnp.sum(jatt.hamming_score(m_, u_, iwl, 8, -3, 3) * g)

    jdm, jdu = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(m),
                                                        jnp.asarray(u))
    for backend, n_calls in (("kernel", 1), ("plain", 0)):
        calls.clear()
        tm = torch.from_numpy(m).requires_grad_()
        tu = torch.from_numpy(u).requires_grad_()
        loss = (tatt.hamming_score(tm, tu, iwl, 8, -3, 3, backend)
                * torch.from_numpy(g)).sum()
        dm, du = torch.autograd.grad(loss, (tm, tu))
        assert len(calls) == n_calls, backend
        np.testing.assert_array_equal(dm.numpy(), np.asarray(jdm))
        np.testing.assert_allclose(du.numpy(), np.asarray(jdu), rtol=1e-5,
                                   atol=1e-6)
        assert np.abs(du.numpy()).max() > 0


@pytest.mark.parametrize("lead", [(), (2,)])
def test_fused_read_backward_routes_and_matches_jax(rng, monkeypatch, lead):
    """(d) The mode-3 fused read's backward calls the wrapper once per
    call (a family's runs folded), and its gradients equal jax.grad
    through the JAX package's fused_attention_read (vmapped over the runs)
    within rtol 1e-5, atol 1e-6."""
    calls = _spy(monkeypatch, tfused)
    fmt = (1, 6)
    B, M, D = 6, 5, 8
    m, c, u = (rng.normal(0.0, 1.6, lead + s).astype(F32)
               for s in ((B, M, D), (B, M, D), (B, D)))
    mask = np.arange(M)[None, :] < rng.integers(1, M + 1, lead + (B, 1))
    mask_f = mask.astype(F32)
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
    assert calls == [(m.shape, u.shape, m.shape[:-1])]
    for a, w, name in zip(got, want, ("dm", "dc", "du")):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    assert np.abs(got[0].numpy()).max() > 0     # the surrogate reaches m
