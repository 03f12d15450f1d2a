"""The Hamming attention of the port (the sign-magnitude encode, the
Hamming score forward and its surrogate backward, the other attention
modes) against the JAX package on the same numpy inputs, and the Hamming
kernel wrapper's CPU dispatch.  The CUDA kernel against its plain version
is tests/test_torch_cuda.py.

Tolerances.  The encode, decode, gray code, the Hamming forward (against
both JAX's jnp route and hamming_score_pallas in interpret mode), the
memory gradient of the surrogate, the gray and binary scores and the
quantized (mode 2) score are bit-identical: they are integer work, sums of
powers of two, or sums on the 2^-frac grid, all exact in float32.  The
query gradient of the surrogate is a float32 sum over the memory rows in
another order than XLA's: rtol 1e-5, atol 1e-6.  The mode-1 (float) score
sums in another order: rtol 1e-5, atol 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qmann_tpu import numerics as jnum  # noqa: E402
from qmann_tpu.ops import attention as jatt  # noqa: E402
from qmann_tpu.ops.pallas.qkernels import hamming_score_pallas  # noqa: E402
from qmann_tpu_torch import numerics as tnum  # noqa: E402
from qmann_tpu_torch.config import QmannConfig  # noqa: E402
from qmann_tpu_torch.ops import attention as tatt  # noqa: E402
from qmann_tpu_torch.ops.cuda import hamming as tham  # noqa: E402

IWLS = (0, 1, 2, 5, 7)


def edge_values(iwl):
    """The encode's edge list at (iwl, 31-iwl): 0, -0.0, +-2^iwl, +-maxf,
    the next float above maxf, +-1e30, and a value whose low half rounds
    to 2^16 under ROUND_UP (it carries into the high half)."""
    maxf = np.float32(jnum.fixed_max_float(iwl, 31 - iwl))
    above = np.nextafter(maxf, np.float32(np.inf))
    carry = np.float32(65535.5) * np.float32(2.0 ** -(31 - iwl))
    return np.array([0.0, -0.0, 2.0 ** iwl, -(2.0 ** iwl), maxf, -maxf,
                     above, -above, 1e30, -1e30, carry, -carry],
                    np.float32)


def encode_inputs(rng, iwl):
    """Values on the 8-bit grid of Q(iwl).(7-iwl), off-grid floats across
    the range, and the edge list."""
    grid = (rng.integers(-127, 128, 64) * 2.0 ** -(7 - iwl)).astype(
        np.float32)
    off = rng.normal(0.0, 2.0 ** iwl, 256).astype(np.float32)
    tiny = rng.normal(0.0, 1e-6, 32).astype(np.float32)
    return np.concatenate([grid, off, tiny, edge_values(iwl)])


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
@pytest.mark.parametrize("iwl", IWLS)
def test_encode_sign_magnitude_matches_jax(rng, iwl, mode):
    x = encode_inputs(rng, iwl)
    js, jm = jnum.encode_sign_magnitude(jnp.asarray(x),
                                        jnum.QFormat(iwl, 31 - iwl, mode))
    ts, tm = tnum.encode_sign_magnitude(torch.from_numpy(x),
                                        tnum.QFormat(iwl, 31 - iwl, mode))
    assert ts.dtype == tm.dtype == torch.int32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert ts[1] == 0                       # -0.0 has sign 0


@pytest.mark.parametrize("fmt", [(5, 2, 3), (2, 5, 1), (0, 31, 3),
                                 (5, 26, 0), (12, 14, 2)])
def test_decode_and_short_formats_match_jax(rng, fmt):
    """encode at short and mid widths (the direct and the split path),
    then decode."""
    iwl = fmt[0]
    x = np.concatenate([rng.normal(0.0, 2.0 ** iwl, 200),
                        [0.0, -0.0, 2.0 ** iwl, -(2.0 ** iwl), 1e30]]
                       ).astype(np.float32)
    js, jm = jnum.encode_sign_magnitude(jnp.asarray(x), jnum.QFormat(*fmt))
    ts, tm = tnum.encode_sign_magnitude(torch.from_numpy(x),
                                        tnum.QFormat(*fmt))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    want = jnum.decode_sign_magnitude(js, jm, jnum.QFormat(*fmt))
    got = tnum.decode_sign_magnitude(ts, tm, tnum.QFormat(*fmt))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("lo,hi", [(24, 30), (0, 30), (10, 17)])
def test_gray_code_matches_jax(rng, lo, hi):
    x = rng.integers(0, 2 ** 31 - 1, 500, dtype=np.int64).astype(np.int32)
    g = jnum.bin2gray(jnp.asarray(x), lo, hi)
    tg = tnum.bin2gray(torch.from_numpy(x), lo, hi)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(g))
    np.testing.assert_array_equal(
        tnum.gray2bin(tg, lo, hi).numpy(),
        np.asarray(jnum.gray2bin(g, lo, hi)))


def hamming_inputs(rng, iwl, B=5, M=6, D=12):
    """m, u around the format's range, with the last sample holding pairs
    whose preprocess wraps in int32 (same magnitudes past 2^30 with
    opposite signs), values at +-2^iwl and a zero."""
    m = rng.normal(0.0, 0.6 * 2.0 ** iwl, (B, M, D)).astype(np.float32)
    u = rng.normal(0.0, 0.6 * 2.0 ** iwl, (B, D)).astype(np.float32)
    big = np.float32(0.625 * 2.0 ** iwl)       # 0.625 + 0.53 > 1: wraps
    m[-1, :, :4] = big
    u[-1, :4] = -np.float32(0.53 * 2.0 ** iwl)
    m[-1, 0, 4], u[-1, 5], m[-1, 1, 6] = 2.0 ** iwl, -(2.0 ** iwl), 0.0
    return m, u


def test_wrapping_preprocess_pair_matches_jax():
    """At iwl 5, m=20 and u=-17: 20*2^26 + 17*2^26 overflows int32; the
    wrapped word carries a set sign bit into the sign comparison."""
    wm = jatt._encode_words(jnp.float32(20.0), 5, 3)
    wu = jatt._encode_words(jnp.float32(-17.0), 5, 3)
    jpm, jpu = jatt._common_mode_preprocess(wm, wu)
    twm = tatt._encode_words(torch.tensor(20.0), 5, 3)
    twu = tatt._encode_words(torch.tensor(-17.0), 5, 3)
    tpm, tpu = tatt._common_mode_preprocess(twm, twu)
    assert int(tpm) == int(jpm) and int(tpu) == int(jpu)
    assert int(tpm) < 0                      # the wrap set bit 31
    for nb in (8, 32):
        np.testing.assert_array_equal(
            tatt._weighted_similarity(tpm, tpu, nb).numpy(),
            np.asarray(jatt._weighted_similarity(jpm, jpu, nb)))


@pytest.mark.parametrize("round_mode", [3, 1])
@pytest.mark.parametrize("num_bit_attention", [None, 12])
@pytest.mark.parametrize("weight_para,weighted", [(0, True), (-1, True),
                                                  (0, False)])
@pytest.mark.parametrize("iwl", [0, 1, 5])
def test_hamming_forward_matches_jax_and_pallas(rng, iwl, weight_para,
                                                weighted, num_bit_attention,
                                                round_mode):
    """num_bit from the config: 8 at bw_wl 8, or num_bit_attention."""
    nb = QmannConfig(iwl=iwl,
                     num_bit_attention=num_bit_attention).num_bits_attention
    m, u = hamming_inputs(rng, iwl)
    args = (iwl, nb, -3, round_mode)
    want = np.asarray(jatt.hamming_score(jnp.asarray(m), jnp.asarray(u),
                                         *args, "jnp", weight_para, weighted))
    want_k = np.asarray(hamming_score_pallas(
        jnp.asarray(m), jnp.asarray(u), *args, interpret=True,
        weight_para=weight_para, weighted=weighted))
    got = tatt.hamming_score_reference(torch.from_numpy(m),
                                       torch.from_numpy(u), *args,
                                       weight_para, weighted).numpy()
    np.testing.assert_array_equal(want, want_k)
    np.testing.assert_array_equal(got, want)
    # the autograd op on both backends (the kernel's CPU route is the plain
    # version) and the dispatch of attention_score
    for backend in ("plain", "kernel"):
        out = tatt.hamming_score(torch.from_numpy(m), torch.from_numpy(u),
                                 *args, backend, weight_para, weighted)
        np.testing.assert_array_equal(out.numpy(), want)
    via = tatt.attention_score(
        torch.from_numpy(m), torch.from_numpy(u), 3,
        tnum.QFormat(iwl, 7 - iwl, round_mode), tnum.QFormat(iwl, 7 - iwl),
        num_bit=nb, hamming_weight_para=weight_para,
        hamming_weighted=weighted)
    np.testing.assert_array_equal(via.numpy(), want)


@pytest.mark.parametrize("iwl", [0, 1, 5])
def test_hamming_surrogate_matches_jax_grad(rng, iwl):
    m, u = hamming_inputs(rng, iwl)
    g = rng.normal(0.0, 1.0, m.shape[:2]).astype(np.float32)

    def jloss(m_, u_):
        return jnp.sum(jatt.hamming_score(m_, u_, iwl, 8, -3, 3) * g)

    jdm, jdu = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(m),
                                               jnp.asarray(u))
    tm = torch.from_numpy(m).requires_grad_()
    tu = torch.from_numpy(u).requires_grad_()
    loss = (tatt.hamming_score(tm, tu, iwl, 8, -3, 3)
            * torch.from_numpy(g)).sum()
    dm, du = torch.autograd.grad(loss, (tm, tu))
    np.testing.assert_array_equal(dm.numpy(), np.asarray(jdm))
    np.testing.assert_allclose(du.numpy(), np.asarray(jdu), rtol=1e-5,
                               atol=1e-6)
    assert np.abs(dm.numpy()).max() > 0 and np.abs(du.numpy()).max() > 0


@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_attention_score_modes_match_jax(rng, mode):
    fa, fb = (2, 5, 3), (2, 5, 3)
    m = rng.normal(0.0, 1.0, (4, 7, 10)).astype(np.float32)
    u = rng.normal(0.0, 1.0, (4, 10)).astype(np.float32)
    want = np.asarray(jatt.attention_score(
        jnp.asarray(m), jnp.asarray(u), mode, jnum.QFormat(*fa),
        jnum.QFormat(*fb)))
    got = tatt.attention_score(torch.from_numpy(m), torch.from_numpy(u),
                               mode, tnum.QFormat(*fa),
                               tnum.QFormat(*fb)).numpy()
    if mode == 1:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)
    if mode == 4:
        np.testing.assert_array_equal(
            tatt.binary_score(torch.from_numpy(m), torch.from_numpy(u)),
            np.asarray(jatt.binary_score(jnp.asarray(m), jnp.asarray(u))))


@pytest.mark.parametrize("iwl,num_bit", [(1, 8), (5, 8), (2, 12)])
def test_gray_hamming_score_matches_jax(rng, iwl, num_bit):
    m, u = hamming_inputs(rng, iwl)
    want = jatt.gray_hamming_score(jnp.asarray(m), jnp.asarray(u), iwl,
                                   num_bit)
    got = tatt.gray_hamming_score(torch.from_numpy(m), torch.from_numpy(u),
                                  iwl, num_bit)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_kernel_wrapper_on_cpu_never_builds(rng, monkeypatch):
    def no_build():
        raise AssertionError("the CPU path must not touch the CUDA build")
    monkeypatch.setattr(tham, "build", no_build)
    monkeypatch.setattr(tham, "load_library", no_build)
    m, u = (torch.from_numpy(a) for a in hamming_inputs(rng, 1))
    before = tham.hamming_score_kernel.launches
    got = tham.hamming_score_kernel(m, u, 1, 8)
    assert torch.equal(got, tham.hamming_score_reference(m, u, 1, 8))
    # other ranks take the plain version on every backend
    one = tatt.hamming_score(m[0], u[0], 1, 8, backend="kernel")
    assert torch.equal(one, got[0])
    assert tham.hamming_score_kernel.launches == before


@pytest.mark.parametrize("knobs", [dict(iwl=32), dict(iwl=-1),
                                   dict(num_bit=0), dict(num_bit=33),
                                   dict(const_scale=65),
                                   dict(weight_para=-33)])
def test_kernel_wrapper_range_checks(rng, knobs):
    m, u = (torch.from_numpy(a) for a in hamming_inputs(rng, 1))
    kw = dict(iwl=1, num_bit=8, const_scale=-3, weight_para=0)
    kw.update(knobs)
    with pytest.raises(ValueError, match="num_bit in"):
        tham.hamming_score_kernel(m, u, **kw)
