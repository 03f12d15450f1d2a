"""The attention read's plain PyTorch version against JAX's
fused_attention_read_pallas (interpret mode), and the wrapper's CPU
dispatch.  The CUDA kernel against the plain version is
tests/test_torch_cuda.py.

Tolerances.  Mode 2: the scores sit on the exact lattice and are
bit-identical; p within atol 1e-6, because exp and the softmax sum differ
by an ulp between torch and XLA; o bit-identical in every query where no
Q(p, act) requant flipped, and at most one query may flip.  Mode 1 (float
dot and float weighted sum, summed in another order): rtol 1e-5,
atol 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from qmann_tpu.numerics import QFormat as JQ  # noqa: E402
from qmann_tpu.ops.pallas.qkernels import (  # noqa: E402
    fused_attention_read_pallas,
)
from qmann_tpu_torch.numerics import QFormat, float_quant  # noqa: E402
from qmann_tpu_torch.ops.cuda import attention_read as ar  # noqa: E402


def _inputs(rng, B, M, D, fmt_w=None, sd=1.5):
    """m, c, u as the model gives them (embeddings quantized at the hop's
    weight format when fmt_w is given), a partial mask, and the last two
    samples with no live row (the padded samples of a partial batch)."""
    m = rng.normal(0.0, sd, (B, M, D)).astype(np.float32)
    c = rng.normal(0.0, sd, (B, M, D)).astype(np.float32)
    u = rng.normal(0.0, sd, (B, D)).astype(np.float32)
    if fmt_w is not None:
        m, c, u = (float_quant(torch.from_numpy(a), fmt_w).numpy()
                   for a in (m, c, u))
    mask = np.arange(M)[None, :] < rng.integers(1, M + 1, B)[:, None]
    mask[-2:] = False
    return m, c, u, mask


def _both(m, c, u, mask, fmts, quantized):
    fa, fb, fc = fmts
    want = fused_attention_read_pallas(
        jnp.asarray(m), jnp.asarray(c), jnp.asarray(u), jnp.asarray(mask),
        JQ(*fa), JQ(*fb), JQ(*fc), score_quantized=quantized,
        sum_quantized=quantized, interpret=True)
    got = ar.fused_read_reference(
        torch.from_numpy(m), torch.from_numpy(c), torch.from_numpy(u),
        torch.from_numpy(mask).to(torch.float32), QFormat(*fa), QFormat(*fb),
        QFormat(*fc), score_quantized=quantized, sum_quantized=quantized,
        attention_mode=2 if quantized else 1)
    return [np.array(a) for a in want], [t.numpy() for t in got]


@pytest.mark.parametrize("fmts", [((5, 2), (5, 2), (5, 2)),
                                  ((2, 5), (2, 5), (2, 5)),
                                  ((5, 2), (5, 2), (0, 0))])
@pytest.mark.parametrize("B,M,D", [(7, 6, 10), (12, 10, 60)])
def test_mode2_plain_matches_pallas_kernel(rng, fmts, B, M, D):
    m, c, u, mask = _inputs(rng, B, M, D, QFormat(6, 1))
    (o_w, p_w, s_w), (o_g, p_g, s_g) = _both(m, c, u, mask, fmts, True)
    np.testing.assert_array_equal(s_g, s_w)
    np.testing.assert_allclose(p_g, p_w, rtol=0, atol=1e-6)
    fc = QFormat(*fmts[2])
    flipped = (float_quant(torch.from_numpy(p_g), fc).numpy()
               != float_quant(torch.from_numpy(p_w), fc).numpy()).any(-1)
    assert flipped.sum() <= 1
    np.testing.assert_array_equal(o_g[~flipped], o_w[~flipped])
    # no live row: p = 0 and o = Q(0), never NaN
    assert (p_g[-2:] == 0).all() and np.isfinite(o_g).all()
    np.testing.assert_array_equal(
        o_g[-2:], float_quant(torch.zeros(o_g[-2:].shape), fc).numpy())


@pytest.mark.parametrize("B,M,D", [(7, 6, 10), (12, 10, 60)])
def test_mode1_plain_matches_pallas_kernel(rng, B, M, D):
    """Float embeddings of sd 0.5 (scores of a few units, as a float model
    gives them: the softmax turns a score's float32 rounding into p's
    relative error times the score)."""
    m, c, u, mask = _inputs(rng, B, M, D, sd=0.5)
    want, got = _both(m, c, u, mask, ((5, 2),) * 3, False)
    for g, w, name in zip(got, want, ("o", "p", "scores")):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=name)
    assert (got[1][-2:] == 0).all() and (got[0][-2:] == 0).all()


def test_wrapper_on_cpu_never_builds(rng, monkeypatch):
    def no_build():
        raise AssertionError("the CPU path must not touch the CUDA build")
    monkeypatch.setattr(ar, "build", no_build)
    monkeypatch.setattr(ar, "load_library", no_build)
    m, c, u, mask = (torch.from_numpy(a) for a in _inputs(rng, 5, 4, 6))
    fmt = QFormat(5, 2)
    before = ar.fused_read.launches
    got = ar.fused_read(m, c, u, mask, fmt, fmt, fmt)
    want = ar.fused_read_reference(m, c, u, mask, fmt, fmt, fmt)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert ar.fused_read.launches == before


def test_mode_3_raises(rng):
    m, c, u, mask = (torch.from_numpy(a) for a in _inputs(rng, 3, 4, 6))
    fmt = QFormat(2, 5)
    for fn in (ar.fused_read, ar.fused_read_reference):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fn(m, c, u, mask, fmt, fmt, fmt, attention_mode=3)
