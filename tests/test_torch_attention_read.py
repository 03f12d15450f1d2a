"""The attention read's plain PyTorch version against JAX's
fused_attention_read_pallas (interpret mode), and the wrapper's CPU
dispatch.  The CUDA kernel against the plain version is
tests/test_torch_cuda.py.

Tolerances.  Modes 2 and 3: the scores sit on an exact grid (the lattice,
or the Hamming terms) and are bit-identical; p within atol 1e-6, because
exp and the softmax sum differ by an ulp between torch and XLA; o
bit-identical in every query where no Q(p, act) requant flipped, and at
most one query may flip.  Mode 1 (float dot and float weighted sum, summed
in another order): rtol 1e-5, atol 1e-6.  The mode-3 fused op's gradients
against JAX's: rtol 1e-5, atol 1e-6 (the softmax and weighted-sum
backwards sum in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qmann_tpu.numerics import QFormat as JQ  # noqa: E402
from qmann_tpu.ops.fused import fused_attention_read as j_fused  # noqa: E402
from qmann_tpu.ops.pallas.qkernels import (  # noqa: E402
    fused_attention_read_pallas,
)
from qmann_tpu_torch.numerics import QFormat, float_quant  # noqa: E402
from qmann_tpu_torch.ops.cuda import attention_read as ar  # noqa: E402
from qmann_tpu_torch.ops.fused import fused_attention_read  # noqa: E402


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


def _both(m, c, u, mask, fmts, quantized, mode=None):
    fa, fb, fc = fmts
    mode = mode or (2 if quantized else 1)
    want = fused_attention_read_pallas(
        jnp.asarray(m), jnp.asarray(c), jnp.asarray(u), jnp.asarray(mask),
        JQ(*fa), JQ(*fb), JQ(*fc), score_quantized=mode == 2,
        sum_quantized=quantized, interpret=True, attention_mode=mode)
    got = ar.fused_read_reference(
        torch.from_numpy(m), torch.from_numpy(c), torch.from_numpy(u),
        torch.from_numpy(mask).to(torch.float32), QFormat(*fa), QFormat(*fb),
        QFormat(*fc), score_quantized=mode == 2, sum_quantized=quantized,
        attention_mode=mode)
    return [np.array(a) for a in want], [t.numpy() for t in got]


def _check_quantized(want, got, fc):
    """The module docstring's mode-2/3 tolerances."""
    (o_w, p_w, s_w), (o_g, p_g, s_g) = want, got
    np.testing.assert_array_equal(s_g, s_w)
    np.testing.assert_allclose(p_g, p_w, rtol=0, atol=1e-6)
    flipped = (float_quant(torch.from_numpy(p_g), fc).numpy()
               != float_quant(torch.from_numpy(p_w), fc).numpy()).any(-1)
    assert flipped.sum() <= 1
    np.testing.assert_array_equal(o_g[~flipped], o_w[~flipped])
    # no live row: p = 0 and o = Q(0), never NaN
    assert (p_g[-2:] == 0).all() and np.isfinite(o_g).all()
    np.testing.assert_array_equal(
        o_g[-2:], float_quant(torch.zeros(o_g[-2:].shape), fc).numpy())


@pytest.mark.parametrize("fmts", [((5, 2), (5, 2), (5, 2)),
                                  ((2, 5), (2, 5), (2, 5)),
                                  ((5, 2), (5, 2), (0, 0))])
@pytest.mark.parametrize("B,M,D", [(7, 6, 10), (12, 10, 60)])
def test_mode2_plain_matches_pallas_kernel(rng, fmts, B, M, D):
    m, c, u, mask = _inputs(rng, B, M, D, QFormat(6, 1))
    want, got = _both(m, c, u, mask, fmts, True)
    _check_quantized(want, got, QFormat(*fmts[2]))


@pytest.mark.parametrize("fmt", [(2, 5), (5, 2), (1, 6), (0, 7)])
@pytest.mark.parametrize("B,M,D", [(7, 6, 10), (12, 10, 60)])
def test_mode3_plain_matches_pallas_kernel(rng, fmt, B, M, D):
    """The Hamming score on the raw m and u (the embeddings at the
    format's own grid, with values past its range), the default knobs."""
    m, c, u, mask = _inputs(rng, B, M, D, QFormat(*fmt), sd=0.8 * 2 ** fmt[0])
    want, got = _both(m, c, u, mask, (fmt,) * 3, True, mode=3)
    _check_quantized(want, got, QFormat(*fmt))


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
    """Mode 3 raises on knobs outside the Hamming kernel's ranges, on
    every device; a mode the read does not cover raises too."""
    m, c, u, mask = (torch.from_numpy(a) for a in _inputs(rng, 3, 4, 6))
    fmt = QFormat(2, 5)
    for fn in (ar.fused_read, ar.fused_read_reference):
        for knobs in (dict(ham_num_bit=0), dict(ham_num_bit=33),
                      dict(ham_weight_para=40)):
            with pytest.raises(ValueError, match="num_bit in"):
                fn(m, c, u, mask, fmt, fmt, fmt, attention_mode=3, **knobs)
        with pytest.raises(ValueError, match="modes 1, 2 and 3"):
            fn(m, c, u, mask, fmt, fmt, fmt, attention_mode=4)


@pytest.mark.parametrize("sum_gq,used", [(False, None), (True, None),
                                         (True, (0,)), (False, (0, 2))])
@pytest.mark.parametrize("fmt", [(1, 6), (5, 2)])
def test_mode3_fused_grads_match_jax(rng, fmt, sum_gq, used):
    """d/d(m, c, u) of sum_k sum(out_k * ct_k) over the outputs in
    ``used`` (all by default; torch hands the backward None for the
    others): the weighted-sum backward (quantized contractions under
    sum_grad_quantized), the softmax backward, the Hamming surrogate."""
    B, M, D = 6, 5, 8
    m, c, u, mask = _inputs(rng, B, M, D, sd=0.8 * 2 ** fmt[0])
    mask_f = mask.astype(np.float32)
    kw = dict(score_quantized=False, sum_quantized=True, attention_mode=3,
              sum_grad_quantized=sum_gq)
    outs = jax.eval_shape(
        lambda: j_fused(jnp.asarray(m), jnp.asarray(c), jnp.asarray(u),
                        jnp.asarray(mask_f), JQ(*fmt), JQ(*fmt), JQ(*fmt),
                        interpret=True, **kw))
    used = range(3) if used is None else used
    cts = {k: rng.normal(0.0, 1.0, outs[k].shape).astype(np.float32)
           for k in used}

    def jloss(m_, c_, u_):
        out = j_fused(m_, c_, u_, jnp.asarray(mask_f), JQ(*fmt), JQ(*fmt),
                      JQ(*fmt), interpret=True, **kw)
        return sum(jnp.sum(out[k] * cts[k]) for k in used)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(m), jnp.asarray(c), jnp.asarray(u))
    tin = [torch.tensor(a, requires_grad=True) for a in (m, c, u)]
    out = fused_attention_read(*tin, torch.from_numpy(mask_f),
                               QFormat(*fmt), QFormat(*fmt), QFormat(*fmt),
                               **kw)
    loss = sum((out[k] * torch.from_numpy(cts[k])).sum() for k in used)
    got = torch.autograd.grad(loss, tin)
    for g, w, name in zip(got, want, ("dm", "dc", "du")):
        g, w = g.numpy(), np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=name)
        assert np.isfinite(g).all()
    assert np.abs(got[0].numpy()).max() > 0     # the surrogate reaches m


def _assert_geometry_covers(geo, B, M, D, smem_bytes):
    """The blocks cover each query once; one block's score rounds give
    each (query, row) G lanes of one warp that cover its D columns once;
    its weighted sum's (row group, column) pairs cover each (row, column)
    once; the partial sums fit the kernel's buffer of one float per
    thread; shared memory fits the 227 KB a block may take, opted in
    exactly above 48 KB."""
    from qmann_tpu_torch.ops.cuda import geometry
    qpb, T, G, R = (geo.queries_per_block, geo.threads, geo.lanes_per_row,
                    geo.row_groups)
    assert (geo.blocks - 1) * qpb < B <= geo.blocks * qpb
    assert T % 32 == 0 and 32 <= T <= geometry.MAX_THREADS
    assert G in (1, 2, 4, 8, 16, 32) and 1 <= R <= M
    assert R == 1 or R * qpb * D <= T
    assert geo.smem_bytes == smem_bytes(qpb, T) <= geometry.SMEM_LIMIT
    assert geo.opt_in == (geo.smem_bytes > 48 * 1024)
    for nq in {min(qpb, B), B - (geo.blocks - 1) * qpb}:
        rows = nq * M
        cols = np.zeros((rows, D), np.int64)
        for t in range(-(-rows * G // T) * T):
            task, g = divmod(t, G)
            if task < rows:
                assert (t % 32) // G == (t % 32 - g) // G   # one warp
                cols[task, g::G] += 1
        assert (cols == 1).all()
        cover = np.zeros((M, nq * D), np.int64)
        for t in range(nq * D * R):
            rg, col = divmod(t, nq * D)
            cover[rg::R, col] += 1
        assert (cover == 1).all()


@pytest.mark.parametrize("M", [1, 10, 50, 64])
@pytest.mark.parametrize("D", [1, 60, 256])
def test_read_and_hamming_geometry_cover_every_query_and_row(M, D):
    from qmann_tpu_torch.ops.cuda import hamming as ham
    for B in (1, 7, 32, 33, 1024, 1025):
        _assert_geometry_covers(
            ar.read_geometry(B, M, D), B, M, D,
            lambda qpb, t: ar.read_smem_bytes(qpb, M, D, t))
        _assert_geometry_covers(
            ham.hamming_geometry(B, M, D), B, M, D,
            lambda qpb, _: ham.hamming_smem_bytes(qpb, M, D))


def test_geometry_rule_at_the_training_shapes():
    """The sweep's choices (PERF.md, section 6): one query per 256-thread
    block at B=32 (512 threads at M=50), two queries per 256-thread block
    at the B=1024 eval chunk."""
    g = ar.read_geometry(32, 10, 60)
    assert (g.queries_per_block, g.threads, g.blocks) == (1, 256, 32)
    g = ar.read_geometry(32, 50, 60)
    assert (g.queries_per_block, g.threads) == (1, 512)
    g = ar.read_geometry(1024, 10, 60)
    assert (g.queries_per_block, g.threads, g.blocks) == (2, 256, 512)
