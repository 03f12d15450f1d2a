"""The chain's plain PyTorch version against JAX's fused_hop_chain_pallas
(interpret mode), and the wrapper's CPU dispatch.  The CUDA kernel against
the plain version is tests/test_torch_cuda.py.

Tolerances: every lattice sum is exact, so hop 0's scores are
bit-identical.  The softmax's exp differs by an ulp between torch and XLA,
so p is held to atol 1e-6; a later hop can then differ only where a
Q(p, act) requant flipped, and every query without such a flip must match
bit for bit in all scores and in u_final.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from qmann_tpu_torch.config import QmannConfig  # noqa: E402
from qmann_tpu_torch.numerics import float_quant  # noqa: E402
from qmann_tpu_torch.ops.cuda import hop_chain  # noqa: E402


def _chain_inputs(rng, tying, B=7, M=5, D=8, K=3, I=17, scale=0.6):
    """flat = counts @ raw weights (the raw stacked GEMM), u quantized at
    fmt_w[0], Gaussian weights of sd 0.6 (N(0, 0.1) x 6: unscaled weights
    quantize to almost nothing at Q5.2), partial masks."""
    cfg = QmannConfig(dim_emb=D, num_hops=K)
    mem = rng.integers(0, 3, (B, M, I)).astype(np.float32)
    n_sen = rng.integers(1, M + 1, B)
    mask = np.arange(M)[None, :] < n_sen[:, None]
    mem *= mask[:, :, None]
    emb = rng.normal(0.0, scale, (I, 2 * K * D)).astype(np.float32)
    flat = np.einsum("bmi,ie->bme", mem, emb).astype(np.float32)
    que = rng.integers(0, 3, (B, I)).astype(np.float32)
    u_raw = que @ rng.normal(0.0, scale, (I, D)).astype(np.float32)
    u = float_quant(torch.from_numpy(u_raw), cfg.fmt_w[0]).numpy()
    if tying == 1:
        hm = rng.normal(0.0, scale, (K, D, D)).astype(np.float32)
    else:
        hm = np.broadcast_to(rng.normal(0.0, scale, (D, D)).astype(np.float32),
                             (K, D, D)).copy()
    return cfg, flat, u, hm, mask


def _run_both(cfg, flat, u, hm, mask, linmap, relu):
    from jax.experimental.pallas import tpu as pltpu
    from qmann_tpu.config import QmannConfig as JaxConfig
    from qmann_tpu.ops.pallas.qkernels import fused_hop_chain_pallas
    jcfg = JaxConfig(dim_emb=cfg.dim_emb, num_hops=cfg.num_hops)
    with pltpu.force_tpu_interpret_mode():
        want = fused_hop_chain_pallas(
            jnp.asarray(flat), jnp.asarray(u), jnp.asarray(hm),
            jnp.asarray(mask), jcfg.fmt_w, jcfg.fmt_att, jcfg.fmt_bin,
            jcfg.fmt_act, linear_mapping=linmap, non_linearity=relu)
    got = hop_chain.fused_hop_chain_reference(
        torch.from_numpy(flat), torch.from_numpy(u), torch.from_numpy(hm),
        torch.from_numpy(mask), cfg.fmt_w, cfg.fmt_att, cfg.fmt_bin,
        cfg.fmt_act, linear_mapping=linmap, non_linearity=relu)
    return ([np.array(a) for a in want], [t.numpy() for t in got])


def _check_chain(cfg, want, got, B):
    """Apply the module docstring's tolerances; returns the flip count."""
    (u_w, p_w, s_w), (u_g, p_g, s_g) = want, got
    np.testing.assert_array_equal(s_g[0], s_w[0])
    np.testing.assert_allclose(p_g, p_w, rtol=0, atol=1e-6)
    flipped = np.zeros(B, bool)
    for h, fmt in enumerate(cfg.fmt_act):
        qw = float_quant(torch.from_numpy(p_w[h]), fmt).numpy()
        qg = float_quant(torch.from_numpy(p_g[h]), fmt).numpy()
        flipped |= (qw != qg).any(-1)
    ok = ~flipped
    np.testing.assert_array_equal(s_g[:, ok], s_w[:, ok])
    np.testing.assert_array_equal(u_g[ok], u_w[ok])
    return int(flipped.sum())


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("linmap", [True, False])
@pytest.mark.parametrize("tying", [1, 2])
def test_chain_reference_matches_jax_kernel(rng, tying, linmap, relu):
    B = 7  # not a multiple of any tile
    cfg, flat, u, hm, mask = _chain_inputs(rng, tying, B=B)
    want, got = _run_both(cfg, flat, u, hm, mask, linmap, relu)
    flips = _check_chain(cfg, want, got, B)
    print(f"queries with a flipped Q(p, act): {flips} of {B}")
    assert flips <= 1


def test_wrapper_on_cpu_never_builds(rng, monkeypatch):
    def no_build():
        raise AssertionError("the CPU path must not touch the CUDA build")
    monkeypatch.setattr(hop_chain, "build", no_build)
    monkeypatch.setattr(hop_chain, "load_library", no_build)
    cfg, flat, u, hm, mask = _chain_inputs(rng, 2)
    args = (torch.from_numpy(flat), torch.from_numpy(u), torch.from_numpy(hm),
            torch.from_numpy(mask), cfg.fmt_w, cfg.fmt_att, cfg.fmt_bin,
            cfg.fmt_act)
    before = hop_chain.fused_hop_chain.launches
    got = hop_chain.fused_hop_chain(*args)
    want = hop_chain.fused_hop_chain_reference(*args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert hop_chain.fused_hop_chain.launches == before


def test_wrapper_raises_on_mode_3(rng):
    cfg, flat, u, hm, mask = _chain_inputs(rng, 2)
    with pytest.raises(NotImplementedError, match="mode 2"):
        hop_chain.fused_hop_chain(
            torch.from_numpy(flat), torch.from_numpy(u), torch.from_numpy(hm),
            torch.from_numpy(mask), cfg.fmt_w, cfg.fmt_att, cfg.fmt_bin,
            cfg.fmt_act, attention_mode=3)
