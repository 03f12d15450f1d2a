"""The serving slice end to end: prepare_inference + forward_prepared (and
the unfused forward) of the port against the JAX package on the same
weights and inputs.

Tolerances: logits rtol=atol=1e-5, because the float output product sums
in another order than XLA's; predictions (argmax_last) exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qmann_tpu.config import QmannConfig as JaxConfig  # noqa: E402
from qmann_tpu.models import memn2n as jmodel  # noqa: E402
from qmann_tpu.ops import argmax_last as j_argmax_last  # noqa: E402
from qmann_tpu_torch.config import QmannConfig  # noqa: E402
from qmann_tpu_torch.data import DataDims, synthetic_batch  # noqa: E402
from qmann_tpu_torch.models import memn2n  # noqa: E402
from qmann_tpu_torch.ops import argmax_last  # noqa: E402

V, M, W = 19, 10, 6   # qa1 shape: dictionary, memory rows, words per row


def qa1_batch(B, seed):
    """Synthetic qa1-shaped stories with partial masks."""
    return synthetic_batch(np.random.default_rng(seed), B, V, M, W)


def jax_params(cfg_kw, dims, seed=0, scale=4.0):
    """JAX init_params scaled x4: unscaled N(0, 0.1) weights quantize to
    almost nothing at Q5.2, and x4 keeps the exact-GEMM bounds."""
    p = jmodel.init_params(JaxConfig(**cfg_kw), dims, jax.random.PRNGKey(seed))
    return {k: np.asarray(v) * np.float32(scale) for k, v in p.items()}


def _compare(cfg_kw, B, seed, prepared=True, expect_fast=None):
    from jax.experimental.pallas import tpu as pltpu
    dims, mem, que, mask = qa1_batch(B, seed)
    jcfg, tcfg = JaxConfig(**cfg_kw), QmannConfig(**cfg_kw)
    pj = jax_params(cfg_kw, dims, seed)
    pt = memn2n.params_from_jax(pj, tcfg, device="cpu")
    bounds = dict(max_count=float(mem.max()),
                  max_rowsum=float(mem.sum(-1).max()))
    targs = (torch.from_numpy(mem), torch.from_numpy(que),
             torch.from_numpy(mask))
    jargs = tuple(jnp.asarray(a) for a in (mem, que, mask))
    if prepared:
        jprep = jmodel.prepare_inference(
            {k: jnp.asarray(v) for k, v in pj.items()}, jcfg, **bounds)
        tprep = memn2n.prepare_inference(pt, tcfg, **bounds)
        assert tprep.fast == jprep.fast
        if expect_fast is not None:
            assert tprep.fast == expect_fast
        with pltpu.force_tpu_interpret_mode():
            want = jmodel.forward_prepared(jprep, *jargs, jcfg)
        got = memn2n.forward_prepared(tprep, *targs, tcfg)
    else:
        want = jmodel.forward({k: jnp.asarray(v) for k, v in pj.items()},
                              *jargs, jcfg)
        got = memn2n.forward(pt, *targs, tcfg)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(argmax_last(got.logits).numpy(),
                                  np.asarray(j_argmax_last(want.logits)))
    # hop 0's scores sit on the exact lattice before any softmax
    np.testing.assert_array_equal(got.scores[0].numpy(),
                                  np.asarray(want.scores[0]))
    assert np.isfinite(got.logits.numpy()).all()
    return got


@pytest.mark.parametrize("chain", [True, False])
@pytest.mark.parametrize("dim_emb,B", [(16, 33), (60, 16)])
def test_forward_prepared_matches_jax(dim_emb, B, chain):
    """The flagship config (mode 2, Q5.2 with EN_MQ, 3 hops, layer-wise
    tying, linear map) on the chain route and the unfused route."""
    _compare(dict(dim_emb=dim_emb, use_fused_chain=chain, verbose=False),
             B, seed=dim_emb + B, expect_fast=True)


@pytest.mark.parametrize("iwl", [0, 1])
def test_low_bit_falls_back_to_forward(iwl):
    """iwl 0/1 formats break the exact-GEMM bounds: prepare_inference
    returns fast=False on both sides and forward_prepared takes forward."""
    _compare(dict(dim_emb=16, iwl=iwl, use_fused_chain=True, verbose=False),
             24, seed=iwl, expect_fast=False)


@pytest.mark.parametrize("kw", [dict(type_weight_tying=1,
                                     en_non_linearity=True),
                                dict(attention_mode=1)])
def test_forward_matches_jax(kw):
    """The unfused forward (iwl 0/1 reach it through the fallback above)."""
    _compare(dict(dim_emb=16, verbose=False, **kw), 20, seed=7,
             prepared=False)


def test_chain_and_unfused_routes_agree():
    """Inside the port, the chain route and the unfused route of
    forward_prepared give the same answers on the same batch."""
    kw = dict(dim_emb=16, verbose=False)
    dims, mem, que, mask = qa1_batch(40, 3)
    pt = memn2n.params_from_jax(jax_params(kw, dims, 3), QmannConfig(**kw),
                                device="cpu")
    args = (torch.from_numpy(mem), torch.from_numpy(que),
            torch.from_numpy(mask))
    outs = []
    for chain in (True, False):
        cfg = QmannConfig(use_fused_chain=chain, **kw)
        prep = memn2n.prepare_inference(pt, cfg, max_count=8.0,
                                        max_rowsum=8.0)
        assert prep.fast
        outs.append(memn2n.forward_prepared(prep, *args, cfg))
    torch.testing.assert_close(outs[0].logits, outs[1].logits, rtol=0, atol=0)
    torch.testing.assert_close(outs[0].scores, outs[1].scores, rtol=0, atol=0)


def test_params_round_trip_and_checks():
    kw = dict(dim_emb=8, verbose=False)
    dims = DataDims(V, M, W, W + 1, V + M)
    for tying in (1, 2):
        cfg_kw = dict(kw, type_weight_tying=tying)
        pj = jax_params(cfg_kw, dims, scale=1.0)
        pt = memn2n.params_from_jax(pj, QmannConfig(**cfg_kw), device="cpu")
        back = memn2n.params_to_jax(pt)
        assert set(back) == set(pj)
        for k in pj:
            np.testing.assert_array_equal(back[k], pj[k])
    pj = jax_params(kw, dims, scale=1.0)
    with pytest.raises(ValueError, match="keys"):
        memn2n.params_from_jax({k: v for k, v in pj.items() if k != "H"},
                               QmannConfig(**kw), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        memn2n.params_from_jax(dict(pj, W=pj["W"][:, :4]), QmannConfig(**kw),
                               device="cpu")
    with pytest.raises(ValueError, match="keys"):
        memn2n.params_from_jax(pj, QmannConfig(type_weight_tying=1, **kw),
                               device="cpu")


def test_init_params_layout():
    cfg = QmannConfig(dim_emb=8, verbose=False)
    dims = DataDims(V, M, W, W + 1, V + M)
    p = memn2n.init_params(cfg, dims, torch.Generator().manual_seed(0),
                           device="cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        memn2n.param_shapes(cfg, dims.dim_input)
    again = memn2n.init_params(cfg, dims, torch.Generator().manual_seed(0),
                               device="cpu")
    for k in p:
        assert torch.equal(p[k], again[k])
    assert 0.05 < float(p["A"].std()) < 0.15


@pytest.mark.parametrize("kw", [dict(en_att_clip=True), dict(en_sc_att=True),
                                dict(en_shift_based_sm=True),
                                dict(en_exp_table_based=True),
                                dict(en_cosine_sim=True),
                                dict(test_maxout=True),
                                dict(en_att_shift=True)])
def test_feature_head_forward_matches_jax(kw):
    """Each feature head's forward, and prepare_inference +
    forward_prepared with use_fused_chain, against JAX.  A feature head is
    outside the chain's envelope on both sides, so the prepared forward
    takes the unfused hops after the exact GEMMs (the scale and maxout
    weights ride along in the prepared raw params)."""
    cfg_kw = dict(dim_emb=8, verbose=False, use_fused_chain=True, **kw)
    _compare(cfg_kw, 12, seed=5, prepared=False)
    got = _compare(cfg_kw, 12, seed=5)
    assert got.attention.shape == (3, 12, M)


def test_cross_entropy_and_argmax_last_match_jax(rng):
    """Metrics of the output layer, with ties in the logits (the
    prediction takes the last maximal index)."""
    from qmann_tpu.ops import cross_entropy as j_cross_entropy
    from qmann_tpu_torch.ops import cross_entropy
    logits = rng.integers(-3, 4, (64, 29)).astype(np.float32) * 0.5
    logits[:8] = 1.0                                      # all tied
    ans = np.zeros((64, 29), np.float32)
    ans[np.arange(64), rng.integers(0, 29, 64)] = 1.0
    ans[:8, 28] = 1.0
    ans[:8, :28] = 0.0
    want = j_cross_entropy(jnp.asarray(logits), jnp.asarray(ans))
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(ans))
    np.testing.assert_array_equal(got.pred.numpy(), np.asarray(want.pred))
    assert (got.pred[:8] == 28).all()
    assert int(got.matches) == int(want.matches)
    np.testing.assert_allclose(float(got.loss), float(want.loss), rtol=1e-5)
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=1e-5)
