"""The hand-written CUDA kernels against their plain PyTorch versions, both
on the card.  Without a card these tests skip.

This file imports no jax, so that it runs on a machine with a GPU and no
jax; tests/conftest.py imports jax, so skip it there:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances (as tests/test_torch_chain.py): hop 0's scores bit-identical,
p within atol 1e-6, at most one query with a flipped Q(p, act) requant,
and every other query bit-identical in all scores and in u_final.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qmann_tpu_torch.config import QmannConfig  # noqa: E402
from qmann_tpu_torch.data import synthetic_batch  # noqa: E402
from qmann_tpu_torch.models import memn2n  # noqa: E402
from qmann_tpu_torch.numerics import float_quant  # noqa: E402
from qmann_tpu_torch.ops import exact_matmul  # noqa: E402
from qmann_tpu_torch.ops.cuda import hop_chain  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _chain_args(cfg, V, M, W, B, dev, seed=0):
    """The chain's inputs as forward_prepared makes them: synthetic
    qa1-shaped stories, seeded weights x4, the exact GEMMs."""
    dims, mem, que, mask = synthetic_batch(np.random.default_rng(seed), B,
                                           V, M, W)
    params = {k: 4.0 * v.to(dev) for k, v in memn2n.init_params(
        cfg, dims, torch.Generator().manual_seed(seed)).items()}
    prep = memn2n.prepare_inference(params, cfg, max_count=float(W + 1),
                                    max_rowsum=float(W + 1))
    assert prep.fast
    mem_t, que_t, mask_t = (torch.from_numpy(a).to(dev)
                            for a in (mem, que, mask))
    flat = exact_matmul(mem_t, prep.embed_wt)
    u = float_quant(exact_matmul(que_t, prep.query_wt), cfg.fmt_w[0])
    return (flat, u, prep.hmats, mask_t, cfg.fmt_w, cfg.fmt_att,
            cfg.fmt_bin, cfg.fmt_act)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"type_weight_tying": 1},
                                {"en_linear_mapping": False,
                                 "en_non_linearity": True}])
@pytest.mark.parametrize("V,M,W", [(19, 10, 6), (64, 50, 7)])
def test_chain_kernel_matches_plain(cuda, V, M, W, kw):
    cfg = QmannConfig(use_fused_chain=True, **kw)
    args = _chain_args(cfg, V, M, W, 1000, cuda)
    flags = dict(linear_mapping=cfg.en_linear_mapping,
                 non_linearity=cfg.en_non_linearity)
    before = hop_chain.fused_hop_chain.launches
    u_g, p_g, s_g = hop_chain.fused_hop_chain(*args, **flags)
    u_w, p_w, s_w = hop_chain.fused_hop_chain_reference(*args, **flags)
    torch.cuda.synchronize()
    assert hop_chain.fused_hop_chain.launches == before + 1
    assert torch.equal(s_g[0], s_w[0])
    torch.testing.assert_close(p_g, p_w, rtol=0, atol=1e-6)
    flipped = torch.zeros(u_g.shape[0], dtype=torch.bool, device=cuda)
    for h, fmt in enumerate(cfg.fmt_act):
        flipped |= (float_quant(p_g[h], fmt) != float_quant(p_w[h], fmt)).any(-1)
    assert int(flipped.sum()) <= 1
    assert torch.equal(s_g[:, ~flipped], s_w[:, ~flipped])
    assert torch.equal(u_g[~flipped], u_w[~flipped])


@pytest.mark.cuda
def test_chain_kernel_rejects_what_it_cannot_take(cuda):
    cfg = QmannConfig(use_fused_chain=True)
    args = list(_chain_args(cfg, 19, 10, 6, 8, cuda))
    with pytest.raises(ValueError, match="bounds"):
        hop_chain.fused_hop_chain(
            torch.zeros((8, 65, 360), device=cuda), args[1], args[2],
            torch.ones((8, 65), device=cuda), *args[4:])
    with pytest.raises(ValueError, match="shapes"):
        hop_chain.fused_hop_chain(args[0][:, :, :300], *args[1:])
    with pytest.raises(TypeError, match="float32"):
        hop_chain.fused_hop_chain(args[0].double(), *args[1:])
