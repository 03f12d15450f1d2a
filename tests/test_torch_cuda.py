"""The hand-written CUDA kernels against their plain PyTorch versions, both
on the card.  Without a card these tests skip.

This file imports no jax, so that it runs on a machine with a GPU and no
jax; tests/conftest.py imports jax, so skip it there:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances.  Chain (as tests/test_torch_chain.py): hop 0's scores
bit-identical, p within atol 1e-6, at most one query with a flipped
Q(p, act) requant, and every other query bit-identical in all scores and in
u_final.  qmatvec: bit-identical (exact lattice sums).  Mode-2 attention
read: scores bit-identical, p within atol 1e-6, o bit-identical but for at
most one flipped query.  Mode-1 read: rtol 1e-5, atol 1e-6 (float sums in
another order).  One SGD step, kernel route against plain route: rtol 1e-5,
atol 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qmann_tpu_torch.config import QmannConfig  # noqa: E402
from qmann_tpu_torch.data import synthetic_batch  # noqa: E402
from qmann_tpu_torch.models import memn2n  # noqa: E402
from qmann_tpu_torch.numerics import float_quant  # noqa: E402
from qmann_tpu_torch.ops import exact_matmul  # noqa: E402
from qmann_tpu_torch.numerics import QFormat  # noqa: E402
from qmann_tpu_torch.ops.cuda import attention_read as ar  # noqa: E402
from qmann_tpu_torch.ops.cuda import hop_chain  # noqa: E402
from qmann_tpu_torch.ops.cuda import qmatvec as qmv  # noqa: E402
from qmann_tpu_torch.ops.qlinear import (  # noqa: E402
    qembed_mat_forward, qmatvec_forward,
)


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
    params = {k: 4.0 * v for k, v in memn2n.init_params(
        cfg, dims, torch.Generator().manual_seed(seed), device=dev).items()}
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


def _training_inputs(V, M, W, B, dev, seed=0):
    """The flagship training layout with weights x4; the last three samples
    have no live row, as the padded samples of a partial batch."""
    cfg = QmannConfig(use_pallas=True)
    dims, mem, que, mask = synthetic_batch(np.random.default_rng(seed), B,
                                           V, M, W)
    for a in (mem, que, mask):
        a[-3:] = 0
    params = {k: 4.0 * v for k, v in memn2n.init_params(
        cfg, dims, torch.Generator().manual_seed(seed), device=dev).items()}
    mem_t, que_t, mask_t = (torch.from_numpy(a).to(dev)
                            for a in (mem, que, mask))
    u = qmatvec_forward(params["B"], que_t, cfg.fmt_w[0], cfg.fmt_w[0])
    return cfg, params, mem_t, que_t, mask_t, u


@pytest.mark.cuda
@pytest.mark.parametrize("V,M,W,B", [(19, 10, 6, 32), (19, 10, 6, 1024),
                                     (64, 50, 7, 32)])
def test_qmatvec_kernel_matches_plain(cuda, V, M, W, B):
    cfg, params, mem, que, _, u = _training_inputs(V, M, W, B, cuda)
    rows = mem.reshape(-1, mem.shape[-1])
    fw = cfg.fmt_w
    cases = [(params["B"], que, fw[0], fw[0]),
             (params["A"], rows, fw[0], fw[0]),
             (params["C"], rows, fw[2], fw[2]),
             (params["H"], u, fw[1], cfg.fmt_bin),
             (params["B"], que, QFormat(0, 0), fw[0]),
             (params["H"], u, fw[1], QFormat(0, 0))]
    for w, x, f_w, f_x in cases:
        before = qmv.quantized_matvec.launches
        got = qmv.quantized_matvec(w, x, f_w, f_x)
        want = qmv.quantized_matvec_reference(w, x, f_w, f_x)
        torch.cuda.synchronize()
        assert qmv.quantized_matvec.launches == before + 1
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [2, 1])
@pytest.mark.parametrize("V,M,W,B", [(19, 10, 6, 32), (19, 10, 6, 1024),
                                     (64, 50, 7, 32)])
def test_attention_read_kernel_matches_plain(cuda, V, M, W, B, mode):
    cfg, params, mem, _, mask, u = _training_inputs(V, M, W, B, cuda)
    m = qembed_mat_forward(mem, params["A"], cfg.fmt_w[0])
    c = qembed_mat_forward(mem, params["C"], cfg.fmt_w[0])
    q = mode == 2
    fmt_act = cfg.fmt_act[0]
    args = (m, c, u, mask.to(torch.float32), cfg.fmt_att[0], cfg.fmt_bin,
            fmt_act, q, q)
    before = ar.fused_read.launches
    o_g, p_g, s_g = ar.fused_read(*args, attention_mode=mode)
    o_w, p_w, s_w = ar.fused_read_reference(*args, attention_mode=mode)
    torch.cuda.synchronize()
    assert ar.fused_read.launches == before + 1
    assert (p_g[-3:] == 0).all() and torch.isfinite(o_g).all()
    if not q:
        for g, w in ((o_g, o_w), (p_g, p_w), (s_g, s_w)):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
        return
    assert torch.equal(s_g, s_w)
    torch.testing.assert_close(p_g, p_w, rtol=0, atol=1e-6)
    flipped = (float_quant(p_g, fmt_act) != float_quant(p_w, fmt_act)).any(-1)
    assert int(flipped.sum()) <= 1
    assert torch.equal(o_g[~flipped], o_w[~flipped])
    assert torch.equal(o_g[-3:], float_quant(torch.zeros_like(o_g[-3:]),
                                             fmt_act))


@pytest.mark.cuda
def test_training_kernels_reject_what_they_cannot_take(cuda):
    fmt = QFormat(5, 2)
    with pytest.raises(ValueError, match="bounds"):
        qmv.quantized_matvec(torch.zeros((200, 100), device=cuda),
                             torch.zeros((4, 100), device=cuda), fmt, fmt)
    with pytest.raises(TypeError, match="float32"):
        qmv.quantized_matvec(torch.zeros((6, 5), device=cuda).double(),
                             torch.zeros((4, 5), device=cuda), fmt, fmt)
    m = torch.zeros((4, 65, 8), device=cuda)
    with pytest.raises(ValueError, match="bounds"):
        ar.fused_read(m, m, torch.zeros((4, 8), device=cuda),
                      torch.ones((4, 65), device=cuda), fmt, fmt, fmt)
    m = torch.zeros((4, 6, 8), device=cuda)
    with pytest.raises(ValueError, match="shapes"):
        ar.fused_read(m, m, torch.zeros((4, 7), device=cuda),
                      torch.ones((4, 6), device=cuda), fmt, fmt, fmt)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ar.fused_read(m, m, torch.zeros((4, 8), device=cuda),
                      torch.ones((4, 6), device=cuda), fmt, fmt, fmt,
                      attention_mode=3)


@pytest.mark.cuda
def test_train_step_kernel_route_matches_plain_route(cuda):
    """One SGD step from the same weights through the kernels
    (use_pallas=True) and through plain PyTorch, on a partial batch."""
    from qmann_tpu_torch.data import synthetic_task
    from qmann_tpu_torch.train import train_step
    from qmann_tpu_torch.train.trainer import _batched_arrays
    data = synthetic_task(np.random.default_rng(0), 40, 1, 1, 19, 10, 6)
    cfg = QmannConfig(use_pallas=True)
    batch = {k: torch.as_tensor(v[1]).to(cuda)
             for k, v in _batched_arrays(data.train, 32).items()}
    base = {k: 4.0 * v for k, v in memn2n.init_params(
        cfg, data.dims, torch.Generator().manual_seed(0), device=cuda).items()}
    lr = torch.tensor(0.3, device=cuda)
    after = []
    for route in (cfg, cfg.replace(use_pallas=False)):
        params = {k: v.clone() for k, v in base.items()}
        before = (qmv.quantized_matvec.launches, ar.fused_read.launches)
        cost, _ = train_step(params, batch, lr, route)
        launched = (qmv.quantized_matvec.launches - before[0],
                    ar.fused_read.launches - before[1])
        assert launched == ((10, 3) if route.use_pallas else (0, 0))
        assert torch.isfinite(cost)
        after.append(params)
    for k in base:
        torch.testing.assert_close(after[0][k], after[1][k], rtol=1e-5,
                                   atol=1e-6)
        assert not torch.equal(after[0][k], base[k])
