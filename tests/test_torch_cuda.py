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
another order).  Hamming score kernel: bit-identical (integer work and
exact sums), on random inputs and on the encode's edge list.  Mode-3 read
and chain: as mode 2.  One SGD step, kernel route against plain route:
rtol 1e-5, atol 1e-6.
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
from qmann_tpu_torch.ops.cuda import hamming as ham  # noqa: E402
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


def _assert_chain_kernel_matches(cfg, args, flags):
    """One launch of the chain kernel against the plain chain, under the
    module docstring's tolerances."""
    before = hop_chain.fused_hop_chain.launches
    u_g, p_g, s_g = hop_chain.fused_hop_chain(*args, **flags)
    u_w, p_w, s_w = hop_chain.fused_hop_chain_reference(*args, **flags)
    torch.cuda.synchronize()
    assert hop_chain.fused_hop_chain.launches == before + 1
    assert torch.equal(s_g[0], s_w[0])
    torch.testing.assert_close(p_g, p_w, rtol=0, atol=1e-6)
    flipped = torch.zeros(u_g.shape[0], dtype=torch.bool, device=u_g.device)
    for h, fmt in enumerate(cfg.fmt_act):
        flipped |= (float_quant(p_g[h], fmt) != float_quant(p_w[h], fmt)).any(-1)
    assert int(flipped.sum()) <= 1
    assert torch.equal(s_g[:, ~flipped], s_w[:, ~flipped])
    assert torch.equal(u_g[~flipped], u_w[~flipped])


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
    _assert_chain_kernel_matches(cfg, args, flags)


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
    """qmatvec refuses an empty x; O*I + I past 12288 floats, which it
    refused before it was tiled over I, now runs (the tiled kernel)."""
    fmt = QFormat(5, 2)
    with pytest.raises(ValueError, match="bounds"):
        qmv.quantized_matvec(torch.zeros((200, 100), device=cuda),
                             torch.zeros((0, 100), device=cuda), fmt, fmt)
    w = torch.full((200, 100), 0.75, device=cuda)
    x = torch.full((4, 100), 2.0, device=cuda)
    assert torch.equal(qmv.quantized_matvec(w, x, fmt, fmt),
                       qmv.quantized_matvec_reference(w, x, fmt, fmt))
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
    with pytest.raises(ValueError, match="num_bit in"):
        ar.fused_read(m, m, torch.zeros((4, 8), device=cuda),
                      torch.ones((4, 6), device=cuda), fmt, fmt, fmt,
                      attention_mode=3, ham_num_bit=33)


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


# ---------------------------------------------------------------------------
# attention mode 3: the Hamming score kernel, and the read and chain kernels'
# mode-3 branches
# ---------------------------------------------------------------------------

def ham_edge_values(iwl):
    """0, -0.0, +-2^iwl, +-maxf, the next float above maxf, +-1e30, a value
    whose low half carries under ROUND_UP, tiny values."""
    maxf = np.float32(2.0 ** iwl)
    above = np.nextafter(maxf, np.float32(np.inf))
    carry = np.float32(65535.5 * 2.0 ** -(31 - iwl))
    return np.array([0.0, -0.0, maxf, -maxf, above, -above, 1e30, -1e30,
                     carry, -carry, 1e-7, -3e-9], np.float32)


def ham_inputs(iwl, B, M, D, seed=0):
    """Gaussian m, u at the format's range; the first sample pairs the edge
    list with itself and with its negation (every sign and wrap case)."""
    rng = np.random.default_rng(seed)
    m = rng.normal(0.0, 0.6 * 2.0 ** iwl, (B, M, D)).astype(np.float32)
    u = rng.normal(0.0, 0.6 * 2.0 ** iwl, (B, D)).astype(np.float32)
    e = ham_edge_values(iwl)[:D]
    for r in range(min(M, len(e))):
        m[0, r, :len(e)] = np.roll(e, r)
    u[0, :len(e)] = -e
    return m, u


@pytest.mark.cuda
@pytest.mark.parametrize("weight_para,weighted", [(0, True), (-1, True),
                                                  (0, False)])
@pytest.mark.parametrize("iwl", [0, 1, 5])
@pytest.mark.parametrize("B,M,D", [(32, 10, 60), (1024, 10, 60),
                                   (32, 50, 60)])
def test_hamming_kernel_matches_plain(cuda, B, M, D, iwl, weight_para,
                                      weighted):
    m, u = (torch.from_numpy(a).to(cuda) for a in ham_inputs(iwl, B, M, D))
    for mode, nb in ((3, 8), (1, 8), (0, 12), (2, 16)):
        args = (m, u, iwl, nb, -3, mode, weight_para, weighted)
        before = ham.hamming_score_kernel.launches
        got = ham.hamming_score_kernel(*args)
        want = ham.hamming_score_reference(*args)
        torch.cuda.synchronize()
        assert ham.hamming_score_kernel.launches == before + 1
        assert torch.equal(got, want), (mode, nb)


@pytest.mark.cuda
def test_hamming_kernel_rejects_what_it_cannot_take(cuda):
    m = torch.zeros((4, 6, 8), device=cuda)
    u = torch.zeros((4, 8), device=cuda)
    with pytest.raises(ValueError, match="num_bit in"):
        ham.hamming_score_kernel(m, u, 1, 33)
    with pytest.raises(ValueError, match="num_bit in"):
        ham.hamming_score_kernel(m, u, 32, 8)
    with pytest.raises(ValueError, match="shapes"):
        ham.hamming_score_kernel(m, u[:, :7], 1, 8)
    with pytest.raises(TypeError, match="float32"):
        ham.hamming_score_kernel(m.double(), u, 1, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("iwl", [1, 5])
@pytest.mark.parametrize("V,M,W,B", [(19, 10, 6, 32), (19, 10, 6, 1024),
                                     (64, 50, 7, 32)])
def test_attention_read_mode3_matches_plain(cuda, V, M, W, B, iwl):
    cfg, params, mem, que, mask, _ = _training_inputs(V, M, W, B, cuda)
    cfg = cfg.replace(iwl=iwl, attention_mode=3)
    m = qembed_mat_forward(mem, params["A"], cfg.fmt_w[0])
    c = qembed_mat_forward(mem, params["C"], cfg.fmt_w[0])
    u = qmatvec_forward(params["B"], que, cfg.fmt_w[0], cfg.fmt_w[0])
    fmt_act = cfg.fmt_act[0]
    args = (m, c, u, mask.to(torch.float32), cfg.fmt_att[0], cfg.fmt_bin,
            fmt_act, False, True, 3, cfg.num_bits_attention)
    before = ar.fused_read.launches
    o_g, p_g, s_g = ar.fused_read(*args)
    o_w, p_w, s_w = ar.fused_read_reference(*args)
    torch.cuda.synchronize()
    assert ar.fused_read.launches == before + 1
    assert torch.equal(s_g, s_w)
    torch.testing.assert_close(p_g, p_w, rtol=0, atol=1e-6)
    flipped = (float_quant(p_g, fmt_act) != float_quant(p_w, fmt_act)).any(-1)
    assert int(flipped.sum()) <= 1
    assert torch.equal(o_g[~flipped], o_w[~flipped])
    assert (p_g[-3:] == 0).all()
    assert torch.equal(o_g[-3:], float_quant(torch.zeros_like(o_g[-3:]),
                                             fmt_act))


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"type_weight_tying": 1}])
@pytest.mark.parametrize("V,M,W", [(19, 10, 6), (64, 50, 7)])
def test_chain_kernel_mode3_matches_plain(cuda, V, M, W, kw):
    cfg = QmannConfig(use_fused_chain=True, attention_mode=3, **kw)
    args = _chain_args(cfg, V, M, W, 1000, cuda)
    flags = dict(linear_mapping=cfg.en_linear_mapping,
                 non_linearity=cfg.en_non_linearity, attention_mode=3,
                 ham_num_bit=cfg.num_bits_attention)
    _assert_chain_kernel_matches(cfg, args, flags)


@pytest.mark.cuda
@pytest.mark.parametrize("extra,launches", [
    ({"use_pallas": True}, (10, 3, 0)),
    ({"use_pallas_hamming": True}, (0, 0, 3)),
    ({"use_pallas": True, "en_grad_quant": True}, (10, 0, 3))])
def test_mode3_train_step_kernel_route_matches_plain_route(cuda, extra,
                                                          launches):
    """One SGD step at iwl 1, mode 3, on a partial batch: the kernel routes
    launch the lattice, the mode-3 read or the Hamming kernel as many
    times as a step runs them, and agree with plain PyTorch."""
    from qmann_tpu_torch.data import synthetic_task
    from qmann_tpu_torch.train import train_step
    from qmann_tpu_torch.train.trainer import _batched_arrays
    data = synthetic_task(np.random.default_rng(0), 40, 1, 1, 19, 10, 6)
    cfg = QmannConfig(iwl=1, attention_mode=3)
    batch = {k: torch.as_tensor(v[1]).to(cuda)
             for k, v in _batched_arrays(data.train, 32).items()}
    base = {k: 4.0 * v for k, v in memn2n.init_params(
        cfg, data.dims, torch.Generator().manual_seed(0), device=cuda).items()}
    lr = torch.tensor(0.3, device=cuda)
    after = []
    for route in (cfg.replace(**extra), cfg):
        params = {k: v.clone() for k, v in base.items()}
        counters = (qmv.quantized_matvec, ar.fused_read,
                    ham.hamming_score_kernel)
        before = [f.launches for f in counters]
        cost, _ = train_step(params, batch, lr, route)
        launched = tuple(f.launches - b for f, b in zip(counters, before))
        assert launched == (launches if route is not cfg else (0, 0, 0))
        assert torch.isfinite(cost)
        after.append(params)
    for k in base:
        torch.testing.assert_close(after[0][k], after[1][k], rtol=1e-5,
                                   atol=1e-6)
    assert not torch.equal(after[0]["A"], base["A"])


# ---------------------------------------------------------------------------
# the redesigned chain and lattice kernels: every rounding mode, ragged
# batches, the kernels' limits, saturation
# ---------------------------------------------------------------------------

def _synthetic_chain(B, M, D, K, quant_mode, dev, scale=0.6, seed=0):
    """flat = bag-of-words counts @ Gaussian weights of sd `scale` (the raw
    stacked GEMM), u quantized at fmt_w[0], lin maps of the same sd,
    partial masks and, from B=7 on, a last query with no live row."""
    cfg = QmannConfig(dim_emb=D, num_hops=K, quant_mode=quant_mode)
    rng = np.random.default_rng(seed)
    I = 17
    mem = rng.integers(0, 3, (B, M, I)).astype(np.float32)
    mask = np.arange(M)[None, :] < rng.integers(1, M + 1, B)[:, None]
    if B >= 7:
        mask[-1] = False
    mem *= mask[:, :, None]
    emb = rng.normal(0.0, scale, (I, 2 * K * D)).astype(np.float32)
    flat = np.einsum("bmi,ie->bme", mem, emb).astype(np.float32)
    que = rng.integers(0, 3, (B, I)).astype(np.float32)
    u_raw = que @ rng.normal(0.0, scale, (I, D)).astype(np.float32)
    hm = rng.normal(0.0, scale, (K, D, D)).astype(np.float32)
    flat_t, u_t, hm_t = (torch.from_numpy(a).to(dev)
                         for a in (flat, u_raw, hm))
    u_t = float_quant(u_t, cfg.fmt_w[0])
    mask_t = torch.from_numpy(mask).to(dev)
    return cfg, (flat_t, u_t, hm_t, mask_t, cfg.fmt_w, cfg.fmt_att,
                 cfg.fmt_bin, cfg.fmt_act)


# (B, K, D, M, linear map, ReLU, weight sd): the flagship at B=1000, ragged
# batches, K/D/M at 1 and at the kernel's limits, the lin map off with ReLU
# on, and weights large enough that saturation fires
CHAIN_SHAPES = [(1000, 3, 60, 10, True, False, 0.6),
                (1, 3, 60, 10, True, False, 0.6),
                (7, 3, 60, 10, True, False, 0.6),
                (1001, 3, 60, 10, True, False, 0.6),
                (1001, 1, 8, 1, True, False, 0.6),
                (1000, 8, 128, 64, True, False, 0.6),
                (1001, 3, 60, 64, False, True, 0.6),
                (1000, 3, 60, 10, True, True, 50.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("quant_mode", [0, 1, 2, 3])
@pytest.mark.parametrize("attention_mode", [2, 3])
@pytest.mark.parametrize("B,K,D,M,linmap,relu,scale", CHAIN_SHAPES)
def test_chain_kernel_every_rounding_mode(cuda, B, K, D, M, linmap, relu,
                                          scale, attention_mode, quant_mode):
    cfg, args = _synthetic_chain(B, M, D, K, quant_mode, cuda, scale)
    flags = dict(linear_mapping=linmap, non_linearity=relu,
                 attention_mode=attention_mode,
                 ham_num_bit=cfg.num_bits_attention)
    if scale > 1.0:   # saturation must fire in the lattices
        sat = cfg.fmt_w[0]
        from qmann_tpu_torch.numerics import fixed_max_float
        assert float(args[0].abs().max()) > fixed_max_float(sat.iwl,
                                                            sat.frac)
    _assert_chain_kernel_matches(cfg, args, flags)


@pytest.mark.cuda
def test_kernels_refuse_mixed_rounding_modes(cuda):
    """Both kernels fix the rounding mode at compile time: formats that mix
    modes raise before a launch (binary formats carry no mode)."""
    cfg, args = _synthetic_chain(8, 10, 60, 3, 3, cuda)
    fmts_act = (QFormat(5, 2, 0),) + cfg.fmt_act[1:]
    before = hop_chain.fused_hop_chain.launches
    with pytest.raises(ValueError, match="rounding mode"):
        hop_chain.fused_hop_chain(*args[:7], fmts_act)
    w = torch.ones((6, 5), device=cuda)
    x = torch.ones((4, 5), device=cuda)
    with pytest.raises(ValueError, match="rounding mode"):
        qmv.quantized_matvec(w, x, QFormat(5, 2, 3), QFormat(5, 2, 1))
    assert hop_chain.fused_hop_chain.launches == before
    got = qmv.quantized_matvec(w, x, QFormat(0, 0, 3), QFormat(5, 2, 1))
    want = qmv.quantized_matvec_reference(w, x, QFormat(0, 0, 3),
                                          QFormat(5, 2, 1))
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("quant_mode", [0, 1, 2, 3])
@pytest.mark.parametrize("rows", [1, 7, 320, 10240, 10241])
def test_qmatvec_kernel_every_rounding_mode(cuda, rows, quant_mode):
    """Bit-identical at every mode: the flagship embedding shape (O=60,
    I=29) at Q5.2, Q6.1 x Q2.5, binary fmt_w and binary fmt_x, x not
    16-byte aligned (a view one row in), and O*I + I at the operand limit
    (O=203, I=60: 12240; O=1, I=6144: 12288)."""
    rng = np.random.default_rng(rows * 4 + quant_mode)

    def t(*shape, counts=False):
        a = (rng.integers(0, 4, shape) if counts
             else rng.normal(0.0, 1.5, shape))
        return torch.from_numpy(a.astype(np.float32)).to(cuda)

    m = quant_mode
    w, x = t(60, 29), t(rows, 29, counts=True)
    x_off = t(rows + 1, 29)[1:]
    cases = [(w, x, QFormat(5, 2, m), QFormat(5, 2, m)),
             (w, t(rows, 29), QFormat(6, 1, m), QFormat(2, 5, m)),
             (w, x, QFormat(0, 0, m), QFormat(5, 2, m)),
             (w, x, QFormat(5, 2, m), QFormat(0, 0, m)),
             (w, x_off, QFormat(4, 3, m), QFormat(4, 3, m)),
             (t(203, 60), t(rows, 60), QFormat(5, 2, m), QFormat(5, 2, m)),
             (t(1, 6144), t(rows, 6144), QFormat(2, 5, m), QFormat(2, 5, m))]
    for w_, x_, f_w, f_x in cases:
        before = qmv.quantized_matvec.launches
        got = qmv.quantized_matvec(w_, x_, f_w, f_x)
        want = qmv.quantized_matvec_reference(w_, x_, f_w, f_x)
        torch.cuda.synchronize()
        assert qmv.quantized_matvec.launches == before + 1
        assert torch.equal(got, want), (tuple(w_.shape), f_w, f_x)


@pytest.mark.cuda
@pytest.mark.parametrize("attention_mode", [2, 3])
def test_chain_kernel_takes_cached_quantized_lin_maps(cuda, attention_mode):
    """The serving path hands the kernel Q(H) from prepare_inference with
    hmats_quantized=True, which skips the kernel's requant of H: the
    result is the plain chain's on the raw lin maps."""
    cfg = QmannConfig(use_fused_chain=True, attention_mode=attention_mode)
    dims, mem, que, mask = synthetic_batch(np.random.default_rng(1), 1000,
                                           19, 10, 6)
    params = {k: 4.0 * v for k, v in memn2n.init_params(
        cfg, dims, torch.Generator().manual_seed(1), device=cuda).items()}
    prep = memn2n.prepare_inference(params, cfg, max_count=7.0,
                                    max_rowsum=7.0)
    assert prep.fast and prep.hmats_q is not None
    mem_t, que_t, mask_t = (torch.from_numpy(a).to(cuda)
                            for a in (mem, que, mask))
    flat = exact_matmul(mem_t, prep.embed_wt)
    u = float_quant(exact_matmul(que_t, prep.query_wt), cfg.fmt_w[0])
    fmts = (cfg.fmt_w, cfg.fmt_att, cfg.fmt_bin, cfg.fmt_act)
    flags = dict(attention_mode=attention_mode,
                 ham_num_bit=cfg.num_bits_attention)
    got = hop_chain.fused_hop_chain(flat, u, prep.hmats_q, mask_t, *fmts,
                                    hmats_quantized=True, **flags)
    want = hop_chain.fused_hop_chain_reference(flat, u, prep.hmats, mask_t,
                                               *fmts, **flags)
    torch.cuda.synchronize()
    (u_g, p_g, s_g), (u_w, p_w, s_w) = got, want
    assert torch.equal(s_g[0], s_w[0])
    torch.testing.assert_close(p_g, p_w, rtol=0, atol=1e-6)
    flipped = torch.zeros(u_g.shape[0], dtype=torch.bool, device=cuda)
    for h, fmt in enumerate(cfg.fmt_act):
        flipped |= (float_quant(p_g[h], fmt) != float_quant(p_w[h], fmt)).any(-1)
    assert int(flipped.sum()) <= 1
    assert torch.equal(s_g[:, ~flipped], s_w[:, ~flipped])
    assert torch.equal(u_g[~flipped], u_w[~flipped])


# ---------------------------------------------------------------------------
# the redesigned read and Hamming kernels: every rounding mode, ragged
# batches, M and D at 1 and at the kernels' limits, saturation, a binary
# fmt_bin, samples with no live row, both sides of the word form
# ---------------------------------------------------------------------------

def _synthetic_read(B, M, D, dev, scale, seed=0):
    """Gaussian m, c of sd `scale` (large enough that the att and act
    formats saturate), u of sd 2, partial masks and, from B=7 on, a last
    sample with no live row."""
    rng = np.random.default_rng(seed + 1000 * M + D)
    m = rng.normal(0.0, scale, (B, M, D)).astype(np.float32)
    c = rng.normal(0.0, scale, (B, M, D)).astype(np.float32)
    u = rng.normal(0.0, 2.0, (B, D)).astype(np.float32)
    mask = (np.arange(M)[None, :]
            < rng.integers(1, M + 1, B)[:, None]).astype(np.float32)
    if B >= 7:
        mask[-1] = 0.0
    return [torch.from_numpy(a).to(dev) for a in (m, c, u, mask)]


def _assert_read_matches(args, kw, quantized):
    """One launch of the read kernel against its plain version under the
    module docstring's tolerances; a sample with no live row gets p = 0."""
    fmt_act = args[6]
    before = ar.fused_read.launches
    o_g, p_g, s_g = ar.fused_read(*args, **kw)
    o_w, p_w, s_w = ar.fused_read_reference(*args, **kw)
    torch.cuda.synchronize()
    assert ar.fused_read.launches == before + 1
    dead = args[3].sum(-1) == 0
    assert (p_g[dead] == 0).all()
    if not quantized:
        for g, w in ((o_g, o_w), (p_g, p_w), (s_g, s_w)):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
        return
    assert torch.equal(s_g, s_w)
    torch.testing.assert_close(p_g, p_w, rtol=0, atol=1e-6)
    flipped = (float_quant(p_g, fmt_act) != float_quant(p_w, fmt_act)).any(-1)
    assert int(flipped.sum()) <= 1
    assert torch.equal(o_g[~flipped], o_w[~flipped])


READ_SHAPES = [(B, M, D) for B in (1, 7, 32, 1024, 1025) for M in (1, 64)
               for D in (1, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("quant_mode", [0, 1, 2, 3])
@pytest.mark.parametrize("attention_mode", [1, 2, 3])
@pytest.mark.parametrize("B,M,D", READ_SHAPES)
def test_read_kernel_every_rounding_mode(cuda, B, M, D, attention_mode,
                                         quant_mode):
    """Modes 1-3 at every rounding mode: Q5.2 scores with Q4.3 weighted
    sums (mode 2; a binary fmt_bin too), the Hamming score at iwl 1 and
    num_bit 8 in its three variants with a Q1.6 sum (mode 3), on inputs
    that saturate the formats; the float read (mode 1)."""
    qm = quant_mode
    m, c, u, mask = _synthetic_read(B, M, D, cuda, scale=20.0)
    if attention_mode == 1:
        # small values: the float sums' rounding stays far below atol
        fmt = QFormat(5, 2, qm)
        _assert_read_matches((m / 400, c / 400, u / 40, mask, fmt, fmt, fmt,
                              False, False),
                             dict(attention_mode=1), quantized=False)
    elif attention_mode == 2:
        for fmt_bin in (QFormat(5, 2, qm), QFormat(0, 0, qm)):
            args = (m, c, u, mask, QFormat(5, 2, qm), fmt_bin,
                    QFormat(4, 3, qm), True, True)
            _assert_read_matches(args, dict(attention_mode=2), True)
    else:
        fmt = QFormat(1, 6, qm)
        for para, weighted in ((0, True), (-1, True), (0, False)):
            args = (m / 8, c / 8, u / 2, mask, fmt, fmt, fmt, False, True)
            _assert_read_matches(args, dict(
                attention_mode=3, ham_num_bit=8, ham_weight_para=para,
                ham_weighted=weighted), True)


def _edge_pairs(iwl, seed=0):
    """m [E, E, 1] and u [E, 1] that pair every value of the encode's edge
    list with every other, beside Gaussian values across the range: one
    term per row, so the row sum is the term itself."""
    e = ham_edge_values(iwl)
    rng = np.random.default_rng(seed + iwl)
    vals = np.concatenate([e, rng.normal(0.0, 0.6 * 2.0 ** iwl, 40)
                           .astype(np.float32)])
    E = len(vals)
    m = np.broadcast_to(vals[None, :, None], (E, E, 1)).copy()
    u = vals[:, None].copy()
    return m, u


@pytest.mark.cuda
@pytest.mark.parametrize("quant_mode", [0, 1, 2, 3])
@pytest.mark.parametrize("iwl", [0, 1, 5, 31])
@pytest.mark.parametrize("num_bit", [8, 25, 26])
def test_hamming_kernel_every_rounding_mode(cuda, num_bit, iwl, quant_mode):
    """Bit-identical in all three variants: every pair of the edge list
    term by term (num_bit 25 takes the word form, 26 the loop), and the
    Gaussian and edge-list inputs of ham_inputs at B=32, 1024 and the wide
    layout at num_bit 8 (row sums exact)."""
    cases = [tuple(torch.from_numpy(a).to(cuda) for a in _edge_pairs(iwl))]
    if num_bit == 8:
        cases += [tuple(torch.from_numpy(a).to(cuda)
                        for a in ham_inputs(iwl, B, M, 60))
                  for B, M in ((32, 10), (1024, 10), (32, 50))]
    for m, u in cases:
        for para, weighted in ((0, True), (-1, True), (0, False)):
            args = (m, u, iwl, num_bit, -3, quant_mode, para, weighted)
            before = ham.hamming_score_kernel.launches
            got = ham.hamming_score_kernel(*args)
            want = ham.hamming_score_reference(*args)
            torch.cuda.synchronize()
            assert ham.hamming_score_kernel.launches == before + 1
            assert torch.equal(got, want), (tuple(m.shape), para, weighted)


@pytest.mark.cuda
@pytest.mark.parametrize("num_bit", list(range(20, 33)))
def test_hamming_row_sums_above_num_bit_19(cuda, num_bit):
    """From num_bit 20 on the weighted row sums may round, in another order
    than the plain version's: the kernel stays within the float32 error of
    two sums of D terms, |term| < 2^(const_scale - weight_para), plus one
    step of the row requant's grid."""
    iwl, D = 1, 60
    m, u = (torch.from_numpy(a).to(cuda) for a in ham_inputs(iwl, 32, 10, D))
    for para in (0, -1):
        got = ham.hamming_score_kernel(m, u, iwl, num_bit, -3, 3, para)
        want = ham.hamming_score_reference(m, u, iwl, num_bit, -3, 3, para)
        bound = (2 * (D - 1) * 2.0 ** -24 * D * 2.0 ** (-3 - para)
                 + 2.0 ** -(31 - iwl))
        assert float((got - want).abs().max()) <= bound
        got_u = ham.hamming_score_kernel(m, u, iwl, num_bit, -3, 3, para,
                                         False)
        want_u = ham.hamming_score_reference(m, u, iwl, num_bit, -3, 3, para,
                                             False)
        assert torch.equal(got_u, want_u)


@pytest.mark.cuda
def test_read_and_hamming_limits_raise_before_a_launch(cuda):
    """M above 64 or D above 256 raises, naming the bound, and formats that
    mix rounding modes in the read raise, before any launch (a binary
    fmt_bin carries no mode, and an unused format is not checked)."""
    fmt = QFormat(5, 2, 3)
    counters = (ar.fused_read, ham.hamming_score_kernel)
    before = [f.launches for f in counters]
    for M, D in ((65, 8), (4, 257)):
        m = torch.zeros((2, M, D), device=cuda)
        u = torch.zeros((2, D), device=cuda)
        mask = torch.ones((2, M), device=cuda)
        with pytest.raises(ValueError, match="M<=64, 1<=D<=256"):
            ar.fused_read(m, m, u, mask, fmt, fmt, fmt)
        with pytest.raises(ValueError, match="M<=64, 1<=D<=256"):
            ham.hamming_score_kernel(m, u, 1, 8)
    m = torch.ones((2, 4, 8), device=cuda)
    u = torch.ones((2, 8), device=cuda)
    mask = torch.ones((2, 4), device=cuda)
    for f_att, f_act, mode in ((QFormat(5, 2, 3), QFormat(5, 2, 0), 2),
                               (QFormat(1, 6, 0), QFormat(1, 6, 3), 3)):
        with pytest.raises(ValueError, match="rounding mode"):
            ar.fused_read(m, m, u, mask, f_att, f_att, f_act,
                          attention_mode=mode)
    assert [f.launches for f in counters] == before
    # a binary fmt_bin of another mode, and mode 1's unused formats, launch
    ar.fused_read(m, m, u, mask, fmt, QFormat(0, 0, 1), fmt)
    ar.fused_read(m, m, u, mask, fmt, fmt, QFormat(5, 2, 0), False, False,
                  attention_mode=1)
    torch.cuda.synchronize()
    assert ar.fused_read.launches == before[0] + 2


@pytest.mark.cuda
@pytest.mark.parametrize("quant_mode", [0, 1, 2, 3])
@pytest.mark.parametrize("O", [1, 60, 203])
@pytest.mark.parametrize("I", [202, 256, 1024, 6145])
def test_qmatvec_kernel_tiled_over_i(cuda, I, O, quant_mode):
    """Past O*I + I = 12288 floats the kernel tiles I (and O above 256) and
    requantizes each output once after the last I-tile: bit-identical to
    the plain version at every rounding mode, on bag-of-words and Gaussian
    x, with binary fmt_w and binary fmt_x (nothing is padded), at ragged B
    (as many rows as the plain version's [B, O, I] lattice allows)."""
    rng = np.random.default_rng(I * 16 + O * 4 + quant_mode)

    def t(*shape, counts=False):
        a = (rng.integers(0, 4, shape) if counts
             else rng.normal(0.0, 1.5, shape))
        return torch.from_numpy(a.astype(np.float32)).to(cuda)

    m = quant_mode
    w = t(O, I)
    for B in [b for b in (1, 37, 2049) if b * O * I <= 2 ** 27]:
        geo = qmv.qmatvec_geometry(B, O, I)
        assert ((geo.o_tile, geo.i_tile) != (O, I)) == (O * I + I > 12288)
        x = t(B, I, counts=True)
        for x_, f_w, f_x in ((x, QFormat(5, 2, m), QFormat(5, 2, m)),
                             (t(B, I), QFormat(6, 1, m), QFormat(2, 5, m)),
                             (x, QFormat(0, 0, m), QFormat(5, 2, m)),
                             (x, QFormat(5, 2, m), QFormat(0, 0, m))):
            before = qmv.quantized_matvec.launches
            got = qmv.quantized_matvec(w, x_, f_w, f_x)
            want = qmv.quantized_matvec_reference(w, x_, f_w, f_x)
            torch.cuda.synchronize()
            assert qmv.quantized_matvec.launches == before + 1
            assert torch.equal(got, want), (B, f_w, f_x)


@pytest.mark.cuda
@pytest.mark.parametrize("O,I,tiled", [(203, 60, False), (1, 6144, False),
                                       (60, 201, False), (60, 202, True),
                                       (1, 6145, True), (257, 48, True)])
def test_qmatvec_whole_row_path_kept_at_the_old_limit(cuda, O, I, tiled):
    """Up to O*I + I = 12288 floats the launch keeps the whole-row kernel
    (o_tile = O, i_tile = I); one float past it takes the tiled kernel;
    both bit-identical."""
    rng = np.random.default_rng(O + I)
    w = torch.from_numpy(rng.normal(0, 1.5, (O, I)).astype(np.float32))
    x = torch.from_numpy(rng.integers(0, 4, (33, I)).astype(np.float32))
    geo = qmv.qmatvec_geometry(33, O, I)
    assert ((geo.o_tile, geo.i_tile) != (O, I)) == tiled
    fmt = QFormat(5, 2)
    got = qmv.quantized_matvec(w.to(cuda), x.to(cuda), fmt, fmt)
    assert torch.equal(got.cpu(), qmv.quantized_matvec_reference(w, x, fmt,
                                                                 fmt))


@pytest.mark.cuda
@pytest.mark.parametrize("quant_mode", [0, 1, 2, 3])
@pytest.mark.parametrize("R,B,O,I", [(3, 7, 60, 29), (5, 1600, 60, 114),
                                     (2, 37, 60, 256), (4, 33, 257, 48),
                                     (1, 320, 60, 29)])
def test_qmatvec_family_axis_every_rounding_mode(cuda, R, B, O, I,
                                                 quant_mode):
    """The family axis (w [R, O, I], x [R, B, I], one launch): bit-identical
    to the stacked plain version and to R launches of the 2-D kernel, at
    every rounding mode, on the whole-row and the tiled kernels, with
    binary fmt_w and binary fmt_x; R = 1 keeps the 2-D call's geometry."""
    rng = np.random.default_rng(R * 1000 + B + quant_mode)

    def t(*shape, counts=False):
        a = (rng.integers(0, 4, shape) if counts
             else rng.normal(0.0, 1.5, shape))
        return torch.from_numpy(a.astype(np.float32)).to(cuda)

    m = quant_mode
    w, x = t(R, O, I), t(R, B, I, counts=True)
    assert qmv.qmatvec_geometry(B, O, I, 1) == qmv.qmatvec_geometry(B, O, I)
    for x_, f_w, f_x in ((x, QFormat(5, 2, m), QFormat(5, 2, m)),
                         (t(R, B, I), QFormat(6, 1, m), QFormat(2, 5, m)),
                         (x, QFormat(0, 0, m), QFormat(5, 2, m)),
                         (x, QFormat(5, 2, m), QFormat(0, 0, m))):
        before = qmv.quantized_matvec.launches
        got = qmv.quantized_matvec(w, x_, f_w, f_x)
        torch.cuda.synchronize()
        assert qmv.quantized_matvec.launches == before + 1
        assert got.shape == (R, B, O)
        assert torch.equal(got, qmv.quantized_matvec_reference(w, x_, f_w,
                                                               f_x))
        for r in range(R):
            assert torch.equal(got[r], qmv.quantized_matvec(w[r], x_[r],
                                                            f_w, f_x))


@pytest.mark.cuda
def test_family_step_launches_as_one_run(cuda):
    """One family step on the kernel route (R = 6 runs, use_pallas) launches
    the lattice 10 times and the read 3 times, as one run's step, and its
    runs equal their single-run steps (rtol 1e-5, atol 1e-6)."""
    from qmann_tpu_torch.train import multi, train_step
    cfg = QmannConfig(use_pallas=True, verbose=False)
    dims, mem, que, mask = synthetic_batch(np.random.default_rng(0), 32,
                                           19, 10, 6)
    R = 6
    runs = [{k: 4.0 * v for k, v in memn2n.init_params(
        cfg, dims, torch.Generator().manual_seed(s), device=cuda).items()}
        for s in range(R)]
    params = {k: torch.stack([p[k] for p in runs]) for k in runs[0]}
    ans = np.zeros_like(que)
    ans[np.arange(32), np.arange(32) % 19] = 1.0
    one = {"memory": mem, "question": que, "answer": ans, "mask": mask,
           "sample_mask": np.ones(32, np.float32),
           "size_b": np.float32(32.0)}
    one = {k: torch.as_tensor(v).to(cuda) for k, v in one.items()}
    batch = {k: torch.stack([v] * R) for k, v in one.items()}
    lr = torch.tensor(cfg.learning_rate, device=cuda)
    before = (qmv.quantized_matvec.launches, ar.fused_read.launches)
    multi.family_step(params, batch, lr, cfg)
    torch.cuda.synchronize()
    assert (qmv.quantized_matvec.launches - before[0],
            ar.fused_read.launches - before[1]) == (10, 3)
    for r, p in enumerate(runs):
        train_step(p, one, lr, cfg)
        for k in p:
            torch.testing.assert_close(params[k][r], p[k], rtol=1e-5,
                                       atol=1e-6)


@pytest.mark.cuda
def test_packet_server_on_the_card_through_the_chain(cuda):
    """The packet server in front of an engine on the card with
    use_fused_chain: every answer over TCP equals the plain route's for the
    same sample, one chain launch per wave, and no failed wave."""
    from qmann_tpu_torch.data import Dictionary, synthetic_samples
    from qmann_tpu_torch.serve import InferenceEngine
    from qmann_tpu_torch.serve.client import PacketClient
    from qmann_tpu_torch.serve.packet import IndexedSample
    from qmann_tpu_torch.serve.server import serve
    rng = np.random.default_rng(9)
    dims, _, _, _ = synthetic_batch(rng, 4, 19, 10, 6)
    dictionary = Dictionary()
    for i in range(1, 19):
        dictionary.add(f"w{i}")
    cfg = QmannConfig(use_fused_chain=True, verbose=False)
    params = {k: 4.0 * v for k, v in memn2n.init_params(
        cfg, dims, torch.Generator().manual_seed(0), device=cuda).items()}
    samples = [IndexedSample(
        [[dictionary.lookup(w) for w in sent] for sent in s.sentences],
        [dims.dim_dict + len(s.sentences) - j - 1
         for j in range(len(s.sentences))],
        [dictionary.lookup(w) for w in s.question], [1])
        for s in synthetic_samples(rng, 200, 19, 10, 6)]
    engines = [InferenceEngine(params, c, dims, dictionary, batch_size=32,
                               max_wait_ms=5.0, device=cuda).start()
               for c in (cfg, cfg.replace(use_fused_chain=False))]
    server = serve(engines[0], port=0)
    host, port = server.server_address[:2]
    try:
        before = hop_chain.fused_hop_chain.launches
        with PacketClient(host, port, timeout=120) as client:
            got = client.query_samples(samples)
        launched = hop_chain.fused_hop_chain.launches - before
        want = [f.result(timeout=120)
                for f in [engines[1].submit_indexed(s) for s in samples]]
    finally:
        server.shutdown()
        server.server_close()
        for e in engines:
            e.stop()
    assert engines[0].prepared.fast
    assert got == want and len(set(got)) > 1
    assert engines[0].stats.failed_waves == 0
    assert launched == engines[0].stats.waves >= 200 // 32
