"""The hand-written CUDA kernels against their plain PyTorch versions, both
on the card.  Without a card these tests skip.

This file imports no jax, so that it runs on a machine with a GPU and no
jax; tests/conftest.py imports jax, so skip it there:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances.  Chain (fused_hop_chain_from_memory against its plain
version, as tests/test_torch_chain.py): hop 0's scores bit-identical, p
within atol 1e-6, at most one query with a flipped Q(p, act) requant, and
every other query bit-identical in all scores and in u_final.  Its own
embedding: bit-identical to the kernel on the exact GEMM's output with the
identity as weights (the embedding sums are exact in any order under
prepare_inference's bounds, and x * 1 plus +-0 terms is x).  qmatvec:
bit-identical (exact lattice sums).  Mode-2 attention
read: scores bit-identical, p within atol 1e-6, o bit-identical but for at
most one flipped query.  Mode-1 read: rtol 1e-5, atol 1e-6 (float sums in
another order).  Hamming score kernel: bit-identical (integer work and
exact sums), on random inputs and on the encode's edge list.  Mode-3 read
and chain: as mode 2.  Hamming surrogate backward: dm bit-identical (int32
views), du within 2*M*2^-24*sum_r|grad_appx*g| (an M-term float32 sum in
another order), two launches bitwise equal.  Weighted sum's quantized
backward: dc bit-identical; dp bit-identical where every sum is exact
(``sums_exact``: words of up to 16 bits), else within ``dp_interval``
(a D-term float32 sum in another order, then the requant); two launches
bitwise equal.  Its ds entry (the fused read's weighted-sum and softmax
backwards), quantized and float: dc bit-identical, ds within ``ds_bound``
(S, an M-term float32 sum, in another order, plus ``dp_error``), two
launches bitwise equal.  One SGD step, kernel route against plain route:
rtol 1e-5, atol 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qmann_tpu_torch.config import QmannConfig  # noqa: E402
from qmann_tpu_torch.data import synthetic_batch  # noqa: E402
from qmann_tpu_torch.models import memn2n  # noqa: E402
from qmann_tpu_torch.numerics import fixed_max_float  # noqa: E402
from qmann_tpu_torch.numerics import float_quant  # noqa: E402
from qmann_tpu_torch.ops import exact_matmul  # noqa: E402
from qmann_tpu_torch.numerics import QFormat  # noqa: E402
from qmann_tpu_torch.ops.cuda import attention_read as ar  # noqa: E402
from qmann_tpu_torch.ops.attention import surrogate_terms  # noqa: E402
from qmann_tpu_torch.ops.cuda import hamming as ham  # noqa: E402
from qmann_tpu_torch.ops.cuda import hamming_bwd as hbwd  # noqa: E402
from qmann_tpu_torch.ops.cuda import hop_chain  # noqa: E402
from qmann_tpu_torch.ops.cuda import qmatvec as qmv  # noqa: E402
from qmann_tpu_torch.ops.cuda import qweighted_sum_bwd as wsb  # noqa: E402
from qmann_tpu_torch.ops.qlinear import (  # noqa: E402
    qembed_mat_forward, qmatvec_forward, qweighted_sum_backward,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _chain_args(cfg, V, M, W, B, dev, seed=0):
    """The chain's inputs as forward_prepared makes them: synthetic
    qa1-shaped stories, seeded weights x4, the exact question GEMM."""
    dims, mem, que, mask = synthetic_batch(np.random.default_rng(seed), B,
                                           V, M, W)
    params = {k: 4.0 * v for k, v in memn2n.init_params(
        cfg, dims, torch.Generator().manual_seed(seed), device=dev).items()}
    prep = memn2n.prepare_inference(params, cfg, max_count=float(W + 1),
                                    max_rowsum=float(W + 1))
    assert prep.fast
    mem_t, que_t, mask_t = (torch.from_numpy(a).to(dev)
                            for a in (mem, que, mask))
    u = float_quant(exact_matmul(que_t, prep.query_wt), cfg.fmt_w[0])
    return (mem_t, prep.embed_wt, u, prep.hmats, mask_t, cfg.fmt_w,
            cfg.fmt_att, cfg.fmt_bin, cfg.fmt_act)


CHAIN = hop_chain.fused_hop_chain_from_memory


def _assert_chain_kernel_matches(cfg, args, flags):
    """One launch of the chain kernel against its plain version, under
    the module docstring's tolerances."""
    before = CHAIN.launches
    u_g, p_g, s_g = CHAIN(*args, **flags)
    u_w, p_w, s_w = hop_chain.fused_hop_chain_from_memory_reference(
        *args, **{k: v for k, v in flags.items() if k != "hmats_quantized"})
    torch.cuda.synchronize()
    assert CHAIN.launches == before + 1
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
    before = CHAIN.launches
    with pytest.raises(ValueError, match="bounds"):
        CHAIN(torch.zeros((8, 65, 29), device=cuda), *args[1:4],
              torch.ones((8, 65), device=cuda), *args[5:])
    with pytest.raises(ValueError, match="shapes"):
        CHAIN(args[0][:, :, :20], *args[1:])
    with pytest.raises(TypeError, match="float32"):
        CHAIN(args[0], args[1], args[2].double(), *args[3:])
    assert CHAIN.launches == before


def _training_inputs(V, M, W, B, dev, seed=0, quant_mode=3):
    """The flagship training layout with weights x4; the last three samples
    have no live row, as the padded samples of a partial batch."""
    cfg = QmannConfig(use_pallas=True, quant_mode=quant_mode)
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


# a family's reads folded to one launch, at megasweep's layout: the R = 40
# mode-3 family's step (1280 queries) and evaluation chunk (5120), the
# R = 200 family's step (6400) and evaluation chunk (25,600)
FAMILY_READS = [(64, 50, 6, 1280), (64, 50, 6, 5120), (64, 50, 6, 6400),
                (64, 50, 6, 25600)]


@pytest.mark.cuda
@pytest.mark.parametrize("quant_mode", [3, 0, 1, 2])
@pytest.mark.parametrize("V,M,W,B", [(19, 10, 6, 32), (19, 10, 6, 1024),
                                     (64, 50, 7, 32)])
def test_qmatvec_kernel_matches_plain(cuda, V, M, W, B, quant_mode):
    cfg, params, mem, que, _, u = _training_inputs(V, M, W, B, cuda,
                                                   quant_mode=quant_mode)
    rows = mem.reshape(-1, mem.shape[-1])
    fw = cfg.fmt_w
    cases = [(params["B"], que, fw[0], fw[0]),
             (params["A"], rows, fw[0], fw[0]),
             (params["C"], rows, fw[2], fw[2]),
             (params["H"], u, fw[1], cfg.fmt_bin),
             (params["B"], que, QFormat(0, 0, quant_mode), fw[0]),
             (params["H"], u, fw[1], QFormat(0, 0, quant_mode))]
    for w, x, f_w, f_x in cases:
        before = qmv.quantized_matvec.launches
        got = qmv.quantized_matvec(w, x, f_w, f_x)
        want = qmv.quantized_matvec_reference(w, x, f_w, f_x)
        torch.cuda.synchronize()
        assert qmv.quantized_matvec.launches == before + 1
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("quant_mode", [3, 0, 1, 2])
@pytest.mark.parametrize("mode", [2, 1])
@pytest.mark.parametrize("V,M,W,B", [(19, 10, 6, 32), (19, 10, 6, 1024),
                                     (64, 50, 7, 32)] + FAMILY_READS[2:])
def test_attention_read_kernel_matches_plain(cuda, V, M, W, B, mode,
                                             quant_mode):
    cfg, params, mem, _, mask, u = _training_inputs(V, M, W, B, cuda,
                                                    quant_mode=quant_mode)
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
                                   (32, 50, 60), (1280, 50, 60),
                                   (5120, 50, 60)])
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


def _assert_backward_matches(m, u, g, iwl, num_bit, mode):
    """The surrogate backward kernel against hamming_backward on the card:
    one launch counted, dm bit for bit, du within its rounding bound, a
    second launch bitwise equal."""
    args = (m, u, g, iwl, num_bit, -3, mode)
    before = hbwd.hamming_backward_kernel.launches
    dm, du = hbwd.hamming_backward_kernel(*args)
    want_dm, want_du = hbwd.hamming_backward(*args)
    again = hbwd.hamming_backward_kernel(*args)
    torch.cuda.synchronize()
    assert hbwd.hamming_backward_kernel.launches == before + 2
    assert dm.shape == m.shape and du.shape == u.shape
    assert torch.equal(dm.view(torch.int32), want_dm.view(torch.int32))
    _, grad_appx = surrogate_terms(m, u, iwl, num_bit, -3, mode)
    slack = (2 * m.shape[-2] * 2.0 ** -24
             * (grad_appx * g[..., None]).abs().sum(-2))
    assert bool(((du - want_du).abs() <= slack).all())
    assert torch.equal(again[0].view(torch.int32), dm.view(torch.int32))
    assert torch.equal(again[1].view(torch.int32), du.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [3, 0, 1, 2])
@pytest.mark.parametrize("iwl", [0, 1, 5, 31])
@pytest.mark.parametrize("B,M,D,num_bits", [
    (32, 10, 60, range(1, 33)), (1024, 10, 60, (1, 8, 25, 32)),
    (32, 50, 60, (1, 8, 25, 32))])
def test_hamming_backward_kernel_matches_plain(cuda, B, M, D, num_bits, iwl,
                                               mode):
    """At the training, eval-chunk and wide shapes, on ham_inputs (the
    encode's edge list in sample 0), every num_bit from 1 to 32 at the
    training shape, num_bit 1, 8, 25 and 32 at the others."""
    m, u = (torch.from_numpy(a).to(cuda) for a in ham_inputs(iwl, B, M, D))
    g = torch.from_numpy(np.random.default_rng(iwl).normal(
        0.0, 1.0, (B, M)).astype(np.float32)).to(cuda)
    g[0, :2] = torch.tensor([0.0, -0.0])
    for num_bit in num_bits:
        _assert_backward_matches(m, u, g, iwl, num_bit, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [3, 0, 1, 2])
@pytest.mark.parametrize("B", [32, 128])
def test_hamming_backward_kernel_folds_a_family(cuda, B, mode):
    """The mode-3 family's [R, B, M, D] = [40, B, 50, 60], folded into the
    kernel's batch by the wrapper, at every rounding mode."""
    m, u = (torch.from_numpy(a).to(cuda) for a in ham_inputs(1, 40 * B, 50,
                                                             60))
    m, u = m.reshape(40, B, 50, 60), u.reshape(40, B, 60)
    g = torch.from_numpy(np.random.default_rng(B).normal(
        0.0, 1.0, (40, B, 50)).astype(np.float32)).to(cuda)
    _assert_backward_matches(m, u, g, 1, 8, mode)


@pytest.mark.cuda
def test_hamming_backward_kernel_rejects_what_it_cannot_take(cuda):
    m = torch.zeros((4, 6, 8), device=cuda)
    u = torch.zeros((4, 8), device=cuda)
    g = torch.zeros((4, 6), device=cuda)
    before = hbwd.hamming_backward_kernel.launches
    with pytest.raises(ValueError, match="num_bit in"):
        hbwd.hamming_backward_kernel(m, u, g, 1, 33)
    with pytest.raises(ValueError, match="shapes"):
        hbwd.hamming_backward_kernel(m, u[:, :7], g, 1, 8)
    with pytest.raises(ValueError, match="M<=64, 1<=D<=256"):
        hbwd.hamming_backward_kernel(torch.zeros((2, 65, 8), device=cuda),
                                     u[:2], torch.zeros((2, 65),
                                                        device=cuda), 1, 8)
    with pytest.raises(ValueError, match="different devices"):
        hbwd.hamming_backward_kernel(m, u, g.cpu(), 1, 8)
    with pytest.raises(TypeError, match="float32"):
        hbwd.hamming_backward_kernel(m.double(), u, g, 1, 8)
    assert hbwd.hamming_backward_kernel.launches == before


def wsum_inputs(fmt, B, M, D, seed=0):
    """c, p, mask, g for the weighted sum's backward: Gaussian c and g at
    the format's range, p in [0, 1); sample 0 holds an edge list in c;
    sample 1's upstream row is zero; padded rows in every sample, p
    non-zero on them (a negative value meets the mask's 0)."""
    rng = np.random.default_rng(seed)
    top = 1.0 if fmt.is_binary else fixed_max_float(fmt.iwl, fmt.frac)
    c = rng.normal(0.0, 0.6 * top, (B, M, D)).astype(np.float32)
    edge = np.array([0.0, -0.0, top, -top, 1.5 * top, -1.5 * top, 1e-7,
                     -1e-7, 3e38, -3e38], np.float32)[:D]
    c[0, 0, :len(edge)] = edge
    p = rng.uniform(0.0, 1.0, (B, M)).astype(np.float32)
    g = rng.normal(0.0, 0.6 * top, (B, D)).astype(np.float32)
    g[min(1, B - 1)] = 0.0
    mask = (np.arange(M) < rng.integers(1, M + 1, (B, 1))).astype(np.float32)
    return c, p, mask, g


def _assert_wsum_backward_matches(c, p, mask, g, fmt):
    """The weighted sum's backward kernel against its plain version on the
    card: two launches counted, dc bit for bit, dp bit for bit where every
    sum is exact and within dp_interval elsewhere, the second launch
    bitwise equal to the first."""
    args = (c, p, mask, g, fmt)
    before = wsb.qweighted_sum_backward_kernel.launches
    dc, dp = wsb.qweighted_sum_backward_kernel(*args)
    again = wsb.qweighted_sum_backward_kernel(*args)
    want_dc, want_dp = qweighted_sum_backward(c, p, mask, g, fmt,
                                              grad_quantized=True)
    torch.cuda.synchronize()
    assert wsb.qweighted_sum_backward_kernel.launches == before + 2
    assert dc.shape == c.shape and dp.shape == p.shape
    assert torch.equal(dc.view(torch.int32), want_dc.view(torch.int32))
    if wsb.sums_exact(fmt, c.shape[-1]):
        assert torch.equal(dp.view(torch.int32), want_dp.view(torch.int32))
    lo, hi = wsb.dp_interval(c, mask, g, fmt)
    assert bool(((lo <= dp) & (dp <= hi)).all())
    for a, b in zip(again, (dc, dp)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


WSUM_FORMATS = ([QFormat(iwl, 7 - iwl, mode) for iwl in (0, 1, 5)
                 for mode in (3, 0, 1, 2)] + [QFormat(0, 0, 3)]
                + [QFormat(1, wl - 2, mode) for wl in (16, 24, 32)
                   for mode in (3, 0, 1, 2)])


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", WSUM_FORMATS)
@pytest.mark.parametrize("B,M,D", [(32, 10, 60), (1024, 10, 60),
                                   (32, 50, 60), (1, 1, 1), (7, 64, 256)])
def test_qweighted_sum_backward_kernel_matches_plain(cuda, B, M, D, fmt):
    """At the training, eval-chunk and wide shapes and the limits, at
    8-bit words in every rounding mode, the binary format and 16-, 24-
    and 32-bit words."""
    _assert_wsum_backward_matches(
        *(torch.from_numpy(a).to(cuda) for a in wsum_inputs(fmt, B, M, D)),
        fmt)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [32, 128])
def test_qweighted_sum_backward_kernel_folds_a_family(cuda, B):
    """The mode-3 family's [R, B, M, D] = [40, B, 50, 60], folded into the
    kernel's batch by the wrapper."""
    fmt = QFormat(1, 6)
    c, p, mask, g = (torch.from_numpy(a).to(cuda)
                     for a in wsum_inputs(fmt, 40 * B, 50, 60, seed=B))
    _assert_wsum_backward_matches(c.reshape(40, B, 50, 60),
                                  p.reshape(40, B, 50),
                                  mask.reshape(40, B, 50),
                                  g.reshape(40, B, 60), fmt)


def _assert_ds_entry_matches(c, p, mask, g, fmt, quantized, cotangents):
    """The ds entry against its plain version on the card: one launch
    counted per call, dc bit for bit, ds within ds_bound, the second launch
    bitwise equal to the first."""
    dp_in, ds_in = (torch.randn(p.shape, device=p.device) if on else None
                    for on in cotangents)
    args = (c, p, mask, g, dp_in, ds_in, fmt, quantized)
    kernel = wsb.weighted_sum_softmax_backward_kernel
    before = kernel.launches
    dc, ds = kernel(*args)
    again = kernel(*args)
    want_dc, want_ds = wsb.weighted_sum_softmax_backward_plain(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    assert dc.shape == c.shape and ds.shape == p.shape
    assert torch.equal(dc.view(torch.int32), want_dc.view(torch.int32))
    _, dp = qweighted_sum_backward(c, p, mask, g, fmt,
                                   grad_quantized=quantized)
    if dp_in is not None:
        dp = dp + dp_in
    bound = wsb.ds_bound(p, dp, wsb.dp_error(c, mask, g, fmt, quantized,
                                             dp_in), ds_in)
    assert bool(((ds.double() - want_ds.double()).abs() <= bound).all())
    for a, b in zip(again, (dc, ds)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("cotangents", [(False, False), (True, True)])
@pytest.mark.parametrize("fmt", WSUM_FORMATS + [None])
@pytest.mark.parametrize("B,M,D", [(32, 10, 60), (1024, 10, 60),
                                   (32, 50, 60), (1, 1, 1), (7, 64, 256),
                                   (5, 33, 130), (9, 3, 7)])
def test_weighted_sum_softmax_backward_kernel_matches_plain(cuda, B, M, D,
                                                            fmt, cotangents):
    """The ds entry at the training, eval-chunk and wide shapes, the
    limits, two column groups a lane (D=130) and the scalar instance
    (D=7), at every format of the dp entry's tests (quantized) and in the
    float instance (fmt None: unit-range inputs), with and without the
    cotangents of p and the scores."""
    quantized = fmt is not None
    c, p, mask, g = (torch.from_numpy(a).to(cuda) for a in wsum_inputs(
        fmt if quantized else QFormat(0, 7), B, M, D))
    if not quantized:
        c = c.clamp(-4.0, 4.0)
    _assert_ds_entry_matches(c, p, mask, g, fmt or QFormat(5, 2), quantized,
                             cotangents)


@pytest.mark.cuda
@pytest.mark.parametrize("R,B,quantized", [(40, 32, True), (40, 128, True),
                                           (200, 32, False)])
def test_weighted_sum_softmax_backward_kernel_folds_a_family(cuda, R, B,
                                                             quantized):
    """The mode-3 family's [40, B, 50, 60] (quantized) and the R = 200
    family's [200, 32, 50, 60] (float), folded by the wrapper."""
    fmt = QFormat(1, 6) if quantized else QFormat(0, 7)
    c, p, mask, g = (torch.from_numpy(a).to(cuda)
                     for a in wsum_inputs(fmt, R * B, 50, 60, seed=B))
    _assert_ds_entry_matches(c.reshape(R, B, 50, 60).clamp(-4.0, 4.0),
                             p.reshape(R, B, 50), mask.reshape(R, B, 50),
                             g.reshape(R, B, 60), fmt, quantized,
                             (False, False))


@pytest.mark.cuda
def test_qweighted_sum_backward_kernel_rejects_what_it_cannot_take(cuda):
    c = torch.zeros((4, 6, 8), device=cuda)
    p = torch.zeros((4, 6), device=cuda)
    g = torch.zeros((4, 8), device=cuda)
    fmt = QFormat(1, 6)
    kernel = wsb.qweighted_sum_backward_kernel
    before = kernel.launches
    with pytest.raises(ValueError, match="format"):
        kernel(c, p, p, g, QFormat(1, 31))
    with pytest.raises(ValueError, match="shapes"):
        kernel(c, p, p, g[:, :7], fmt)
    with pytest.raises(ValueError, match="M<=64, 1<=D<=256"):
        kernel(torch.zeros((2, 65, 8), device=cuda),
               torch.zeros((2, 65), device=cuda),
               torch.zeros((2, 65), device=cuda), g[:2], fmt)
    with pytest.raises(ValueError, match="different devices"):
        kernel(c, p, p, g.cpu(), fmt)
    with pytest.raises(TypeError, match="float32"):
        kernel(c.double(), p, p, g, fmt)
    assert kernel.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("quant_mode", [3, 0, 1, 2])
@pytest.mark.parametrize("iwl", [1, 5])
@pytest.mark.parametrize("V,M,W,B", [(19, 10, 6, 32), (19, 10, 6, 1024),
                                     (64, 50, 7, 32)] + FAMILY_READS)
def test_attention_read_mode3_matches_plain(cuda, V, M, W, B, iwl,
                                            quant_mode):
    cfg, params, mem, que, mask, _ = _training_inputs(V, M, W, B, cuda,
                                                      quant_mode=quant_mode)
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
    ({"use_pallas": True}, (10, 3, 0, 3, 0, 3)),
    ({"use_pallas_hamming": True}, (0, 0, 3, 3, 3, 0)),
    ({"use_pallas": True, "en_grad_quant": True}, (10, 0, 3, 3, 3, 0))])
def test_mode3_train_step_kernel_route_matches_plain_route(cuda, extra,
                                                          launches):
    """One SGD step at iwl 1, mode 3, on a partial batch: the kernel routes
    launch the lattice, the mode-3 read or the Hamming kernel, the
    surrogate backward and the weighted sum's quantized backward once per
    hop, as many times as a step runs them, and agree with plain
    PyTorch."""
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
                    ham.hamming_score_kernel, hbwd.hamming_backward_kernel,
                    wsb.qweighted_sum_backward_kernel,
                    wsb.weighted_sum_softmax_backward_kernel)
        before = [f.launches for f in counters]
        cost, _ = train_step(params, batch, lr, route)
        launched = tuple(f.launches - b for f, b in zip(counters, before))
        assert launched == (launches if route is not cfg else (0,) * 6)
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
    stacked GEMM) as the memory, with the identity as the weights: the
    kernel's slices are flat's values, so its requant of them is
    exercised on arbitrary floats; u quantized at fmt_w[0], lin maps of
    the same sd, partial masks and, from B=7 on, a last query with no
    live row."""
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
    return cfg, (flat_t, torch.eye(2 * K * D, device=dev), u_t, hm_t,
                 mask_t, cfg.fmt_w, cfg.fmt_att, cfg.fmt_bin, cfg.fmt_act)


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
    before = CHAIN.launches
    with pytest.raises(ValueError, match="rounding mode"):
        CHAIN(*args[:8], fmts_act)
    w = torch.ones((6, 5), device=cuda)
    x = torch.ones((4, 5), device=cuda)
    with pytest.raises(ValueError, match="rounding mode"):
        qmv.quantized_matvec(w, x, QFormat(5, 2, 3), QFormat(5, 2, 1))
    assert CHAIN.launches == before
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
    u = float_quant(exact_matmul(que_t, prep.query_wt), cfg.fmt_w[0])
    fmts = (cfg.fmt_w, cfg.fmt_att, cfg.fmt_bin, cfg.fmt_act)
    flags = dict(attention_mode=attention_mode,
                 ham_num_bit=cfg.num_bits_attention)
    got = CHAIN(mem_t, prep.embed_wt, u, prep.hmats_q, mask_t, *fmts,
                hmats_quantized=True, **flags)
    want = hop_chain.fused_hop_chain_from_memory_reference(
        mem_t, prep.embed_wt, u, prep.hmats, mask_t, *fmts, **flags)
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
# the kernel's embedding: each hop's slices from the memory and Q(A|C),
# bit-identical to the kernel on the exact GEMM's output
# ---------------------------------------------------------------------------

# (V, M, W): the flagship (I=29), the wide layout (I=114), rows of 10 to 13
# nonzero entries at the wide layout (longer than the kList = 8 slots), a
# large I (1050)
EMBED_LAYOUTS = {"flagship": (19, 10, 6), "wide": (64, 50, 6),
                 "long rows": (64, 50, 11), "large I": (1000, 50, 6)}


def _chain_on_flat(memory, embed_wt, *rest, **flags):
    """The chain kernel on the exact GEMM's output: flat as the memory and
    the identity as the weights, so that each hop's slices are flat's
    values (x * 1 plus +-0 terms is x): the oracle for the kernel's own
    embedding of the memory."""
    flat = exact_matmul(memory, embed_wt)
    eye = torch.eye(flat.shape[-1], device=flat.device)
    return CHAIN(flat, eye, *rest, **flags)


def _embedded_case(cfg, V, M, W, B, dev, seed=0):
    """Bag-of-words stories whose every row, live or padded, holds W
    random words and its time bit; counts at max_count (W+1) in every
    third query; one dense row (every entry 1); random live lengths and,
    from B=2 on, a last query that is all padding.  Seeded weights x4, or
    x3 where x4 leaves the exact route (rows of more than 8 words),
    prepare_inference on those bounds (max_rowsum covers the dense row).
    Returns (prep, memory, question, mask) on dev."""
    rng = np.random.default_rng(seed)
    I = V + M
    dims, _, que, _ = synthetic_batch(rng, B, V, M, W)
    mem = np.zeros((B, M, I), np.float32)
    np.add.at(mem, (np.arange(B)[:, None, None], np.arange(M)[None, :, None],
                    rng.integers(1, V, (B, M, W))), 1.0)
    mem[:, np.arange(M), V + np.arange(M)] = 1.0
    mem[::3, 0, 0] = W + 1
    mem[0, M // 2] = 1.0
    mask = np.arange(M)[None, :] < rng.integers(1, M + 1, B)[:, None]
    if B >= 2:
        mask[-1] = False
    base = memn2n.init_params(cfg, dims, torch.Generator().manual_seed(seed),
                              device=dev)
    for scale in (4.0, 3.0):
        prep = memn2n.prepare_inference(
            {k: scale * v for k, v in base.items()}, cfg,
            max_count=float(W + 1), max_rowsum=float(max(I, W + 1)))
        if prep.fast:
            break
    assert prep.fast and prep.hmats_q is not None
    return prep, *(torch.from_numpy(a).to(dev) for a in (mem, que, mask))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", EMBED_LAYOUTS)
@pytest.mark.parametrize("B,quant_mode", [(1, 3), (64, 3), (1000, 3),
                                          (1000, 0), (1000, 1), (1000, 2)])
@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("attention_mode", [2, 3])
def test_embedded_chain_kernel_matches_gemm_and_flat_kernel(
        cuda, attention_mode, cached, B, quant_mode, layout):
    """fused_hop_chain_from_memory's (u, p, s) equal, bit for bit, the
    kernel on the exact GEMM's output (_chain_on_flat), on raw H and on
    the cached Q(H), and hold to the plain version under the module
    docstring's tolerances; one launch counted.  At B=1000 in every
    rounding mode (the kernel fixes the mode at compile time)."""
    cfg = QmannConfig(use_fused_chain=True, attention_mode=attention_mode,
                      quant_mode=quant_mode)
    prep, mem, que, mask = _embedded_case(cfg, *EMBED_LAYOUTS[layout], B,
                                          cuda)
    u = float_quant(exact_matmul(que, prep.query_wt), cfg.fmt_w[0])
    hm = prep.hmats_q if cached else prep.hmats
    rest = (mask, cfg.fmt_w, cfg.fmt_att, cfg.fmt_bin, cfg.fmt_act)
    flags = dict(attention_mode=attention_mode,
                 ham_num_bit=cfg.num_bits_attention, hmats_quantized=cached)
    want = _chain_on_flat(mem, prep.embed_wt, u, hm, *rest, **flags)
    before = CHAIN.launches
    got = CHAIN(mem, prep.embed_wt, u, hm, *rest, **flags)
    torch.cuda.synchronize()
    assert CHAIN.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    _assert_chain_kernel_matches(cfg, (mem, prep.embed_wt, u, hm, *rest),
                                 flags)


@pytest.mark.cuda
@pytest.mark.parametrize("attention_mode", [2, 3])
def test_embedded_chain_kernel_takes_an_all_padding_query(cuda,
                                                          attention_mode):
    """B=1 with no live row and nonzero counts in every row: every row is
    embedded and scored, p is 0, as on the exact GEMM's output."""
    cfg = QmannConfig(use_fused_chain=True, attention_mode=attention_mode)
    prep, mem, que, mask = _embedded_case(cfg, 19, 10, 6, 1, cuda)
    mask = torch.zeros_like(mask)
    u = float_quant(exact_matmul(que, prep.query_wt), cfg.fmt_w[0])
    rest = (prep.hmats_q, mask, cfg.fmt_w, cfg.fmt_att, cfg.fmt_bin,
            cfg.fmt_act)
    flags = dict(attention_mode=attention_mode,
                 ham_num_bit=cfg.num_bits_attention, hmats_quantized=True)
    want = _chain_on_flat(mem, prep.embed_wt, u, *rest, **flags)
    got = CHAIN(mem, prep.embed_wt, u, *rest, **flags)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not bool(got[1].any()) and bool(got[2].any())


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["flagship", "wide"])
@pytest.mark.parametrize("attention_mode", [2, 3])
def test_forward_prepared_embeds_in_the_chain(cuda, attention_mode, layout):
    """forward_prepared's chain route launches the chain once a call and
    gives the logits, p and scores of the exact GEMM then the chain kernel
    on its output, bit for bit."""
    cfg = QmannConfig(use_fused_chain=True, attention_mode=attention_mode)
    prep, mem, que, mask = _embedded_case(cfg, *EMBED_LAYOUTS[layout], 1000,
                                          cuda)
    u = memn2n._prepared_question(prep, que, cfg)
    u_w, p_w, s_w = _chain_on_flat(
        mem, prep.embed_wt, u, prep.hmats_q, mask, cfg.fmt_w, cfg.fmt_att,
        cfg.fmt_bin, cfg.fmt_act, attention_mode=attention_mode,
        ham_num_bit=cfg.num_bits_attention, hmats_quantized=True)
    logits_w = qmatvec_forward(memn2n._output_weight(prep.raw, cfg), u_w,
                               cfg.fmt_ds_ans, cfg.fmt_ds_ans,
                               quantized=False)
    before = CHAIN.launches
    with torch.inference_mode():
        out = memn2n.forward_prepared(prep, mem, que, mask, cfg)
    torch.cuda.synchronize()
    assert CHAIN.launches == before + 1
    assert torch.equal(out.logits, logits_w)
    assert torch.equal(out.attention, p_w)
    assert torch.equal(out.scores, s_w)


@pytest.mark.cuda
def test_embedded_chain_kernel_rejects_what_it_cannot_take(cuda):
    cfg = QmannConfig(use_fused_chain=True)
    prep, mem, que, mask = _embedded_case(cfg, 19, 10, 6, 8, cuda)
    u = float_quant(exact_matmul(que, prep.query_wt), cfg.fmt_w[0])
    rest = (prep.hmats, mask, cfg.fmt_w, cfg.fmt_att, cfg.fmt_bin,
            cfg.fmt_act)
    before = CHAIN.launches
    with pytest.raises(ValueError, match="shapes"):
        CHAIN(mem, prep.embed_wt[:-1], u, *rest)
    with pytest.raises(ValueError, match="bounds"):
        CHAIN(torch.zeros((8, 65, 29), device=cuda), prep.embed_wt, u,
              prep.hmats, torch.ones((8, 65), device=cuda), *rest[2:])
    with pytest.raises(TypeError, match="float32"):
        CHAIN(mem, prep.embed_wt.double(), u, *rest)
    assert CHAIN.launches == before


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


# the zero-skipping lattice's cases: (R, B) of x, the run.sh family's
# memory rows (R = 200, fewer rows) and one run's 32 / 320 / 1600 / 10240
SKIP_SHAPES = [(200, 64), (1, 32), (1, 320), (1, 1600), (1, 10240)]
SKIP_CASES = ["bow", "dense", "tiny", "negative", "nan_w", "nan_x",
              "mixed", "binary_w", "binary_x"]


def _skip_operands(case, R, B, mode, dev):
    """(w, x, fmt_w, fmt_x) of one zero-skip case: bag-of-words rows of
    I = 64 + 50 (6 words and a time bit, every other row dead) against
    Gaussian weights; "dense" is a hop's linear map (O = I = 60, Gaussian
    x); "tiny" adds values that Q(x) rounds to zero; "negative" has
    negative weights and x, so zeros meet them with either sign; "nan_w"
    a NaN in w on columns where x is zero; "nan_x" a NaN in x; "mixed"
    Q6.1 x Q2.5; the binary formats map 0 to +1 (no skip)."""
    rng = np.random.default_rng(SKIP_CASES.index(case) * 64 + B + R + mode)
    O, I = 60, 114
    w = rng.normal(0.0, 1.5, (R, O, I)).astype(np.float32)
    x = np.zeros((R, B, I), np.float32)
    runs, live = np.arange(R)[:, None], np.arange(0, B, 2)
    for _ in range(6):
        np.add.at(x, (runs, live, rng.integers(0, 64, (R, live.size))), 1.0)
    x[:, live, 64 + live % 50] = 1.0
    f = QFormat(5, 2, mode)
    fmt_w = fmt_x = f
    if case == "dense":
        w = rng.normal(0.0, 1.5, (R, 60, 60)).astype(np.float32)
        x = rng.normal(0.0, 1.5, (R, B, 60)).astype(np.float32)
    elif case == "tiny":
        x = x + (rng.normal(0.0, 1e-3, x.shape)
                 * (rng.random(x.shape) < 0.2)).astype(np.float32)
    elif case == "negative":
        w, x = -np.abs(w), -x
    elif case == "nan_w":
        w[:, 7, 100] = np.nan
        w[:, 3, 113] = np.nan
    elif case == "nan_x":
        x[:, 1 % B, 9] = np.nan
    elif case == "mixed":
        fmt_w, fmt_x = QFormat(6, 1, mode), QFormat(2, 5, mode)
    elif case == "binary_w":
        fmt_w = QFormat(0, 0, mode)
    elif case == "binary_x":
        fmt_x = QFormat(0, 0, mode)
    w, x = (torch.from_numpy(a).to(dev) for a in (w, x))
    if R == 1:
        w, x = w[0], x[0]
    return w, x, fmt_w, fmt_x


@pytest.mark.cuda
@pytest.mark.parametrize("quant_mode", [0, 1, 2, 3])
@pytest.mark.parametrize("case", SKIP_CASES)
@pytest.mark.parametrize("R,B", SKIP_SHAPES)
def test_qmatvec_skips_zero_entries_bit_for_bit(cuda, R, B, case,
                                                quant_mode):
    """The whole-row kernel skips the entries with Q(x) == +-0 whose column
    of Q(w) holds no NaN: bit-identical to the plain lattice (int32 views,
    NaN masks equal) on bag-of-words rows with dead rows, dense rows, tiny
    x, signed zeros, a NaN in Q(w) where x is zero (NaN, as dense), a NaN
    in x, mixed formats, every rounding mode; a launch counts in
    ``sparse_launches`` unless a format is binary (the dense loop)."""
    w, x, fmt_w, fmt_x = _skip_operands(case, R, B, quant_mode, cuda)
    before = (qmv.quantized_matvec.launches,
              qmv.quantized_matvec.sparse_launches)
    got = qmv.quantized_matvec(w, x, fmt_w, fmt_x)
    want = qmv.quantized_matvec_reference(w, x, fmt_w, fmt_x)
    torch.cuda.synchronize()
    sparse = 0 if case.startswith("binary") else 1
    assert (qmv.quantized_matvec.launches - before[0],
            qmv.quantized_matvec.sparse_launches - before[1]) == (1, sparse)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32),
                       want[~nan].view(torch.int32))
    if case == "nan_w":
        assert torch.isnan(got[..., [3, 7]]).all()


@pytest.mark.cuda
def test_graphed_family_step_counts_sparse_launches(cuda):
    """A family step captured as a graph (R = 6, use_pallas, the lattice's
    formats non-binary) counts each of its 10 lattice launches in
    ``sparse_launches`` too, per replay as per eager call."""
    from qmann_tpu_torch import graphs
    from qmann_tpu_torch.train import multi
    cfg = graphs.without_fast_path(QmannConfig(use_pallas=True,
                                               verbose=False))
    dims, mem, que, mask = synthetic_batch(np.random.default_rng(0), 32,
                                           19, 10, 6)
    R = 6
    params = {k: torch.stack([4.0 * v for _ in range(R)])
              for k, v in memn2n.init_params(
                  cfg, dims, torch.Generator().manual_seed(0),
                  device=cuda).items()}
    ans = np.zeros_like(que)
    ans[np.arange(32), np.arange(32) % 19] = 1.0
    one = {"memory": mem, "question": que, "answer": ans, "mask": mask,
           "sample_mask": np.ones(32, np.float32),
           "size_b": np.float32(32.0)}
    batch = {k: torch.stack([torch.as_tensor(v).to(cuda)] * R)
             for k, v in one.items()}
    lr = torch.tensor(cfg.learning_rate, device=cuda)
    g = graphs.Graphs(cuda)
    bound = (*params.values(), *batch.values(), lr)
    for _ in range(4):      # warm-up, capture and replay, replays
        before = graphs.launch_counts()
        g(("family_step",), lambda: multi.family_step(params, batch, lr,
                                                      cfg), bound=bound)
        torch.cuda.synchronize()
        ran = [a - b for a, b in zip(graphs.launch_counts(), before)]
        assert ran[0] == ran[7] == 10
    (graph,) = g.graphs.values()
    assert graph.replays == 3
    assert graph.launches[0] == graph.launches[7] == 10


def _edge_samples(dims, n_dict):
    """Packet-stream samples at the edges of the engine's index path: NULL
    (index 0) counted, indices past the dictionary and in the temporal
    columns dropped before the truncation to the row's words, stories past
    max_line, transmitted temporal indices out of range, in a word column
    or missing, empty sentences and an empty question."""
    from qmann_tpu_torch.serve.packet import IndexedSample
    d = dims
    drop = [n_dict, d.dim_dict - 1, d.dim_dict, d.dim_input - 1, 4095]
    words = [i % (n_dict - 1) + 1 for i in range(3 * d.max_word)]
    return [
        IndexedSample([[0, 0, 1], drop + words], [d.dim_dict, d.dim_dict + 1],
                      [0] + drop + [2, 3], [1]),
        IndexedSample([words[i:i + 3] for i in range(d.max_line + 3)],
                      [d.dim_dict + (i % d.max_line)
                       for i in range(d.max_line + 3)], words[:3], [1]),
        IndexedSample([[1, 2], [3], words, [4]], [d.dim_input, 2], [5, 6],
                      [2]),
        IndexedSample([[], [1], []], [d.dim_dict + 2, 4095, d.dim_dict], [],
                      [3]),
        IndexedSample([drop], [d.dim_dict], drop + words[:2], [1]),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("attention_mode", [2, 3])
def test_packet_server_on_the_card_through_the_chain(cuda, attention_mode):
    """The packet server in front of an engine on the card with
    use_fused_chain, in modes 2 and 3 at iwl 5: every answer over TCP, the
    edge samples' included, equals the plain route's for the sample as the
    server decodes it (the wire drops a sentence without a temporal
    index), one chain launch per wave, and no failed wave."""
    from qmann_tpu_torch.data import Dictionary, synthetic_samples
    from qmann_tpu_torch.serve import InferenceEngine
    from qmann_tpu_torch.serve.client import PacketClient
    from qmann_tpu_torch.serve.packet import (
        IndexedSample, PacketDecoder, encode_sample)
    from qmann_tpu_torch.serve.server import serve
    rng = np.random.default_rng(9)
    dims, _, _, _ = synthetic_batch(rng, 4, 19, 10, 6)
    dictionary = Dictionary()
    for i in range(1, 19):
        dictionary.add(f"w{i}")
    cfg = QmannConfig(use_fused_chain=True, attention_mode=attention_mode,
                      verbose=False)
    params = {k: 4.0 * v for k, v in memn2n.init_params(
        cfg, dims, torch.Generator().manual_seed(0), device=cuda).items()}
    samples = [IndexedSample(
        [[dictionary.lookup(w) for w in sent] for sent in s.sentences],
        [dims.dim_dict + len(s.sentences) - j - 1
         for j in range(len(s.sentences))],
        [dictionary.lookup(w) for w in s.question], [1])
        for s in synthetic_samples(rng, 200, 19, 10, 6)]
    samples += _edge_samples(dims, len(dictionary))
    engines = [InferenceEngine(params, c, dims, dictionary, batch_size=32,
                               max_wait_ms=5.0, device=cuda).start()
               for c in (cfg, cfg.replace(use_fused_chain=False))]
    server = serve(engines[0], port=0)
    host, port = server.server_address[:2]
    try:
        before = CHAIN.launches
        with PacketClient(host, port, timeout=120) as client:
            got = client.query_samples(samples)
        launched = CHAIN.launches - before
        want = [f.result(timeout=120) for f in [
            engines[1].submit_indexed(PacketDecoder().feed(
                encode_sample(s))[0]) for s in samples]]
    finally:
        server.shutdown()
        server.server_close()
        for e in engines:
            e.stop()
    assert engines[0].prepared.fast
    assert got == want and len(set(got)) > 1
    assert engines[0].stats.failed_waves == 0
    assert launched == engines[0].stats.waves >= 200 // 32
