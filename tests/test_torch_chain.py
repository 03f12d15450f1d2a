"""The chain's plain PyTorch version against JAX's fused_hop_chain_pallas
(interpret mode), and the wrapper's CPU dispatch.  The CUDA kernel against
the plain version is tests/test_torch_cuda.py.

Tolerances: every lattice sum and every Hamming row sum is exact, so hop
0's scores are bit-identical (modes 2 and 3).  The softmax's exp differs by
an ulp between torch and XLA, so p is held to atol 1e-6; a later hop can
then differ only where a Q(p, act) requant flipped, and every query without
such a flip must match bit for bit in all scores and in u_final.  Through
forward_prepared, the float output layer sums in another order: logits of
the queries without a flip within rtol 1e-5, atol 1e-5, and their
predictions equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from qmann_tpu_torch.config import QmannConfig  # noqa: E402
from qmann_tpu_torch.numerics import float_quant  # noqa: E402
from qmann_tpu_torch.ops import exact_matmul  # noqa: E402
from qmann_tpu_torch.ops.cuda import hop_chain  # noqa: E402

CHAIN = hop_chain.fused_hop_chain_from_memory


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


def _run_both(cfg, flat, u, hm, mask, linmap, relu, mode=2):
    from jax.experimental.pallas import tpu as pltpu
    from qmann_tpu.config import QmannConfig as JaxConfig
    from qmann_tpu.ops.pallas.qkernels import fused_hop_chain_pallas
    jcfg = JaxConfig(dim_emb=cfg.dim_emb, num_hops=cfg.num_hops)
    with pltpu.force_tpu_interpret_mode():
        want = fused_hop_chain_pallas(
            jnp.asarray(flat), jnp.asarray(u), jnp.asarray(hm),
            jnp.asarray(mask), jcfg.fmt_w, jcfg.fmt_att, jcfg.fmt_bin,
            jcfg.fmt_act, linear_mapping=linmap, non_linearity=relu,
            attention_mode=mode, ham_num_bit=jcfg.num_bits_attention)
    got = hop_chain.fused_hop_chain_reference(
        torch.from_numpy(flat), torch.from_numpy(u), torch.from_numpy(hm),
        torch.from_numpy(mask), cfg.fmt_w, cfg.fmt_att, cfg.fmt_bin,
        cfg.fmt_act, linear_mapping=linmap, non_linearity=relu,
        attention_mode=mode, ham_num_bit=cfg.num_bits_attention)
    return ([np.array(a) for a in want], [t.numpy() for t in got])


def _flips(cfg, p_w, p_g):
    """The queries in which some hop's Q(p, act) requant differs."""
    flipped = np.zeros(p_w.shape[1], bool)
    for h, fmt in enumerate(cfg.fmt_act):
        qw = float_quant(torch.from_numpy(p_w[h]), fmt).numpy()
        qg = float_quant(torch.from_numpy(p_g[h]), fmt).numpy()
        flipped |= (qw != qg).any(-1)
    return flipped


def _check_chain(cfg, want, got, B):
    """Apply the module docstring's tolerances; returns the flip count."""
    (u_w, p_w, s_w), (u_g, p_g, s_g) = want, got
    np.testing.assert_array_equal(s_g[0], s_w[0])
    np.testing.assert_allclose(p_g, p_w, rtol=0, atol=1e-6)
    ok = ~_flips(cfg, p_w, p_g)
    np.testing.assert_array_equal(s_g[:, ok], s_w[:, ok])
    np.testing.assert_array_equal(u_g[ok], u_w[ok])
    return B - int(ok.sum())


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


# the mode-3 rows (tying, linmap, relu) of test_pallas.py's chain grid
MODE3_ROWS = [(2, True, False), (1, False, False)]


@pytest.mark.parametrize("tying,linmap,relu", MODE3_ROWS)
def test_mode3_chain_reference_matches_jax_kernel(rng, tying, linmap, relu):
    """The in-chain Hamming score on the requanted m and the raw current
    u, at the config's num_bit (8)."""
    B = 7
    cfg, flat, u, hm, mask = _chain_inputs(rng, tying, B=B)
    want, got = _run_both(cfg, flat, u, hm, mask, linmap, relu, mode=3)
    assert _check_chain(cfg, want, got, B) <= 1


def _forward_prepared_vs_jax(rng, tying, linmap, relu, mode):
    """forward_prepared with use_fused_chain (the chain route, Q(H) cached
    by prepare_inference) against JAX's, in interpret mode, on
    test_pallas.py's set-up: weights x6, B=7, partial masks."""
    import jax
    from jax.experimental.pallas import tpu as pltpu
    from qmann_tpu.config import QmannConfig as JaxConfig
    from qmann_tpu.models import memn2n as jmodel
    from qmann_tpu_torch.data import DataDims
    from qmann_tpu_torch.models import memn2n
    kw = dict(dim_emb=8, num_hops=3, verbose=False, type_weight_tying=tying,
              attention_mode=mode, en_linear_mapping=linmap,
              en_non_linearity=relu, use_fused_chain=True)
    jcfg, cfg = JaxConfig(**kw), QmannConfig(**kw)
    dims = DataDims(dim_dict=12, max_line=5, max_word=5, dim_word=6,
                    dim_input=17)
    pj = {k: np.asarray(v) * np.float32(6.0) for k, v in
          jmodel.init_params(jcfg, dims, jax.random.PRNGKey(1)).items()}
    B = 7
    mem = rng.integers(0, 3, (B, 5, 17)).astype(np.float32)
    que = rng.integers(0, 3, (B, 17)).astype(np.float32)
    mask = np.arange(5)[None, :] < rng.integers(1, 6, B)[:, None]
    mem = mem * mask[:, :, None]
    bounds = dict(max_count=6.0, max_rowsum=6.0)
    jprep = jmodel.prepare_inference({k: jnp.asarray(v) for k, v in
                                      pj.items()}, jcfg, **bounds)
    prep = memn2n.prepare_inference(
        memn2n.params_from_jax(pj, cfg, device="cpu"), cfg, **bounds)
    assert prep.fast and jprep.fast
    want_q = torch.stack([float_quant(prep.hmats[h], cfg.fmt_w[h])
                          for h in range(3)])
    assert torch.equal(prep.hmats_q, want_q)
    with pltpu.force_tpu_interpret_mode():
        want = jmodel.forward_prepared(jprep, jnp.asarray(mem),
                                       jnp.asarray(que), jnp.asarray(mask),
                                       jcfg)
    before = CHAIN.launches
    got = memn2n.forward_prepared(prep, torch.from_numpy(mem),
                                  torch.from_numpy(que),
                                  torch.from_numpy(mask), cfg)
    assert CHAIN.launches == before   # CPU: plain chain
    p_w, p_g = np.array(want.attention), got.attention.numpy()
    s_w, s_g = np.array(want.scores), got.scores.numpy()
    np.testing.assert_array_equal(s_g[0], s_w[0])
    np.testing.assert_allclose(p_g, p_w, rtol=0, atol=1e-6)
    ok = ~_flips(cfg, p_w, p_g)
    assert ok.sum() >= B - 1
    np.testing.assert_array_equal(s_g[:, ok], s_w[:, ok])
    lw, lg = np.array(want.logits), got.logits.numpy()
    np.testing.assert_allclose(lg[ok], lw[ok], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(lg[ok].argmax(-1), lw[ok].argmax(-1))
    assert np.isfinite(lg).all()


@pytest.mark.parametrize("tying,linmap,relu", MODE3_ROWS)
def test_mode3_forward_prepared_matches_jax(rng, tying, linmap, relu):
    _forward_prepared_vs_jax(rng, tying, linmap, relu, mode=3)


@pytest.mark.parametrize("tying,linmap,relu", MODE3_ROWS)
def test_mode2_forward_prepared_matches_jax(rng, tying, linmap, relu):
    """The mode-2 twin: the chain route with Q(H) cached."""
    _forward_prepared_vs_jax(rng, tying, linmap, relu, mode=2)


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_float_quant_is_idempotent_up_to_30_bits(mode):
    """Why prepare_inference may cache Q(H) and the kernel skip its
    requant: for every (iwl, frac) with 1 <= iwl+frac <= 30,
    float_quant(float_quant(x)) == float_quant(x) bit for bit, on an edge
    list (+-maxf and beyond, +-2^31/2^frac, +-inf, +-0.0, tiny values, half
    steps) and a Gaussian spread."""
    from qmann_tpu_torch.numerics import QFormat, fixed_max_float
    for n in range(1, 31):
        for iwl in range(n + 1):
            fmt = QFormat(iwl, n - iwl, mode)
            maxf = np.float32(fixed_max_float(iwl, n - iwl))
            step = np.float32(2.0 ** -(n - iwl))
            pts = np.array([maxf, np.nextafter(maxf, np.float32(np.inf)),
                            2.0 ** (31 - n + iwl), np.inf, 0.0, 1e-45,
                            3e-9, 0.5 * step, 1.5 * step, 2.5 * step],
                           np.float32)
            spread = np.random.default_rng(n * 64 + iwl).normal(
                0.0, 2.0 ** iwl, 128).astype(np.float32)
            x = torch.from_numpy(np.concatenate([pts, -pts, spread]))
            once = float_quant(x, fmt)
            twice = float_quant(once, fmt)
            assert torch.equal(once.view(torch.int32),
                               twice.view(torch.int32)), fmt


def _memory_args(rng, fmts_act=None):
    """fused_hop_chain_from_memory's arguments on _embedded_inputs."""
    cfg, mem, wt, u, hm, mask = _embedded_inputs(rng, 2)
    return cfg, (*(torch.from_numpy(a) for a in (mem, wt, u, hm, mask)),
                 cfg.fmt_w, cfg.fmt_att, cfg.fmt_bin, fmts_act or cfg.fmt_act)


def test_wrapper_on_cpu_never_builds(rng, monkeypatch):
    def no_build():
        raise AssertionError("the CPU path must not touch the CUDA build")
    monkeypatch.setattr(hop_chain, "build", no_build)
    monkeypatch.setattr(hop_chain, "load_library", no_build)
    _, args = _memory_args(rng)
    before = CHAIN.launches
    got = CHAIN(*args)
    want = hop_chain.fused_hop_chain_from_memory_reference(*args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert CHAIN.launches == before


def test_wrapper_raises_on_mode_3(rng):
    """Mode 3 raises on Hamming knobs outside the kernel's ranges, on
    every device; a mode the chain does not cover raises too."""
    _, args = _memory_args(rng)
    flat_args = (exact_matmul(args[0], args[1]), *args[2:])
    for fn, a in ((CHAIN, args),
                  (hop_chain.fused_hop_chain_reference, flat_args)):
        for knobs in (dict(ham_num_bit=0), dict(ham_const_scale=-65)):
            with pytest.raises(ValueError, match="num_bit in"):
                fn(*a, attention_mode=3, **knobs)
        with pytest.raises(ValueError, match="modes 2 and 3"):
            fn(*a, attention_mode=1)


@pytest.mark.parametrize("M,D", [(1, 1), (10, 60), (50, 60), (64, 1),
                                 (1, 128), (64, 128)])
def test_chain_geometry_covers_every_query_once(M, D):
    """For every B from 1 to 2100 (and B=100000) at the kernel's limits,
    from a memory of the flagship's 29 entries a row: block b takes
    queries [b*qpb, min((b+1)*qpb, B)), so the blocks cover each query
    exactly once; shared memory fits the 227 KB a block may take, the
    opt-in flag is set exactly above 48 KB, and the threads are whole
    warps within the kernel's 512."""
    for B in [*range(1, 2101), 100000]:
        for K in (1, hop_chain.MAX_HOPS):
            geo = hop_chain.chain_geometry(B, M, D, K, 29)
            qpb = geo.queries_per_block
            assert qpb >= 1 and (geo.blocks - 1) * qpb < B <= geo.blocks * qpb
            covered = np.zeros(B, np.int64)
            for b in range(geo.blocks):
                covered[b * qpb:min((b + 1) * qpb, B)] += 1
            assert (covered == 1).all()
            assert geo.smem_bytes == hop_chain.chain_smem_bytes(
                qpb, M, D, 29, geo.weights_staged)
            assert geo.smem_bytes <= hop_chain.SMEM_LIMIT <= 227 * 1024
            assert geo.opt_in == (geo.smem_bytes > 48 * 1024)
            assert geo.threads % 32 == 0
            assert 32 <= geo.threads <= hop_chain.MAX_THREADS


def test_chain_geometry_keeps_the_largest_shape_in_one_block():
    """At K=8, M=64, D=128 one query per block still fits, from a memory
    of 1 entry a row (its weight slices staged in the buffer of Q(H)) and
    of 1050 (read through the cache): Q(H) 128 x 129, the rows' lists of
    8 pairs and counts, one stage of 64 x 256 floats, the per-query
    vectors."""
    for I, staged in ((1, True), (1050, False)):
        geo = hop_chain.chain_geometry(1, 64, 128, 8, I)
        assert geo.queries_per_block == 1 and geo.opt_in
        assert geo.weights_staged == staged
        assert geo.smem_bytes == 4 * (128 * 129 + 64 * (2 * 128 + 2 * 8 + 1)
                                      + 3 * 128 + 3 * 64)


def test_wrapper_on_cpu_takes_mixed_rounding_modes(rng):
    """The kernel fixes one rounding mode per launch and its wrapper
    refuses formats that mix modes on the card (tests/test_torch_cuda.py);
    the plain version, which CPU tensors take, keeps accepting them."""
    from qmann_tpu_torch.numerics import QFormat
    cfg = QmannConfig(dim_emb=8, num_hops=3)
    _, args = _memory_args(rng, (QFormat(5, 2, 0),) + cfg.fmt_act[1:])
    got = CHAIN(*args)
    want = hop_chain.fused_hop_chain_from_memory_reference(*args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _embedded_inputs(rng, tying, B=7, M=5, D=8, K=3, I=17, scale=0.6):
    """The embedded chain's inputs: bag-of-words counts (0..2, padded rows
    left nonzero, the last query all padding), embed_wt = Q(A|C) [I, 2K*D]
    quantized per hop at fmt_w, u quantized at fmt_w[0], lin maps of sd
    `scale`."""
    cfg = QmannConfig(dim_emb=D, num_hops=K)
    mem = rng.integers(0, 3, (B, M, I)).astype(np.float32)
    mask = np.arange(M)[None, :] < rng.integers(1, M + 1, B)[:, None]
    mask[-1] = False
    emb = torch.from_numpy(rng.normal(0.0, scale, (I, 2 * K * D))
                           .astype(np.float32))
    wt = torch.cat([float_quant(emb[:, j * D:(j + 1) * D], cfg.fmt_w[j % K])
                    for j in range(2 * K)], dim=1).numpy()
    que = rng.integers(0, 3, (B, I)).astype(np.float32)
    u_raw = que @ rng.normal(0.0, scale, (I, D)).astype(np.float32)
    u = float_quant(torch.from_numpy(u_raw), cfg.fmt_w[0]).numpy()
    hm = rng.normal(0.0, scale, (K if tying == 1 else 1, D, D))
    hm = np.broadcast_to(hm, (K, D, D)).astype(np.float32).copy()
    return cfg, mem, wt, u, hm, mask


@pytest.mark.parametrize("mode", [2, 3])
@pytest.mark.parametrize("tying,linmap,relu", [(1, True, False),
                                               (2, False, True)])
def test_embedded_chain_reference_matches_jax(rng, tying, linmap, relu,
                                              mode):
    """fused_hop_chain_from_memory's plain version (the exact stacked GEMM,
    then the plain chain) against JAX's _mxu_matmul then
    fused_hop_chain_pallas (interpret mode), on padded rows with nonzero
    counts and an all-padding query: the module docstring's tolerances,
    and the product itself bit-identical."""
    from qmann_tpu.ops.qlinear import _mxu_matmul
    B = 7
    cfg, mem, wt, u, hm, mask = _embedded_inputs(rng, tying, B=B)
    flat = np.array(_mxu_matmul(jnp.asarray(mem), jnp.asarray(wt), True))
    np.testing.assert_array_equal(
        flat, exact_matmul(torch.from_numpy(mem), torch.from_numpy(wt)))
    want, _ = _run_both(cfg, flat, u, hm, mask, linmap, relu, mode=mode)
    got = hop_chain.fused_hop_chain_from_memory_reference(
        torch.from_numpy(mem), torch.from_numpy(wt), torch.from_numpy(u),
        torch.from_numpy(hm), torch.from_numpy(mask), cfg.fmt_w,
        cfg.fmt_att, cfg.fmt_bin, cfg.fmt_act, linear_mapping=linmap,
        non_linearity=relu, attention_mode=mode,
        ham_num_bit=cfg.num_bits_attention)
    assert _check_chain(cfg, want, [t.numpy() for t in got], B) <= 1


def test_embedded_wrapper_on_cpu_never_builds(rng, monkeypatch):
    """On CPU tensors fused_hop_chain_from_memory is its plain version, which
    is the plain chain on exact_matmul(memory, embed_wt) bit for bit, and
    counts no launch."""
    def no_build():
        raise AssertionError("the CPU path must not touch the CUDA build")
    monkeypatch.setattr(hop_chain, "build", no_build)
    monkeypatch.setattr(hop_chain, "load_library", no_build)
    cfg, mem, wt, u, hm, mask = _embedded_inputs(rng, 2)
    mem_t, wt_t = torch.from_numpy(mem), torch.from_numpy(wt)
    rest = (torch.from_numpy(u), torch.from_numpy(hm), torch.from_numpy(mask),
            cfg.fmt_w, cfg.fmt_att, cfg.fmt_bin, cfg.fmt_act)
    launches = CHAIN.launches
    for mode in (2, 3):
        got = CHAIN(mem_t, wt_t, *rest, attention_mode=mode)
        want = hop_chain.fused_hop_chain_reference(
            exact_matmul(mem_t, wt_t), *rest, attention_mode=mode)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert CHAIN.launches == launches


@pytest.mark.parametrize("I", [1, 29, 114, 1050])
@pytest.mark.parametrize("M,D", [(1, 1), (10, 60), (50, 60), (64, 1),
                                 (1, 128), (64, 128)])
def test_embedded_chain_geometry_fits(M, D, I):
    """The launch's geometry, for every B from 1 to 2100 (and B=100000)
    over the kernel's limits and memories of 1 to 1050 entries a row: the
    blocks cover each query once, one stage of slices, the rows' lists of
    x and the weight slices where they are staged fit the 227 KB a block
    may take, the slices are staged wherever they fit beside one query,
    the opt-in flag is set exactly above 48 KB, and the threads are whole
    warps within 512.  A block with a longer row than LIST_ENTRIES, full
    or the last: its lists get an even number of at least LIST_ENTRIES
    slots a row, within the room from the end of Q(H) to the counts."""
    for B in [*range(1, 2101), 100000]:
        for K in (1, hop_chain.MAX_HOPS):
            geo = hop_chain.chain_geometry(B, M, D, K, I)
            qpb = geo.queries_per_block
            assert qpb >= 1 and (geo.blocks - 1) * qpb < B <= geo.blocks * qpb
            assert geo.smem_bytes == hop_chain.chain_smem_bytes(
                qpb, M, D, I, geo.weights_staged)
            assert geo.smem_bytes <= hop_chain.SMEM_LIMIT <= 227 * 1024
            assert geo.weights_staged == (hop_chain.chain_smem_bytes(
                1, M, D, I, True) <= hop_chain.SMEM_LIMIT)
            assert geo.opt_in == (geo.smem_bytes > 48 * 1024)
            assert geo.threads % 32 == 0
            assert 32 <= geo.threads <= hop_chain.MAX_THREADS
            h0 = -(-D * (D + 1) // 4) * 4
            hbuf = geo.smem_bytes // 4 - qpb * M * (
                2 * D + 2 * hop_chain.LIST_ENTRIES + 1) - 3 * qpb * (D + M)
            last = B - (geo.blocks - 1) * qpb
            for rows in {qpb * M, last * M}:
                L = hop_chain.list_slots(qpb, rows, M, D, I,
                                         geo.weights_staged)
                assert L % 2 == 0 and L >= hop_chain.LIST_ENTRIES
                room = ((hbuf - h0) // 2 if L > hop_chain.LIST_ENTRIES
                        else 0) + qpb * M * hop_chain.LIST_ENTRIES
                assert rows * L <= room
    assert hop_chain.chain_geometry(1000, 50, 60, 3, 114).weights_staged
    assert not hop_chain.chain_geometry(1000, 50, 60, 3, 1050).weights_staged
    # the serve cell's shape: 2 queries a block, 58 slots a row when a row
    # is longer than 8
    geo = hop_chain.chain_geometry(1000, 50, 60, 3, 114)
    assert geo.queries_per_block == 2
    assert hop_chain.list_slots(2, 100, 50, 60, 114, True) == 58
