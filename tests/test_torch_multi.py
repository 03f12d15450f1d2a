"""The family trainer of the port (``qmann_tpu_torch/train/multi.py``)
against JAX's ``train_tasks_multi`` and against the port's own per-run
``train_task``, and its parts against ``jax.vmap`` of JAX's: the stacked
lattice, the read with the runs folded into its batch, the stacked SGD
update and null-column zeroing, and the integer fast path.

Tolerances, with their reasons:
  * the family against JAX's or against ``train_task`` (2 epochs): error
    rates, ``ind_best`` and ``err_valid_best`` exact (against
    ``train_task``'s float64 rates, within 1e-6: the family's are float32,
    as JAX's, and 1e-6 is far below one sample); costs rtol 1e-4 (the
    float backward sums in another order, over ~10 SGD steps); the weights
    (final or best snapshot) rtol 1e-4, atol 1e-6;
  * the stacked lattice, the fast path where its predicate holds, the
    Hamming score and the predicates: exact (every lattice sum is exact);
  * the folded read: as tests/test_torch_attention_read.py (scores exact,
    p atol 1e-6, o exact but in at most one query whose Q(p) flipped);
  * the stacked update: rtol 1e-6, atol 1e-7 (the clip norm sums in
    another order); zero_null_columns exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qmann_tpu.config import QmannConfig as JaxConfig  # noqa: E402
from qmann_tpu.models import memn2n as jmodel  # noqa: E402
from qmann_tpu.numerics import QFormat as JQ  # noqa: E402
from qmann_tpu.ops import qlinear as jqlinear  # noqa: E402
from qmann_tpu.ops.pallas.qkernels import (  # noqa: E402
    fused_attention_read_pallas, qmatvec_pallas,
)
from qmann_tpu.train import optim as joptim  # noqa: E402
from qmann_tpu.train.multi import train_tasks_multi as j_multi  # noqa: E402
from qmann_tpu_torch.config import QmannConfig  # noqa: E402
from qmann_tpu_torch.data import babi  # noqa: E402
from qmann_tpu_torch.models import memn2n  # noqa: E402
from qmann_tpu_torch.numerics import QFormat, float_quant  # noqa: E402
from qmann_tpu_torch.ops import attention, qlinear  # noqa: E402
from qmann_tpu_torch.ops.cuda import qmatvec as qmv  # noqa: E402
from qmann_tpu_torch.ops.fused import fused_attention_read  # noqa: E402
from qmann_tpu_torch.train import multi, optim  # noqa: E402
from qmann_tpu_torch.train.trainer import train_task  # noqa: E402

from test_torch_train import to_jax_task  # noqa: E402

V, M, W = 19, 10, 6   # qa1 shape
SEEDS = [0, 3]


@pytest.fixture(autouse=True)
def one_thread():
    """These tests run thousands of tiny torch ops: one intra-op thread
    keeps them from contending with the other test processes for the
    cores (many times slower when they do)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tasks():
    """Two tasks of different train sizes (70: two full batches and a
    partial one; 45: one batch fewer, so the family's grid gives it an
    all-padding batch)."""
    return {1: babi.synthetic_task(np.random.default_rng(1), 70, 20, 20,
                                   V, M, W),
            2: babi.synthetic_task(np.random.default_rng(2), 45, 20, 20,
                                   V, M, W)}


def _assert_family_equal(got, want, n_runs, best_too):
    """The module docstring's tolerances, run for run; want holds JAX's
    train_tasks_multi result (or the same fields)."""
    assert got.task_indices == list(want.task_indices)
    assert got.seeds == list(want.seeds) and len(got.err_test) == n_runs
    assert len(got.history) == len(want.history)
    for g, w in zip(got.history, want.history):
        for key in ("err_train", "err_valid"):
            np.testing.assert_array_equal(g[key], np.asarray(w[key]), key)
        for key in ("cost_train", "cost_valid"):
            np.testing.assert_allclose(g[key], np.asarray(w[key]),
                                       rtol=1e-4, err_msg=key)
        assert g["lr"] == w["lr"]
    np.testing.assert_array_equal(got.err_test, np.asarray(want.err_test))
    np.testing.assert_allclose(got.cost_test, np.asarray(want.cost_test),
                               rtol=1e-4)
    np.testing.assert_array_equal(got.err_valid_best,
                                  np.asarray(want.err_valid_best))
    np.testing.assert_array_equal(got.ind_best, np.asarray(want.ind_best))
    snaps = [("params", got.params, want.params)]
    if best_too:
        snaps.append(("best", got.best_params, want.best_params))
    for name, g, w in snaps:
        for k in w:
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"{name} {k}")


@pytest.mark.parametrize("kw", [dict(),
                                dict(en_sample_shuffled=True,
                                     en_save_best_model=True)])
def test_family_matches_jax_train_tasks_multi(tasks, kw):
    """2 tasks x 2 seeds, 2 epochs, iwl 1 (JAX's unscaled N(0, 0.1) init
    survives Q1.6), from JAX's vmapped initial weights.  JAX runs its plain
    route; the port runs its plain route and its kernel route (use_pallas:
    on the CPU the wrappers take the kernels' plain versions)."""
    cfg_kw = dict(dim_emb=16, num_hops=2, num_itr=2, iwl=1, verbose=False,
                  **kw)
    jcfg = JaxConfig(**cfg_kw)
    jtasks = {t: to_jax_task(d) for t, d in tasks.items()}
    want = j_multi(jcfg, jtasks, SEEDS, eval_chunk=16)
    keys = jnp.stack([jax.random.PRNGKey(s) for s in SEEDS * len(tasks)])
    init = jax.vmap(lambda k: jmodel.init_params(jcfg, jtasks[1].dims, k))(
        keys)
    init = {k: np.asarray(v) for k, v in init.items()}
    for use_pallas in (False, True):
        got = multi.train_tasks_multi(
            QmannConfig(**cfg_kw, use_pallas=use_pallas), tasks, SEEDS,
            eval_chunk=16, params=init, device="cpu")
        _assert_family_equal(got, want, 4, kw.get("en_save_best_model"))
    for k, v in init.items():     # the caller's weights are not touched
        np.testing.assert_array_equal(v, np.asarray(
            jax.vmap(lambda k: jmodel.init_params(jcfg, jtasks[1].dims, k))(
                keys)[k]))


FAMILY_CONFIGS = {
    "plain": dict(),
    "use_pallas": dict(use_pallas=True),
    "no_fast_path": dict(),
    "tying_1": dict(type_weight_tying=1, use_pallas=True),
    "maxout": dict(test_maxout=True),
    "cosine": dict(en_cosine_sim=True),
    "shift_softmax": dict(en_shift_based_sm=True),
    "exp_plan": dict(en_exp_table_based=True),
    "sc_att": dict(en_sc_att=True),
    "att_shift": dict(en_att_shift=True),
    "weight_decay": dict(lambda_=0.001),
    "linear_start": dict(en_linear_start=True, num_itr_linear_start=1),
    "mode1_float": dict(attention_mode=1, en_fixed_point=False),
    "binary": dict(binary_mode=True),
    "mode3_pallas": dict(attention_mode=3, iwl=1, use_pallas=True),
    "mode3_hamming": dict(attention_mode=3, iwl=1, use_pallas_hamming=True),
}


@pytest.mark.parametrize("name", list(FAMILY_CONFIGS))
def test_family_matches_train_task_per_run(tasks, name):
    """Every run of the family equals the port's own train_task from the
    same weights (x4 at iwl 5, so that they survive Q5.2): each head
    (maxout, tying 1, cosine, the softmax variants, the scale), linear
    start, the float and binary runs and the kernel routes."""
    cfg = QmannConfig(dim_emb=8, num_hops=2, num_itr=2, verbose=False,
                      en_save_best_model=True, **FAMILY_CONFIGS[name])
    # both seeds on the two base routes, one seed (2 runs) elsewhere
    seeds = SEEDS if name in ("plain", "use_pallas") else SEEDS[1:]
    runs = [(t, s) for t in tasks for s in seeds]
    base = [{k: 4.0 * v for k, v in memn2n.init_params(
        cfg, tasks[1].dims, torch.Generator().manual_seed(s),
        device="cpu").items()} for _, s in runs]
    got = multi.train_tasks_multi(
        cfg, tasks, seeds, eval_chunk=16, device="cpu",
        params={k: torch.stack([b[k] for b in base]) for k in base[0]},
        integer_fast_path=False if name == "no_fast_path" else None)
    for r, ((t, s), b) in enumerate(zip(runs, base)):
        ref = train_task(cfg.replace(seed=s), tasks[t], b, device="cpu")
        for e, h in enumerate(ref.history):
            g = got.history[e]
            # the family's validation error is float32 (JAX's): equal
            # match counts differ by at most an ulp of the rate
            assert g["err_train"][r] == h.err_train, (r, e)
            assert abs(g["err_valid"][r] - h.err_valid) <= 1e-6, (r, e)
            np.testing.assert_allclose(
                [g["cost_train"][r], g["cost_valid"][r]],
                [h.cost_train, h.cost_valid], rtol=1e-4)
        assert abs(got.err_test[r] - ref.err_test) <= 1e-6, r
        np.testing.assert_allclose(got.cost_test[r], ref.cost_test,
                                   rtol=1e-4)
        for k in b:
            np.testing.assert_allclose(got.params[k][r].numpy(),
                                       ref.params[k].numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=k)


def test_family_initialises_each_run_from_its_seed(tasks):
    cfg = QmannConfig(dim_emb=8, num_hops=2, num_itr=1, verbose=False)
    got = multi.train_tasks_multi(cfg, tasks, SEEDS, device="cpu")
    ref = train_task(cfg.replace(seed=SEEDS[1]), tasks[2], device="cpu")
    assert got.task_indices == [1, 1, 2, 2] and got.seeds == SEEDS * 2
    assert abs(got.err_test[3] - ref.err_test) <= 1e-6
    np.testing.assert_allclose(got.params["A"][3].numpy(),
                               ref.params["A"].numpy(), rtol=1e-4,
                               atol=1e-6)


def test_family_refuses_mixed_shapes_and_defaults_to_the_card(tasks):
    other = babi.synthetic_task(np.random.default_rng(3), 20, 4, 4, V + 1,
                                M, W)
    cfg = QmannConfig(dim_emb=8, num_itr=1, verbose=False)
    with pytest.raises(ValueError, match="uniform"):
        multi.train_tasks_multi(cfg, {1: tasks[1], 3: other}, [0],
                                device="cpu")
    with pytest.raises(ValueError, match="shape"):
        multi.train_tasks_multi(cfg, tasks, [0], device="cpu",
                                params={"A": np.zeros((3, 8, 29))})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            multi.train_tasks_multi(cfg, tasks, [0])


@pytest.mark.parametrize("fmt_w,fmt_x", [((5, 2), (5, 2)), ((2, 5), (6, 1)),
                                         ((0, 0), (5, 2)), ((5, 2), (0, 0))])
def test_stacked_lattice_matches_vmapped_pallas(rng, fmt_w, fmt_x):
    """The family's plain lattice (w [R, O, I], x [R, B, I]) against
    jax.vmap of the TPU kernel in interpret mode, bit for bit, the binary
    format on either operand; and in pieces (PLAIN_CHUNK) as one."""
    R, B, O, I = 3, 13, 7, 29
    w = rng.normal(0.0, 1.5, (R, O, I)).astype(np.float32)
    x = rng.integers(0, 4, (R, B, I)).astype(np.float32)
    want = jax.vmap(lambda a, b: qmatvec_pallas(
        a, b, JQ(*fmt_w), JQ(*fmt_x), interpret=True))(jnp.asarray(w),
                                                        jnp.asarray(x))
    got = qmv.quantized_matvec(torch.from_numpy(w), torch.from_numpy(x),
                               QFormat(*fmt_w), QFormat(*fmt_x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for r in range(R):
        np.testing.assert_array_equal(got[r].numpy(), qmv.quantized_matvec(
            torch.from_numpy(w[r]), torch.from_numpy(x[r]), QFormat(*fmt_w),
            QFormat(*fmt_x)).numpy())


def test_plain_lattice_in_pieces_is_unchanged(rng, monkeypatch):
    w = torch.from_numpy(rng.normal(0.0, 1.5, (3, 7, 29)).astype(np.float32))
    x = torch.from_numpy(rng.integers(0, 4, (3, 13, 29)).astype(np.float32))
    whole = qmv.quantized_matvec_reference(w, x, QFormat(5, 2), QFormat(5, 2))
    monkeypatch.setattr(qmv, "PLAIN_CHUNK", 7 * 29 * 2)
    torch.testing.assert_close(
        qmv.quantized_matvec_reference(w, x, QFormat(5, 2), QFormat(5, 2)),
        whole, rtol=0, atol=0)
    with pytest.raises(ValueError, match="do not form"):
        qmv.quantized_matvec_reference(w, x[:2], QFormat(5, 2),
                                       QFormat(5, 2))


@pytest.mark.parametrize("mode", [2, 3])
def test_folded_read_matches_vmapped_pallas(rng, mode):
    """The read with R runs folded into its batch ([R, B, M, D]) against
    jax.vmap of the TPU kernel in interpret mode; in mode 3 the Hamming
    score's kernel route ([R, B, M, D], folded) against its plain
    version."""
    R, B, D = 3, 6, 16
    fmt = (1, 6) if mode == 3 else (5, 2)
    m, c = (rng.normal(0.0, 1.5, (R, B, M, D)).astype(np.float32)
            for _ in range(2))
    u = rng.normal(0.0, 1.5, (R, B, D)).astype(np.float32)
    mask = np.arange(M) < rng.integers(1, M + 1, (R, B))[..., None]
    mask[:, -1] = False
    want = jax.vmap(lambda a, b, e, f: fused_attention_read_pallas(
        a, b, e, f, JQ(*fmt), JQ(*fmt), JQ(*fmt), score_quantized=mode == 2,
        sum_quantized=True, interpret=True, attention_mode=mode))(
        *(jnp.asarray(a) for a in (m, c, u, mask)))
    got = fused_attention_read(
        *(torch.from_numpy(a) for a in (m, c, u)),
        torch.from_numpy(mask).to(torch.float32), QFormat(*fmt),
        QFormat(*fmt), QFormat(*fmt), score_quantized=mode == 2,
        attention_mode=mode, ham_num_bit=8)
    (o_w, p_w, s_w), (o_g, p_g, s_g) = ([np.asarray(a) for a in want],
                                        [t.numpy() for t in got])
    assert o_g.shape == (R, B, D) and p_g.shape == s_g.shape == (R, B, M)
    np.testing.assert_array_equal(s_g, s_w)
    np.testing.assert_allclose(p_g, p_w, rtol=0, atol=1e-6)
    flipped = (float_quant(torch.from_numpy(p_g), QFormat(*fmt)).numpy()
               != float_quant(torch.from_numpy(p_w.copy()),
                              QFormat(*fmt)).numpy()).any(-1)
    assert flipped.sum() <= 1
    np.testing.assert_array_equal(o_g[~flipped], o_w[~flipped])
    if mode == 3:
        args = (torch.from_numpy(m), torch.from_numpy(u), 1, 8)
        np.testing.assert_array_equal(
            attention.hamming_score(*args, backend="kernel").numpy(),
            attention.hamming_score_reference(*args).numpy())


def _stacked_params(rng, R, tying):
    D, I, K = 6, 11, 2
    shapes = ({"E": (K + 1, D, I), "H": (K, D, D)} if tying == 1 else
              {"A": (D, I), "C": (D, I), "B": (D, I), "W": (I, D),
               "H": (D, D)})
    shapes["scale"] = (K,)
    shapes["maxout_w"] = shapes["maxout_b"] = (5,)
    return {k: rng.normal(0.0, 0.5, (R,) + s).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("tying", [1, 2])
@pytest.mark.parametrize("grad_sd", [0.1, 30.0])
def test_family_update_matches_vmapped_jax(rng, tying, grad_sd):
    """The stacked SGD step (per-run clip, per-matrix for a stacked E/H,
    per-run divisor max(size_b, 1), weight decay, the scale's and the
    maxout pieces' rules, the null columns zeroed) equals jax.vmap of
    JAX's, and a run whose batch is all padding keeps its weights."""
    R = 4
    kw = dict(type_weight_tying=tying, en_sc_att=True, test_maxout=True,
              lambda_=0.01)
    params = _stacked_params(rng, R, tying)
    grads = {k: rng.normal(0.0, grad_sd, v.shape).astype(np.float32)
             for k, v in params.items()}
    size_b = np.array([32.0, 7.0, 0.0, 1.0], np.float32)
    lr, scale_dim = 0.01, 10
    jcfg = JaxConfig(**kw)

    def one(p, g, sb):
        new = joptim.sgd_update(p, g, jnp.float32(lr), jnp.maximum(sb, 1.0),
                                jcfg, scale_dim=scale_dim)
        new = joptim.zero_null_columns(new, jcfg)
        return jax.tree.map(lambda a, b: jnp.where(sb > 0, a, b), new, p)

    want = jax.vmap(one)({k: jnp.asarray(v) for k, v in params.items()},
                         {k: jnp.asarray(v) for k, v in grads.items()},
                         jnp.asarray(size_b))
    got = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    multi.family_update(got, {k: torch.from_numpy(v)
                              for k, v in grads.items()},
                        torch.tensor(lr), torch.from_numpy(size_b),
                        QmannConfig(**kw), scale_dim,
                        np.flatnonzero(size_b == 0))
    for k in params:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    for k in params:
        np.testing.assert_array_equal(got[k][2].numpy(), params[k][2])
    zeroed = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    optim.zero_null_columns(zeroed, QmannConfig(**kw))
    want_z = jax.vmap(lambda p: joptim.zero_null_columns(p, jcfg))(
        {k: jnp.asarray(v) for k, v in params.items()})
    for k in params:
        np.testing.assert_array_equal(zeroed[k].numpy(),
                                      np.asarray(want_z[k]))


def _fast_path_operands(rng, R):
    """Per run: counts and weights; run 1's products saturate (weights
    x1000 against a count of 2), run 2 has a count above the format's
    range; runs 0 and 3 pass."""
    B, I, D = 5, 12, 7
    s = rng.integers(0, 2, (R, B, M, I)).astype(np.float32)
    q = rng.integers(0, 2, (R, B, I)).astype(np.float32)
    ws = [rng.normal(0.0, 0.5, (R, D, I)).astype(np.float32)
          for _ in range(3)]
    for w in ws:
        w[1] *= 1000.0
    s[1, 0, 0, 0] = q[1, 0, 0] = 2.0
    s[2, 0, 0, 0] = q[2, 0, 0] = 300.0
    return s, q, ws


@pytest.mark.parametrize("fmt", [(5, 2), (1, 6)])
def test_integer_fast_path_matches_jax_select(rng, fmt):
    """The predicate per run equals JAX's (under vmap), and the plain
    route's embeddings and query embedding with the fast path equal JAX's
    vmapped select of its two branches, bit for bit; where the predicate
    holds they equal the lattice."""
    R = 4
    s, q, ws = _fast_path_operands(rng, R)
    fmts = [QFormat(*fmt), QFormat(fmt[0] + 1, fmt[1] - 1) if fmt[1]
            else QFormat(*fmt), QFormat(*fmt)]
    jf = [JQ(f.iwl, f.frac) for f in fmts]
    pred_j = [np.asarray(jax.vmap(lambda a, b, f=f: jqlinear.
                                  _integer_input_fast_path_ok(a, b, f))(
        jnp.asarray(s), jnp.asarray(w))) for w, f in zip(ws, jf)]
    pred_t = [qlinear.integer_fast_ok(torch.from_numpy(s),
                                      torch.from_numpy(w), f, f).numpy()
              for w, f in zip(ws, fmts)]
    for a, b in zip(pred_t, pred_j):
        np.testing.assert_array_equal(a, b)
    assert pred_t[0].any() and not pred_t[0].all()
    want = jax.vmap(lambda a, *b: jqlinear._qembed_mat_multi_impl(
        a, b, tuple(jf), True, "jnp", True))(
        jnp.asarray(s), *(jnp.asarray(w) for w in ws))
    wt = [torch.from_numpy(w) for w in ws]
    got = qlinear.qembed_mat_multi(torch.from_numpy(s), wt, fmts,
                                   fast=pred_t)
    lattice = qlinear.qembed_mat_multi(torch.from_numpy(s), wt, fmts)
    for g, w, lat, p in zip(got, want, lattice, pred_t):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g[p].numpy(), lat[p].numpy())
    fq = fmts[0]
    pq_j = np.asarray(jax.vmap(lambda a, b: jqlinear._qmatvec_integer_fast_ok(
        a, jax.numpy.asarray(b), jf[0], jf[0]))(
        jnp.asarray(q), jax.vmap(lambda w: jqlinear.float_quant(w, jf[0]))(
            jnp.asarray(ws[0]))))
    pq_t = qlinear.integer_fast_ok(torch.from_numpy(q), wt[0], fq,
                                   fq).numpy()
    np.testing.assert_array_equal(pq_t, pq_j)
    want_q = jax.vmap(lambda w, x: jqlinear._qmatvec_fwd_impl(
        w, x, jf[0], jf[0], True, "jnp", True))(jnp.asarray(ws[0]),
                                                 jnp.asarray(q))
    got_q = qlinear.qmatvec(wt[0], torch.from_numpy(q), fq, fq, fast=pq_t)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))


def test_family_forward_reads_its_predicates_once(rng, tasks, monkeypatch):
    """With the fast path the plain forward reads every weight's predicate
    in one host sync and then takes the GEMM; the kernel route takes the
    lattice (no predicate)."""
    cfg = QmannConfig(dim_emb=8, num_hops=2, verbose=False)
    data = tasks[1]
    params = {k: torch.stack([v, v]) for k, v in memn2n.init_params(
        cfg, data.dims, torch.Generator().manual_seed(0),
        device="cpu").items()}
    inputs = [torch.from_numpy(np.stack([a[:4]] * 2)).to(
        torch.float32 if a.dtype != bool else torch.bool)
        for a in (data.train.memory, data.train.question, data.train.mask)]
    calls = []
    real = memn2n._integer_fast_decisions

    def spy(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(memn2n, "_integer_fast_decisions", spy)
    fast = memn2n.forward(params, *inputs, cfg)
    slow = memn2n.forward(params, *inputs,
                          cfg.replace(en_integer_fast_path=False))
    kern = memn2n.forward(params, *inputs, cfg.replace(use_pallas=True))
    assert len(calls) == 1
    for a, b, c in zip(fast, slow, kern):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        torch.testing.assert_close(a, c, rtol=0, atol=0)


def test_single_run_fast_path_follows_the_config(tasks, monkeypatch):
    """A single run's forward takes the fast path from
    cfg.en_integer_fast_path (JAX's forward), bit-identical to the
    lattice; the single-run training step turns it off (JAX's
    train_epoch)."""
    from qmann_tpu_torch.train import trainer
    cfg = QmannConfig(dim_emb=8, num_hops=2, verbose=False)
    data = tasks[1]
    params = memn2n.init_params(cfg, data.dims,
                                torch.Generator().manual_seed(0),
                                device="cpu")
    mem, qst, msk = (torch.from_numpy(a[:4]) for a in (
        data.train.memory, data.train.question, data.train.mask))
    decisions = []
    real = memn2n._integer_fast_decisions

    def spy(*a):
        decisions.append(real(*a))
        return decisions[-1]

    monkeypatch.setattr(memn2n, "_integer_fast_decisions", spy)
    fast = memn2n.forward(params, mem.float(), qst.float(), msk, cfg)
    slow = memn2n.forward(params, mem.float(), qst.float(), msk,
                          cfg.replace(en_integer_fast_path=False))
    assert len(decisions) == 1
    fast_q, fast_m = decisions[0]
    assert fast_q and all(fast_m)       # the GEMM ran for every weight
    for a, b in zip(fast, slow):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    batch = {"memory": mem.float(), "question": qst.float(),
             "answer": torch.from_numpy(data.train.answer[:4]).float(),
             "mask": msk, "sample_mask": torch.ones(4),
             "size_b": torch.tensor(4.0)}
    p_on, p_off = ({k: v.clone() for k, v in params.items()}
                   for _ in range(2))
    lr = torch.tensor(cfg.learning_rate)
    trainer.train_step(p_on, batch, lr, cfg)
    trainer.train_step(p_off, batch, lr,
                       cfg.replace(en_integer_fast_path=False))
    assert len(decisions) == 1
    for k in params:
        torch.testing.assert_close(p_on[k], p_off[k], rtol=0, atol=0)


@pytest.mark.parametrize("B", [6400, 25600])
def test_read_and_hamming_geometry_at_the_family_batch(B):
    """R runs folded into the read's and the Hamming kernel's batch: 200 x
    32 queries at a training step, 200 x 128 at an eval chunk (M=50,
    D=60): every query covered once, within the kernels' limits."""
    from qmann_tpu_torch.ops.cuda import attention_read as ar
    from qmann_tpu_torch.ops.cuda import hamming as ham
    from test_torch_attention_read import _assert_geometry_covers
    _assert_geometry_covers(ar.read_geometry(B, 50, 60), B, 50, 60,
                            lambda qpb, t: ar.read_smem_bytes(qpb, 50, 60, t))
    _assert_geometry_covers(ham.hamming_geometry(B, 50, 60), B, 50, 60,
                            lambda qpb, _: ham.hamming_smem_bytes(qpb, 50,
                                                                  60))


@pytest.mark.parametrize("R,B,O,I", [(200, 1600, 60, 114),
                                     (200, 6400, 60, 114),
                                     (200, 32, 60, 114), (200, 32, 60, 60),
                                     (40, 2048, 60, 256), (1, 320, 60, 29)])
def test_qmatvec_geometry_with_a_family_axis(R, B, O, I):
    """The family's launch: the grid's z extent is R, and the blocks of all
    R runs are counted against the resident blocks.  Whole rows: each
    run's rows are shared evenly by as many blocks as one wave holds, or
    by blocks of about MAX_ROWS rows where those are more (rows a multiple
    of the warps; one row a warp where they fit), each row taken once; the
    tiled kernel's rows follow its own rule; R = 1 is the 2-D call's
    geometry."""
    from test_torch_qmatvec import _rows_taken
    geo = qmv.qmatvec_geometry(B, O, I, R)
    one = qmv.qmatvec_geometry(B, O, I)
    o_blocks = -(-O // geo.o_tile)
    assert geo.blocks == -(-B // geo.rows_per_block) * o_blocks * R
    assert R <= qmv.MAX_RUNS and geo.smem_bytes <= 48 * 1024
    assert (geo.o_tile, geo.i_tile) == (one.o_tile, one.i_tile)
    if O * I + I <= qmv.MAX_SMEM_FLOATS:
        warp_rows = -(-B // qmv.WARPS)
        per_run = max(1, min(warp_rows, max(qmv.RESIDENT_BLOCKS // R,
                                            -(-B // qmv.MAX_ROWS))))
        assert geo.rows_per_block == qmv.WARPS * -(-warp_rows // per_run)
        assert geo.rows_per_block <= qmv.MAX_ROWS + qmv.WARPS
        assert geo.smem_bytes == one.smem_bytes
        assert (_rows_taken(geo, B) == 1).all()
    else:
        base = max(1, min(32, qmv.THREADS // geo.o_tile))
        tiles = 1
        while (tiles < qmv.MAX_TILES
               and -(-B // (base * tiles)) * o_blocks * R
               > qmv.RESIDENT_BLOCKS):
            tiles *= 2
        assert geo.rows_per_block == base * tiles
    if R == 1:
        assert geo == one
    if (R, B, I) == (200, 1600, 114):   # the run.sh family's memory rows
        assert geo[:4] == (160, 60, 114, 2000)


MEGASWEEP_FLAGS = {
    "mode1": ["--attention-mode", "1"],
    "mode3": ["--attention-mode", "3", "--iwl", "1"],
    "no_fixed_point": ["--attention-mode", "1", "--no-fixed-point"],
    "bw_wl_4": ["--bw-wl", "4", "--iwl", "1"],
    "binary_mode": ["--binary-mode"],
    "sc_att": ["--sc-att"],
    "att_shift": ["--att-shift"],
    "weight_decay": ["--weight-decay", "0.001"],
    "save_best_model": ["--save-best-model"],
    "no_fast_path": ["--no-fast-path"],
}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return babi.write_synthetic_corpus(
        str(tmp_path_factory.mktemp("data")), np.random.default_rng(5), [1],
        48, 16, joint=False)


@pytest.mark.parametrize("name", list(MEGASWEEP_FLAGS))
def test_megasweep_flags_each_train_one_epoch(corpus, tmp_path, name):
    """Every configuration megasweep's flags make trains one epoch of a
    family (1 task x 2 seeds on the CPU, at the files' own layout: the
    padded one is tests/test_torch_cli.py's): summary rows and finite
    histories; none is refused."""
    from qmann_tpu_torch.bench import megasweep
    out = tmp_path / "out"
    assert megasweep.main(
        ["--tasks", "1", "--seeds", "0,1", "--epochs", "1",
         "--max-samples", "32", "--max-test-samples", "8",
         "--pad-dict", "0", "--pad-line", "0",
         "--data-path", corpus[0], "--raw-data-path", corpus[1],
         "--out-dir", str(out), "--device", "cpu",
         *MEGASWEEP_FLAGS[name]]) == 0
    import json
    rows = json.loads((out / "summary.json").read_text())
    assert len(rows) == 1 and rows[0]["seeds"] == [0, 1]
    hist = np.load(out / "history.npz")
    iwl = rows[0]["iwl"]
    for k in ("cost_train", "cost_valid"):
        assert hist[f"iwl{iwl}_{k}"].shape == (1, 2)
        assert np.isfinite(hist[f"iwl{iwl}_{k}"]).all()
