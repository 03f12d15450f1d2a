"""The port's captured programs (``qmann_tpu_torch/graphs.py``): the bodies
that ``train_epoch``, ``multi_epoch`` and ``dependent_batches`` replay on
the card, run here eagerly on the CPU, against JAX's compiled programs
(``train_epoch``, ``multi_epoch``) on the same numpy inputs and against
the port's eager loops; the storage the graphs bind; the launch
accounting on a stub capture.  The ``cuda`` cases (replay against the
eager route bit for bit; a host sync in a body raises) skip without a
card.  jax is imported inside the tests that compare with it, so that
the file runs on the card's machine, which has none:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_graphs.py -q -m cuda

Tolerances, with their reasons:
  * against JAX's ``train_epoch``: as tests/test_torch_train.py's SGD-step
    test, parameters rtol 1e-5, atol 1e-6 and the cost rtol 1e-5 (the
    backward products and the softmax sum in another order), matches
    equal;
  * against JAX's ``multi_epoch``: as tests/test_torch_multi.py, the
    weights (final and best snapshot) rtol 1e-4, atol 1e-6, costs rtol
    1e-4, error rates, ``ind_best`` and the best-model selection exact;
  * against the port's eager loops: bit for bit (the same operations in
    the same order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qmann_tpu_torch import graphs  # noqa: E402
from qmann_tpu_torch.bench.common import dependent_batches  # noqa: E402
from qmann_tpu_torch.config import QmannConfig  # noqa: E402
from qmann_tpu_torch.data import babi  # noqa: E402
from qmann_tpu_torch.models import memn2n  # noqa: E402
from qmann_tpu_torch.ops import argmax_last  # noqa: E402
from qmann_tpu_torch.ops.cuda import qmatvec as qmv  # noqa: E402
from qmann_tpu_torch.train import multi, trainer  # noqa: E402

V, M, W = 19, 10, 6   # qa1 shape


def _jax_params(cfg_kw, dims, seed, scale=4.0):
    """JAX's init_params (scaled, as tests/test_torch_train.py's)."""
    from test_torch_train import jax_params
    return jax_params(cfg_kw, dims, seed=seed, scale=scale)


@pytest.fixture(autouse=True)
def one_thread():
    """Many tiny torch ops: one intra-op thread, as tests/test_torch_multi.py
    (the suite's processes contend for the cores otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _epoch_batches(seed, n_batches=3, batch=8, live_last=5):
    """[NB, B, ...] epoch arrays of a synthetic task, the last batch
    partial (live_last live samples, the rest padding)."""
    data = babi.synthetic_task(np.random.default_rng(seed),
                               n_batches * batch, 1, 1, V, M, W)
    n = (n_batches - 1) * batch + live_last
    split = data.train
    cut = babi.VectorizedSplit(split.memory[:n], split.question[:n],
                               split.answer[:n], split.n_sen[:n],
                               split.answer_index[:n])
    return data, trainer._batched_arrays(cut, batch)


EPOCH_CASES = {
    "mode 2, use_pallas": (dict(), dict(use_pallas=True), False),
    "mode 3 iwl 1, use_pallas": (dict(attention_mode=3, iwl=1),
                                 dict(use_pallas=True), False),
    "linear start": (dict(), dict(use_pallas=True), True),
}


@pytest.mark.parametrize("case", sorted(EPOCH_CASES))
def test_epoch_body_matches_jax_train_epoch(case):
    """A 3-batch epoch (the last partial) through JAX's train_epoch (one
    lax.scan) and through the port's, whose steps read their batch by a
    device counter and write their cost and matches by slot."""
    import jax.numpy as jnp
    from qmann_tpu.config import QmannConfig as JaxConfig
    from qmann_tpu.train import trainer as jtrainer
    kw, port_kw, remove_softmax = EPOCH_CASES[case]
    cfg_kw = dict(dim_emb=16, size_batch=8, verbose=False, **kw)
    data, batches = _epoch_batches(5)
    pj = _jax_params(cfg_kw, data.dims, seed=5)
    jp, jcost, jmatch = jtrainer.train_epoch(
        {k: jnp.asarray(v) for k, v in pj.items()},
        {k: jnp.asarray(v) for k, v in batches.items()}, jnp.float32(0.3),
        JaxConfig(**cfg_kw), remove_softmax)
    tcfg = QmannConfig(**cfg_kw, **port_kw)
    tp = memn2n.params_from_jax(pj, tcfg, device="cpu")
    tp, tcost, tmatch = trainer.train_epoch(
        tp, {k: torch.from_numpy(v) for k, v in batches.items()},
        torch.tensor(0.3), tcfg, remove_softmax)
    np.testing.assert_allclose(float(tcost), float(jcost), rtol=1e-5)
    assert int(tmatch) == int(jmatch)
    for k in pj:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
        assert not np.array_equal(tp[k].numpy(), pj[k]), k


@pytest.mark.parametrize("remove_softmax", [False, True])
def test_epoch_body_equals_the_eager_step_loop(remove_softmax):
    """The counter-driven epoch body against train_step over each batch's
    slice with the costs and matches stacked and summed (the epoch as it
    ran before it was a graph): bit for bit."""
    cfg = QmannConfig(dim_emb=16, size_batch=8, use_pallas=True,
                      verbose=False)
    data, batches_np = _epoch_batches(6)
    base = {k: 4.0 * v for k, v in memn2n.init_params(
        cfg, data.dims, torch.Generator().manual_seed(6),
        device="cpu").items()}
    batches = {k: torch.from_numpy(v) for k, v in batches_np.items()}
    lr = torch.tensor(0.3)
    loop = {k: v.clone() for k, v in base.items()}
    costs, matches = [], []
    for i in range(batches["memory"].shape[0]):
        c, m = trainer.train_step(loop, {k: v[i] for k, v in batches.items()},
                                  lr, cfg, remove_softmax)
        costs.append(c)
        matches.append(m)
    body = {k: v.clone() for k, v in base.items()}
    _, cost, match = trainer.train_epoch(body, batches, lr, cfg,
                                         remove_softmax)
    assert torch.equal(cost, torch.stack(costs).sum())
    assert torch.equal(match, torch.stack(matches).sum())
    for k in base:
        assert torch.equal(body[k], loop[k]), k


def _family_inputs():
    """2 tasks (24 and 13 training stories: the shorter has an
    all-padding batch) x 2 seeds, batch 8, in both packages' layouts."""
    tasks = [babi.synthetic_task(np.random.default_rng(t), n, 11, 11, V, M, W)
             for t, n in ((7, 24), (8, 13))]
    seeds, B = [0, 1], 8
    run_task = [0, 0, 1, 1]
    R = len(run_task)
    split = {s: multi._stack_split([getattr(t, s) for t in tasks])
             for s in ("train", "valid")}
    n = np.array([len(t.train) for t in tasks])[run_task]
    nb = int(-(-n.max() // B))
    rng = np.random.default_rng(9)
    perm = np.zeros((R, nb * B), np.int64)
    smask = np.zeros((nb, R, B), np.float32)
    for r in range(R):
        perm[r, :n[r]] = rng.permutation(n[r])
        smask[:, r] = (np.arange(nb * B) < n[r]).reshape(nb, B)
    return tasks, seeds, run_task, split, perm, smask, B


def test_multi_epoch_matches_jax_multi_epoch():
    """Two epochs of the port's multi_epoch against JAX's on a 2 x 2
    family, the best-model state fed back: runs 1 and 3 start from a best
    error no epoch can reach, so the selection keeps their old snapshots
    and takes the others' new weights."""
    import jax.numpy as jnp
    from qmann_tpu.config import QmannConfig as JaxConfig
    from qmann_tpu.train import multi as jmulti
    tasks, seeds, run_task, split, perm, smask, B = _family_inputs()
    cfg_kw = dict(dim_emb=16, num_hops=2, iwl=1, size_batch=B,
                  verbose=False, en_save_best_model=True)
    jcfg = JaxConfig(**cfg_kw)
    tcfg = QmannConfig(use_pallas=True, **cfg_kw)
    init = [_jax_params(cfg_kw, tasks[0].dims, s, scale=1.0)
            for s in seeds * 2]
    p0 = {k: np.stack([p[k] for p in init]) for k in init[0]}
    best0 = {k: v + np.float32(0.5) for k, v in p0.items()}
    state0 = (np.array([np.inf, -1.0, np.inf, -1.0], np.float32),
              np.full(4, np.inf, np.float32), np.zeros(4, np.int32))
    size_b = smask.sum(-1)

    jstate = ({k: jnp.asarray(v) for k, v in p0.items()},
              {k: jnp.asarray(v) for k, v in best0.items()},
              *(jnp.asarray(a) for a in state0))
    jdata = {s: {k: jnp.asarray(v) for k, v in split[s].items()}
             for s in split}
    tdata = {s: {k: torch.from_numpy(v) for k, v in split[s].items()}
             for s in split}
    tstate = ({k: torch.from_numpy(v.copy()) for k, v in p0.items()},
              {k: torch.from_numpy(v.copy()) for k, v in best0.items()},
              *(torch.from_numpy(a.copy()) for a in state0))
    g = graphs.Graphs("cpu")
    for itr in range(2):
        jout = jmulti.multi_epoch(
            *jstate, jnp.int32(itr), jdata["train"], jdata["valid"],
            jnp.asarray(np.array(run_task, np.int32)), jnp.asarray(perm),
            jnp.asarray(smask), jnp.asarray(size_b), jnp.float32(0.2), jcfg,
            False, B, 8)
        tout = multi.multi_epoch(
            *tstate, itr, tdata["train"], tdata["valid"],
            torch.tensor(run_task), torch.from_numpy(perm),
            torch.from_numpy(smask), torch.from_numpy(size_b),
            torch.tensor(0.2), tcfg, False, B, 8, g)
        jstate, tstate = jout[:5], tout[:5]
        names = ("params", "best", "best_err", "best_cost", "ind_best",
                 "cost_train", "match_train", "cost_valid", "err_valid")
        for name, j, t in zip(names, jout, tout):
            if isinstance(j, dict):
                for k in j:
                    np.testing.assert_allclose(
                        t[k].numpy(), np.asarray(j[k]), rtol=1e-4,
                        atol=1e-6, err_msg=f"epoch {itr} {name} {k}")
            elif name in ("cost_train", "cost_valid", "best_cost"):
                np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                           rtol=1e-4, err_msg=name)
            else:
                np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                              err_msg=name)
    for k in p0:      # the unreachable runs kept their old snapshots
        np.testing.assert_array_equal(tstate[1][k][[1, 3]].numpy(),
                                      best0[k][[1, 3]])
        np.testing.assert_array_equal(tstate[1][k][[0, 2]].numpy(),
                                      tstate[0][k][[0, 2]].numpy())


def test_train_task_keeps_its_buffers_storage(monkeypatch):
    """Across train_task's epochs (linear start: two programs) the
    parameters, the epoch's batches (shuffled each epoch) and the lr tensor
    that its graphs bind keep their storage, and the result holds the same
    parameter tensors."""
    seen = []
    real = trainer.train_epoch

    def spy(params, batches, lr, cfg, remove_softmax=False, **kw):
        seen.append(([v.data_ptr() for v in params.values()],
                     [v.data_ptr() for v in batches.values()],
                     lr.data_ptr()))
        return real(params, batches, lr, cfg, remove_softmax, **kw)

    monkeypatch.setattr(trainer, "train_epoch", spy)
    cfg = QmannConfig(dim_emb=8, size_batch=16, num_itr=2, verbose=False,
                      en_sample_shuffled=True, en_save_best_model=True,
                      en_linear_start=True, num_itr_linear_start=1)
    data = babi.synthetic_task(np.random.default_rng(2), 40, 10, 10, V, M, W)
    res = trainer.train_task(cfg, data, device="cpu")
    assert len(seen) == 3 and all(s == seen[0] for s in seen)
    assert [v.data_ptr() for v in res.params.values()] == seen[0][0]


def test_train_tasks_multi_keeps_its_buffers_storage(monkeypatch):
    """Across train_tasks_multi's epochs the stacked parameters, the best
    snapshots (selected in place), the best-model state, the epoch's
    permutations (shuffled each epoch) and the lr tensor keep their
    storage."""
    seen = []
    real = multi.multi_epoch

    def spy(params, best, best_err, best_cost, ind_best, itr, *args):
        out = real(params, best, best_err, best_cost, ind_best, itr, *args)
        seen.append(([v.data_ptr() for v in (*out[0].values(),
                                             *out[1].values())],
                     [t.data_ptr() for t in out[2:5]],
                     [args[3].data_ptr(), args[6].data_ptr()]))
        return out

    monkeypatch.setattr(multi, "multi_epoch", spy)
    cfg = QmannConfig(dim_emb=8, num_hops=2, size_batch=16, num_itr=3,
                      use_pallas=True, verbose=False,
                      en_sample_shuffled=True, en_save_best_model=True)
    tasks = {t: babi.synthetic_task(np.random.default_rng(t), 30, 10, 10,
                                    V, M, W) for t in (1, 2)}
    res = multi.train_tasks_multi(cfg, tasks, [0, 1], eval_chunk=8,
                                  device="cpu", log=lambda *a: None)
    assert len(seen) == 3 and all(s == seen[0] for s in seen)
    assert [v.data_ptr() for v in res.params.values()] == seen[0][0][:len(
        res.params)]


class _StubGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_launch_accounting_on_a_stub_capture():
    """What the wrappers count during a capture is taken back (no kernel
    ran) and added again at every replay, on whatever object the
    wrapper's module name holds at the time."""
    start = graphs.launch_counts()
    delta = []
    with graphs.launches_taken_back(delta):
        qmv.quantized_matvec.launches += 10
        qmv.quantized_matvec.sparse_launches += 10
        graphs._counters()[1][0].launches += 3    # the read's count
        chain = graphs._counters()[3][0]
        chain.launches += 2
        chain.embedded_launches += 2
    # graphs.COUNTED: seven wrappers' launches, then the lattice's sparse
    # launches and the chain's embedded ones
    assert delta == [10, 3, 0, 2, 0, 0, 0, 10, 2]
    assert graphs.launch_counts() == start
    stub = _StubGraph()
    g = graphs.Graph(("family_step",), stub, (), None, delta)
    for _ in range(4):
        g.replay()
    assert stub.replays == g.replays == 4
    assert graphs.launch_counts() == (start[0] + 40, start[1] + 12,
                                      start[2], start[3] + 8, *start[4:7],
                                      start[7] + 40, start[8] + 8)
    real = qmv.quantized_matvec

    def spy(*args):
        return real(*args)

    spy.launches = spy.sparse_launches = 0
    qmv.quantized_matvec = spy
    try:
        g.replay()
        assert spy.launches == spy.sparse_launches == 10
    finally:
        qmv.quantized_matvec = real
    for (fn, count), s in zip(graphs._counters(), start):
        setattr(fn, count, s)


# route: (config, launches of the dp entry, launches of the ds entry)
WSUM_ROUTES = {"use_pallas": (dict(use_pallas=True), 0, 3),
               "use_pallas_hamming": (dict(use_pallas_hamming=True), 3, 0),
               "plain": (dict(), 0, 0)}


@pytest.mark.parametrize("route", WSUM_ROUTES)
def test_launch_accounting_of_the_wsum_backward(monkeypatch, route):
    """The weighted sum's backward kernel's two entries are graphs.COUNTED's
    sixth (dp) and seventh (ds) wrappers: a captured mode-3 step (here an
    eager CPU step, with spies that count each call of an entry as its
    launch) gains 3 on its route's entry (the fused read's ds entry on
    use_pallas, the unfused hop's dp entry on use_pallas_hamming), taken
    back after the capture and added again by every replay, and none on
    the plain route."""
    from qmann_tpu_torch.ops import fused
    from qmann_tpu_torch.ops.cuda import qweighted_sum_bwd as wsb

    def counting(real):
        def spy(*args):
            spy.launches += 1
            return real(*args)
        spy.launches = 0
        return spy

    dp_spy = counting(wsb.qweighted_sum_backward_kernel)
    ds_spy = counting(wsb.weighted_sum_softmax_backward_kernel)
    monkeypatch.setattr(wsb, "qweighted_sum_backward_kernel", dp_spy)
    monkeypatch.setattr(wsb, "weighted_sum_softmax_backward_kernel", ds_spy)
    monkeypatch.setattr(fused, "weighted_sum_softmax_backward_kernel",
                        ds_spy)
    extra, want_dp, want_ds = WSUM_ROUTES[route]
    cfg = QmannConfig(dim_emb=8, attention_mode=3, iwl=1, verbose=False,
                      **extra)
    data, batches = _epoch_batches(5, n_batches=1)
    params = memn2n.init_params(cfg, data.dims,
                                torch.Generator().manual_seed(5),
                                device="cpu")
    batch = {k: torch.as_tensor(v[0]) for k, v in batches.items()}
    start = graphs.launch_counts()
    delta = []
    with graphs.launches_taken_back(delta):
        trainer.train_step(params, batch, torch.tensor(0.3), cfg)
    assert delta[5:7] == [want_dp, want_ds]
    assert graphs.launch_counts() == start
    g = graphs.Graph(("step",), _StubGraph(), (), None, delta)
    for _ in range(2):
        g.replay()
    assert graphs.launch_counts() == tuple(s + 2 * d
                                           for s, d in zip(start, delta))
    assert (dp_spy.launches, ds_spy.launches) == (2 * want_dp, 2 * want_ds)
    for (fn, count), s in zip(graphs._counters(), start):
        setattr(fn, count, s)


def test_graphs_run_the_body_eagerly_on_the_cpu():
    """On the CPU every call runs its body (no capture, no static
    buffer), and ``static`` gives one persistent buffer per name."""
    g = graphs.Graphs("cpu")
    calls = []

    def body(x):
        calls.append(x)
        return x * 2

    x = torch.arange(3.0)
    for _ in range(3):
        assert torch.equal(g(("double",), body, x), x * 2)
    assert len(calls) == 3 and all(c is x for c in calls) and not g.graphs
    buf = g.static("counter", (1,), torch.int64)
    assert g.static("counter", (1,), torch.int64) is buf
    assert int(buf) == 0


def _old_dependent_batches(forward, mem, que, mask, k):
    """bench/common.py's loop before it became one program."""
    carry = torch.zeros((), dtype=que.dtype, device=que.device)
    preds = []
    with torch.inference_mode():
        for _ in range(k):
            pred = argmax_last(forward(mem, que + carry, mask).logits)
            carry = (pred[0] < 0).to(que.dtype)
            preds.append(pred)
        return torch.stack(preds)


@pytest.mark.parametrize("chain", [False, True])
def test_dependent_batches_program_equals_the_loop(chain):
    """The k-batch program with its carry, run through a Graphs (eagerly
    here), against the loop it replaced, on forward_prepared."""
    cfg = QmannConfig(dim_emb=16, use_fused_chain=chain)
    dims, mem, que, mask = babi.synthetic_batch(np.random.default_rng(4),
                                                24, V, M, W)
    params = {k: 4.0 * v for k, v in memn2n.init_params(
        cfg, dims, torch.Generator().manual_seed(4), device="cpu").items()}
    prep = memn2n.prepare_inference(params, cfg, max_count=float(W + 1),
                                    max_rowsum=float(W + 1))

    def forward(m, q, msk):
        return memn2n.forward_prepared(prep, m, q, msk, cfg)

    mem, que, mask = (torch.from_numpy(a) for a in (mem, que, mask))
    want = _old_dependent_batches(forward, mem, que, mask, 5)
    g = graphs.Graphs("cpu")
    for _ in range(3):
        assert torch.equal(dependent_batches(forward, mem, que, mask, 5, g),
                           want)
    assert torch.equal(dependent_batches(forward, mem, que, mask, 5), want)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_replayed_epoch_equals_the_eager_loop(cuda):
    """Two graphed epochs (warm-up, capture, replays) against train_step
    over the same batches, bit for bit, and the launch counts those of
    the kernels that ran: 10 lattice and 3 read launches per step."""
    cfg = QmannConfig(use_pallas=True, size_batch=32, verbose=False)
    data, batches_np = _epoch_batches(1, n_batches=4, batch=32,
                                      live_last=9)
    base = {k: 4.0 * v for k, v in memn2n.init_params(
        cfg, data.dims, torch.Generator().manual_seed(1),
        device=cuda).items()}
    batches = {k: torch.from_numpy(v).to(cuda) for k, v in batches_np.items()}
    lr = torch.tensor(0.3, device=cuda)
    loop = {k: v.clone() for k, v in base.items()}
    graphed = {k: v.clone() for k, v in base.items()}
    g = graphs.Graphs(cuda)
    for _ in range(2):
        costs = []
        for i in range(4):
            costs.append(trainer.train_step(
                loop, {k: v[i] for k, v in batches.items()}, lr, cfg)[0])
        before = graphs.launch_counts()
        _, cost, _ = trainer.train_epoch(graphed, batches, lr, cfg,
                                         graphs=g)
        torch.cuda.synchronize()
        ran = [a - b for a, b in zip(graphs.launch_counts(), before)]
        assert ran[:2] == [40, 12]
        assert torch.equal(cost, torch.stack(costs).sum())
    assert len(g.graphs) == 1
    for k in base:
        assert torch.equal(graphed[k], loop[k]), k


@pytest.mark.cuda
def test_a_host_sync_in_a_body_raises(cuda):
    """A body that reads a value on the host fails on the card at its
    first call (the warm-up, under sync debug mode "error"), before any
    capture; nothing falls back to eager."""
    g = graphs.Graphs(cuda)
    x = torch.ones(4, device=cuda)
    with pytest.raises(RuntimeError):
        g(("item",), lambda t: t * t.sum().item(), x)
    assert not g.graphs
