"""The port's device mesh (``qmann_tpu_torch/parallel/``) against the JAX
package's on the CPU.

Each mesh shape, (2, 2) and (1, 4), is one group of 4 spawned ranks on
gloo, started once by a module-scoped fixture; every rank runs every check
of ``_rank_checks`` on numpy inputs the fixture makes and returns numpy
results.  Each test then reads those results and holds them against the
JAX function on the same inputs, run in this process on the 8 virtual CPU
devices of ``tests/conftest.py`` over a JAX mesh of the same shape.  The
ranks import neither jax nor ``qmann_tpu``: this module imports jax only
inside its fixtures and tests.

Tolerances, as ``tests/test_parallel.py`` holds JAX's sharded functions to
its single-device ones:
  * sharded and explicit steps: parameters rtol 2e-5, atol 2e-6 (gradient
    sums in another order); cost rtol 1e-4; matches equal; every rank's
    parameters bitwise equal after 3 steps;
  * memory-sharded read: p rtol 1e-5, atol 1e-6; o within one 2^-frac step
    when quantized, else rtol 1e-5, atol 1e-6; gradients rtol 1e-5, atol
    2e-6 * max|grad| per array (du sums unit-size terms that cancel to
    ~1e-2: each side is ~1e-6 of max|du| off a float64 sum, in opposite
    directions; a mis-transposed collective would multiply a gradient by
    the axis size);
  * sharded prepared infer and eval_split(mesh=): predictions, matches and
    errors equal, cost rtol 1e-6;
  * the engine over the mesh: answers equal to the plain route's;
  * specs, mesh layouts and the backend rule: equal.
"""
import dataclasses
import multiprocessing as mp

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qmann_tpu_torch.config import QmannConfig  # noqa: E402
from qmann_tpu_torch.data import DataDims  # noqa: E402
from qmann_tpu_torch.models import memn2n  # noqa: E402
from qmann_tpu_torch.parallel import distributed, explicit  # noqa: E402
from qmann_tpu_torch.parallel import mesh as pmesh, sharding  # noqa: E402
from qmann_tpu_torch.parallel.launch import free_port, run_ranks  # noqa: E402

SHAPES = [(2, 2), (1, 4)]
DIM_INPUT, M_ROWS, DIM_EMB = 24, 8, 16
# name -> (config fields, batch, remove_softmax)
STEP_CASES = {
    "mode2": ({}, "b8", False),
    "mode3": ({"attention_mode": 3, "iwl": 1}, "b8", False),
    "kernel_route": ({"use_pallas": True}, "b8", False),
    "shift": ({"en_att_shift": True}, "b8", False),
    "sc_att": ({"en_sc_att": True}, "b8", False),
    "ragged": ({}, "b7", False),
    "linear_start": ({}, "b8", True),
}
EXPLICIT_CASES = ("mode2", "mode3")
READ_CASES = {
    "mode2": {"attention_mode": 2},
    "mode1": {"attention_mode": 1, "en_fixed_point": False},
    "mode3": {"attention_mode": 3},
    "shift": {"attention_mode": 2, "en_att_shift": True},
    "clip": {"attention_mode": 2, "en_att_clip": True},
}
GRAD_CASES = ("mode1", "mode3", "shift")
LR, SIZE_B = 0.3, 8.0


def make_case(rng, n=8, m=M_ROWS, dim_input=DIM_INPUT):
    """tests/test_parallel.py's batch: binary bag-of-words rows, one-hot
    answers, a ragged row mask."""
    dims = DataDims(dim_dict=dim_input - m, max_line=m, max_word=6,
                    dim_word=7, dim_input=dim_input)
    mem = rng.integers(0, 2, (n, m, dim_input)).astype(np.float32)
    que = rng.integers(0, 2, (n, dim_input)).astype(np.float32)
    ans = np.zeros((n, dim_input), np.float32)
    ans[np.arange(n), rng.integers(1, dim_input, n)] = 1.0
    n_sen = rng.integers(1, m + 1, n)
    mask = np.arange(m)[None, :] < n_sen[:, None]
    batch = {"memory": mem * mask[:, :, None], "question": que,
             "answer": ans, "mask": mask,
             "sample_mask": np.ones(n, np.float32)}
    return dims, batch


def cfg_of(**kw):
    return QmannConfig(dim_emb=DIM_EMB, num_hops=3, verbose=False, **kw)


def jax_cfg(**kw):
    from qmann_tpu.config import QmannConfig as JaxConfig
    kw = {k: v for k, v in kw.items() if k != "use_pallas"}
    return JaxConfig(dim_emb=DIM_EMB, num_hops=3, verbose=False, **kw)


def jax_mesh(model):
    from qmann_tpu.parallel import make_mesh
    return make_mesh(4, model_parallelism=model)


# ---------------------------------------------------------------------------
# what each rank runs
# ---------------------------------------------------------------------------

def _tensors(params):
    return {k: torch.tensor(v) for k, v in params.items()}


def _numpy(params):
    return {k: v.numpy().copy() for k, v in params.items()}


def _rank_checks(model, inputs):
    """Every check on this rank; numpy results keyed by check."""
    torch.manual_seed(0)
    mesh = pmesh.make_mesh(4, model, device="cpu")
    out = {"mesh": dict(data=mesh.data, model=mesh.model,
                        data_idx=mesh.data_idx, model_idx=mesh.model_idx,
                        backend=mesh.backend, rank=mesh.rank)}
    default = pmesh.make_mesh(device="cpu")
    hybrid = pmesh.make_hybrid_mesh(model, device="cpu")
    out["mesh"].update(default=(default.data, default.model),
                       hybrid=(hybrid.data, hybrid.model))
    try:
        pmesh.make_hybrid_mesh(3, device="cpu")
    except ValueError as exc:
        out["mesh"]["hybrid_refusal"] = str(exc)

    # the sharded step: one step from the fixture's weights, then two more
    steps = {}
    for name, (kw, bkey, rm) in STEP_CASES.items():
        cfg = cfg_of(**kw)
        params = _tensors(inputs["params"][name])
        step = sharding.make_sharded_train_step(cfg, mesh)
        batch = inputs[bkey]
        _, cost, matches = step(params, batch, LR, SIZE_B, rm)
        first = _numpy(params)
        for _ in range(2):
            step(params, batch, LR, SIZE_B, rm)
        steps[name] = dict(params=first, cost=float(cost),
                           matches=int(matches), after3=_numpy(params),
                           layout=tuple(step.layout(
                               batch["question"].shape[0],
                               batch["mask"].shape[-1], rm)))
    out["steps"] = steps
    out["explicit"] = {}
    for name in EXPLICIT_CASES:
        cfg = cfg_of(**STEP_CASES[name][0])
        params = _tensors(inputs["params"][name])
        step = explicit.make_explicit_train_step(cfg, mesh)
        _, cost, matches = step(params, inputs["b8"], LR, SIZE_B)
        out["explicit"][name] = dict(params=_numpy(params), cost=float(cost),
                                     matches=int(matches))
    try:
        explicit.make_explicit_train_step(cfg_of(type_weight_tying=1), mesh)
    except NotImplementedError as exc:
        out["explicit_refusal"] = str(exc)

    # the memory-sharded read: forward, and gradients of sum(o * g)
    read = inputs["read"]
    rows = ("data", "model", None)
    spec = {"m": rows, "c": rows, "u": ("data", None),
            "mask": ("data", "model"), "g": ("data", None)}
    blk = {k: torch.tensor(sharding._block(mesh, read[k], s))
           for k, s in spec.items()}
    out["read"], out["read_grads"] = {}, {}
    for name, kw in READ_CASES.items():
        cfg = cfg_of(**kw)
        m, c, u = (blk[k].clone().requires_grad_() for k in ("m", "c", "u"))
        o, p = distributed.memory_sharded_attention_read(
            mesh, m, c, u, blk["mask"], cfg)
        out["read"][name] = (o.detach().numpy(), p.detach().numpy())
        if name in GRAD_CASES:
            grads = torch.autograd.grad((o * blk["g"]).sum(), (m, c, u))
            out["read_grads"][name] = tuple(g.numpy() for g in grads)

    # serving and evaluation
    out["prepared"] = {}
    for mode in (2, 3):
        cfg = cfg_of(attention_mode=mode)
        params = memn2n.params_from_jax(inputs["params"][f"mode{mode}"], cfg,
                                        device="cpu")
        b = inputs["b8"]
        prep = memn2n.prepare_inference(
            params, cfg, max_count=2.0,
            max_rowsum=float(b["memory"].sum(-1).max()))
        run = sharding.make_sharded_prepared_infer(prep, cfg, mesh)
        cost, matches, pred = run(b["memory"], b["question"], b["answer"],
                                  b["mask"])
        out["prepared"][mode] = (float(cost), int(matches), pred.numpy(),
                                 prep.fast)
    from qmann_tpu_torch.data.babi import VectorizedSplit
    from qmann_tpu_torch.train import eval_split
    b24 = inputs["b24"]
    split = VectorizedSplit(b24["memory"], b24["question"], b24["answer"],
                            b24["mask"].sum(-1).astype(np.int32),
                            b24["answer"].argmax(-1).astype(np.int32))
    cfg = cfg_of()
    out["eval"] = eval_split(_tensors(inputs["params"]["eval"]), split, cfg,
                             chunk=16, mesh=mesh)
    out["engine"] = _engine_answers(inputs, mesh)
    return out


def _engine(inputs, mesh, chain=True, **kw):
    from qmann_tpu_torch.data import Dictionary
    from qmann_tpu_torch.serve import InferenceEngine
    dictionary = Dictionary()
    for w in inputs["words"]:
        dictionary.add(w)
    cfg = cfg_of(use_fused_chain=chain)
    params = memn2n.params_from_jax(inputs["params"]["mode2"], cfg,
                                    device="cpu")
    dims = DataDims(dim_dict=DIM_INPUT - M_ROWS, max_line=M_ROWS,
                    max_word=6, dim_word=7, dim_input=DIM_INPUT)
    return InferenceEngine(params, cfg, dims, dictionary, batch_size=8,
                           max_wait_ms=20.0, mesh=mesh, device="cpu", **kw)


def _engine_answers(inputs, mesh):
    """The mesh engine's answers to the stories (rank 0; the others
    follow), and its failed waves."""
    eng = _engine(inputs, mesh).start()
    answers = None
    try:
        if mesh is None or mesh.rank == 0:
            futs = [eng.submit(s, q) for s, q in inputs["stories"]]
            answers = [f.result(timeout=120) for f in futs]
    finally:
        eng.stop()
    return answers, eng.stats.failed_waves, eng.cfg.use_fused_chain


# ---------------------------------------------------------------------------
# the fixture: one group of 4 ranks per mesh shape
# ---------------------------------------------------------------------------

def _inputs():
    import jax
    from qmann_tpu.models import memn2n as jmodel
    rng = np.random.default_rng(0)
    dims, b8 = make_case(rng)
    _, b7 = make_case(np.random.default_rng(1), n=7, m=6)
    _, b24 = make_case(np.random.default_rng(2), n=24)

    def init(kw, seed=0, dims=dims):
        p = jmodel.init_params(jax_cfg(**kw), dims, jax.random.PRNGKey(seed))
        # x4: unscaled N(0, 0.1) weights quantize to almost nothing at Q5.2
        return {k: np.asarray(v) * np.float32(4.0) for k, v in p.items()}

    params = {name: init(kw, dims=dims if bkey == "b8" else DataDims(
        dim_dict=DIM_INPUT - 6, max_line=6, max_word=6, dim_word=7,
        dim_input=DIM_INPUT)) for name, (kw, bkey, _) in STEP_CASES.items()}
    params["eval"] = init({}, seed=1)
    B, M, D = 4, 8, DIM_EMB
    n_sen = rng.integers(2, M + 1, B)
    read = {"m": rng.normal(0, 1.0, (B, M, D)).astype(np.float32),
            "c": rng.normal(0, 1.0, (B, M, D)).astype(np.float32),
            "u": rng.normal(0, 1.0, (B, D)).astype(np.float32),
            "mask": np.arange(M)[None, :] < n_sen[:, None],
            "g": rng.normal(0, 1.0, (B, D)).astype(np.float32)}
    words = [f"w{i}" for i in range(1, DIM_INPUT - M_ROWS)]
    stories = [([[words[i] for i in rng.integers(0, len(words),
                                                 rng.integers(1, 6))]
                 for _ in range(rng.integers(1, M_ROWS + 3))],
                [words[i] for i in rng.integers(0, len(words), 3)])
               for _ in range(40)]
    return dict(params=params, b8=b8, b7=b7, b24=b24, read=read,
                words=words, stories=stories)


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def ranks(request, inputs):
    """((data, model), the 4 ranks' results)."""
    data, model = request.param
    return request.param, run_ranks(_rank_checks, data * model,
                                    (model, inputs), device="cpu",
                                    timeout=400)


def _whole(results, get, spec, shape):
    """The global array from the ranks' blocks under spec."""
    out = np.zeros(shape, np.float32)
    for res in results:
        r = res["mesh"]
        idx = []
        for dim, axis in enumerate(spec):
            if axis is None:
                idx.append(slice(None))
                continue
            n, k = r[axis], r[f"{axis}_idx"]
            size = shape[dim] // n
            idx.append(slice(k * size, (k + 1) * size))
        out[tuple(idx)] = get(res)
    return out


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def test_mesh_axes_layout_and_hybrid_mesh(ranks):
    (data, model), results = ranks
    jm = jax_mesh(model)
    for rank, res in enumerate(results):
        r = res["mesh"]
        assert (r["data"], r["model"]) == jm.devices.shape == (data, model)
        # JAX's row-major reshape(n // mp, mp)
        assert (r["data_idx"], r["model_idx"]) == divmod(rank, model)
        assert r["rank"] == rank and r["backend"] == "gloo"
        assert r["default"] == jax_mesh(None).devices.shape == (1, 4)
        assert r["hybrid"] == (data, model)
        assert "does not divide the 4 ranks of a host" in r["hybrid_refusal"]


def test_backend_rule():
    assert pmesh.backend_for("cuda", 1, 1) == "nccl"
    assert pmesh.backend_for("cuda", 4, 4) == "nccl"
    assert pmesh.backend_for("cuda", 4, 1) == "gloo"   # ranks share a card
    assert pmesh.backend_for("cpu", 1, 0) == "gloo"
    assert pmesh.backend_for("cpu", 4, 8) == "gloo"


@pytest.mark.parametrize("model", [1, 2, 4])
def test_specs_match_jax_partition_specs(model):
    from qmann_tpu.parallel import sharding as jsharding
    jm = jax_mesh(model)
    mesh = pmesh.Mesh(4 // model, model, 0, 0, torch.device("cpu"), "gloo",
                      {"data": None, "model": None})
    for n, m in ((8, 8), (7, 6), (24, 10)):
        _, batch = make_case(np.random.default_rng(0), n=n, m=m)
        want = jsharding.batch_shardings(jm, batch)
        got = sharding.batch_shardings(mesh, batch)
        assert got == {k: tuple(v.spec) for k, v in want.items()}
        assert sharding.infer_specs(mesh, n, m) == {
            k: tuple(v) for k, v in jsharding.infer_specs(jm, n, m).items()}
        assert sharding.axis_if_divisible(mesh, "model", m) == \
            jsharding.axis_if_divisible(jm, "model", m)
    params = {"A": np.zeros((16, 24)), "W": np.zeros((24, 16)),
              "E": np.zeros((4, 16, 24)), "scale": np.zeros(3)}
    want = jsharding.param_shardings(jm, params)
    assert sharding.param_shardings(mesh, params) == {
        k: tuple(v.spec) for k, v in want.items()}


def _jax_step(make, jm, name, inputs):
    """JAX's step made by make(cfg, mesh), one step on the case."""
    import jax.numpy as jnp
    from qmann_tpu.parallel import shard_batch, shard_params
    kw, bkey, rm = STEP_CASES[name]
    params = {k: jnp.asarray(v) for k, v in inputs["params"][name].items()}
    out, cost, matches = make(jax_cfg(**kw), jm)(
        shard_params(jm, params), shard_batch(jm, inputs[bkey]),
        jnp.float32(LR), jnp.float32(SIZE_B),
        **({"remove_softmax": True} if rm else {}))
    return {k: np.asarray(v) for k, v in out.items()}, float(cost), \
        int(matches)


_SINGLE = {}


def _jax_single_step(name, inputs):
    """JAX's step on one device (its sharded step over a mesh of one), the
    reference its own sharded steps are held to in tests/test_parallel.py;
    one compile per case for both mesh shapes (the kernel route's case is
    mode 2's: JAX's config has no kernel switch on the CPU)."""
    from qmann_tpu.parallel import make_mesh, make_sharded_train_step
    key = "mode2" if name == "kernel_route" else name
    if key not in _SINGLE:
        _SINGLE[key] = _jax_step(make_sharded_train_step, make_mesh(1), key,
                                 inputs)
    return _SINGLE[key]


def _check_step(got, want, inputs, name):
    params, cost, matches = want
    for k in params:
        np.testing.assert_allclose(got["params"][k], params[k], rtol=2e-5,
                                   atol=2e-6, err_msg=k)
    np.testing.assert_allclose(got["cost"], cost, rtol=1e-4)
    assert got["matches"] == matches
    # the step moved the weights
    moved = max(np.max(np.abs(params[k] - inputs["params"][name][k]))
                for k in params)
    assert moved > 1e-3


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_sharded_step_matches_jax_sharded_step(ranks, inputs, name):
    """Each case's step against JAX's step on one device and, in mode 2,
    against JAX's GSPMD step on a JAX mesh of the same shape; all 4 ranks'
    parameters bitwise equal after 3 steps.  The cases cover the memory
    split (mode 2, mode 3, the kernel route's plain versions, the score
    shift) and the memory kept whole (EN_SC_ATT, M = 6 over 4 with B = 7
    over 2, linear start)."""
    from qmann_tpu.parallel import make_sharded_train_step as jmake
    (data, model), results = ranks
    _check_step(results[0]["steps"][name], _jax_single_step(name, inputs),
                inputs, name)
    if name == "mode2":
        _check_step(results[0]["steps"][name],
                    _jax_step(jmake, jax_mesh(model), name, inputs), inputs,
                    name)
    split, m_split, rows, copies = results[0]["steps"][name]["layout"]
    if name in ("sc_att", "linear_start") or (name == "ragged"
                                              and model == 4):
        assert not m_split
    elif model > 1:
        assert m_split
    for res in results[1:]:
        for k, v in res["steps"][name]["after3"].items():
            np.testing.assert_array_equal(
                v, results[0]["steps"][name]["after3"][k], err_msg=k)


@pytest.mark.parametrize("name", EXPLICIT_CASES)
def test_explicit_step_matches_jax_explicit_step(ranks, inputs, name):
    """Mode 2 against JAX's explicit step on a JAX mesh of the same shape,
    mode 3 against JAX's step on one device."""
    from qmann_tpu.parallel import make_explicit_train_step as jmake
    (data, model), results = ranks
    want = (_jax_step(jmake, jax_mesh(model), name, inputs)
            if name == "mode2" else _jax_single_step(name, inputs))
    for res in results:
        _check_step(res["explicit"][name], want, inputs, name)


def test_explicit_step_refuses_tying_1(ranks):
    from qmann_tpu.parallel import make_explicit_train_step as jmake
    (_, model), results = ranks
    with pytest.raises(NotImplementedError) as want:
        jmake(jax_cfg(type_weight_tying=1), jax_mesh(model))
    assert all(r["explicit_refusal"] == str(want.value) for r in results)


def _jax_read(model, kw, read):
    """JAX's memory-sharded read on a JAX mesh of the same shape, jitted
    (shard_map runs op by op otherwise)."""
    import jax
    import jax.numpy as jnp
    from qmann_tpu.parallel import memory_sharded_attention_read
    jm = jax_mesh(model)
    cfg = jax_cfg(**kw)
    mask = jnp.asarray(read["mask"])

    def f(m, c, u):
        return memory_sharded_attention_read(jm, m, c, u, mask, cfg)

    return jm, cfg, f, tuple(jnp.asarray(read[k]) for k in ("m", "c", "u"))


@pytest.mark.parametrize("name", sorted(READ_CASES))
def test_memory_sharded_read_matches_jax(ranks, inputs, name):
    (data, model), results = ranks
    read = inputs["read"]
    B, M, D = read["m"].shape
    import jax
    _, cfg, f, args = _jax_read(model, READ_CASES[name], read)
    o_want, p_want = (np.asarray(x) for x in jax.jit(f)(*args))
    o = _whole(results, lambda r: r["read"][name][0], ("data", None), (B, D))
    p = _whole(results, lambda r: r["read"][name][1], ("data", "model"),
               (B, M))
    np.testing.assert_allclose(p, p_want, rtol=1e-5, atol=1e-6)
    if cfg.wsum_quantized:
        assert np.max(np.abs(o - o_want)) <= 2.0 ** (-cfg.fmt_act[0].frac)
    else:
        np.testing.assert_allclose(o, o_want, rtol=1e-5, atol=1e-6)
    # o is the same on every rank of the model axis
    for r in results:
        ref = next(s for s in results if s["mesh"]["data_idx"]
                   == r["mesh"]["data_idx"])
        np.testing.assert_array_equal(r["read"][name][0], ref["read"][name][0])


@pytest.mark.parametrize("name", GRAD_CASES)
def test_memory_sharded_read_gradients_match_jax(ranks, inputs, name):
    """The gradients of sum(o * g) through the distributed read against
    JAX's: a psum whose backward all-reduced would scale dm and dc by the
    model axis' size, a vary without one would leave du partial."""
    import jax
    import jax.numpy as jnp
    (data, model), results = ranks
    read = inputs["read"]
    B, M, D = read["m"].shape
    _, _, f, args = _jax_read(model, READ_CASES[name], read)
    g = jnp.asarray(read["g"])
    want = jax.jit(jax.grad(lambda *a: jnp.sum(f(*a)[0] * g),
                            argnums=(0, 1, 2)))(*args)
    got = [_whole(results, lambda r, i=i: r["read_grads"][name][i], spec,
                  shape) for i, (spec, shape) in enumerate((
                      (("data", "model", None), (B, M, D)),
                      (("data", "model", None), (B, M, D)),
                      (("data", None), (B, D))))]
    for a, b, label in zip(got, want, ("dm", "dc", "du")):
        scale = np.max(np.abs(np.asarray(b)))
        assert scale > 1e-3, label
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5,
                                   atol=2e-6 * scale, err_msg=label)


@pytest.mark.parametrize("mode", [2, 3])
def test_sharded_prepared_infer_matches_jax(ranks, inputs, mode):
    import jax.numpy as jnp
    from qmann_tpu.models import memn2n as jmodel
    from qmann_tpu.parallel import make_sharded_prepared_infer as jmake
    (_, model), results = ranks
    b = inputs["b8"]
    cfg = jax_cfg(attention_mode=mode)
    params = inputs["params"][f"mode{mode}"]
    prep = jmodel.prepare_inference(
        {k: jnp.asarray(v) for k, v in params.items()}, cfg, max_count=2.0,
        max_rowsum=float(b["memory"].sum(-1).max()))
    cost, matches, pred = jmake(prep, cfg, jax_mesh(model))(
        b["memory"], b["question"], b["answer"], b["mask"])
    for res in results:
        got_cost, got_matches, got_pred, fast = res["prepared"][mode]
        assert fast == prep.fast
        np.testing.assert_array_equal(got_pred, np.asarray(pred))
        assert got_matches == int(matches)
        np.testing.assert_allclose(got_cost, float(cost), rtol=1e-6)
    assert len(set(np.asarray(pred).tolist())) > 1


def test_eval_split_mesh_matches_jax(ranks, inputs):
    import jax.numpy as jnp
    from qmann_tpu.data.babi import VectorizedSplit
    from qmann_tpu.parallel import shard_params
    from qmann_tpu.train import eval_split
    (_, model), results = ranks
    b = inputs["b24"]
    split = VectorizedSplit(b["memory"], b["question"], b["answer"],
                            b["mask"].sum(-1).astype(np.int32),
                            b["answer"].argmax(-1).astype(np.int32))
    jm = jax_mesh(model)
    params = shard_params(jm, {k: jnp.asarray(v) for k, v in
                               inputs["params"]["eval"].items()})
    cost, err, preds = eval_split(params, split, jax_cfg(), chunk=16,
                                  mesh=jm)
    for res in results:
        got_cost, got_err, got_preds = res["eval"]
        np.testing.assert_array_equal(got_preds, preds)
        assert got_err == err
        np.testing.assert_allclose(got_cost, cost, rtol=1e-6)


def test_engine_over_the_mesh_answers_as_the_plain_route(ranks, inputs):
    """Rank 0 serves 40 requests over waves of 8 while the others follow;
    the answers equal the port's single-device engine on the plain
    prepared forward, which the mesh pins (use_fused_chain off)."""
    _, results = ranks
    answers, failed, chain = results[0]["engine"]
    eng = _engine(inputs, None, chain=False).start()
    try:
        plain = [eng.submit(s, q).result(timeout=120)
                 for s, q in inputs["stories"]]
    finally:
        eng.stop()
    assert answers == plain and failed == 0 and not chain
    assert all(r["engine"][0] is None for r in results[1:])
    assert len(set(plain)) > 1


# where the failing engines of _failing_engines raise, on wave 2
FAIL_CASES = ("vectorize", "leader", "follower", "every")


def _failing_engines(inputs):
    """On a (1, 2) mesh, one engine per case of FAIL_CASES whose second
    wave raises: in rank 0's vectorizer (before the broadcast), after rank
    0's part, after rank 1's part, or on both ranks before their parts.
    Rank 0 submits the 40 stories and, once they have resolved, one more.
    Returns per case what each rank saw."""
    import concurrent.futures as cf
    import time
    mesh = pmesh.make_mesh(2, 2, device="cpu")
    out = {}
    for where in FAIL_CASES:
        eng = _engine(inputs, mesh)
        waves = [0]

        def fail_on_wave_2(fn, after):
            def wrapped(*args):
                waves[0] += 1
                if waves[0] == 2 and not after:
                    raise RuntimeError(f"injected on rank {mesh.rank}")
                res = fn(*args)
                if waves[0] == 2:
                    raise RuntimeError(f"injected on rank {mesh.rank}")
                return res
            return wrapped

        if where == "vectorize" and mesh.rank == 0:
            eng._vectorize = fail_on_wave_2(eng._vectorize, False)
        elif (where == "every" or where == "leader" and mesh.rank == 0
              or where == "follower" and mesh.rank == 1):
            eng._infer_sharded = fail_on_wave_2(eng._infer_sharded,
                                                where != "every")
        t0 = time.perf_counter()
        eng.start()
        seen = dict(answers=None, late=None)
        try:
            if mesh.rank == 0:
                futs = [eng.submit(s, q) for s, q in inputs["stories"]]
                cf.wait(futs, timeout=120)
                seen["answers"] = [f.result() if f.done() and not
                                   f.exception() else repr(f.exception())
                                   if f.done() else "pending" for f in futs]
                late = eng.submit(*inputs["stories"][0])
                seen["late"] = ("failed at once" if late.done()
                                and late.exception() else
                                late.result(timeout=60))
        finally:
            eng.stop(timeout=60)
        seen.update(error=repr(eng.error) if eng.error else None,
                    failed=eng.stats.failed_waves,
                    seconds=time.perf_counter() - t0)
        out[where] = seen
    return out


@pytest.fixture(scope="module")
def failures(inputs):
    """Both ranks' results of _failing_engines, and the plain route's
    answers to the stories."""
    results = run_ranks(_failing_engines, 2, (inputs,), device="cpu",
                        timeout=300)
    eng = _engine(inputs, None, chain=False).start()
    try:
        plain = [eng.submit(s, q).result(timeout=120)
                 for s, q in inputs["stories"]]
    finally:
        eng.stop()
    return results, plain


@pytest.mark.parametrize("where", FAIL_CASES[1:])
def test_failed_wave_on_the_mesh_ends_every_rank(failures, where):
    """A wave that fails after its broadcast, on one rank or on all, ends
    the engine on every rank at that wave: the ranks return from stop, the
    earlier waves' answers are the plain route's, that wave's and the
    queued requests fail, a request submitted afterwards fails at once,
    and every rank's engine holds the cause."""
    results, plain = failures
    lead, follow = (r[where] for r in results)
    answers = lead["answers"]
    n_ok = next(i for i, a in enumerate(answers) if not isinstance(a, int))
    assert 0 < n_ok < len(answers) and answers[:n_ok] == plain[:n_ok]
    assert all(isinstance(a, str) and a.startswith("RuntimeError")
               for a in answers[n_ok:])
    assert lead["late"] == "failed at once"
    assert lead["failed"] == 1
    assert "injected" in lead["error"] or "another rank" in lead["error"]
    assert follow["error"] is not None
    assert max(lead["seconds"], follow["seconds"]) < 60


def test_vectorizer_failure_on_the_mesh_fails_one_wave(failures):
    """A wave that fails in rank 0's vectorizer, before its broadcast,
    fails alone, as off a mesh: every other request is answered as on the
    plain route, and the engine keeps serving on both ranks."""
    results, plain = failures
    lead, follow = (r["vectorize"] for r in results)
    bad = [i for i, a in enumerate(lead["answers"]) if not isinstance(a, int)]
    assert bad and lead["failed"] == 1
    assert all("injected on rank 0" in lead["answers"][i] for i in bad)
    assert [a for i, a in enumerate(lead["answers"]) if i not in bad] == \
        [a for i, a in enumerate(plain) if i not in bad]
    assert lead["late"] == plain[0]
    assert lead["error"] is None and follow["error"] is None


# the collective timeout of the hung-peer case, seconds
HUNG_TIMEOUT_S = 3.0


def _hung_peer_engine(inputs, done_file):
    """On a (1, 2) mesh whose groups (the world's, the mesh's and the
    engine's) time out after HUNG_TIMEOUT_S: rank 1 computes its part of
    the first wave and raises before the wave's status all_reduce, which
    rank 0 then waits in.  Rank 1 stays alive until rank 0 has returned
    from stop (done_file), at most 10 timeouts, so that only the timeout
    can end rank 0's wait.  Returns what each rank saw and its seconds
    from the wave's submission to the return of stop."""
    import datetime
    import os
    import time
    timeout = datetime.timedelta(seconds=HUNG_TIMEOUT_S)
    mesh = pmesh.make_mesh(2, 2, device="cpu", timeout=timeout)
    eng = _engine(inputs, mesh, mesh_timeout=timeout)
    if mesh.rank == 1:
        def hang(compute):
            compute()
            raise RuntimeError("injected on rank 1")
        eng._wave_on_mesh = hang
    eng.start()
    seen = {}
    t0 = time.perf_counter()
    if mesh.rank == 0:
        fut = eng.submit(*inputs["stories"][0])
        try:
            seen["answer"] = fut.result(timeout=60)
        except Exception as exc:  # noqa: BLE001 - the expected failure
            seen["answer"] = repr(exc)
        eng.stop(timeout=60)
        seen["seconds"] = time.perf_counter() - t0
        open(done_file, "w").close()
    else:
        eng._thread.join(60)
        deadline = time.monotonic() + 10 * HUNG_TIMEOUT_S
        while not os.path.exists(done_file) and time.monotonic() < deadline:
            time.sleep(0.05)
        eng.stop(timeout=60)
        seen["seconds"] = time.perf_counter() - t0
    seen["error"] = repr(eng.error) if eng.error else None
    return seen


def test_hung_peer_ends_the_mesh_engine_within_its_timeout(inputs,
                                                           tmp_path):
    """A rank that fails between a wave's broadcast and its status
    all_reduce leaves rank 0 inside that collective: the engine group's
    timeout ends it, rank 0 fails the wave and closes, and both ranks
    return within twice the timeout (the spawned group is the test's own:
    a group that timed out is broken)."""
    import datetime
    lead, follow = run_ranks(
        _hung_peer_engine, 2, (inputs, str(tmp_path / "rank0_done")),
        device="cpu", timeout=120,
        group_timeout=datetime.timedelta(seconds=HUNG_TIMEOUT_S))
    assert isinstance(lead["answer"], str)
    assert "RuntimeError" in lead["answer"] and lead["error"]
    assert "injected on rank 1" in follow["error"]
    assert max(lead["seconds"], follow["seconds"]) < 2 * HUNG_TIMEOUT_S


def _cli_on_rank(argv):
    """python -m qmann_tpu_torch's main on this rank, with every
    eval_split call of the command line recorded: the mesh it was given,
    and the error it returned beside the error off the mesh."""
    import qmann_tpu_torch.train as train
    from qmann_tpu_torch import cli
    real, seen = train.eval_split, []

    def spy(params, split, cfg, *args, mesh=None, **kw):
        out = real(params, split, cfg, *args, mesh=mesh, **kw)
        seen.append((mesh.world if mesh else None, out[1],
                     real(params, split, cfg, *args, **kw)[1]))
        return out

    train.eval_split = spy
    try:
        return cli.main(argv), seen
    finally:
        train.eval_split = real


def test_cli_joint_mode_evaluates_each_task_on_the_mesh(tmp_path):
    """--joint under --mesh 2,1 on two ranks: each task's test split is
    evaluated over the mesh on both ranks, with the error of the
    evaluation off the mesh, and rank 0 writes one result row per task."""
    from qmann_tpu_torch.data import babi
    parsed, raw = babi.write_synthetic_corpus(
        str(tmp_path / "data"), np.random.default_rng(11), [1, 2], 80, 24,
        parsed=[1])
    out = tmp_path / "out"
    argv = ["1", "1", "2", "5", "--joint", "--shuffle", "--dim-forced",
            "--max-dict-len", "24", "--max-sen-len", "12", "--max-samples",
            "96", "--max-test-samples", "16", "--mesh", "2,1", "--epochs",
            "1", "--dim-emb", "8", "--hops", "2", "--data-path", parsed,
            "--raw-data-path", raw, "--out-dir", str(out), "--device",
            "cpu", "--quiet"]
    results = run_ranks(_cli_on_rank, 2, (argv,), device="cpu", timeout=200)
    for rc, seen in results:
        assert rc == 0 and len(seen) == 2
        assert all(world == 2 and err == err_single
                   for world, err, err_single in seen)
    assert results[0][1] == results[1][1]
    rows = (out / "result.csv").read_text().splitlines()
    assert [r.split(",")[0] for r in rows[rows.index(next(
        r for r in rows if r.startswith("ind_data_set"))) + 1:]] == ["1", "2"]


def _multihost_worker(port, pid, results):
    """One of two processes joining through initialize_multihost's
    coordinator address."""
    import os
    os.environ.pop("LOCAL_WORLD_SIZE", None)
    torch.set_num_threads(1)
    backend = pmesh.initialize_multihost(f"localhost:{port}", 2, pid,
                                         device="cpu")
    try:
        mesh = pmesh.make_hybrid_mesh(2, device="cpu")
        x = torch.tensor([float(pid + 1)])
        total = distributed.psum(x, mesh.group("model"))
        results.put((pid, backend, (mesh.data, mesh.model), float(total)))
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()


def test_initialize_multihost_two_processes():
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_multihost_worker, args=(port, pid, results),
                         daemon=True) for pid in range(2)]
    for p in procs:
        p.start()
    try:
        got = sorted(results.get(timeout=120) for _ in procs)
        for p in procs:
            p.join(timeout=60)
            assert not p.is_alive()
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
    assert got == [(0, "gloo", (1, 2), 3.0), (1, "gloo", (1, 2), 3.0)]


def test_make_mesh_without_a_group_is_one_rank():
    mesh = pmesh.make_mesh(device="cpu")
    assert (mesh.data, mesh.model, mesh.rank, mesh.world) == (1, 1, 0, 1)
    assert mesh.group(("data", "model")) is None
    with pytest.raises(ValueError, match="torch.distributed.run"):
        pmesh.make_mesh(2, device="cpu")


def test_port_parallel_all_matches_jax():
    import qmann_tpu.parallel as jparallel
    import qmann_tpu_torch.parallel as tparallel
    assert tparallel.__all__ == jparallel.__all__
    assert dataclasses.is_dataclass(pmesh.Mesh)
