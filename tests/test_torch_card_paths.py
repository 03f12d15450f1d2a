"""The port's entry points on the card, each against its plain route on
the card: the paths that the CPU tests hold to JAX on the plain kernels
run here on the hand-written ones.  Without a card these tests skip.

This file imports no jax, so that it runs on a machine with a GPU and no
jax; tests/conftest.py imports jax, so skip it there:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_card_paths.py -q -m cuda

Each test runs one path at the flagship widths (3 hops, dim_emb 60,
EN_MQ formats, batch 32) on qa1-shaped synthetic stories (V=19, M=10,
W=6), or on megasweep's padded layout (V=64, M=50) where the path is the
family's, and counts the kernels it launched (``graphs.launch_counts``:
what the card ran, graph replays included).

Tolerances.  Answers and predictions: equal to the plain route's (the
prepared forward is exact), but for at most one query with a flipped
Q(p, act) requant on the chain.  One SGD step, kernel route against plain
route, and a family step against ``train_step``: rtol 1e-5, atol 1e-6
(the backward's float sums in another order).  A family run's history
against its ``train_task``: error rates equal, costs rtol 2e-4.  The
mesh's steps against the single-device plain step: parameters rtol 2e-5,
atol 2e-6, cost rtol 1e-4, matches equal, its ranks bitwise equal; its
distributed read within atol 1e-6 of p and one 2^-frac step of o.  A
graphed program against the eager one: bit for bit (the same kernels in
the same order).
"""
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qmann_tpu_torch import cli, graphs  # noqa: E402
from qmann_tpu_torch.config import QmannConfig  # noqa: E402
from qmann_tpu_torch.data import (  # noqa: E402
    DataDims, Dictionary, load_test_split, synthetic_batch, synthetic_task,
    write_synthetic_corpus,
)
from qmann_tpu_torch.data.babi import TaskData, VectorizedSplit  # noqa: E402
from qmann_tpu_torch.models import memn2n  # noqa: E402
from qmann_tpu_torch.numerics import float_quant  # noqa: E402
from qmann_tpu_torch.ops.losses import argmax_last  # noqa: E402
from qmann_tpu_torch.serve import InferenceEngine, Request  # noqa: E402
from qmann_tpu_torch.train import multi, train_step, train_task  # noqa: E402
from qmann_tpu_torch.train.trainer import _batched_arrays  # noqa: E402
from qmann_tpu_torch.utils import load_checkpoint, save_checkpoint  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
V, M, W = 19, 10, 6          # qa1's shape
EVAL_CHUNK = 1024            # train_task's evaluation chunk
# graphs.COUNTED's first seven counts: each kernel wrapper's launches
KINDS = ("qmatvec", "read", "hamming", "chain", "hamming_bwd", "wsum_dp",
         "wsum_ds")
# training routes: (config, launches per forward, launches per step's
# backward and update)
ROUTES = {
    "mode2": (dict(use_pallas=True), dict(qmatvec=10, read=3),
              dict(wsum_ds=3)),
    "mode3": (dict(iwl=1, attention_mode=3, use_pallas=True),
              dict(qmatvec=10, read=3), dict(hamming_bwd=3, wsum_ds=3)),
    "mode3 hamming": (dict(iwl=1, attention_mode=3, use_pallas_hamming=True),
                      dict(hamming=3), dict(hamming_bwd=3, wsum_dp=3))}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def task():
    """qa1-shaped stories: 200 to train (6 batches of 32, then one of 8),
    40 to validate, 40 to test."""
    return synthetic_task(np.random.default_rng(0), 200, 40, 40, V, M, W)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Seeded qa1-shaped stories of tasks 1-2 (and qa_joint) in the bAbI
    raw format, task 1 in the parsed format too: (data path, raw path)."""
    return write_synthetic_corpus(str(tmp_path_factory.mktemp("corpus")),
                                  np.random.default_rng(0), [1, 2], CLI_FILE,
                                  CLI_TEST, parsed=[1])


def _counts():
    return dict(zip(KINDS, graphs.launch_counts()))


def _since(before):
    """The launches since ``before`` (a _counts()), once the card is done."""
    torch.cuda.synchronize()
    return {k: v - before[k] for k, v in _counts().items()}


def _want(*terms):
    """{kind: launches} from (count, {kind: launches per unit}) terms."""
    out = dict.fromkeys(KINDS, 0)
    for n, per in terms:
        for k, v in per.items():
            out[k] += n * v
    return out


def _base(cfg, dims, dev, seed=0):
    """Seeded weights x4 (unscaled, Q5.2 maps almost all to 0)."""
    return {k: 4.0 * v for k, v in memn2n.init_params(
        cfg, dims, torch.Generator().manual_seed(seed), device=dev).items()}


def _scaled(cfg, dims, dev):
    """Seeded weights at the largest of x6, x5, x4 and x3 at which
    prepare_inference keeps the exact route on the engine's bounds."""
    base = memn2n.init_params(cfg, dims, torch.Generator().manual_seed(0),
                              device=dev)
    bound = float(dims.max_word + 1)
    for scale in (6.0, 5.0, 4.0, 3.0):
        params = {k: scale * v for k, v in base.items()}
        if memn2n.prepare_inference(params, cfg, max_count=bound,
                                    max_rowsum=bound).fast:
            return params
    pytest.fail("no weight scale keeps prepare_inference on the exact route")


def _dictionary(n=V):
    dictionary = Dictionary()
    for i in range(1, n):
        dictionary.add(f"w{i}")
    return dictionary


def _stories(rng, n, words):
    """n (sentences, question) requests of 1 to M+2 sentences of 1 to W
    words: the longer stories overflow the memory."""
    return [([[words[i] for i in rng.integers(0, len(words),
                                              rng.integers(1, W + 1))]
              for _ in range(rng.integers(1, M + 3))],
             [words[i] for i in rng.integers(0, len(words), 4)])
            for _ in range(n)]


def _steps_agree(cfg, base, data, dev, remove_softmax=False):
    """One SGD step from ``base`` on a full batch and on the partial last
    one, on cfg's kernel route and on the plain route: every value finite,
    the parameters within rtol 1e-5, atol 1e-6, the plain route launching
    nothing.  Returns the kernel route's launches over the two steps."""
    batches = _batched_arrays(data.train, 32)
    lr = torch.tensor(cfg.learning_rate, device=dev)
    plain = cfg.replace(use_pallas=False, use_pallas_hamming=False)
    launched = dict.fromkeys(KINDS, 0)
    for i in (0, batches["memory"].shape[0] - 1):
        batch = {k: torch.as_tensor(v[i]).to(dev) for k, v in batches.items()}
        after = []
        for route in (cfg, plain):
            params = {k: v.clone() for k, v in base.items()}
            before = _counts()
            cost, _ = train_step(params, batch, lr, route, remove_softmax)
            ran = _since(before)
            if route is plain:
                assert ran == _want()
            else:
                launched = {k: launched[k] + ran[k] for k in KINDS}
            assert bool(torch.isfinite(cost))
            assert all(bool(torch.isfinite(v).all()) for v in params.values())
            after.append(params)
        for k in base:
            torch.testing.assert_close(after[0][k], after[1][k], rtol=1e-5,
                                       atol=1e-6)
    return launched


# ---------------------------------------------------------------------------
# training: train_task, the feature heads
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("route", ROUTES)
def test_train_task_on_the_kernels(cuda, task, route):
    """train_task for 2 epochs on a kernel route launches the lattice, the
    read or the Hamming kernel once per hop of every forward (training
    steps and evaluation chunks) and the backward kernels once per hop of
    every step, with every cost finite, as on the plain route (which
    launches nothing); one SGD step on it equals the plain route's on a
    full and the partial batch; in mode 3, A (reached only through the
    Hamming surrogate) gets a gradient."""
    kw, fwd, bwd = ROUTES[route]
    cfg = QmannConfig(num_itr=2, verbose=False, **kw)
    steps = cfg.num_itr * math.ceil(len(task.train) / cfg.size_batch)
    chunks = (cfg.num_itr * math.ceil(len(task.valid) / EVAL_CHUNK)
              + math.ceil(len(task.test) / EVAL_CHUNK))
    for c in (cfg, cfg.replace(use_pallas=False, use_pallas_hamming=False)):
        before = _counts()
        res = train_task(c, task, device=cuda)
        ran = _since(before)
        assert ran == (_want((steps + chunks, fwd), (steps, bwd)) if c is cfg
                       else _want())
        assert len(res.history) == 2 and math.isfinite(res.cost_test)
        assert all(math.isfinite(h.cost_train) and math.isfinite(h.cost_valid)
                   for h in res.history)
    base = _base(cfg, task.dims, cuda)
    assert _steps_agree(cfg, base, task, cuda) == _want((2, fwd), (2, bwd))
    if cfg.attention_mode == 3:
        b = {k: torch.as_tensor(v[0]).to(cuda)
             for k, v in _batched_arrays(task.train, 32).items()}
        leaves = {k: v.clone().requires_grad_() for k, v in base.items()}
        loss, _ = memn2n.loss_and_metrics(
            leaves, b["memory"], b["question"], b["answer"], b["mask"],
            b["sample_mask"], cfg)
        assert float(torch.autograd.grad(loss, [leaves["A"]])[0].abs()
                     .max()) > 0


# the feature heads, on the unfused hop (JAX's envelope keeps them out of
# the fused read and the chain)
HEADS = {"sc_att": dict(en_sc_att=True),
         "shift_sm": dict(en_shift_based_sm=True),
         "exp_plan": dict(en_exp_table_based=True),
         "cosine": dict(en_cosine_sim=True),
         "maxout": dict(test_maxout=True),
         "att_shift": dict(en_att_shift=True),
         "att_clip": dict(en_att_clip=True),
         "linear start": dict(en_linear_start=True),
         "mode3 sc_att": dict(iwl=1, attention_mode=3, en_sc_att=True)}


@pytest.mark.cuda
@pytest.mark.parametrize("head", HEADS)
def test_feature_step_on_the_kernels(cuda, task, head):
    """Each feature head at mode 2 iwl 5 on use_pallas, and EN_SC_ATT in
    mode 3 at iwl 1: one SGD step on a full and the partial batch equals
    the plain route's, launching per step the lattice 10 times and nothing
    else (in mode 3 also the Hamming kernel, its surrogate backward and
    the weighted sum's dp entry 3 times each); linear start's step, without
    the softmax, likewise.  train_task with linear start (2 epochs without
    the softmax, then 1) launches the read and the weighted sum's ds entry
    only in the last epoch's steps and in every evaluation chunk; mode 3
    with EN_SC_ATT for 1 epoch launches no read; every cost finite."""
    cfg = QmannConfig(use_pallas=True, verbose=False, **HEADS[head])
    launched = _steps_agree(cfg, _base(cfg, task.dims, cuda), task, cuda,
                            remove_softmax=head == "linear start")
    per_step = (dict(qmatvec=10, hamming=3, hamming_bwd=3, wsum_dp=3)
                if cfg.attention_mode == 3 else dict(qmatvec=10))
    assert launched == _want((2, per_step))
    if head not in ("linear start", "mode3 sc_att"):
        return
    run = cfg.replace(num_itr=1, num_itr_linear_start=2)
    quiet = 2 if run.en_linear_start else 0   # epochs without the softmax
    steps = math.ceil(len(task.train) / run.size_batch)
    chunks = ((quiet + 1) * math.ceil(len(task.valid) / EVAL_CHUNK)
              + math.ceil(len(task.test) / EVAL_CHUNK))
    before = _counts()
    res = train_task(run, task, device=cuda)
    ran = _since(before)
    assert len(res.history) == quiet + 1 and math.isfinite(res.cost_test)
    assert all(math.isfinite(h.cost_train) and math.isfinite(h.cost_valid)
               for h in res.history)
    if run.attention_mode == 3:
        assert ran == _want((steps + chunks, dict(qmatvec=10, hamming=3)),
                            (steps, dict(hamming_bwd=3, wsum_dp=3)))
    else:
        assert ran == _want(((quiet + 1) * steps + chunks, dict(qmatvec=10)),
                            (steps + chunks, dict(read=3)),
                            (steps, dict(wsum_ds=3)))


# ---------------------------------------------------------------------------
# serving: the engine, the dependent batches, the packet server
# ---------------------------------------------------------------------------

# config, whether the prepared forward is exact (None: prepare=False), the
# launches per wave
ENGINES = {
    "mode2 chain": (dict(use_fused_chain=True), True, dict(chain=1)),
    "mode3 iwl5 chain": (dict(attention_mode=3, use_fused_chain=True), True,
                         dict(chain=1)),
    "mode3 iwl1 use_pallas": (dict(iwl=1, attention_mode=3, use_pallas=True,
                                   use_fused_chain=True), False,
                              dict(qmatvec=10, read=3)),
    "sc_att": (dict(en_sc_att=True, use_pallas=True, use_fused_chain=True),
               True, dict(qmatvec=3)),
    "unprepared": (dict(use_pallas=True), None, dict(qmatvec=10, read=3))}


@pytest.mark.cuda
@pytest.mark.parametrize("case", ENGINES)
def test_engine_on_the_kernels(cuda, case):
    """An InferenceEngine on the card answers 100 requests over several
    waves of 32 as the plain route's engine does, with no failed wave: on
    the chain in modes 2 and 3 at iwl 5 (one launch a wave); at mode 3
    iwl 1, where prepare_inference is not exact, on the lattice and the
    read; with EN_SC_ATT, whose envelope excludes the chain, on the exact
    GEMM and the lattice for its lin maps alone; unprepared (prepare=False)
    on the lattice and the read.  Each wave's graphed program answers as
    the same program run eagerly, with finite logits."""
    kw, fast, per_wave = ENGINES[case]
    cfg = QmannConfig(**kw)
    dictionary = _dictionary()
    dims = synthetic_batch(np.random.default_rng(1), 8, V, M, W)[0]
    params = (_base(cfg, dims, cuda) if fast is False
              else _scaled(cfg, dims, cuda))
    stories = _stories(np.random.default_rng(2), 100, dictionary.words[1:])
    engine = InferenceEngine(params, cfg, dims, dictionary, batch_size=32,
                             prepare=fast is not None, device=cuda)
    before = _counts()
    engine.start()
    try:
        answers = [f.result(timeout=300)
                   for f in [engine.submit(s, q) for s, q in stories]]
    finally:
        engine.stop()
    ran = _since(before)
    st = engine.stats
    assert st.failed_waves == 0 and st.requests == len(stories)
    if fast is None:
        assert engine.prepared is None
    else:
        assert engine.prepared.fast == fast
    assert ran == _want((st.waves, per_wave))
    plain = InferenceEngine(params, cfg.replace(use_pallas=False,
                                                use_fused_chain=False),
                            dims, dictionary, batch_size=32,
                            device=cuda).start()
    try:
        want = [f.result(timeout=300)
                for f in [plain.submit(s, q) for s, q in stories]]
    finally:
        plain.stop()
    assert answers == want
    eager = []
    for i in range(0, len(stories), 32):
        reqs = [Request(s, q) for s, q in stories[i:i + 32]]
        wave = [torch.from_numpy(a).to(cuda) for a in engine._vectorize(reqs)]
        eager.extend(engine._predict(*wave).cpu().tolist()[:len(reqs)])
        if engine.prepared is not None:
            with torch.inference_mode():
                out = memn2n.forward_prepared(engine.prepared, *wave,
                                              engine._graph_cfg)
            assert bool(torch.isfinite(out.logits).all())
    assert answers == eager


@pytest.mark.cuda
@pytest.mark.parametrize("attention_mode", [2, 3])
def test_dependent_batches_graphed_on_the_chain(cuda, attention_mode):
    """bench.py's program (30 dependent batches of 1000 queries) on the
    chain as replays of its captured graph: predictions equal to the eager
    loop's, bit for bit, and 30 chain launches a program, 90 in three."""
    from qmann_tpu_torch.bench.common import dependent_batches
    cfg = QmannConfig(attention_mode=attention_mode, use_fused_chain=True)
    dims, mem, que, mask = synthetic_batch(np.random.default_rng(0), 1000,
                                           V, M, W)
    bound = float(dims.max_word + 1)
    prep = memn2n.prepare_inference(_scaled(cfg, dims, cuda), cfg,
                                    max_count=bound, max_rowsum=bound)
    args = [torch.from_numpy(a).to(cuda) for a in (mem, que, mask)]

    def forward(m, q, k):
        return memn2n.forward_prepared(prep, m, q, k, cfg)

    want = dependent_batches(forward, *args, 30)
    g = graphs.Graphs(cuda)
    before = _counts()
    got = [dependent_batches(forward, *args, 30, g) for _ in range(3)]
    assert _since(before) == _want((90, dict(chain=1)))
    assert all(torch.equal(x, want) for x in got)


def _cli_model(corpus, dev, out):
    """One epoch of task 1 through the command line, on the plain route:
    its checkpoint's (params, cfg, dims, dictionary, directory)."""
    rc = cli.main(["1", "1", "1", "5", "--epochs", "1", "--checkpoint-dir",
                   str(out), "--out-dir", str(out), *_files(corpus, dev)])
    assert rc == 0
    ckpt = out / "qa1_single-supporting-fact_loop0"
    params, cfg, dims = load_checkpoint(str(ckpt))
    dictionary = Dictionary()
    for w in json.loads((ckpt / "dictionary.json").read_text())[1:]:
        dictionary.add(w)
    return params, cfg, DataDims(**dims), dictionary, ckpt


@pytest.mark.cuda
def test_packet_server_and_client_processes(cuda, corpus, tmp_path):
    """python -m qmann_tpu_torch.serve.server on a checkpoint saved with
    use_fused_chain, queried by python -m qmann_tpu_torch.serve.client
    --task 1: the client streams every sample and prints the plain route's
    err_test on the same samples; the server process is ended and gone.
    (The engine behind the server, over TCP in process, is
    tests/test_torch_cuda.py's packet-server test.)"""
    from qmann_tpu_torch.data.native import load_task_native
    from qmann_tpu_torch.models.memn2n import params_from_jax
    from qmann_tpu_torch.serve.client import samples_from_split
    params, cfg, dims, dictionary, _ = _cli_model(corpus, cuda,
                                                  tmp_path / "run")
    cfg = cfg.replace(use_fused_chain=True)
    n_test = 30
    ckpt = save_checkpoint(str(tmp_path / "ckpt"), params, cfg, dims,
                           tag="served", dictionary=dictionary)
    test_n = load_task_native("qa1_single-supporting-fact", corpus[0],
                              raw_path=corpus[1], limit_test=n_test).test
    engine = InferenceEngine(
        params_from_jax(params, cfg, device=cuda),
        cfg.replace(use_fused_chain=False), dims, dictionary, batch_size=64,
        device=cuda).start()
    try:
        plain_n = [f.result(timeout=300) for f in [
            engine.submit_indexed(x)
            for x in samples_from_split(test_n, dims)]]
    finally:
        engine.stop()
    err_plain = 1.0 - sum(int(a == int(test_n.answer_index[i]))
                          for i, a in enumerate(plain_n)) / len(plain_n)
    srv = subprocess.Popen(
        [sys.executable, "-m", "qmann_tpu_torch.serve.server",
         "--checkpoint", ckpt, "--port", "0", "--device", str(cuda)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        line = srv.stdout.readline()
        addr = re.match(r"serving on (\S+):(\d+)", line)
        assert addr, line
        proc = subprocess.run(
            [sys.executable, "-m", "qmann_tpu_torch.serve.client", "--host",
             addr.group(1), "--port", addr.group(2), "--task", "1",
             "--limit", str(n_test), "--data-path", corpus[0],
             "--raw-data-path", corpus[1]], cwd=REPO, capture_output=True,
            text=True, timeout=300)
    finally:
        srv.kill()
        srv.wait(timeout=60)
    assert srv.poll() is not None
    assert proc.returncode == 0, proc.stderr[-2000:]
    streamed = re.search(r"streamed (\d+) samples; err_test = (\S+)",
                         proc.stdout)
    assert streamed and int(streamed.group(1)) == n_test
    assert streamed.group(2) == f"{err_plain:f}"


# ---------------------------------------------------------------------------
# the command line and the tools
# ---------------------------------------------------------------------------

CLI_FILE, CLI_TEST = 200, 50   # stories a task: train file (10% valid), test


def _files(corpus, dev):
    return ["--data-path", corpus[0], "--raw-data-path", corpus[1],
            "--device", str(dev)]


def _cli_forwards(epochs, n_file, n_test, extra_chunks=0):
    """Training steps plus evaluation chunks of a command-line task run:
    the train file's last 10% is the validation split; batches of 32."""
    n_va = int(n_file * 0.1)
    return (epochs * (math.ceil((n_file - n_va) / 32)
                      + math.ceil(n_va / EVAL_CHUNK))
            + math.ceil(n_test / EVAL_CHUNK) + extra_chunks)


def _cli_steps(epochs, n_file):
    return epochs * math.ceil((n_file - int(n_file * 0.1)) / 32)


def _epoch_lines(out):
    """(epoch lines the command line printed, whether each one's training
    and validation losses are finite)."""
    costs = [float(v) for m in re.finditer(r"loss: ([^,]+), ([^,]+), ", out)
             for v in m.groups()]
    return len(costs) // 2, all(map(math.isfinite, costs))


def _csv_tasks(path):
    """The task column of a result CSV's rows (after its header line)."""
    lines = Path(path).read_text().splitlines()
    head = max(i for i, ln in enumerate(lines)
               if ln.startswith("ind_data_set"))
    return [ln.split(",")[0] for ln in lines[head + 1:]]


# argv, the launches expected (per forward, per step), epoch lines
CLIS = {
    "tasks": (["1", "1", "2", "5", "--epochs", "2", "--use-pallas",
               "--profile"],
              lambda: _want((2 * _cli_forwards(2, CLI_FILE, CLI_TEST),
                             dict(qmatvec=10, read=3)),
                            (2 * _cli_steps(2, CLI_FILE), dict(wsum_ds=3))),
              4),
    "joint": (["1", "1", "2", "5", "--joint", "--shuffle", "--dim-forced",
               "--max-dict-len", "192", "--max-sen-len", "64",
               "--use-pallas", "--epochs", "1"],
              lambda: _want((_cli_forwards(1, 2 * CLI_FILE, CLI_TEST, 2),
                             dict(qmatvec=10, read=3)),
                            (_cli_steps(1, 2 * CLI_FILE), dict(wsum_ds=3))),
              1),
    "mode3 hamming": (["1", "1", "1", "1", "--attention-mode", "3",
                       "--use-pallas-hamming", "--epochs", "1"],
                      lambda: _want((_cli_forwards(1, CLI_FILE, CLI_TEST),
                                     dict(hamming=3)),
                                    (_cli_steps(1, CLI_FILE),
                                     dict(hamming_bwd=3, wsum_dp=3))),
                      1)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", CLIS)
def test_cli_on_the_kernels(cuda, corpus, tmp_path, capsys, case):
    """python -m qmann_tpu_torch's main() on the card: tasks 1-2 on
    use_pallas for 2 epochs, the joint block (--dim-forced at 192 words
    and 64 sentences: dim_input 256, the lattice tiled over I) and mode 3
    at iwl 1 on use_pallas_hamming, each launching its kernels once per
    hop of every forward and step, every cost finite, one result row a
    task; the checkpoint of task 1, reloaded and served through the chain,
    predicts as the plain route but in a query whose Q(p, act) flipped
    (at most one)."""
    argv, want, n_epochs = CLIS[case]
    out = tmp_path / "run"
    before = _counts()
    rc = cli.main([*argv, "--checkpoint-dir", str(out), "--out-dir",
                   str(out), *_files(corpus, cuda)])
    ran = _since(before)
    printed = capsys.readouterr().out
    assert rc == 0
    assert ran == want()
    assert _epoch_lines(printed) == (n_epochs, True)
    if case == "joint":
        _, _, dims = load_checkpoint(str(out / "qa_joint_loop0"))
        assert dims["dim_input"] == 256
        from qmann_tpu_torch.ops.cuda import qmatvec as qmv
        geo = qmv.qmatvec_geometry(32 * 64, 60, 256)
        assert (geo.o_tile, geo.i_tile) != (60, 256)
        return
    tasks = ["1", "2"] if case == "tasks" else ["1"]
    for name in ("result.csv", "result_all.csv"):
        assert _csv_tasks(out / name) == tasks
    if case != "tasks":
        return
    ckpt = out / "qa1_single-supporting-fact_loop0"
    params, cfg, dims = load_checkpoint(str(ckpt))
    dictionary = Dictionary()
    for w in json.loads((ckpt / "dictionary.json").read_text())[1:]:
        dictionary.add(w)
    dims = DataDims(**dims)
    test = load_test_split("qa1_single-supporting-fact", corpus[0],
                           dictionary, dims, raw_path=corpus[1])
    prep = memn2n.prepare_inference(
        memn2n.params_from_jax(params, cfg, device=cuda), cfg,
        max_count=float(dims.max_word + 1),
        max_rowsum=float(dims.max_word + 1))
    assert prep.fast
    batch = [torch.from_numpy(a).to(cuda)
             for a in (test.memory, test.question, test.mask)]
    before = _counts()
    with torch.inference_mode():
        served = memn2n.forward_prepared(
            prep, *batch, cfg.replace(use_fused_chain=True))
        assert _since(before) == _want((1, dict(chain=1)))
        plain = memn2n.forward_prepared(
            prep, *batch, cfg.replace(use_fused_chain=False,
                                      use_pallas=False))
    flipped = torch.zeros(len(test), dtype=torch.bool, device=cuda)
    for h, fmt in enumerate(cfg.fmt_act):
        flipped |= (float_quant(served.attention[h], fmt)
                    != float_quant(plain.attention[h], fmt)).any(-1)
    assert int(flipped.sum()) <= 1
    pred_s, pred_p = (argmax_last(o.logits) for o in (served, plain))
    assert torch.equal(pred_s[~flipped], pred_p[~flipped])


@pytest.mark.cuda
def test_cli_on_a_mesh_under_torchrun(cuda, corpus, tmp_path):
    """python -m torch.distributed.run --nproc-per-node 2 -m
    qmann_tpu_torch 1 1 1 5 --mesh 2,1 --use-pallas on the card: it
    finishes, and rank 0 alone prints the loop line and writes
    result.csv."""
    out = tmp_path / "cli"
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "qmann_tpu_torch", "1", "1", "1",
         "5", "--mesh", "2,1", "--use-pallas", "--epochs", "2",
         "--data-path", corpus[0], "--raw-data-path", corpus[1],
         "--out-dir", str(out), "--device", cuda.type],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    loops = [ln for ln in proc.stdout.splitlines() if "loop 0: err_test" in ln]
    assert len(loops) == 1
    assert _csv_tasks(out / "result.csv") == ["1"]


def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def _finite(rows):
    return all(math.isfinite(v) for r in rows for v in r.values()
               if isinstance(v, float))


def _tool(name, corpus, dev, tmp_path, capsys):
    """Run one tool's main() on the card: (its exit code, its JSON
    lines)."""
    from qmann_tpu_torch.bench import (backend_ab, diagnose, engine_bench,
                                       megasweep, probe_dispatch, qps,
                                       scatt_study, trace_forward)
    files = _files(corpus, dev)
    synthetic = ["--synthetic", "19,10,6,60", "--weight-scale", "4",
                 "--device", str(dev)]
    fn, argv = {
        "engine_bench": (engine_bench.main, [
            "--batch", "64", "--passes", "3", "--requests", "200",
            "--use-fused-chain", "--use-pallas", *files]),
        "backend_ab mode2": (backend_ab.main, [
            "--variants", "unfused,chain,read", *synthetic]),
        "backend_ab mode3": (backend_ab.main, [
            "--attention-mode", "3", "--variants",
            "unfused,hamming,read,chain", *synthetic]),
        "probe_dispatch": (probe_dispatch.main, [
            "--synthetic", "--use-fused-chain", "--device", str(dev)]),
        "trace_forward": (trace_forward.main, [
            "--synthetic", "--use-fused-chain", "--iters", "1", "--top",
            "10", "--out", str(tmp_path / "trace"), "--device", str(dev)]),
        "qps": (qps.main, [
            "--synthetic", "--use-pallas", "--use-fused-chain", "--iters",
            "5", "--train-iters", "1", "--requests", "512", "--max-samples",
            "2000", "--device", str(dev)]),
        "diagnose": (diagnose.main, ["--epochs", "2", *files]),
        "scatt_study": (scatt_study.main, [
            "--epochs", "1", "--seeds", "1", "--out-dir",
            str(tmp_path / "scatt"), *files]),
        "megasweep": (megasweep.main, [
            "--tasks", "1-2", "--seeds", "0-1", "--epochs", "1",
            "--out-dir", str(tmp_path / "mega"), *files])}[name]
    rc = fn(argv)
    return rc, _json_lines(capsys.readouterr().out)


TOOLS = ("engine_bench", "backend_ab mode2", "backend_ab mode3",
         "probe_dispatch", "trace_forward", "qps", "diagnose", "scatt_study",
         "megasweep", "scaling", "verify_kernels")


@pytest.mark.cuda
@pytest.mark.parametrize("name", TOOLS)
def test_tool_on_the_card(cuda, corpus, tmp_path, capsys, name):
    """Each bench tool's one run on the card and its gate: engine_bench's
    prepared engine on the chain answers as the unprepared one on the
    lattice and the read, no failed wave; backend_ab's routes give
    identical predictions with no host sync in the loop; probe_dispatch a
    line; trace_forward puts the chain kernel's records, each with a
    Python path, in the attention-score bucket; qps four positive
    numbers; diagnose and scatt_study their records, every number finite;
    megasweep's default route (the integer fast path, no use_pallas) its
    summary of 2 tasks x 2 seeds and finite costs without a kernel launch;
    scaling one line at --devices 1 and exit 2 at --devices 2 on one card;
    verify_kernels every kernel against its plain version."""
    if name == "verify_kernels":
        from qmann_tpu_torch.utils.verification import verify_kernels
        checks = verify_kernels(device=cuda)
        assert checks and all(r.ok for r in checks), checks
        return
    if name == "scaling":
        cmd = [sys.executable, "-m", "qmann_tpu_torch.bench.scaling",
               "--iters", "5", "--device", cuda.type, "--devices"]
        env = {**os.environ, "PYTHONPATH": str(REPO)}
        one = subprocess.run([*cmd, "1"], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=300)
        two = subprocess.run([*cmd, "2"], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=300)
        lines = _json_lines(one.stdout)
        assert one.returncode == 0 and len(lines) == 1, one.stderr[-2000:]
        assert lines[0]["train_samples_per_sec"] > 0
        assert two.returncode == (2 if torch.cuda.device_count() < 2 else 0)
        return
    before = _counts()
    rc, rows = _tool(name, corpus, cuda, tmp_path, capsys)
    ran = _since(before)
    assert rc == 0 and rows
    if name == "engine_bench":
        assert rows[2]["answers_identical"]
        assert all(r["failed_waves"] == 0 for r in rows[:2])
    elif name.startswith("backend_ab"):
        assert all(r["outputs_identical"] and r["host_syncs_in_loop"] == 0
                   for r in rows[:-1])
    elif name == "trace_forward":
        chain = rows[-1]["hand_kernels"]["hop_chain"]
        assert chain["records"] >= 1 and not chain["records_without_path"]
        assert chain["buckets"] == ["attention score"]
    elif name == "qps":
        assert all(rows[-1][k] > 0 for k in (
            "inference_qps", "serving_engine_qps", "train_samples_per_sec",
            "epoch_seconds"))
    elif name == "diagnose":
        assert len(rows) == 2 and _finite(rows)
    elif name == "scatt_study":
        from qmann_tpu_torch.bench.scatt_study import MITIGATIONS
        assert len(rows) == len(MITIGATIONS) and _finite(rows)
    elif name == "megasweep":
        mega = tmp_path / "mega"
        summary = json.loads((mega / "summary.json").read_text())
        meta = json.loads((mega / "meta.json").read_text())
        history = np.load(mega / "history.npz")
        assert len(summary) == 2 and all(len(r["errs"]) == 2
                                         for r in summary)
        assert meta["stages"][0]["runs"] == 4
        assert all(np.isfinite(history[f"iwl5_{k}"]).all()
                   for k in ("cost_train", "cost_valid"))
        assert ran == _want()


# ---------------------------------------------------------------------------
# the family trainer (train/multi.py)
# ---------------------------------------------------------------------------

FAMILY_SIZES = (100, 70, 45)   # train stories of 3 tasks: 4 batches of 32
FAMILY_SPLIT = 20              # validation and test stories a task


def _family_tasks():
    """{task index: TaskData} at megasweep's padded layout (V=64, M=50):
    each task a random subset of one pool's stories, of its own train
    size."""
    rng = np.random.default_rng(16)
    pool = synthetic_task(rng, 400, 3 * FAMILY_SPLIT, 3 * FAMILY_SPLIT, 64,
                          50, 6)

    def subset(split, n):
        idx = np.sort(rng.permutation(len(split))[:n])
        return VectorizedSplit(*(getattr(split, f.name)[idx]
                                 for f in dataclasses.fields(split)))

    return {t + 1: TaskData(subset(pool.train, n),
                            subset(pool.valid, FAMILY_SPLIT),
                            subset(pool.test, FAMILY_SPLIT), pool.dims,
                            pool.dictionary)
            for t, n in enumerate(FAMILY_SIZES)}


def _family_batch(tasks, run_task, i, dev):
    """Batch i of the family's grid (no shuffle), each run's samples
    32i... of its task, padding past its count (sample 0, masked out), as
    train_tasks_multi lays them out: the [R, 32, ...] device batch and the
    runs whose batch is all padding."""
    split = [tasks[t].train for t in run_task]
    rows = np.arange(i * 32, (i + 1) * 32)
    n = np.array([len(s) for s in split])
    idx = np.where(rows[None] < n[:, None], rows[None], 0)
    out = {k: np.stack([getattr(s, k)[j] for s, j in zip(split, idx)])
           for k in ("memory", "question", "answer", "mask")}
    out["sample_mask"] = (rows[None] < n[:, None]).astype(np.float32)
    out["size_b"] = out["sample_mask"].sum(-1)
    return ({k: torch.from_numpy(v).to(dev) for k, v in out.items()},
            set(np.flatnonzero(out["size_b"] == 0).tolist()))


@pytest.mark.cuda
@pytest.mark.parametrize("route", ROUTES)
def test_family_on_the_kernels(cuda, monkeypatch, route):
    """The family trainer on a kernel route, 3 tasks x 2 seeds (R = 6):
    one family step launches the kernels as one run's step does, and each
    run's slice equals train_step on its own batch, on the first batch
    and on the last, where the shorter tasks' batches are all padding and
    leave their runs' weights untouched, bit for bit.  train_tasks_multi
    for 2 epochs launches the kernels once per family step and evaluation
    chunk, its lattice launches all skip the zero entries of Q(x), its
    graphed epochs equal the eager ones bit for bit, and a run's history
    equals its own train_task's."""
    kw, fwd, bwd = ROUTES[route]
    cfg = QmannConfig(num_itr=2, verbose=False, **kw)
    tasks = _family_tasks()
    seeds = [0, 1]
    run_task = [t for t in tasks for _ in seeds]
    dims = tasks[1].dims
    runs = [_base(cfg, dims, cuda, seed=s) for _ in tasks for s in seeds]
    stacked = {k: torch.stack([p[k] for p in runs]) for k in runs[0]}
    lr = torch.tensor(cfg.learning_rate, device=cuda)
    nb = math.ceil(max(FAMILY_SIZES) / 32)
    for i in (0, nb - 1):
        batch, padding = _family_batch(tasks, run_task, i, cuda)
        assert bool(padding) == (i == nb - 1)
        params = {k: v.clone() for k, v in stacked.items()}
        before = _counts()
        multi.family_step(params, batch, lr, cfg)
        assert _since(before) == _want((1, fwd), (1, bwd))
        for r, one in enumerate(runs):
            if r in padding:
                assert all(torch.equal(params[k][r], v)
                           for k, v in one.items())
                continue
            one = {k: v.clone() for k, v in one.items()}
            train_step(one, {k: v[r] for k, v in batch.items()}, lr, cfg)
            for k, v in one.items():
                torch.testing.assert_close(params[k][r], v, rtol=1e-5,
                                           atol=1e-6)

    steps = cfg.num_itr * nb
    chunks = (cfg.num_itr + 1) * math.ceil(FAMILY_SPLIT / 128)
    res = {}
    for side in ("graphed", "eager"):
        if side == "eager":
            monkeypatch.setattr(multi, "_runner",
                                lambda graphs, cfg: multi._eager)
        sparse = graphs.launch_counts()[7]
        before = _counts()
        res[side] = multi.train_tasks_multi(
            cfg, tasks, seeds, params={k: v.clone()
                                       for k, v in stacked.items()},
            device=cuda)
        ran = _since(before)
        assert ran == _want((steps + chunks, fwd), (steps, bwd))
        assert graphs.launch_counts()[7] - sparse == ran["qmatvec"]
    for k in stacked:
        assert torch.equal(res["graphed"].params[k], res["eager"].params[k])
    for a, b in zip(res["graphed"].history, res["eager"].history):
        for k in ("cost_train", "err_train", "cost_valid", "err_valid"):
            np.testing.assert_array_equal(a[k], b[k])
    fam = res["graphed"]
    for r in (0, len(runs) - 1):
        ref = train_task(cfg.replace(seed=seeds[r % 2]), tasks[run_task[r]],
                         params={k: v.clone() for k, v in runs[r].items()},
                         device=cuda)
        got = np.array([[h[k][r] for k in ("err_train", "err_valid",
                                           "cost_train", "cost_valid")]
                        for h in fam.history])
        want = np.array([[h.err_train, h.err_valid, h.cost_train,
                          h.cost_valid] for h in ref.history])
        np.testing.assert_allclose(got[:, :2], want[:, :2], rtol=0,
                                   atol=1e-6)
        assert abs(fam.err_test[r] - ref.err_test) <= 1e-6
        np.testing.assert_allclose(got[:, 2:], want[:, 2:], rtol=2e-4)


# ---------------------------------------------------------------------------
# the device mesh (parallel/): ranks spawned on the card
# ---------------------------------------------------------------------------

MESH_STEPS = {"mode2": dict(use_pallas=True),
              "mode3": dict(attention_mode=3, iwl=1, use_pallas=True),
              "mode3 hamming": dict(attention_mode=3, iwl=1,
                                    use_pallas_hamming=True)}
MESH_LR = 0.3
# the wrappers whose inputs the ranks keep: (module, the name through
# which the mesh's path calls the wrapper, kernel).  The lattice, the two
# Hamming wrappers and the weighted sum's dp entry are looked up on their
# own modules at each call; the read and the ds entry through ops/fused.py
MESH_RECORDED = (("qmann_tpu_torch.ops.cuda.qmatvec", "quantized_matvec",
                  "qmatvec"),
                 ("qmann_tpu_torch.ops.cuda.hamming", "hamming_score_kernel",
                  "hamming"),
                 ("qmann_tpu_torch.ops.cuda.hamming_bwd",
                  "hamming_backward_kernel", "hamming_bwd"),
                 ("qmann_tpu_torch.ops.cuda.qweighted_sum_bwd",
                  "qweighted_sum_backward_kernel", "wsum_dp"),
                 ("qmann_tpu_torch.ops.fused", "fused_read", "read"),
                 ("qmann_tpu_torch.ops.fused",
                  "weighted_sum_softmax_backward_kernel", "wsum_ds"))


def _record_calls(module, name, key, calls):
    """Put a spy in ``name``'s place in ``module`` that keeps, in
    ``calls``, the inputs (as numpy) of the first call at each signature
    (the tensors' shapes and the other arguments) and calls the wrapper.
    A wrapper counts its launches on the name in its own module, so those
    of the spied wrappers count on the spy while it is there.  Returns
    (spy, a function that puts the wrapper back)."""
    wrapper = getattr(module, name)

    def spy(*args):
        sig = (key,) + tuple(tuple(a.shape) if isinstance(a, torch.Tensor)
                             else repr(a) for a in args)
        if sig not in calls:
            calls[sig] = (key, tuple(a.detach().cpu().numpy()
                                     if isinstance(a, torch.Tensor) else a
                                     for a in args))
        return wrapper(*args)

    for count in ("launches", "sparse_launches"):   # those the wrapper keeps
        if hasattr(wrapper, count):
            setattr(spy, count, 0)
    setattr(module, name, spy)
    return spy, lambda: setattr(module, name, wrapper)


def _mesh_rank(n, model, inputs, full):
    """One spawned rank of an (n // model, model) mesh on the card: the
    sharded and the explicit steps (full) or the sharded mode-2 step
    alone, and (full) the distributed read, the sharded prepared infer,
    eval_split(mesh=) and the engine over the mesh.  Everything after the
    mesh is up is the mesh's path: its launches are counted, and the
    kernels' inputs kept at each signature (_record_calls).  Returns numpy
    results."""
    import importlib
    from qmann_tpu_torch.parallel import (
        make_explicit_train_step, make_mesh, make_sharded_prepared_infer,
        make_sharded_train_step, memory_sharded_attention_read)
    from qmann_tpu_torch.parallel.sharding import put_infer_inputs
    from qmann_tpu_torch.train import eval_split

    mesh = make_mesh(n, model, device="cuda")
    dev = mesh.device
    before = _counts()
    calls = {}
    spies = [(key, *_record_calls(importlib.import_module(mod), name, key,
                                  calls))
             for mod, name, key in MESH_RECORDED]
    out = {"backend": mesh.backend, "index": (mesh.data_idx, mesh.model_idx)}

    def host(params):
        return {k: v.cpu().numpy().copy() for k, v in params.items()}

    batch = {k: torch.tensor(v, device=dev)
             for k, v in inputs["batch"].items()}
    size_b = float(inputs["batch"]["sample_mask"].sum())
    makers = [("sharded", make_sharded_train_step)]
    if full:
        makers.append(("explicit", make_explicit_train_step))
    out["steps"] = {}
    for name in list(MESH_STEPS)[:3 if full else 1]:
        cfg = QmannConfig(**MESH_STEPS[name])
        for kind, make in makers:
            params = {k: torch.tensor(v, device=dev)
                      for k, v in inputs["params"][name].items()}
            step = make(cfg, mesh)
            _, cost, matches = step(params, batch, MESH_LR, size_b)
            first = host(params)
            for _ in range(2):
                step(params, batch, MESH_LR, size_b)
            out["steps"][name, kind] = dict(params=first, cost=float(cost),
                                            matches=int(matches),
                                            after3=host(params))
    if full:
        specs = {"m": ("data", "model", None), "c": ("data", "model", None),
                 "u": ("data", None), "mask": ("data", "model")}
        out["read"] = {}
        for name, (kw, arrays) in inputs["read"].items():
            lb = put_infer_inputs(mesh, specs, **arrays)
            with torch.no_grad():
                o, p = memory_sharded_attention_read(
                    mesh, lb["m"], lb["c"], lb["u"], lb["mask"],
                    QmannConfig(**kw))
            out["read"][name] = (o.cpu().numpy(), p.cpu().numpy())
        sb = inputs["serve_batch"]
        out["prepared"] = {}
        for mode, raw in inputs["serve_params"].items():
            cfg = QmannConfig(attention_mode=mode, use_fused_chain=True)
            params = {k: torch.tensor(v, device=dev) for k, v in raw.items()}
            prep = memn2n.prepare_inference(params, cfg, **inputs["bounds"])
            cost, matches, pred = make_sharded_prepared_infer(
                prep, cfg, mesh)(sb["memory"], sb["question"], sb["answer"],
                                 sb["mask"])
            out["prepared"][mode] = (float(cost), int(matches),
                                     pred.cpu().numpy(), prep.fast)
        out["eval"] = eval_split(
            {k: torch.tensor(v, device=dev)
             for k, v in inputs["params"]["mode2"].items()},
            inputs["eval_split"], QmannConfig(use_pallas=True), mesh=mesh)
        dictionary = _dictionary()
        engine = InferenceEngine(
            {k: torch.tensor(v) for k, v in
             inputs["serve_params"][2].items()},
            QmannConfig(use_fused_chain=True), DataDims(**inputs["dims"]),
            dictionary, batch_size=32, mesh=mesh).start()
        answers = None
        try:
            if mesh.rank == 0:
                answers = [f.result(timeout=300) for f in
                           [engine.submit(s, q)
                            for s, q in inputs["stories"]]]
        finally:
            engine.stop()
        out["engine"] = (answers, engine.stats.failed_waves,
                         engine.cfg.use_fused_chain)
    for _, _, restore in spies:
        restore()
    torch.cuda.synchronize()
    out["launches"] = {k: v - before[k] for k, v in _counts().items()}
    for key, spy, _ in spies:
        out["launches"][key] += spy.launches
    out["calls"] = calls
    return out


def _check_recorded_calls(results, dev):
    """Each kernel on the inputs the ranks gave it, at every signature
    they launched it at, against its plain version on the card: the
    lattice and the Hamming kernel bit for bit, the read and the
    backwards under card checks of tests/test_torch_cuda.py's tolerances.
    Returns the kernels checked."""
    from qmann_tpu_torch.ops.attention import surrogate_terms
    from qmann_tpu_torch.ops.cuda import attention_read as ar
    from qmann_tpu_torch.ops.cuda import hamming as ham
    from qmann_tpu_torch.ops.cuda import hamming_bwd as hbwd
    from qmann_tpu_torch.ops.cuda import qmatvec as qmv
    from qmann_tpu_torch.ops.cuda import qweighted_sum_bwd as wsb
    from qmann_tpu_torch.ops.qlinear import qweighted_sum_backward
    pairs = {"qmatvec": (qmv.quantized_matvec,
                         qmv.quantized_matvec_reference),
             "hamming": (ham.hamming_score_kernel,
                         ham.hamming_score_reference),
             "hamming_bwd": (hbwd.hamming_backward_kernel,
                             hbwd.hamming_backward),
             "wsum_dp": (wsb.qweighted_sum_backward_kernel,
                         lambda *a: qweighted_sum_backward(
                             *a, grad_quantized=True)),
             "wsum_ds": (wsb.weighted_sum_softmax_backward_kernel,
                         wsb.weighted_sum_softmax_backward_plain),
             "read": (ar.fused_read, ar.fused_read_reference)}
    calls = {}
    for r in results:
        calls.update(r["calls"])
    checked = set()
    for key, args in calls.values():
        args = tuple(torch.from_numpy(a).to(dev) if isinstance(a, np.ndarray)
                     else a for a in args)
        kernel, plain = pairs[key]
        with torch.no_grad():
            got, want = kernel(*args), plain(*args)
        if key in ("qmatvec", "hamming"):
            assert torch.equal(got, want), key
        elif key == "read":
            fmt_act, quantized = args[6], args[8]
            if quantized:
                assert torch.equal(got[2], want[2])
                torch.testing.assert_close(got[1], want[1], rtol=0,
                                           atol=1e-6)
                flipped = (float_quant(got[1], fmt_act)
                           != float_quant(want[1], fmt_act)).any(-1)
                assert int(flipped.sum()) <= 1
                assert torch.equal(got[0][~flipped], want[0][~flipped])
            else:
                for g, w in zip(got, want):
                    torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
        elif key == "hamming_bwd":
            m, u, g = args[:3]
            assert torch.equal(got[0].view(torch.int32),
                               want[0].view(torch.int32))
            _, grad_appx = surrogate_terms(m, u, *args[3:])
            slack = (2 * m.shape[-2] * 2.0 ** -24
                     * (grad_appx * g[..., None]).abs().sum(-2))
            assert bool(((got[1] - want[1]).abs() <= slack).all())
        elif key == "wsum_dp":
            c, p, mask, g, fmt = args
            assert torch.equal(got[0].view(torch.int32),
                               want[0].view(torch.int32))
            lo, hi = wsb.dp_interval(c, mask, g, fmt)
            assert bool(((lo <= got[1]) & (got[1] <= hi)).all())
        else:
            c, p, mask, g, dp_in, ds_in, fmt, quantized = args
            assert torch.equal(got[0].view(torch.int32),
                               want[0].view(torch.int32))
            _, dp = qweighted_sum_backward(c, p, mask, g, fmt,
                                           grad_quantized=quantized)
            if dp_in is not None:
                dp = dp + dp_in
            bound = wsb.ds_bound(p, dp, wsb.dp_error(
                c, mask, g, fmt, quantized, dp_in), ds_in)
            assert bool(((got[1].double() - want[1].double()).abs()
                         <= bound).all())
        checked.add(key)
    return checked


@pytest.mark.cuda
def test_mesh_on_the_card(cuda):
    """The mesh at the flagship widths.  (2, 2): 4 ranks on the card over
    gloo (they share it, so NCCL cannot serve them): the sharded and the
    explicit step at batch 32 on use_pallas (mode 2 iwl 5, mode 3 iwl 1)
    and use_pallas_hamming (mode 3 iwl 1) against the single-device plain
    step, every rank's parameters bitwise equal after 3 steps; the
    distributed read (modes 2 and 3, B=32, M=50) against the read's plain
    version; the sharded prepared infer (modes 2 and 3, B=1000) against
    the single-device prepared forward; eval_split(mesh=) against the
    plain eval_split; the engine over the mesh answering as the plain
    route, no failed wave, the chain pinned off.  (1, 1): one rank over
    NCCL, its step as the single-device one.  The lattice, the Hamming
    kernels and the weighted sum's dp entry launch at (2, 2), the read and
    the ds entry at (1, 1), where the memory is whole, and the chain at
    neither; each launched kernel equals its plain version on the ranks'
    inputs."""
    from qmann_tpu_torch.ops.losses import cross_entropy
    from qmann_tpu_torch.parallel.launch import run_ranks
    from qmann_tpu_torch.train import eval_split
    dev = cuda
    rng = np.random.default_rng(18)

    def with_answers(B, mem, que, mask):
        ans = np.zeros((B, mem.shape[-1]), np.float32)
        ans[np.arange(B), rng.integers(1, V, B)] = 1.0
        return {"memory": mem, "question": que, "answer": ans, "mask": mask,
                "sample_mask": np.ones(B, np.float32)}

    dims, *arrays = synthetic_batch(rng, 32, V, M, W)
    batch = with_answers(32, *arrays)
    params = {name: {k: v.cpu().numpy() for k, v in _base(
        QmannConfig(**kw), dims, "cpu").items()}
        for name, kw in MESH_STEPS.items()}

    def single_step(name):
        cfg = QmannConfig(**MESH_STEPS[name]).replace(
            use_pallas=False, use_pallas_hamming=False)
        p = {k: torch.tensor(v, device=dev) for k, v in params[name].items()}
        b = {k: torch.tensor(v, device=dev) for k, v in batch.items()}
        b["size_b"] = b["sample_mask"].sum()
        cost, matches = train_step(p, b, torch.tensor(MESH_LR, device=dev),
                                   cfg)
        return ({k: v.cpu().numpy() for k, v in p.items()}, float(cost),
                int(matches))

    refs = {name: single_step(name) for name in MESH_STEPS}
    read_in, read_want = {}, {}
    for name, kw in (("mode2", {}), ("mode3", dict(attention_mode=3,
                                                   iwl=1))):
        from qmann_tpu_torch.ops.cuda import attention_read as ar
        from qmann_tpu_torch.ops.qlinear import (qembed_mat_forward,
                                                 qmatvec_forward)
        cfg = QmannConfig(use_pallas=True, **kw)
        d, mem, que, mask = synthetic_batch(rng, 32, 64, 50, 7)
        p = _base(cfg, d, dev)
        mem_t, que_t, mask_t = (torch.from_numpy(a).to(dev)
                                for a in (mem, que, mask))
        f0 = cfg.fmt_w[0]
        u = qmatvec_forward(p["B"], que_t, f0, f0)
        m, c = (qembed_mat_forward(mem_t, p[w], f0) for w in "AC")
        read_in[name] = (dict(use_pallas=True, **kw), {
            "m": m.cpu().numpy(), "c": c.cpu().numpy(),
            "u": u.cpu().numpy(), "mask": mask})
        with torch.no_grad():
            read_want[name] = ar.fused_read_reference(
                m, c, u, mask_t.to(torch.float32), cfg.fmt_att[0],
                cfg.fmt_bin, cfg.fmt_act[0],
                score_quantized=cfg.attention_mode == 2,
                sum_quantized=cfg.wsum_quantized,
                attention_mode=cfg.attention_mode,
                ham_num_bit=cfg.num_bits_attention,
                ham_const_scale=cfg.attention_const_scale)
    sdims, *sarrays = synthetic_batch(rng, 1000, V, M, W)
    serve_batch = with_answers(1000, *sarrays)
    bounds = dict(max_count=float(sdims.max_word + 1),
                  max_rowsum=float(sdims.max_word + 1))
    serve_params, prepared_want = {}, {}
    for mode in (2, 3):
        cfg = QmannConfig(attention_mode=mode)
        p = _scaled(cfg, sdims, dev)
        prep = memn2n.prepare_inference(p, cfg, **bounds)
        serve_params[mode] = {k: v.cpu().numpy() for k, v in p.items()}
        with torch.no_grad():
            out = memn2n.forward_prepared(prep, *(
                torch.from_numpy(serve_batch[k]).to(dev)
                for k in ("memory", "question", "mask")), cfg)
            met = cross_entropy(out.logits, torch.from_numpy(
                serve_batch["answer"]).to(dev))
        prepared_want[mode] = (float(met.cost), int(met.matches),
                               met.pred.cpu().numpy())
    split = synthetic_task(rng, 64, 16, 1000, V, M, W).test
    eval_want = eval_split({k: torch.tensor(v, device=dev) for k, v in
                            params["mode2"].items()}, split, QmannConfig(),
                           device=dev)
    dictionary = _dictionary()
    stories = _stories(rng, 200, dictionary.words[1:])
    plain_engine = InferenceEngine(
        {k: torch.tensor(v) for k, v in serve_params[2].items()},
        QmannConfig(), sdims, dictionary, batch_size=32, device=dev).start()
    try:
        engine_want = [f.result(timeout=300) for f in
                       [plain_engine.submit(s, q) for s, q in stories]]
    finally:
        plain_engine.stop()
    inputs = dict(batch=batch, params=params, read=read_in,
                  serve_batch=serve_batch, serve_params=serve_params,
                  bounds=bounds, eval_split=split, stories=stories,
                  dims=dataclasses.asdict(sdims))

    def check_steps(results, names, kinds):
        for name in names:
            ref_p, ref_cost, ref_matches = refs[name]
            for kind in kinds:
                got = results[0]["steps"][name, kind]
                for k in ref_p:
                    np.testing.assert_allclose(got["params"][k], ref_p[k],
                                               rtol=2e-5, atol=2e-6)
                assert got["matches"] == ref_matches
                assert math.isclose(got["cost"], ref_cost, rel_tol=1e-4)
                for r in results:
                    for k in ref_p:
                        np.testing.assert_array_equal(
                            r["steps"][name, kind]["after3"][k],
                            got["after3"][k])

    def summed(results):
        return {k: sum(r["launches"][k] for r in results) for k in KINDS}

    r22 = run_ranks(_mesh_rank, 4, (4, 2, inputs, True), device="cuda",
                    timeout=600)
    check_steps(r22, list(MESH_STEPS), ("sharded", "explicit"))
    for name, (want_o, want_p, _) in read_want.items():
        B, D = want_o.shape
        o = np.zeros((B, D), np.float32)
        p = np.zeros(want_p.shape, np.float32)
        for r in r22:
            d, j = r["index"]
            ro, rp = r["read"][name]
            o[d * ro.shape[0]:(d + 1) * ro.shape[0]] = ro
            p[d * rp.shape[0]:(d + 1) * rp.shape[0],
              j * rp.shape[1]:(j + 1) * rp.shape[1]] = rp
        step_act = 2.0 ** -QmannConfig(**read_in[name][0]).fmt_act[0].frac
        assert float(np.max(np.abs(p - want_p.cpu().numpy()))) <= 1e-6
        assert float(np.max(np.abs(o - want_o.cpu().numpy()))) <= step_act
    for mode, (cost, matches, pred) in prepared_want.items():
        for r in r22:
            got_cost, got_matches, got_pred, fast = r["prepared"][mode]
            assert fast and got_matches == matches
            np.testing.assert_array_equal(got_pred, pred)
            assert math.isclose(got_cost, cost, rel_tol=1e-6)
    for r in r22:
        np.testing.assert_array_equal(r["eval"][2], eval_want[2])
        assert r["eval"][1] == eval_want[1]
        assert math.isclose(r["eval"][0], eval_want[0], rel_tol=1e-6)
    answers, failed, chain = r22[0]["engine"]
    assert answers == engine_want and not failed and not chain
    n22 = summed(r22)

    r11 = run_ranks(_mesh_rank, 1, (1, 1, inputs, False), device="cuda",
                    timeout=300)
    assert r11[0]["backend"] == "nccl"
    check_steps(r11, ["mode2"], ("sharded",))
    n11 = summed(r11)
    assert min(n22["qmatvec"], n22["hamming"], n22["hamming_bwd"],
               n22["wsum_dp"], n11["qmatvec"], n11["read"],
               n11["wsum_ds"]) >= 1
    assert n22["chain"] == n11["chain"] == 0
    launched = {k for k in KINDS if n22[k] + n11[k]}
    assert _check_recorded_calls(r22 + r11, dev) == launched
