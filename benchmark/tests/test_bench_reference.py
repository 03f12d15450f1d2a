"""The plain reference against ``qmann_tpu_torch``'s plain route at a tiny
size on the CPU: the forward's logits, one SGD step of a single run and of
a family, in both configurations; the control (the reference in TF32)
failing the comparison; and the reference importing nothing of the
program."""
from __future__ import annotations

import subprocess
import sys

import pytest
import torch

from benchmark import common, stories
from benchmark.jobs import training
from benchmark.reference import Reference, to_tf32

CONFIGS = ["memn2n-qmann-m2-iwl5", "memn2n-qmann-m3-iwl1"]


def model_of(name):
    return common.load_json(common.BENCH_DIR / "configs" / f"{name}.json")[
        "model"]


def batch_of(n, seed, runs=0, V=19, M=10, W=6):
    st = stories.make_stories(max(runs, 1) * n, V, M, W, (1, M), (1, W), 3,
                              stories.generator(seed, 0, "cpu"), "cpu")
    lead = (max(runs, 1), n)
    b = {k: st[k].reshape(lead + tuple(st[k].shape[1:])) for k in
         ("memory", "question", "answer", "mask")}
    b["sample_mask"] = torch.ones(lead)
    b["sample_mask"][:, n - 3:] = 0.0          # a partial last batch
    b["size_b"] = b["sample_mask"].sum(-1)
    return b


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_matches_the_plain_route(name):
    from qmann_tpu_torch.models import memn2n
    md = model_of(name)
    cfg = common.program_config(md, {})
    b = batch_of(12, 3)
    w = common.make_weights(md, 29, 0.4, 3, "cpu")
    prog = memn2n.forward(w, b["memory"][0], b["question"][0], b["mask"][0],
                          cfg).logits
    ref = Reference(md).logits(w, b["memory"][0], b["question"][0],
                               b["mask"][0])
    assert torch.allclose(prog, ref, rtol=1e-6, atol=1e-5)
    assert torch.equal(prog.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("name", CONFIGS)
def test_one_step_matches_train_step(name):
    from qmann_tpu_torch.train import trainer
    md = model_of(name)
    cfg = common.program_config(md, {})
    b = batch_of(16, 4)
    w = common.make_weights(md, 29, 0.4, 4, "cpu")
    init = {k: v[None].clone() for k, v in w.items()}
    cost, _ = trainer.train_step(w, {k: v[0] for k, v in b.items()}, 0.3,
                                 cfg)
    ref = {k: v.clone() for k, v in init.items()}
    ref_cost = Reference(md).sgd_step(ref, b, 0.3)
    assert float(cost) == pytest.approx(float(ref_cost[0]), rel=1e-6)
    for k in w:
        assert torch.allclose(w[k], ref[k][0], rtol=1e-5, atol=1e-6), k


def test_one_family_step_matches_family_step():
    from qmann_tpu_torch.train import multi
    md = model_of(CONFIGS[0])
    cfg = common.program_config(md, {"use_pallas": False,
                                     "en_integer_fast_path": False})
    b = batch_of(8, 5, runs=3)
    b["sample_mask"][1] = 0.0                  # an all-padding batch
    b["size_b"] = b["sample_mask"].sum(-1)
    w = common.make_weights(md, 29, 0.4, 5, "cpu", runs=3)
    ref = {k: v.clone() for k, v in w.items()}
    cost, _ = multi.family_step(w, b, torch.tensor(0.3), cfg)
    ref_cost = Reference(md).sgd_step(ref, b, 0.3)
    assert torch.allclose(cost, ref_cost, rtol=1e-6)
    for k in w:
        assert torch.allclose(w[k], ref[k], rtol=1e-5, atol=1e-6), k
        assert torch.equal(w[k][1], ref[k][1])


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -1.0 - 2 ** -10,
                      3.0e-20, 65504.0])
    got = to_tf32(x)
    assert got[0] == 1.0 and got[1] == 1.0            # a tie to even
    assert got[2] == 1.0 + 2 ** -9                    # a tie up to even
    assert got[3] == -1.0 - 2 ** -10                  # already TF32
    assert torch.all((got.view(torch.int32) & 0x1FFF) == 0)


@pytest.mark.parametrize("name", CONFIGS)
def test_the_control_fails_the_training_check(name):
    """The reference in TF32, in the program's place, at the cell's widths
    on qa1's shape: its loss gap is far over the cell's limit, the
    program's plain route's within it."""
    from qmann_tpu_torch.train import trainer
    md = model_of(name)
    cfg = common.program_config(md, {})
    cell = {CONFIGS[0]: "family.m2.runsh", CONFIGS[1]: "step.m3.cli"}[name]
    limits = common.find_cell(common.load_spec(), cell)["cell"]["limits"]
    w = common.make_weights(md, 29, 0.4, 6, "cpu")
    init = {k: v[None].clone() for k, v in w.items()}
    batches = [batch_of(32, 60 + k) for k in range(3)]
    prog = training.Steps([], [])
    for b in batches:
        cost, _ = trainer.train_step(w, {k: v[0] for k, v in b.items()},
                                     0.3, cfg)
        prog.costs.append(cost.reshape(1))
        prog.after.append({k: v[None].clone() for k, v in w.items()})
    ref = training.reference_steps(md, init, batches, 0.3)
    ctl = training.reference_steps(md, init, batches, 0.3, control=True)
    size_b = batches[0]["size_b"]
    ok = training.numbers(prog, ref, init, size_b, 0.3, md)
    bad = training.numbers(ctl, ref, init, size_b, 0.3, md)
    assert all(ok[k] <= limits[k] for k in limits), ok
    assert any(bad[k] > limits[k] for k in limits), bad


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); import benchmark.reference,"
            " benchmark.work, benchmark.stories; print(sorted({m.split('.')[0]"
            " for m in sys.modules} & {'qmann_tpu_torch', 'qmann_tpu', 'jax',"
            " 'jaxlib', 'flax'}))" % str(common.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
