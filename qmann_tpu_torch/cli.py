"""Command-line driver (counterpart of ``qmann_tpu/cli.py``).

Mirrors the reference CLI (MemN2N/MemN2N.c:211-274):

    python -m qmann_tpu_torch <num_task_loop> <task_start> <task_end> <iwl>

with every flag of ``python -m qmann_tpu`` and its defaults, plus
``--device`` (default ``cuda``; without a card it raises unless given
``--device cpu``).  Writes ``result.csv`` and ``result_all.csv`` in the
reference's shape to ``--out-dir`` and, with ``--checkpoint-dir``, one
checkpoint per task loop (``utils/checkpoint.py``, readable by either
package).

``--mesh d,m`` trains on a (data, model) mesh of d*m processes, one per
rank, started by torchrun:

    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m qmann_tpu_torch 1 1 1 5 --mesh 2,2

Outside torchrun, ``--mesh 1,1`` makes a group of this one process and any
larger mesh exits 2.  The backend follows ``parallel.mesh.backend_for``
(NCCL with a card per rank, gloo where ranks share a card or on the CPU).
Rank 0 alone prints and writes the result CSVs and checkpoints.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from qmann_tpu_torch.config import QmannConfig
from qmann_tpu_torch.utils.reporting import (
    TaskLoopResult, TaskResult, config_banner, write_run_outputs,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="qmann_tpu_torch",
        description="Q-MANN on PyTorch/CUDA: quantized MemN2N on bAbI")
    p.add_argument("num_task_loop", type=int, nargs="?", default=1,
                   help="repeats per task (run.sh uses 10)")
    p.add_argument("task_start", type=int, nargs="?", default=1)
    p.add_argument("task_end", type=int, nargs="?", default=1)
    p.add_argument("iwl", type=int, nargs="?", default=5,
                   help="integer word length; frac = BW_WL-1-iwl")
    p.add_argument("--attention-mode", type=int, default=2,
                   choices=[1, 2, 3, 4])
    p.add_argument("--bw-wl", type=int, default=8)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=0.3)
    p.add_argument("--dim-emb", type=int, default=60)
    p.add_argument("--hops", type=int, default=3)
    p.add_argument("--tying", type=int, default=2, choices=[1, 2])
    p.add_argument("--no-linear-mapping", action="store_true")
    p.add_argument("--no-fixed-point", action="store_true")
    p.add_argument("--no-mq", action="store_true")
    p.add_argument("--binary-mode", action="store_true")
    p.add_argument("--shift-based-sm", action="store_true")
    p.add_argument("--sc-att", action="store_true",
                   help="learnable scale before the attention softmax "
                        "(EN_SC_ATT, define.h:59)")
    p.add_argument("--att-shift", action="store_true",
                   help="opt-in saturation mitigation: shift raw attention "
                        "score sums by the row max before requant "
                        "(NOT a reference knob; see BENCH.md)")
    p.add_argument("--hamming-weight-para", type=int, default=0,
                   help="HAMMING_WEIGHT_PARA (define.h:24-28): bit-weight "
                        "exponent offset of the mode-3 similarity, "
                        "w = 2^(-i-para); shipped 0, commented variant -1")
    p.add_argument("--hamming-unweighted", action="store_true",
                   help="mode-3 unweighted similarity: plain matching-bit "
                        "count (f_weighted=false, lib/layer_cuda.cu:297-304)")
    p.add_argument("--att-clip", action="store_true",
                   help="opt-in saturation mitigation: clip raw attention "
                        "score sums at maxf - step (STE)")
    p.add_argument("--non-linearity", action="store_true",
                   help="ReLU between hops (EN_NON_LINEARITY, define.h:294)")
    p.add_argument("--grad-quant", action="store_true",
                   help="EN_GRAD_QUANT (define.h:91, undef in the shipped "
                        "build): fixed-point effects in the backward pass")
    p.add_argument("--grad-quant-placement", default="backward",
                   choices=["backward", "update"],
                   help="'backward' = the reference's f_fixed threading "
                        "(quantized dot_mat_vec bwd contractions + dense "
                        "saturation grad mask, lib/layer.c:551-555); "
                        "'update' = single-point batch-gradient quantize "
                        "in sgd_update (pre-r5 deviation, for comparison)")
    p.add_argument("--quant-mode", type=int, default=3, choices=[0, 1, 2, 3],
                   help="rounding: 0 down, 1 up, 2 nearest-even, "
                        "3 toward zero (EN_QUANT_MODE, define.h:35-47)")
    p.add_argument("--weight-decay", type=float, default=0.0,
                   help="L2 coefficient lambda (define.h:238)")
    p.add_argument("--linear-start", action="store_true")
    p.add_argument("--shuffle", action="store_true",
                   help="EN_SAMPLE_SHUFFLED: one-time global sample permutation\n"
                        "(randomizing the train/valid split, MemN2N.c:1046-1052);\n"
                        "the reference's joint config block turns this on\n"
                        "(define.h:177-191).  Two deliberate deviations: (1) we\n"
                        "also reshuffle the TRAIN ORDER each epoch (upstream's\n"
                        "per-epoch rand_perm is dead code — MemN2N.c:1115-1117\n"
                        "immediately overwrites it with the fixed global\n"
                        "permutation, so its order is constant); (2) all\n"
                        "--num-task-loop repeats share ONE split (seeded by\n"
                        "--seed) where upstream draws a fresh permutation per\n"
                        "run — keeps loops comparable on identical data")
    p.add_argument("--max-sen-len", type=int, default=50,
                   help="MAX_SEN_LEN (define.h:154; the joint block uses 64)")
    p.add_argument("--max-dict-len", type=int, default=64,
                   help="MAX_DICT_LEN (define.h:153; joint block 192) — only\n"
                        "binding with --dim-forced")
    p.add_argument("--dim-forced", action="store_true",
                   help="DIM_FORCED: force dims to max_dict_len/max_sen_len")
    p.add_argument("--save-best-model", action="store_true")
    p.add_argument("--similarity-analysis", action="store_true",
                   help="EN_SIMILARITY_ANALYSIS (define.h:71): dump the "
                        "attention softmax inputs/outputs per epoch into "
                        "25-epoch-bucket CSVs")
    p.add_argument("--similarity-dir", default=None,
                   help="where the similarity CSVs go (default: out-dir)")
    p.add_argument("--similarity-probe", type=int, default=32,
                   help="samples dumped per epoch; 0 = the FULL validation "
                        "split (reference per-sample fidelity, "
                        "MemN2N.c:1416-1475)")
    p.add_argument("--joint", action="store_true",
                   help="EN_JOINT: train once on qa_joint, test per task")
    p.add_argument("--pe", action="store_true",
                   help="EN_PE: position encoding on the question vector")
    p.add_argument("--no-time", action="store_true",
                   help="disable temporal encoding (EN_TIME=false)")
    p.add_argument("--use-raw", action="store_true",
                   help="parse raw bAbI text even when parsed files exist")
    p.add_argument("--rand-noise-time", type=float, default=0.0,
                   help="RAND_NOISE_TIME temporal-noise augmentation rate")
    p.add_argument("--use-pallas", action="store_true",
                   help="route the training forward's lattices and reads "
                        "through the hand-written CUDA kernels")
    p.add_argument("--use-pallas-hamming", action="store_true",
                   help="mode 3 only: run just the Hamming score as the "
                        "CUDA kernel")
    p.add_argument("--use-fused-chain", action="store_true",
                   help="serving forward: run the whole K-hop chain as one "
                        "CUDA kernel per batch")
    p.add_argument("--data-path",
                   default="/root/reference/MemN2N/dataset/en_10k_parsed")
    p.add_argument("--raw-data-path",
                   default="/root/reference/MemN2N/dataset/"
                           "tasks_1-20_v1-2/en-10k")
    p.add_argument("--max-samples", type=int, default=None,
                   help="limit train samples (smoke runs)")
    p.add_argument("--max-test-samples", type=int, default=None)
    p.add_argument("--out-dir", default=".")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--checkpoint-dir", default=None,
                   help="save trained params + Q-format metadata here")
    p.add_argument("--profile", action="store_true",
                   help="print the per-phase time profile")
    p.add_argument("--mesh", default=None,
                   help="device mesh spec 'data,model' e.g. '4,2': one "
                        "process per rank, started by torchrun")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on; 'cpu' runs the kernels' "
                        "plain versions")
    return p


def config_from_args(args) -> QmannConfig:
    return QmannConfig(
        attention_mode=args.attention_mode,
        bw_wl=args.bw_wl,
        iwl=args.iwl,
        num_itr=args.epochs,
        size_batch=args.batch_size,
        learning_rate=args.lr,
        dim_emb=args.dim_emb,
        num_hops=args.hops,
        type_weight_tying=args.tying,
        en_linear_mapping=not args.no_linear_mapping,
        en_fixed_point=not args.no_fixed_point,
        en_mq=not args.no_mq,
        binary_mode=args.binary_mode,
        en_shift_based_sm=args.shift_based_sm,
        en_sc_att=args.sc_att,
        en_att_shift=args.att_shift,
        en_att_clip=args.att_clip,
        hamming_weight_para=args.hamming_weight_para,
        hamming_weighted=not args.hamming_unweighted,
        en_non_linearity=args.non_linearity,
        en_grad_quant=args.grad_quant,
        grad_quant_placement=args.grad_quant_placement,
        quant_mode=args.quant_mode,
        lambda_=args.weight_decay,
        en_linear_start=args.linear_start,
        en_sample_shuffled=args.shuffle,
        max_sen_len=args.max_sen_len,
        max_dict_len=args.max_dict_len,
        dim_forced=args.dim_forced,
        en_save_best_model=args.save_best_model,
        en_similarity_analysis=args.similarity_analysis,
        similarity_analysis_dir=(args.similarity_dir or args.out_dir),
        similarity_probe_size=args.similarity_probe,
        en_joint=args.joint,
        en_pe=args.pe,
        en_time=not args.no_time,
        use_raw_babi=args.use_raw,
        rand_noise_time=args.rand_noise_time,
        use_pallas=args.use_pallas,
        use_pallas_hamming=args.use_pallas_hamming,
        use_fused_chain=args.use_fused_chain,
        data_path=args.data_path,
        raw_data_path=args.raw_data_path,
        seed=args.seed,
        verbose=not args.quiet,
    )


def _join_mesh(spec: str, device):
    """The mesh of ``--mesh d,m``, joining the process group torchrun's
    environment describes (or, outside torchrun, a group of this process
    for a mesh of one rank).  Returns (mesh, whether this call made the
    group), or None when the processes do not match the mesh."""
    import torch.distributed as dist
    from qmann_tpu_torch.parallel.launch import init_single_process
    from qmann_tpu_torch.parallel.mesh import initialize_multihost, make_mesh
    parts = [int(x) for x in spec.split(",")]
    model_par = parts[1] if len(parts) > 1 else 1
    n = parts[0] * model_par
    world = int(os.environ.get("WORLD_SIZE", 1))
    if world != n:
        print(f"error: --mesh {spec} needs {n} processes, one per rank; "
              f"this run has {world}.  Start it with torchrun: python -m "
              f"torch.distributed.run --standalone --nproc-per-node {n} -m "
              f"qmann_tpu_torch ... --mesh {spec}", file=sys.stderr)
        return None
    made = not dist.is_initialized()
    if made:
        if "WORLD_SIZE" in os.environ:
            initialize_multihost(device=device)
        else:
            init_single_process(device)
    return make_mesh(n, model_par, device=device), made


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)

    # deferred imports so --help stays fast
    from qmann_tpu_torch.device import resolve_device
    dev = resolve_device(args.device)
    mesh, made = None, False
    if args.mesh:
        joined = _join_mesh(args.mesh, dev)
        if joined is None:
            return 2
        mesh, made = joined
        dev = mesh.device
    try:
        return _run(args, cfg, dev, mesh)
    finally:
        if made:
            import torch.distributed as dist
            dist.destroy_process_group()


def _run(args, cfg: QmannConfig, dev, mesh) -> int:
    from qmann_tpu_torch.data.native import load_task_native as load_task
    from qmann_tpu_torch.train import train_task
    from qmann_tpu_torch.utils.profiling import PhaseProfiler

    from qmann_tpu_torch.parallel.mesh import rank0_only

    rank0 = mesh is None or mesh.rank == 0
    say = rank0_only(print, mesh)
    if mesh is not None:
        say(f"< Mesh : data={mesh.data} model={mesh.model} > backend "
            f"{mesh.backend}")
    say(config_banner(cfg))
    results = []
    prof = PhaseProfiler(dev)

    def save_ckpt(res, loop_cfg, dims, dictionary, tag):
        if not rank0:
            return
        from qmann_tpu_torch.utils.checkpoint import save_checkpoint
        # with --save-best-model the evaluated (and served) weights are
        # the best snapshot, not the possibly-collapsed final epoch
        params_to_save = (res.best_params
                          if cfg.en_save_best_model and res.best_params
                          else res.params)
        save_checkpoint(args.checkpoint_dir, params_to_save, loop_cfg,
                        dims, tag=tag, dictionary=dictionary)

    if cfg.en_joint:
        # EN_JOINT: train ONCE on qa_joint, then test every task with the
        # jointly-trained model (done_joint_training guard,
        # MemN2N/MemN2N.c:520-533)
        from qmann_tpu_torch.data.babi import load_test_split
        from qmann_tpu_torch.train import eval_split
        with prof.phase("data"):
            data = load_task(
                "qa1_single-supporting-fact", cfg.data_path,
                raw_path=cfg.raw_data_path, max_sen_len=cfg.max_sen_len,
                rate_valid=cfg.rate_num_valid_sample,
                rand_noise_time=cfg.rand_noise_time,
                limit_train=args.max_samples,
                limit_test=args.max_test_samples,
                use_raw=cfg.use_raw_babi, enable_time=cfg.en_time,
                en_pe=cfg.en_pe, train_task_name="qa_joint",
                dim_forced=cfg.dim_forced, max_dict_len=cfg.max_dict_len,
                shuffle_split=cfg.en_sample_shuffled, split_seed=cfg.seed)
        say(f"    Joint training: {len(data.train)} samples, "
            f"dict {data.dims.dim_dict}")
        joint_runs = []
        for loop in range(args.num_task_loop):
            loop_cfg = cfg.replace(seed=cfg.seed + loop)
            with prof.phase("train"):
                res = train_task(loop_cfg, data, device=dev, mesh=mesh)
            joint_runs.append(res)
            if args.checkpoint_dir:
                save_ckpt(res, loop_cfg, data.dims, data.dictionary,
                          f"qa_joint_loop{loop}")
        for task_index in range(args.task_start, args.task_end + 1):
            task = cfg.task_name(task_index)
            test = load_test_split(task, cfg.data_path, data.dictionary,
                                   data.dims, raw_path=cfg.raw_data_path,
                                   use_raw=cfg.use_raw_babi,
                                   enable_time=cfg.en_time,
                                   max_sen_len=cfg.max_sen_len,
                                   limit_test=args.max_test_samples)
            loops = []
            for loop, res in enumerate(joint_runs):
                eval_params = (res.best_params if cfg.en_save_best_model
                               and res.best_params else res.params)
                _, err, _ = eval_split(eval_params, test, cfg, device=dev,
                                       mesh=mesh)
                loops.append(TaskLoopResult(res.time_train, 0.0, 0.0, err))
            errs = [l.err_test for l in loops]
            say(f"  task {task_index} ({task}) joint err_test "
                f"avg/max/min: {np.mean(errs):f}/{np.max(errs):f}/"
                f"{np.min(errs):f}")
            results.append(TaskResult(task_index, loops))
    else:
        for task_index in range(args.task_start, args.task_end + 1):
            task = cfg.task_name(task_index)
            say(f"< Task {task_index} : {task} >")
            with prof.phase("data"):
                data = load_task(
                    task, cfg.data_path, raw_path=cfg.raw_data_path,
                    max_sen_len=cfg.max_sen_len,
                    rate_valid=cfg.rate_num_valid_sample,
                    rand_noise_time=cfg.rand_noise_time,
                    limit_train=args.max_samples,
                    limit_test=args.max_test_samples,
                    use_raw=cfg.use_raw_babi, enable_time=cfg.en_time,
                    en_pe=cfg.en_pe,
                    dim_forced=cfg.dim_forced, max_dict_len=cfg.max_dict_len,
                    shuffle_split=cfg.en_sample_shuffled,
                    split_seed=cfg.seed,
                )
            say(f"    Dim input : {data.dims.dim_input}")
            say(f"    Dim emb   : {cfg.dim_emb}")
            say(f"    Samples   : train {len(data.train)}, "
                f"valid {len(data.valid)}, test {len(data.test)}")

            loops = []
            for loop in range(args.num_task_loop):
                loop_cfg = cfg.replace(seed=cfg.seed + loop)
                with prof.phase("train"):
                    res = train_task(loop_cfg, data, device=dev, mesh=mesh)
                loops.append(TaskLoopResult(
                    time_train=res.time_train,
                    err_train=(res.history[-1].err_train if res.history
                               else 1.0),
                    time_test=res.time_test,
                    err_test=res.err_test))
                say(f"  loop {loop}: err_test {res.err_test:f} "
                    f"(train {res.time_train:.1f}s, "
                    f"test {res.time_test:.3f}s)")
                if args.checkpoint_dir:
                    save_ckpt(res, loop_cfg, data.dims, data.dictionary,
                              f"{task}_loop{loop}")
            results.append(TaskResult(task_index, loops))
            errs = [l.err_test for l in loops]
            say(f"  task {task_index} err_test avg/max/min: "
                f"{np.mean(errs):f}/{np.max(errs):f}/{np.min(errs):f}")

    if rank0:
        write_run_outputs(args.out_dir, cfg, results)
    if args.profile:
        say(prof.report())
    return 0


if __name__ == "__main__":
    sys.exit(main())
