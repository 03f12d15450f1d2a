"""Configuration system — a jax-free copy of ``qmann_tpu/config.py``.

The machine with the GPU has no jax, and ``qmann_tpu.config`` imports
``qmann_tpu.numerics`` (jax), so the port keeps its own copy with the same
fields, defaults, dispatch properties and derived formats;
tests/test_torch_config.py holds the two equal field by field.  The
TPU-execution flags keep their names: ``use_fused_chain`` selects the
Hopper chain kernel (ops/cuda); ``use_pallas`` and ``use_pallas_hamming``
select kernels not ported yet and are ignored by the port.

The reference's configuration is a compile-time header (MemN2N/define.h)
plus four positional CLI arguments (MemN2N/MemN2N.c:211-274) — sweeps
recompile the binary (MemN2N/run.sh).  Here every knob is a runtime field
of one dataclass, with the same defaults as the shipped define.h, plus the
derived per-hop Q-format arrays the reference builds in main()
(MemN2N/MemN2N.c:679-767).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from qmann_tpu_torch.numerics import QFormat, ROUND_TOWARD_ZERO

# bAbI task list (MemN2N/define.h:326-348); index 21 is the joint task.
BABI_TASKS = (
    "qa1_single-supporting-fact",
    "qa2_two-supporting-facts",
    "qa3_three-supporting-facts",
    "qa4_two-arg-relations",
    "qa5_three-arg-relations",
    "qa6_yes-no-questions",
    "qa7_counting",
    "qa8_lists-sets",
    "qa9_simple-negation",
    "qa10_indefinite-knowledge",
    "qa11_basic-coreference",
    "qa12_conjunction",
    "qa13_compound-coreference",
    "qa14_time-reasoning",
    "qa15_basic-deduction",
    "qa16_basic-induction",
    "qa17_positional-reasoning",
    "qa18_size-reasoning",
    "qa19_path-finding",
    "qa20_agents-motivations",
    "qa_joint",
)


@dataclasses.dataclass(frozen=True)
class QmannConfig:
    """All reference knobs (define.h line refs in comments) as one config."""

    # --- quantization (define.h:15-47) ---
    attention_mode: int = 2          # :15  1 float / 2 quantized / 3 hamming / 4 binary
    bw_wl: int = 8                   # :21  total word length
    iwl: int = 5                     # argv[4]; frac = bw_wl - 1 - iwl
    num_bit_attention: Optional[int] = None  # :24 default BW_WL (via 1+iwl+frac)
    hamming_weight_para: int = 0     # :26-28 bit-weight exponent offset
    hamming_weighted: bool = True    # f_weighted similarity variant
    quant_mode: int = ROUND_TOWARD_ZERO      # :35-47 EN_QUANT_MODE undef -> trunc
    en_fixed_point: bool = True      # :31
    en_mq: bool = True               # :79  per-hop mixed precision
    binary_mode: bool = False        # :88  iwl=frac=0 everywhere
    attention_const_scale: int = -3  # :67
    en_grad_quant: bool = False      # :91 (undef)
    # EN_GRAD_QUANT placement: "backward" is the reference's f_fixed
    # threading (lib/layer.c:551-555 — quantized dot_mat_vec backward
    # contractions at (1, iwl+frac-1) + the dense saturation grad mask;
    # weight-grad accumulations stay float, lib/layer_cuda.cu:3266);
    # "update" quantizes the accumulated batch gradient once in
    # sgd_update (the pre-round-5 single-point deviation, kept for
    # comparison)
    grad_quant_placement: str = "backward"

    # --- model (define.h:150-196, :284-298) ---
    num_hops: int = 3                # :243-275 per attention mode; 3 for modes 1-3
    dim_emb: int = 60                # :159
    max_dict_len: int = 64           # :153
    max_sen_len: int = 50            # :154
    dim_forced: bool = False         # :151
    en_joint: bool = False           # :152
    en_time: bool = True             # :196 temporal encoding
    en_pe: bool = False              # :298 position encoding
    type_weight_tying: int = 2       # :287  1 adjacent / 2 layer-wise (RNN)
    en_linear_mapping: bool = True   # :291  linear map H between hops
    en_non_linearity: bool = False   # :294  ReLU between hops
    en_sc_att: bool = False          # :59   learnable scale before attn softmax
    en_similarity_analysis: bool = False  # :71  softmax distribution dumps
    similarity_analysis_dir: str = "."    # where the bucket CSVs go
    # per-epoch dump size: N = probe the first N validation samples;
    # 0 = FULL-split dump (the reference's per-sample fidelity,
    # MemN2N/MemN2N.c:1416-1475 — every sample, every hop, every epoch)
    similarity_probe_size: int = 32
    en_shift_based_sm: bool = False  # :55
    en_exp_table_based: bool = False # :315  exp_plan softmax
    en_cosine_sim: bool = False      # :200
    test_maxout: bool = False        # :309  maxout-attention trial model
    # opt-in saturation-collapse mitigations (NOT in the reference; OFF by
    # default for parity — see BENCH.md's collapse study and
    # ops/qlinear.qscore's score_mod):
    en_att_shift: bool = False       # shift raw score sums by the row max
    en_att_clip: bool = False        # clip raw score sums at maxf - step

    # --- training (define.h:204-254, :313) ---
    learning_rate: float = 0.3       # :241/:252
    rate_decay_step: int = 25        # :240/:251
    num_itr: int = 100               # :242/:253
    size_batch: int = 32             # :225
    lambda_: float = 0.0             # :238/:249
    en_max_grad_l2_norm: bool = True # :206
    max_grad_l2_norm: float = 40.0   # :208
    rand_noise_time: float = 0.0     # :214
    en_linear_start: bool = False    # :218
    num_itr_linear_start: int = 5    # :220
    zeroing_null_weight: bool = True # :313
    rate_num_valid_sample: float = 0.1  # :193
    en_sample_shuffled: bool = False    # :172
    en_save_best_model: bool = False    # :76
    count_early_stopping: int = 5       # :82

    # --- data (define.h:122-124, :168-172, :322-323) ---
    data_path: str = "/root/reference/MemN2N/dataset/en_10k_parsed"
    raw_data_path: str = "/root/reference/MemN2N/dataset/tasks_1-20_v1-2/en-10k"
    use_raw_babi: bool = False       # parse raw bAbI instead of parsed format
    num_sample: int = 10000          # :170
    num_sample_test: int = 1000      # :171
    en_num_sample_from_file: bool = True  # :168
    null_char: str = "NULL"          # :232
    max_word_len: int = 20           # :123

    # --- TPU execution ---
    use_pallas: bool = False   # route hot-op forwards through Pallas kernels
    # mode-3 only: run JUST the Hamming score as the VMEM-tiled Pallas
    # kernel while everything else stays on the XLA path — the clean
    # per-op Pallas-vs-XLA A/B for the paper's core op (the mode-2
    # demotion verdict of docs/PROFILE_r4.md never covered the int32
    # bit-lattice workload)
    use_pallas_hamming: bool = False
    # integer-exactness fast paths: the STATIC integer-input stacked-MXU
    # embedding route plus the runtime lax.cond MXU routes.  Bit-identical
    # either way (the fast branch equals the lattice exactly whenever its
    # predicate holds — tests/test_ops.py).  Measured defaults differ by
    # regime (docs/PROFILE_r4.md): the serial gradient step compiles the
    # conds out (trainer.train_epoch — their branch copies cost more than
    # the small per-batch matmuls save), while the vmapped family trainer
    # and all inference paths keep them (the static MXU route is a 4x at
    # family scale and 2.56x in the scan bench)
    en_integer_fast_path: bool = True
    # serving/bench only: run the whole K-hop chain as ONE Pallas program
    # inside forward_prepared (mode 2, quantized, no feature heads);
    # bit-identical to the unfused chain (tests/test_pallas.py)
    use_fused_chain: bool = False

    # --- misc ---
    seed: int = 0
    verbose: bool = True             # :302

    def __post_init__(self):
        if self.binary_mode:
            object.__setattr__(self, "iwl", 0)
        if self.en_att_shift and self.en_att_clip:
            raise ValueError("en_att_shift and en_att_clip are mutually "
                             "exclusive score mitigations")
        if self.grad_quant_placement not in ("update", "backward"):
            raise ValueError(
                f"unknown grad_quant_placement {self.grad_quant_placement!r}")

    # ------------------------------------------------------------------
    # dot_mat_vec family dispatch — THE single home of the reference's
    # per-mode quantization rules, shared by models/memn2n._hop_stack and
    # parallel/distributed._attention_read_local:
    #   * forward f_fixed is hardcoded per attention mode
    #     (lib/layer.c:177-251): mode 1 false, mode 2 true, mode 3 the
    #     layer flag (EN_FIXED_POINT); mode 4 has no live path (keeps the
    #     layer flag here);
    #   * the mode-3 weighted-sum BACKWARD quantizes whenever the layer
    #     is fixed, independent of EN_GRAD_QUANT (bwd_appx receives
    #     dot->f_fixed unconditionally, lib/layer.c:588-599);
    #   * modes 1/2 backwards quantize only under EN_GRAD_QUANT with the
    #     layer fixed (f_fixed threaded at lib/layer.c:551-575).
    # ------------------------------------------------------------------

    @property
    def grad_quant_backward(self) -> bool:
        """True when the EN_GRAD_QUANT per-backward placement is active."""
        return (self.en_grad_quant
                and self.grad_quant_placement == "backward"
                and self.en_fixed_point)

    @property
    def wsum_quantized(self) -> bool:
        """Weighted-sum FORWARD quantization per the mode dispatch."""
        return {1: False, 2: True}.get(self.attention_mode,
                                       self.en_fixed_point)

    @property
    def wsum_grad_quantized(self) -> bool:
        """Weighted-sum BACKWARD quantization: unconditional on f_fixed
        in mode 3; EN_GRAD_QUANT-gated otherwise."""
        if self.attention_mode == 3:
            return self.en_fixed_point
        return self.grad_quant_backward

    @property
    def att_score_mod(self) -> str:
        """score_mod for ops.qscore ("none" unless a mitigation is on)."""
        if self.en_att_shift:
            return "shift"
        if self.en_att_clip:
            return "clip"
        return "none"

    # ------------------------------------------------------------------
    # Derived Q-format wiring (MemN2N/MemN2N.c:679-767)
    # ------------------------------------------------------------------

    @property
    def frac(self) -> int:
        """frac = BW_WL - 1 - iwl (MemN2N/MemN2N.c:273-274)."""
        if self.binary_mode:
            return 0
        return self.bw_wl - 1 - self.iwl

    def _fmt(self, iwl: int, frac: int) -> QFormat:
        return QFormat(iwl, frac, self.quant_mode)

    @property
    def fmt_act(self) -> Tuple[QFormat, ...]:
        """Per-hop activation format iwl[]/frac[] — uniform
        (MemN2N/MemN2N.c:715-722)."""
        return tuple(self._fmt(self.iwl, self.frac) for _ in range(self.num_hops))

    @property
    def fmt_w(self) -> Tuple[QFormat, ...]:
        """Per-hop weight format iwl_w[]/frac_w[]; EN_MQ gives hop 0
        iwl+1/frac-1 and hop 2 iwl-1/frac+1 (MemN2N/MemN2N.c:748-754).

        The reference stores iwl/frac as unsigned int, so at the extreme
        operating points its EN_MQ arithmetic UNDERFLOWS (iwl=0 makes
        hop 2's iwl_w wrap to UINT_MAX — sweep_fixed.sh runs exactly that
        config into undefined behavior; likewise iwl=7 wraps hop 0's
        frac).  Here the per-hop adjustment is skipped when it would
        leave the valid range — a documented sane-ification of reference
        UB."""
        fmts = [[self.iwl, self.frac] for _ in range(self.num_hops)]
        if self.en_mq and not self.binary_mode and self.num_hops >= 3:
            if fmts[0][1] - 1 >= 0:
                fmts[0][0] += 1
                fmts[0][1] -= 1
            if fmts[2][0] - 1 >= 0:
                fmts[2][0] -= 1
                fmts[2][1] += 1
        return tuple(self._fmt(i, f) for i, f in fmts)

    @property
    def fmt_att(self) -> Tuple[QFormat, ...]:
        """Per-hop attention format iwl_att[]/frac_att[] — uniform."""
        return tuple(self._fmt(self.iwl, self.frac) for _ in range(self.num_hops))

    @property
    def fmt_bin(self) -> QFormat:
        """Second operand format of the attention dot (iwl_bin/frac_bin,
        MemN2N/MemN2N.c:774-780): (0,0) in BINARY_MODE else the base format."""
        if self.binary_mode:
            return self._fmt(0, 0)
        return self._fmt(self.iwl, self.frac)

    @property
    def fmt_ds_ans(self) -> QFormat:
        """Output layer nominal format — runs float (MemN2N.c:766-767,
        902-906) with iwl=8/frac=7."""
        return self._fmt(8, 7)

    @property
    def num_bits_attention(self) -> int:
        """Bits compared by the Hamming attention: the reference passes
        1+iwl_m+frac_m of the dotmv layer (lib/layer.c:230)."""
        if self.num_bit_attention is not None:
            return self.num_bit_attention
        return 1 + self.iwl + self.frac

    def task_name(self, task_index: int) -> str:
        """1-based task index -> dataset name (define.h:326-348)."""
        return BABI_TASKS[task_index - 1]

    def replace(self, **kw) -> "QmannConfig":
        return dataclasses.replace(self, **kw)
