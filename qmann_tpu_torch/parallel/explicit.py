"""The explicit-collective training step (counterpart of
``qmann_tpu/parallel/explicit.py``).

JAX's explicit step runs the whole SGD step inside one shard_map with the
memory always split over "model"; its GSPMD step lets XLA choose.  In the
port both are ``sharding.ShardedTrainStep``, the local step over (data,
model) shards with every collective written out; the explicit one always
splits the memory, so each hop's read is the distributed one
(``distributed._attention_read_local``: psum'ed softmax statistics and
psum'ed quantized partial sums), and it refuses what JAX's refuses.

Scope: the default reference wiring (layer-wise tying TYPE 2, the plain
exp softmax, no EN_SC_ATT, maxout or cosine heads, no EN_GRAD_QUANT); the
sharded step covers the rest.
"""
from __future__ import annotations

from qmann_tpu_torch.config import QmannConfig
from qmann_tpu_torch.parallel.mesh import Mesh
from qmann_tpu_torch.parallel.sharding import ShardedTrainStep


def _check_supported(cfg: QmannConfig) -> None:
    unsupported = []
    if cfg.type_weight_tying != 2:
        unsupported.append("type_weight_tying != 2")
    if cfg.en_sc_att or cfg.test_maxout or cfg.en_cosine_sim:
        unsupported.append("sc_att/maxout/cosine attention heads")
    if cfg.en_shift_based_sm or cfg.en_exp_table_based:
        unsupported.append("softmax variants")
    if cfg.en_grad_quant:
        unsupported.append("EN_GRAD_QUANT (use the GSPMD step — it "
                           "partitions the quantized backward "
                           "contractions automatically)")
    if unsupported:
        raise NotImplementedError(
            "explicit-collective step supports the default wiring; "
            f"use the GSPMD step for: {', '.join(unsupported)}")


def make_explicit_train_step(cfg: QmannConfig, mesh: Mesh
                             ) -> ShardedTrainStep:
    """One SGD step with the memory split over "model" (M must divide it);
    called as step(params, batch, lr, size_b) like the sharded step."""
    _check_supported(cfg)
    return ShardedTrainStep(cfg, mesh, memory_split=True)
