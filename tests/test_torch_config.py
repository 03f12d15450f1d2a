"""The port's jax-free QmannConfig held equal to qmann_tpu.config's."""
import dataclasses

import pytest

pytest.importorskip("torch")

from qmann_tpu.config import QmannConfig as JaxConfig  # noqa: E402
from qmann_tpu_torch.config import QmannConfig as TorchConfig  # noqa: E402

PROPERTIES = ("frac", "fmt_act", "fmt_w", "fmt_att", "fmt_bin", "fmt_ds_ans",
              "num_bits_attention", "grad_quant_backward", "wsum_quantized",
              "wsum_grad_quantized", "att_score_mod")


def test_fields_and_defaults_match():
    jf = [(f.name, f.default, f.type) for f in dataclasses.fields(JaxConfig)]
    tf = [(f.name, f.default, f.type) for f in dataclasses.fields(TorchConfig)]
    assert tf == jf


@pytest.mark.parametrize("en_mq", [True, False])
@pytest.mark.parametrize("iwl", [0, 1, 5])
@pytest.mark.parametrize("mode", [1, 2, 3])
def test_derived_formats_and_dispatch_match(mode, iwl, en_mq):
    for extra in ({}, {"en_grad_quant": True},
                  {"en_grad_quant": True, "grad_quant_placement": "update"},
                  {"en_fixed_point": False}, {"en_att_shift": True},
                  {"binary_mode": True}, {"num_hops": 2},
                  {"num_bit_attention": 4}):
        kw = dict(attention_mode=mode, iwl=iwl, en_mq=en_mq, **extra)
        j, t = JaxConfig(**kw), TorchConfig(**kw)
        assert dataclasses.asdict(t) == dataclasses.asdict(j), kw
        for name in PROPERTIES:
            assert getattr(t, name) == getattr(j, name), (name, kw)
        assert t.task_name(3) == j.task_name(3)
    with pytest.raises(ValueError):
        TorchConfig(en_att_shift=True, en_att_clip=True)
    with pytest.raises(ValueError):
        TorchConfig(grad_quant_placement="nowhere")
