"""Bench tools of the port (counterparts of ``qmann_tpu/bench/``)."""
