"""The engine's host vectorization per wave, from its own counters
(``EngineStats``: ``vectorize_s`` over ``waves``) in the traced window."""


def read(ctx):
    w = ctx["work"]
    if not w.get("waves"):
        return None
    return 1e3 * w["vectorize_s"] / w["waves"]
