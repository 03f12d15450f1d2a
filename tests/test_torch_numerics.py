"""qmann_tpu_torch.numerics against qmann_tpu.numerics, bit for bit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qmann_tpu import numerics as jnum  # noqa: E402
from qmann_tpu_torch import numerics as tnum  # noqa: E402

MODES = (tnum.ROUND_DOWN, tnum.ROUND_UP, tnum.ROUND_NEAREST_EVEN,
         tnum.ROUND_TOWARD_ZERO)
SMALL = [(i, f) for i in range(8) for f in range(8) if i + f <= 7]
FULL = [(i, 31 - i) for i in range(32)]


def _inputs(iwl, frac, rng):
    """Random values over and past the format's range plus its edges:
    +-max, +-2^iwl, -0.0, the values just beyond saturation, half-grid
    points (rounding ties) and the int32 conversion boundary."""
    maxf = np.float32(jnum.fixed_max_float(iwl, frac))
    step = np.float32(2.0 ** -frac)
    edges = [maxf, -maxf, np.float32(2.0 ** iwl), -np.float32(2.0 ** iwl),
             np.nextafter(maxf, np.float32(np.inf)),
             np.nextafter(-maxf, -np.float32(np.inf)),
             np.nextafter(maxf, np.float32(0)), -0.0, 0.0,
             step / 2, -step / 2, 1.5 * step, -1.5 * step, 2.5 * step,
             -2.5 * step, np.float32(2.0 ** 31), -np.float32(2.0 ** 31),
             np.float32(3e38), -np.float32(3e38)]
    span = float(maxf) * 1.5 + 1.0
    rand = rng.uniform(-span, span, 2000)
    grid = rng.integers(-600, 600, 500) * float(step) / 2
    x = np.concatenate([np.asarray(edges, np.float32),
                        rand.astype(np.float32), grid.astype(np.float32)])
    # XLA's CPU backend flushes subnormals to zero (the binary format's
    # "just beyond saturation" values are subnormal); the card does not
    return x[(x == 0) | (np.abs(x) >= np.finfo(np.float32).tiny)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("group", ["small", "full"])
def test_float_quant_matches_jax(mode, group, rng):
    for iwl, frac in (SMALL if group == "small" else FULL):
        x = _inputs(iwl, frac, rng)
        want = np.asarray(jnum.float_quant(x, jnum.QFormat(iwl, frac, mode)))
        got = tnum.float_quant(torch.from_numpy(x),
                               tnum.QFormat(iwl, frac, mode)).numpy()
        np.testing.assert_array_equal(got, want,
                                      err_msg=f"Q{iwl}.{frac} mode {mode}")
        # the sign of zero carries through too
        np.testing.assert_array_equal(np.signbit(got), np.signbit(want),
                                      err_msg=f"Q{iwl}.{frac} mode {mode}")


def test_fixed_max_float_matches_jax():
    for iwl, frac in SMALL + FULL:
        assert tnum.fixed_max_float(iwl, frac) == float(
            jnum.fixed_max_float(iwl, frac))


@pytest.mark.parametrize("fmts", [
    [(6, 1, 3), (5, 2, 3), (4, 3, 3)] * 2,             # EN_MQ hop formats
    [(5, 2, 3)] * 4,                                   # one format
    [(2, 29, 0), (5, 2, 0), (0, 31, 0)],               # full width, floor
    [(5, 2, 3), (0, 0, 3), (4, 3, 3)],                 # a binary block
    [(5, 2, 2), (5, 2, 3), (1, 6, 1)],                 # mixed modes
])
def test_float_quant_blocks_matches_jax(fmts, rng):
    widths = [3, 5, 4, 2, 6, 1][:len(fmts)]
    n = 1000
    x = np.concatenate([
        np.stack([rng.choice(_inputs(i, f, rng), n) for _ in range(w)], 1)
        for (i, f, _), w in zip(fmts, widths)], axis=1)
    want = np.asarray(jnum.float_quant_blocks(
        x, tuple(jnum.QFormat(*f) for f in fmts), tuple(widths)))
    got = tnum.float_quant_blocks(
        torch.from_numpy(x), tuple(tnum.QFormat(*f) for f in fmts),
        tuple(widths)).numpy()
    np.testing.assert_array_equal(got, want)
