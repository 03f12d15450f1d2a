"""The two formulas the redesigned read and Hamming kernels rest on,
emulated in torch on the CPU (the kernels themselves run only on the card,
tests/test_torch_cuda.py):

- FastQ31<Mode> (csrc/qformat.cuh), the branch-free quantizer of the
  31-bit full-width format, against float_quant for every iwl in [0, 31]
  and every rounding mode on an edge list;
- the word form of the Hamming similarity (csrc/hamming.cuh): the masked
  match word read as a fixed-point fraction, or its popcount, against the
  plain bit loop of ops/attention.py for num_bit 1..25.

Tolerance: none; both are compared bit for bit (NaN where float_quant
gives NaN).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qmann_tpu_torch.numerics import (  # noqa: E402
    QFormat, fixed_max_float, float_quant,
)
from qmann_tpu_torch.ops import attention as tatt  # noqa: E402

F32 = np.float32


def _fast_quant31(x, iwl, mode):
    """FastQ31 in float32 torch: one multiply, one rounding of the fixed
    kind, one multiply, a NaN-propagating clamp to [-maxf, maxf]
    (torch.maximum / minimum keep NaN, as PTX max.NaN / min.NaN do), and 0
    at x == -maxf."""
    frac = 31 - iwl
    rnd = (torch.floor, torch.ceil, torch.round, torch.trunc)[mode]
    maxf = torch.tensor(fixed_max_float(iwl, frac))
    v = rnd(x * (2.0 ** frac)) * (2.0 ** -frac)
    v = torch.minimum(torch.maximum(v, -maxf), maxf)
    return torch.where(x == -maxf, torch.zeros_like(v), v)


def _edge_values31(iwl):
    """+-maxf (= 2^iwl) and the floats beside it, the grid's half steps
    (ties) and their neighbours, +-inf, NaN, +-0.0, subnormals, tiny and
    huge values, and Gaussian values in and out of range."""
    maxf = F32(fixed_max_float(iwl, 31 - iwl))
    step = F32(2.0 ** -(31 - iwl))
    pts = [maxf, np.nextafter(maxf, F32(np.inf)), np.nextafter(maxf, F32(0)),
           F32(2.0 ** 31 / 2.0 ** (31 - iwl)), F32(np.inf), F32(np.nan),
           F32(0.0), F32(1e-45), F32(1e-40), F32(1e-38), F32(3e-9),
           F32(1e30), F32(3e38)]
    for k in (0.5, 1.5, 2.5, 3.0, 7.5, 1e6 + 0.5):
        v = F32(k * step)
        pts += [v, np.nextafter(v, F32(0)), np.nextafter(v, F32(np.inf))]
    rng = np.random.default_rng(iwl)
    spread = np.concatenate([rng.normal(0.0, 0.5 * 2.0 ** iwl, 256),
                             rng.normal(0.0, 4.0 * 2.0 ** iwl, 64)])
    vals = np.concatenate([np.array(pts, F32), spread.astype(F32)])
    return torch.from_numpy(np.concatenate([vals, -vals]))


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_fast_quant31_formula_equals_float_quant(mode):
    """The argument of csrc/qformat.cuh (FastQ31): for every iwl in
    [0, 31] at frac = 31 - iwl, the clamp of the rounded value with the
    INT_MIN wrap as a select at x == -maxf equals float_quant bit for bit
    (-0.0 included)."""
    for iwl in range(32):
        x = _edge_values31(iwl)
        got = _fast_quant31(x, iwl, mode)
        want = float_quant(x, QFormat(iwl, 31 - iwl, mode))
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan), iwl
        assert torch.equal(got[~nan].view(torch.int32),
                           want[~nan].view(torch.int32)), iwl


def _mask(num_bit):
    """csrc/hamming.cuh's mask: the bits 30 .. 32-num_bit."""
    return 0x7FFFFFFF & ~((1 << (32 - num_bit)) - 1)


def _word_similarity(wa, wb, num_bit, weight_para, weighted):
    """The word form on int32 words, in int64 and float32: match = ~differ
    & mask; weighted: float32(match) * 2^(-31-weight_para), negated where
    the sign bits differ; unweighted: the popcount of match."""
    differ = (wa.to(torch.int64) ^ wb.to(torch.int64)) & 0xFFFFFFFF
    match = ~differ & _mask(num_bit)
    if not weighted:
        return sum(((match >> k) & 1) for k in range(31)).to(torch.float32)
    sim = match.to(torch.float32) * F32(2.0 ** (-31 - weight_para))
    return torch.where(((differ >> 31) & 1) == 1, -sim, sim)


def _words(rng):
    """Random int32 words beside edge words: 0, all ones, the sign bit
    alone, the magnitude mask, one bit at each position, and alternating
    bit patterns; every pair of them."""
    edge = [0, -1, -(2 ** 31), 2 ** 31 - 1, 0x55555555, -0x55555556,
            0x2AAAAAAA] + [1 << k for k in range(31)]
    rand = rng.integers(-(2 ** 31), 2 ** 31, 512)
    vals = np.concatenate([np.array(edge, np.int64), rand]).astype(np.int32)
    a = torch.from_numpy(np.repeat(vals, len(edge)))
    b = torch.from_numpy(np.tile(vals[:len(edge)], len(vals)))
    pairs = torch.from_numpy(rng.integers(-(2 ** 31), 2 ** 31, (2, 4096))
                             .astype(np.int32))
    return torch.cat([a, pairs[0]]), torch.cat([b, pairs[1]])


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("weight_para", [-32, -1, 0, 32])
def test_word_form_equals_the_bit_loop(rng, weight_para, weighted):
    """For num_bit 1..25 and const_scale in {-64, -3, 0, 64} the word form
    times 2^const_scale equals the plain ascending float32 loop times
    2^const_scale bit for bit; the unweighted count at every num_bit up to
    32.  From num_bit 27 on the loop rounds twice where the word form
    rounds once, and they differ (the kernels keep the loop from num_bit
    26 on; at 26 both round once, at the last bit, and agree)."""
    wa, wb = _words(rng)
    loop = (lambda nb: tatt._weighted_similarity(wa, wb, nb, weight_para)
            if weighted else tatt.unweighted_similarity(wa, wb, nb))
    for num_bit in range(1, 33 if not weighted else 26):
        want = loop(num_bit)
        got = _word_similarity(wa, wb, num_bit, weight_para, weighted)
        for cs in (-64, -3, 0, 64):
            scale = F32(2.0 ** cs)
            assert torch.equal((got * scale).view(torch.int32),
                               (want * scale).view(torch.int32)), \
                (num_bit, cs)
    if weighted:
        for num_bit in range(27, 33):
            got = _word_similarity(wa, wb, num_bit, weight_para, True)
            assert not torch.equal(got, loop(num_bit)), num_bit


@pytest.fixture
def rng():
    return np.random.default_rng(0)
