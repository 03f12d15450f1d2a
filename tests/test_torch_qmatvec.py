"""The qmatvec lattice's plain PyTorch version against JAX's qmatvec_pallas
(interpret mode), the wrapper's CPU dispatch, and the kernel backend of the
port's qlinear ops.  The CUDA kernel against the plain version is
tests/test_torch_cuda.py.

Tolerance: none.  Every quantized product lies on the 2^-frac grid and
every partial sum stays under 2^24 grid units, so the float32 sums are
exact in any order and the outputs are bit-identical.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from qmann_tpu.numerics import QFormat as JQ  # noqa: E402
from qmann_tpu.ops.pallas.qkernels import qmatvec_pallas  # noqa: E402
from qmann_tpu_torch.numerics import QFormat  # noqa: E402
from qmann_tpu_torch.ops import qlinear  # noqa: E402
from qmann_tpu_torch.ops.cuda import qmatvec as qmv  # noqa: E402


def _operands(rng, B, O, I, counts):
    w = rng.normal(0.0, 1.5, (O, I)).astype(np.float32)
    if counts:   # bag-of-words rows, as the embeddings take them
        x = rng.integers(0, 4, (B, I)).astype(np.float32)
    else:
        x = rng.normal(0.0, 1.5, (B, I)).astype(np.float32)
    return w, x


@pytest.mark.parametrize("fmt_w,fmt_x", [((5, 2), (2, 5)), ((2, 5), (2, 5)),
                                         ((6, 1), (6, 1)), ((0, 0), (2, 5)),
                                         ((5, 2), (0, 0))])
@pytest.mark.parametrize("B,O,I,counts", [(19, 13, 21, False),
                                          (7, 60, 29, True),
                                          (33, 5, 3, False)])
def test_plain_matches_pallas_kernel(rng, fmt_w, fmt_x, B, O, I, counts):
    """Formats iwl 2/5/6, the binary format on either operand (0 -> +1),
    ragged shapes that fill no tile."""
    w, x = _operands(rng, B, O, I, counts)
    want = qmatvec_pallas(jnp.asarray(w), jnp.asarray(x), JQ(*fmt_w),
                          JQ(*fmt_x), interpret=True)
    got = qmv.quantized_matvec_reference(torch.from_numpy(w),
                                         torch.from_numpy(x),
                                         QFormat(*fmt_w), QFormat(*fmt_x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrapper_on_cpu_never_builds(rng, monkeypatch):
    def no_build():
        raise AssertionError("the CPU path must not touch the CUDA build")
    monkeypatch.setattr(qmv, "build", no_build)
    monkeypatch.setattr(qmv, "load_library", no_build)
    w, x = (torch.from_numpy(a) for a in _operands(rng, 9, 6, 11, True))
    before = qmv.quantized_matvec.launches
    got = qmv.quantized_matvec(w, x, QFormat(5, 2), QFormat(5, 2))
    want = qmv.quantized_matvec_reference(w, x, QFormat(5, 2), QFormat(5, 2))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert qmv.quantized_matvec.launches == before


@pytest.mark.parametrize("fmt", [QFormat(5, 2), QFormat(0, 0)])
def test_kernel_backend_matches_plain(rng, fmt):
    """qmatvec with leading batch dims, qembed_mat and qembed_mat_multi on
    the kernel backend (the plain version on the CPU) equal the plain
    lattice, the binary format's XNOR scale included."""
    w = torch.from_numpy(rng.normal(0.0, 1.5, (8, 11)).astype(np.float32))
    x = torch.from_numpy(rng.integers(0, 3, (2, 5, 11)).astype(np.float32))
    a = torch.from_numpy(rng.normal(0.0, 1.5, (8, 11)).astype(np.float32))
    got = qlinear.qmatvec(w, x, fmt, QFormat(5, 2), backend="kernel")
    want = qlinear.qmatvec(w, x, fmt, QFormat(5, 2), backend="plain")
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    got = qlinear.qembed_mat(x, a, fmt, backend="kernel")
    want = qlinear.qembed_mat(x, a, fmt, backend="plain")
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    got = qlinear.qembed_mat_multi(x, [w, a], [fmt, QFormat(6, 1)],
                                   backend="kernel")
    want = qlinear.qembed_mat_multi(x, [w, a], [fmt, QFormat(6, 1)])
    for g, wnt in zip(got, want):
        torch.testing.assert_close(g, wnt, rtol=0, atol=0)


def test_unknown_backend_raises():
    w = torch.zeros((3, 4))
    with pytest.raises(ValueError, match="backend"):
        qlinear.qmatvec(w, torch.zeros((2, 4)), QFormat(5, 2), QFormat(5, 2),
                        backend="pallas")


def _fast_quant(x, fmt):
    """The device's compile-time quantizer (csrc/qformat.cuh, FastQ) in
    torch: one multiply, one rounding of the fixed kind, one multiply and a
    NaN-propagating clamp to [-maxf, maxf] (torch.maximum / minimum keep
    NaN, as PTX max.NaN / min.NaN do); no +-2^31 clamp, no INT_MIN wrap,
    and saturation decided on the rounded value, not on x."""
    from qmann_tpu_torch.numerics import fixed_max_float
    rnd = (torch.floor, torch.ceil, torch.round, torch.trunc)[fmt.mode]
    maxf = torch.tensor(fixed_max_float(fmt.iwl, fmt.frac))
    deq = rnd(x * (2.0 ** fmt.frac)) * (2.0 ** -fmt.frac)
    return torch.minimum(torch.maximum(deq, -maxf), maxf)


def _edge_values(fmt):
    """+-maxf, the floats just beyond and just inside, +-2^31/2^frac and
    its neighbours, +-inf, NaN, +-0.0, tiny and denormal values, the grid's
    half steps (ties) and points beside them, and a Gaussian spread."""
    from qmann_tpu_torch.numerics import fixed_max_float
    f32 = np.float32
    maxf = f32(fixed_max_float(fmt.iwl, fmt.frac))
    big = f32(2.0 ** (31 - fmt.frac))
    step = f32(2.0 ** -fmt.frac)
    pts = [maxf, np.nextafter(maxf, f32(np.inf)),
           np.nextafter(maxf, f32(0)), big, np.nextafter(big, f32(np.inf)),
           np.nextafter(big, f32(0)), f32(np.inf), f32(np.nan), f32(0.0),
           f32(1e-45), f32(1e-38), f32(3e-9), f32(1e30), f32(3e38)]
    for k in (0.5, 1.5, 2.5, 3.0, 7.5):
        v = f32(k * step)
        pts += [v, np.nextafter(v, f32(0)), np.nextafter(v, f32(np.inf))]
    spread = np.random.default_rng(fmt.iwl * 64 + fmt.frac).normal(
        0.0, 2.0 ** fmt.iwl, 256).astype(np.float32)
    vals = np.concatenate([np.array(pts, np.float32), spread])
    return torch.from_numpy(np.concatenate([vals, -vals]))


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_fast_quant_formula_equals_float_quant(mode):
    """The argument of csrc/qformat.cuh: for every (iwl, frac) with
    1 <= iwl+frac <= 30 the formula without fq's clamp and wrap, with the
    saturation as a clamp of the rounded value, equals float_quant bit for
    bit (NaN where float_quant gives NaN)."""
    from qmann_tpu_torch.numerics import float_quant
    for n in range(1, 31):
        for iwl in range(n + 1):
            fmt = QFormat(iwl, n - iwl, mode)
            x = _edge_values(fmt)
            got, want = _fast_quant(x, fmt), float_quant(x, fmt)
            nan = torch.isnan(want)
            assert torch.equal(torch.isnan(got), nan), fmt
            assert torch.equal(got[~nan].view(torch.int32),
                               want[~nan].view(torch.int32)), fmt


def _rows_taken(geo, B):
    """How many times the whole-row kernel's warps take each row: block b
    owns rows [b*R, min((b+1)*R, B)) with R = rows_per_block, and its warp
    k takes rows b*R + k, b*R + k + WARPS, ... of them."""
    R, taken = geo.rows_per_block, np.zeros(B, np.int64)
    blocks = np.arange(-(-B // R))[:, None]
    first = blocks * R + np.arange(qmv.WARPS)          # [block, warp]
    end = np.minimum((blocks + 1) * R, B)
    for step in range(0, R, qmv.WARPS):
        rows = first + step
        np.add.at(taken, rows[rows < end], 1)
    return taken


@pytest.mark.parametrize("O,I", [(1, 1), (60, 29), (60, 60), (60, 114),
                                 (1, 6144), (203, 60), (4095, 3),
                                 (6143, 1)])
def test_qmatvec_geometry_covers_every_row_once(O, I):
    """For every B from 1 to 2100 (and 4224, 4225, 10240, 10241, 100000)
    at shapes up to the operand limit O*I + I <= 12288: the blocks' warps
    take each row exactly once; the rows per block are a multiple of the
    warps, one row a warp while the grid fits the card's resident blocks,
    else as few as keep the grid within them, but for MAX_ROWS (a block's
    Q(w) is then paid for at most about MAX_ROWS rows); Q(w)^T (row stride
    O, odd where it fits), its NaN bits and the warps' lists fit the
    227 KB a block may ask for."""
    assert O * I + I <= qmv.MAX_SMEM_FLOATS
    words = -(-I // 32)
    odd_fits = I * (O | 1) + words <= qmv.MAX_SMEM_FLOATS
    ld = qmv.wq_stride(O, I)
    assert ld == (O | 1 if odd_fits else O)
    smem = 4 * (((I * ld + words + 1) & ~1)
                + qmv.WARPS * 32 * qmv.CHUNKS * 2)
    assert smem == qmv.whole_row_smem_bytes(O, I) <= 227 * 1024
    for B in [*range(1, 2101), 4224, 4225, 10240, 10241, 100000]:
        geo = qmv.qmatvec_geometry(B, O, I)
        R = geo.rows_per_block
        assert (geo.o_tile, geo.i_tile) == (O, I)
        assert R % qmv.WARPS == 0
        assert (geo.blocks - 1) * R < B <= geo.blocks * R
        warp_rows = -(-B // qmv.WARPS)
        if warp_rows <= qmv.RESIDENT_BLOCKS:
            assert R == qmv.WARPS
        else:
            assert R <= qmv.MAX_ROWS + qmv.WARPS
            assert geo.blocks <= max(qmv.RESIDENT_BLOCKS,
                                     -(-B // qmv.MAX_ROWS))
            assert (geo.blocks > qmv.RESIDENT_BLOCKS
                    or R == qmv.WARPS * -(-warp_rows // qmv.RESIDENT_BLOCKS))
        if B <= 2100 or B == 10241:
            assert (_rows_taken(geo, B) == 1).all()
        assert geo.smem_bytes == smem
    # the flagship's query embedding and memory embedding, an evaluation
    # chunk's: one row a warp, then two
    assert qmv.qmatvec_geometry(32, 60, 29)[:4] == (8, 60, 29, 4)
    assert qmv.qmatvec_geometry(320, 60, 29)[:4] == (8, 60, 29, 40)
    assert qmv.qmatvec_geometry(10240, 60, 29)[:4] == (16, 60, 29, 640)


@pytest.mark.parametrize("O,I", [(60, 202), (60, 256), (60, 1024), (1, 6145),
                                 (203, 6145), (257, 48), (600, 300),
                                 (5000, 3)])
def test_tiled_qmatvec_geometry_covers_every_output_once(O, I):
    """Past O*I + I = 12288 floats: O-tiles of at most THREADS outputs,
    I-tiles of at most MAX_I_TILE; the rows per block follow the
    whole-row rule on the O-tile; each block's (rows x o_tile) outputs fit
    MAX_OUTPUTS per thread, its Q(w) and Q(x) tiles (odd row stride) fit
    48 KB; the grid covers every output (b, o) exactly once and the I-tiles
    every column."""
    assert O * I + I > qmv.MAX_SMEM_FLOATS
    for B in (1, 7, 32, 2048, 2049, 65536, 100001):
        geo = qmv.qmatvec_geometry(B, O, I)
        R, TO, TI = geo.rows_per_block, geo.o_tile, geo.i_tile
        assert TO == min(O, qmv.THREADS) and 1 <= TI <= qmv.MAX_I_TILE
        assert R * TO <= qmv.MAX_OUTPUTS * qmv.THREADS
        assert geo.smem_bytes == 4 * (TO + R) * (TI | 1) <= 48 * 1024
        o_blocks = -(-O // TO)
        assert geo.blocks == -(-B // R) * o_blocks
        base = max(1, min(32, qmv.THREADS // TO))
        tiles = 1
        while (tiles < qmv.MAX_TILES
               and -(-B // (base * tiles)) * o_blocks > qmv.RESIDENT_BLOCKS):
            tiles *= 2
        assert R == base * tiles
        if B <= 2049:
            covered = np.zeros((B, O), np.int64)
            for bx in range(-(-B // R)):
                for by in range(o_blocks):
                    covered[bx * R:(bx + 1) * R, by * TO:(by + 1) * TO] += 1
            assert (covered == 1).all()
        cols = np.zeros(I, np.int64)
        for i0 in range(0, I, TI):
            cols[i0:i0 + TI] += 1
        assert (cols == 1).all()
    # the joint block's memory embedding: 4 rows x 60 outputs per block
    assert qmv.qmatvec_geometry(2048, 60, 256)[:3] == (4, 60, 64)


def _walk(w, x, fmt_w, fmt_x, skip):
    """The whole-row kernel's sum in torch: out[b, o] = Q(acc) with acc
    from +0, adding Q(Q(w[o, i]) * Q(x[b, i])) in order of i over the
    entries it takes: with ``skip``, those whose Q(x) is nonzero (NaN
    included) or whose column of Q(w) holds a NaN (the ballot's mask),
    else every entry."""
    from qmann_tpu_torch.numerics import float_quant
    wq, xq = float_quant(w, fmt_w), float_quant(x, fmt_x)
    take = torch.ones(xq.shape, dtype=torch.bool)
    if skip:
        take = (xq != 0) | torch.isnan(wq).any(0)
    acc = torch.zeros((x.shape[0], w.shape[0]), dtype=torch.float32)
    for i in range(x.shape[1]):
        prod = float_quant(wq[:, i] * xq[:, i, None], fmt_w)
        acc = torch.where(take[:, i, None], acc + prod, acc)
    return float_quant(acc, fmt_w)


def _same_bits(a, b):
    nan = torch.isnan(a)
    return (torch.equal(nan, torch.isnan(b))
            and torch.equal(a[~nan].view(torch.int32),
                            b[~nan].view(torch.int32)))


def _walk_case(case, rng, mode):
    """(w, x, fmt_w, fmt_x) of one case of the zero-skip walk."""
    f = QFormat(5, 2, mode)
    w = rng.normal(0.0, 1.5, (60, 114)).astype(np.float32)
    x = np.zeros((40, 114), np.float32)      # bag-of-words, dead rows
    for b in range(0, 40, 2):
        x[b, rng.integers(0, 64, 6)] += 1.0
        x[b, 64 + b % 50] = 1.0
    if case == "dense":                      # a hop's linear map
        w = rng.normal(0.0, 1.5, (60, 60)).astype(np.float32)
        x = rng.normal(0.0, 1.5, (40, 60)).astype(np.float32)
    elif case == "tiny":                     # Q(x) rounds them to +-0
        x = x * np.float32(0.3) + rng.normal(0.0, 1e-3, x.shape).astype(
            np.float32) * (rng.random(x.shape) < 0.2)
    elif case == "negative":                 # -0 products: sign of zero
        w = -np.abs(w)
        x = -x
    elif case == "nan_w":                    # a NaN where x is zero
        w[7, 100] = np.nan
        w[3, 113] = np.nan
    elif case == "nan_x":
        x[4, 9] = np.nan
    elif case == "mixed":
        return (torch.from_numpy(w), torch.from_numpy(x), QFormat(6, 1, mode),
                QFormat(2, 5, mode))
    elif case == "wide":                     # 30-bit words: inexact sums
        w = rng.normal(0.0, 30.0, (60, 114)).astype(np.float32)
        x = x * np.float32(97.3)
        return (torch.from_numpy(w), torch.from_numpy(x),
                QFormat(12, 18, mode), QFormat(12, 18, mode))
    return torch.from_numpy(w), torch.from_numpy(x), f, f


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
@pytest.mark.parametrize("case", ["bow", "dense", "tiny", "negative",
                                  "nan_w", "nan_x", "mixed", "wide"])
def test_zero_skip_walk_equals_the_dense_sum(case, mode):
    """The argument of csrc/qmatvec.cu: leaving out the entries with
    Q(x) == +-0 whose column of Q(w) holds no NaN changes no bit of the
    in-order sum (acc starts at +0 and never becomes -0, so adding +-0
    leaves it as it is), on bag-of-words rows with dead rows, dense rows,
    tiny x that Q rounds to zero, negative weights against zeros, a NaN
    in Q(w) on a column where x is zero (NaN, as the dense sum), a NaN in
    x, mixed formats and 30-bit words, whose sums are not exact; with
    words of 8 bits it equals the plain lattice too."""
    rng = np.random.default_rng(["bow", "dense", "tiny", "negative",
                                 "nan_w", "nan_x", "mixed",
                                 "wide"].index(case) * 4 + mode)
    w, x, fmt_w, fmt_x = _walk_case(case, rng, mode)
    got = _walk(w, x, fmt_w, fmt_x, skip=True)
    assert _same_bits(got, _walk(w, x, fmt_w, fmt_x, skip=False))
    if case != "wide":
        want = qmv.quantized_matvec_reference(w, x, fmt_w, fmt_x)
        assert _same_bits(got, want)
    if case == "nan_w":
        assert torch.isnan(got[:, [3, 7]]).all()
    if case == "negative":
        assert not torch.signbit(got[1::2]).any()   # dead rows: +0


@pytest.mark.parametrize("fmt_w,fmt_x,O,I,skips", [
    (QFormat(5, 2, 3), QFormat(5, 2, 3), 60, 114, True),   # the family
    (QFormat(1, 6, 3), QFormat(1, 6, 3), 60, 29, True),    # mode 3, iwl 1
    (QFormat(6, 1, 0), QFormat(2, 5, 0), 60, 60, True),    # mixed widths
    (QFormat(12, 18, 2), QFormat(12, 18, 2), 60, 29, True),  # 30 bits
    (QFormat(0, 0, 3), QFormat(5, 2, 3), 60, 29, False),   # binary w
    (QFormat(5, 2, 3), QFormat(0, 0, 3), 60, 60, False),   # binary x
    (QFormat(1, 30, 3), QFormat(5, 2, 3), 60, 29, False),  # 31 bits: AnyQ
    (QFormat(5, 2, 1), QFormat(5, 2, 2), 60, 29, False),   # mixed modes
    (QFormat(5, 2, 3), QFormat(5, 2, 3), 60, 256, False),  # tiled
])
def test_which_launches_skip_zero_entries(fmt_w, fmt_x, O, I, skips):
    """``sparse_launches`` counts the route that skips the zero entries of
    Q(x): the whole-row kernel on the compile-time quantizer, chosen by
    the formats and the shape alone; binary and 31-bit formats (AnyQ)
    keep the dense loop, and the tiled kernel is dense."""
    geo = qmv.qmatvec_geometry(33, O, I)
    assert qmv.skips_zeros(geo, O, I, fmt_w, fmt_x) is skips
