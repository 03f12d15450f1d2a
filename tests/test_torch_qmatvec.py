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
