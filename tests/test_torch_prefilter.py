"""The prefilter as a banded solve: ``spline_band_factors``, the plain sweep
that the CUDA kernel (``ops/csrc/spline_prefilter.cu``) is held against, and
``prefilter``'s choice between the kernel and the dense matmuls, on the CPU.

The kernel itself runs only on the card (``chip_smoke.py`` phase 3d holds it
against the dense float64 path and this plain sweep).  Inputs are made with
numpy seeds.
"""
import numpy as np
import pytest
import torch

from lagrangiancoherence_tpu_torch.ops import cuda_prefilter as CP
from lagrangiancoherence_tpu_torch.ops import interp as TI

torch.set_num_threads(1)

SIZES = (2, 3, 4, 5, 8, 33, 721, 1440)


@pytest.mark.parametrize("n", SIZES)
def test_band_factors_rebuild_the_band(n):
    """L @ U is the mirrored forward band that ``spline_filter_matrix``
    inverts, and the factors are cached read-only float64."""
    f = TI.spline_band_factors(n, 3)
    assert f.shape == (3, n) and f.dtype == np.float64
    assert not f.flags.writeable and TI.spline_band_factors(n, 3) is f
    lower = np.eye(n) + np.diag(f[0, 1:], -1)
    upper = np.diag(1.0 / f[1]) + np.diag(f[2, :-1], 1)
    band = TI._spline_forward_band(n, 3)
    np.testing.assert_allclose(lower @ upper, band, rtol=0, atol=1e-15)
    assert f[0, 0] == 0.0 and f[2, -1] == 0.0
    np.testing.assert_allclose(np.linalg.inv(band),
                               TI.spline_filter_matrix(n, 3), rtol=0,
                               atol=0)


def test_band_factors_orders():
    """Order 3 only; n < 2 is the identity, as in ``spline_filter_matrix``."""
    np.testing.assert_array_equal(TI.spline_band_factors(1, 3),
                                  [[0.0], [1.0], [0.0]])
    for order in (2, 4, 5):
        with pytest.raises(NotImplementedError, match="covers order 3"):
            TI.spline_band_factors(8, order)


@pytest.mark.parametrize("ny,nx", [(2, 3), (5, 8), (8, 5), (9, 16), (33, 40),
                                   (721, 6), (4, 1440)])
def test_plain_sweep_matches_the_dense_inverse(ny, nx):
    """float64: each axis's sweep equals ``spline_filter_matrix(n, 3)`` on
    that axis, and both together the dense prefilter, within 1e-13 of the
    field's largest value (odd and even sizes, the mirrored edges)."""
    rng = np.random.RandomState(ny * 1000 + nx)
    x = rng.randn(3, ny, nx)
    xt = torch.tensor(x)
    by = torch.tensor(TI.spline_band_factors(ny))
    bx = torch.tensor(TI.spline_band_factors(nx))
    scale = np.abs(x).max()
    along_y = CP.solve_band_torch(xt, by, -2).numpy()
    along_x = CP.solve_band_torch(xt, bx, -1).numpy()
    my, mx = TI.spline_filter_matrix(ny, 3), TI.spline_filter_matrix(nx, 3)
    assert np.abs(along_y - my @ x).max() <= 1e-13 * scale
    assert np.abs(along_x - x @ mx.T).max() <= 1e-13 * scale
    both = CP.spline_prefilter_torch(xt, by, bx).numpy()
    assert np.abs(both - my @ x @ mx.T).max() <= 1e-13 * scale


@pytest.mark.parametrize("call", ["first", "repeated"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("order", [2, 3, 4, 5])
def test_prefilter_on_the_cpu_is_the_dense_path(order, dtype, call):
    """On the CPU ``prefilter`` is ``prefilter_dense``: the two dense
    matmuls by ``spline_filter_matrix`` exactly, and it launches nothing.
    A first call builds the two operators; a repeated call builds none."""
    rng = np.random.RandomState(order)
    field = torch.tensor(rng.randn(2, 3, 11, 24), dtype=dtype)
    my = torch.tensor(TI.spline_filter_matrix(11, order), dtype=dtype)
    mx = torch.tensor(TI.spline_filter_matrix(24, order), dtype=dtype)
    want = torch.matmul(torch.matmul(my, field), mx.transpose(0, 1))
    if call == "first":
        TI._operator.cache_clear()
    else:
        TI.prefilter_dense(field, order)
    built = TI._operator.cache_info().misses
    before = CP.LAUNCHES
    assert torch.equal(TI.prefilter(field, order), want)
    assert torch.equal(TI.prefilter_dense(field, order), want)
    assert CP.LAUNCHES == before
    built = TI._operator.cache_info().misses - built
    assert built == (2 if call == "first" else 0)


@pytest.mark.parametrize("device_type,order,dtype,banded", [
    ("cuda", 3, torch.float32, True),
    ("cuda", 3, torch.float64, True),
    ("cuda", 3, torch.float16, False),
    ("cuda", 3, torch.bfloat16, False),
    ("cuda", 2, torch.float32, False),
    ("cuda", 5, torch.float64, False),
    ("cpu", 3, torch.float32, False),
    ("cpu", 3, torch.float64, False)])
def test_prefilter_takes_the_kernel_by_what_it_sees(device_type, order,
                                                    dtype, banded):
    """The banded kernel runs on a CUDA tensor at order 3 in float32 or
    float64, and nowhere else."""
    assert TI._band_solve_applies(device_type, order, dtype) is banded


def test_wrapper_refuses_what_the_kernel_does_not_take():
    by = torch.tensor(TI.spline_band_factors(5))
    bx = torch.tensor(TI.spline_band_factors(6))
    x = torch.zeros(2, 5, 6, dtype=torch.float64)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        CP.spline_prefilter(x, by, bx)
    with pytest.raises(ValueError, match="must be contiguous"):
        CP.spline_prefilter(torch.zeros(2, 6, 5, dtype=torch.float64)
                            .transpose(1, 2), by, bx)
    with pytest.raises(TypeError, match="dtype torch.float16 not supported"):
        CP.spline_prefilter(x.half(), by, bx)
    with pytest.raises(ValueError, match=r"needs \(\.\.\., ny, nx\)"):
        CP.spline_prefilter(torch.zeros(6, dtype=torch.float64), by, bx)


@pytest.mark.parametrize("n", [9, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_band_factors_are_uploaded_once(n, dtype):
    """``prefilter``'s factors: ``spline_band_factors`` in the field's
    dtype on its device, one tensor a (size, dtype, device)."""
    kw = dict(order=3, dtype=dtype, device=torch.device("cpu"))
    band = TI._operator(TI.spline_band_factors, n, **kw)
    assert TI._operator(TI.spline_band_factors, n, **kw) is band
    assert band.dtype == dtype and band.shape == (3, n)
    np.testing.assert_array_equal(
        band.numpy(), TI.spline_band_factors(n).astype(band.numpy().dtype))
