"""Port parity: lagrangiancoherence_tpu_torch.ops.interp (the plain gather that
the CUDA kernel is held against) against the JAX package's ops/interp.py, on
the CPU in float64.

Inputs are made with numpy seeds and go through both packages.  Bound:
1e-12 per interpolated value — both sides evaluate the same operations in
the same order, so what remains is the BLAS summation order of the
prefilter matmuls (~1e-14 on these O(1) fields).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lagrangiancoherence_tpu.ops import interp as JI
from lagrangiancoherence_tpu_torch.ops import interp as TI
from lagrangiancoherence_tpu_torch.ops import cuda_interp

torch.set_num_threads(1)

ATOL = 1e-12


def _grid(ny, nx):
    return (np.linspace(-90.0, 90.0, ny),
            np.linspace(-180.0, 180.0 - 360.0 / nx, nx))


def _positions(lats, lons, displacement):
    """The displacement spectra of tests/test_pallas_interp.py:23-37."""
    px0, py0 = np.meshgrid(lons, lats)
    if displacement == "smooth":
        px = px0 + 15 * np.sin(py0 / 30) + 3
        py = np.clip(py0 + 10 * np.cos(px0 / 40), -90, 90)
    elif displacement == "whirl":
        px = px0 + 700 * np.sin(py0 / 7) * np.cos(px0 / 11)
        py = np.clip(py0 + 4 * np.sin(px0 / 20), -90, 90)
    else:  # violent shear
        px = px0 + 120 * np.sin(py0 / 10) * np.cos(px0 / 15)
        py = np.clip(py0 + 60 * np.sin(px0 / 20), -90, 90)
    px = np.where(px > 180, -180 + (px % 180), px)
    return np.where(px < -180, px % 180, px), py


def _bounds(lats, lons, order):
    return dict(x_min=lons.min(), x_max=lons.max(), y_min=lats.min(),
                y_max=lats.max(), order=order)


def _both_multi(fields, coeffs, px, py, bounds):
    want = np.asarray(JI.interp_at_parcels_multi(
        jnp.asarray(fields), jnp.asarray(coeffs), jnp.asarray(px),
        jnp.asarray(py), **bounds))
    got = TI.interp_at_parcels_multi(
        torch.tensor(fields), torch.tensor(coeffs), torch.tensor(px),
        torch.tensor(py), **bounds).numpy()
    return got, want


@pytest.mark.parametrize("order", [2, 3, 4, 5])
def test_spline_filter_matrix_and_prefilter(order):
    rng = np.random.RandomState(order)
    for n in (2, 17, 72):
        np.testing.assert_allclose(TI.spline_filter_matrix(n, order),
                                   JI.spline_filter_matrix(n, order),
                                   rtol=0, atol=ATOL)
    fields = rng.randn(3, 2, 19, 40)
    want = np.asarray(JI.prefilter(jnp.asarray(fields), order=order))
    got = TI.prefilter(torch.tensor(fields), order=order).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_prefilter_refuses_tf32():
    x = torch.zeros(4, 6, dtype=torch.float32)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="prefilter needs"):
            TI.prefilter(x, order=3)
    finally:
        torch.set_float32_matmul_precision(prev)
    assert TI.prefilter(x, order=1) is x   # orders 0/1: no prefilter


@pytest.mark.parametrize("displacement", ["smooth", "whirl", "shear"])
@pytest.mark.parametrize("F", [2, 4])
@pytest.mark.parametrize("order", [0, 1, 2, 3, 4, 5])
def test_interp_at_parcels_multi_matches_jax(order, F, displacement):
    rng = np.random.RandomState(10 * order + F)
    lats, lons = _grid(37, 72)
    fields = rng.randn(F, 37, 72)
    coeffs = np.asarray(JI.prefilter(jnp.asarray(fields), order=order))
    px, py = _positions(lats, lons, displacement)
    got, want = _both_multi(fields, coeffs, px, py,
                            _bounds(lats, lons, order))
    assert got.shape == (F, 37, 72)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("order", [1, 3, 5])
def test_interp_at_parcels_single_field_matches_jax(order):
    rng = np.random.RandomState(order)
    lats, lons = _grid(25, 48)
    field = rng.randn(25, 48)
    coeffs = np.asarray(JI.prefilter(jnp.asarray(field), order=order))
    px, py = _positions(lats, lons, "shear")
    b = _bounds(lats, lons, order)
    want = np.asarray(JI.interp_at_parcels(
        jnp.asarray(field), jnp.asarray(coeffs), jnp.asarray(px),
        jnp.asarray(py), row_offset=1, **b))
    got = TI.interp_at_parcels(
        torch.tensor(field), torch.tensor(coeffs), torch.tensor(px),
        torch.tensor(py), row_offset=1, **b).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_fold_boundary_last_column():
    """The grid's own last column scales to exactly n, which folds onto the
    edge of the tap -1 mirror zone (tests_tpu/test_device_parity.py:100-138):
    a one-ulp slip in the scale chain moves the taps, a ~1e-2 jump."""
    ny, nx = 16, 128
    lats, lons = _grid(ny, nx)
    LON, LAT = np.meshgrid(np.deg2rad(lons), np.deg2rad(lats))
    u = 20.0 * np.cos(LAT) + 2.0 * np.cos(3 * LON) * np.sin(2 * LAT)
    raw = np.stack([u, 0.5 * u])
    coeffs = np.asarray(JI.prefilter(jnp.asarray(raw), order=3))
    px = np.broadcast_to(lons, (ny, nx)).copy()
    py = np.broadcast_to(lats[:, None], (ny, nx)).copy()
    got, want = _both_multi(raw, coeffs, px, py, _bounds(lats, lons, 3))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("order", [1, 3])
def test_pole_rows_far_out_and_nan_positions(order):
    """Pole-home rows at +-2**27 degrees (where the 1/cos(lat) metric flings
    them) take the 'constant' path: 0.  NaN positions give NaN on spline
    rows and 0 on pole rows, where JAX's gather fills and XLA casts
    floor(NaN) to index 0."""
    rng = np.random.RandomState(7)
    lats, lons = _grid(33, 64)
    fields = rng.randn(4, 33, 64)
    coeffs = np.asarray(JI.prefilter(jnp.asarray(fields), order=order))
    px, py = _positions(lats, lons, "smooth")
    px[:order, :9] = 2.0 ** 27
    px[-order:, :9] = -2.0 ** 27
    px[12, :5] = 2.0 ** 27           # a spline row far out too
    px[0, 20], py[-1, 21] = np.nan, np.nan
    px[10, :3] = np.nan
    py[15, 30] = np.nan
    got, want = _both_multi(fields, coeffs, px, py,
                            _bounds(lats, lons, order))
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[:, 10, :3]).all() and np.isnan(got[:, 15, 30]).all()
    assert (got[:, 0, 20] == 0).all() and (got[:, -1, 21] == 0).all()
    assert (got[:, :order, :9] == 0).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, equal_nan=True)


def test_cuda_wrapper_on_cpu_is_the_plain_version():
    """On CPU tensors the K1 wrapper windows the resident (T, 2, ny, nx)
    stacks by f0/nf and evaluates the plain version: no launch, flag 0."""
    rng = np.random.RandomState(3)
    lats, lons = _grid(21, 40)
    W = torch.tensor(rng.randn(3, 2, 21, 40))
    CW = TI.prefilter(W, order=3)
    px, py = (torch.tensor(a) for a in _positions(lats, lons, "shear"))
    b = _bounds(lats, lons, 3)
    before = cuda_interp.LAUNCHES
    for f0, nf, row_offset in ((0, 4, 0), (2, 4, 0), (4, 2, 0), (0, 4, 1)):
        rows = slice(row_offset, row_offset + 10)
        got, flag = cuda_interp.cuda_interp_multi(
            W, CW, px[rows], py[rows], f0=f0, nf=nf, row_offset=row_offset,
            **b)
        want = TI.interp_at_parcels_multi(
            W.reshape(6, 21, 40)[f0:f0 + nf],
            CW.reshape(6, 21, 40)[f0:f0 + nf], px[rows], py[rows],
            row_offset=row_offset, **b)
        assert torch.equal(got, want)
        assert flag.dtype == torch.int32 and int(flag) == 0
    assert cuda_interp.LAUNCHES == before
