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


def test_order0_tie_matches_the_oracle():
    """A 29-row grid over 10-80 degrees scales row 14 (45 degrees) to the
    Q4 index 29 * 35 / 70 = 14.5, an exact tie of the order-0 tap
    floor(f + 0.5): the port, eager JAX and scipy take row 15 there.  The
    reference here is the scipy oracle, not JAX's jitted path: under jit
    the Q4 scaling comes out as 14.499999999999998 and the tap takes row
    14 (ROADMAP.md, "Known in the reference").  This pins the port to the
    oracle, so that no change moves it toward the jitted value."""
    from lagrangiancoherence_tpu_torch.testing.oracle import \
        oracle_map_coordinates
    lats = np.linspace(10.0, 80.0, 29)
    lons = np.linspace(-180.0, 180.0 - 360.0 / 40, 40)
    field = np.random.RandomState(29).randn(29, 40)
    px, py = np.meshgrid(lons, lats)
    want = oracle_map_coordinates(field, lats, lons, px, py, order=0)
    b = _bounds(lats, lons, 0)
    got = TI.interp_at_parcels(torch.tensor(field), torch.tensor(field),
                               torch.tensor(px), torch.tensor(py),
                               **b).numpy()
    assert 29 * (lats[14] - lats[0]) / 70 == 14.5
    np.testing.assert_array_equal(got[14], want[14])
    np.testing.assert_array_equal(got, want)


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


def _per_tap_multi(fields, coeffs, px, py, *, order, row_offset=0,
                   home_rows=None, **b):
    """``interp_at_parcels_multi`` restated one tap at a time, as JAX writes
    it: every tap's F values through ``_take`` (NaN outside the grid), the
    bilinear pole pass over every parcel, and a ``where`` on the home row."""
    nf, ny, nx = fields.shape
    xi_f, yi_f = TI.scale_positions(px, py, nx=nx, ny=ny, **b)
    flat = coeffs.reshape(nf, ny * nx)
    yi, wy = TI._axis_taps(TI._fold_coord_wrap(yi_f, ny), ny, order)
    xi, wx = TI._axis_taps(TI._fold_coord_wrap(xi_f, nx), nx, order)
    interior = None
    for j in range(len(yi)):
        for k in range(len(xi)):
            w = (wy[j] * wx[k]).to(fields.dtype)
            term = w[None] * TI._take(flat, yi[j] * nx + xi[k])
            interior = term if interior is None else interior + term
    poles = TI._bilinear_constant(fields.reshape(nf, ny * nx), yi_f, xi_f,
                                  ny, nx)
    is_pole = TI._pole_rows(px.shape, order, ny, row_offset, px.device,
                            home_rows)
    return torch.where(is_pole[None], poles, interior)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("order", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("ny,nx", [(19, 36), (4, 7)])
def test_multi_gather_bit_for_bit_per_tap(ny, nx, order, dtype):
    """The gather's one NaN mask, in-place products and pole pass on the
    pole rows give the per-tap formulation's values bit for bit (NaN where
    it is NaN): whole grids, row blocks at either pole and inside, blocks
    with home rows, flat and 3-D position arrays, and positions that are
    NaN, infinite or 1e30 (folded far outside the grid on the small one)."""
    rng = np.random.RandomState(ny * 10 + order)
    b = dict(x_min=-180.0, x_max=180.0, y_min=-90.0, y_max=90.0)
    cases = [((ny, nx), 0, False), ((3, nx), 0, False),
             ((3, nx), ny - 3, False), ((3, nx), 1, False),
             ((5, 11), 0, True), ((ny * nx,), 0, False),
             ((2, 3, 4), 1, False)]
    fields = torch.tensor(rng.randn(4, ny, nx), dtype=dtype)
    coeffs = torch.tensor(rng.randn(4, ny, nx), dtype=dtype)
    for shape, row_offset, with_homes in cases:
        px = torch.tensor(rng.uniform(-400, 400, shape), dtype=dtype)
        py = torch.tensor(rng.uniform(-100, 100, shape), dtype=dtype)
        fx, fy = px.reshape(-1), py.reshape(-1)
        fx[::7], fx[3::11], fx[5::13] = float("nan"), float("inf"), 1e30
        fy[2::9], fy[4::17] = float("nan"), -1e30
        kw = dict(order=order, row_offset=row_offset, **b)
        if with_homes:
            kw["home_rows"] = torch.tensor(
                rng.randint(0, ny, (shape[0], 1)))
        got = TI.interp_at_parcels_multi(fields, coeffs, px, py, **kw)
        want = _per_tap_multi(fields, coeffs, px, py, **kw)
        assert got.shape == want.shape and got.is_contiguous()
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan), (shape, row_offset)
        assert torch.equal(got[~nan], want[~nan]), (shape, row_offset)
