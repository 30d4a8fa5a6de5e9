"""Port parity of the whole slice: lagrangiancoherence_tpu_torch's
``ftle_pipeline`` / ``FTLEPipeline`` against the JAX package and the scipy
oracle, on the CPU.

Bounds:
* float64 FTLE within 1e-5 of JAX and of the oracle, relative to the
  field's largest value (the JAX package's own oracle bound,
  tests/test_ftle.py).  Positions agree to ~1e-13, but the stencil stage
  runs in float32 (quirk Q6, ops/stencil.py), where X, Y, Z ~ 6.4e6 m: a
  1e-13 position difference can flip the last float32 bit of one sample;
* on the global grid, the rows whose FTLE reads an exact-pole home row
  (the stencil reaches 2 rows, so rows 0-2 and the last 3) are left out of
  that bound, and with ``sigma`` the band widens by the Gaussian's radius:
  there conv_x = conv_y/|cos(+-90 deg)| ~ 1.5e11 deg/(m/s)
  turns a 1e-16 m/s wind difference into ~0.3 deg per step, so even the
  JAX package and the oracle end ~120 deg apart on those rows.  Their
  positions are checked to stay in bounds, and the next rows in to 1e-10;
* float32 end to end: p99 |dlog-FTLE| <= 1.5e-3 against the JAX float32
  pipeline (the committed f32 bound, BASELINE.md).
"""
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lagrangiancoherence_tpu.grid import Grid as JaxGrid
from lagrangiancoherence_tpu.models import ftle as JF
from lagrangiancoherence_tpu.models.pipeline import \
    ftle_pipeline as jax_ftle_pipeline
from lagrangiancoherence_tpu.models.settls import \
    parcel_propagation_core as jax_propagation
from lagrangiancoherence_tpu.ops.interp import spline_filter_matrix
from lagrangiancoherence_tpu.testing import flows
from lagrangiancoherence_tpu.testing import oracle as O
from lagrangiancoherence_tpu_torch import FTLEPipeline, ftle_pipeline
from lagrangiancoherence_tpu_torch.convert import (grid_from_jax,
                                                   tensors_from_numpy)
from lagrangiancoherence_tpu_torch.models import ftle as TF
from lagrangiancoherence_tpu_torch.models.settls import \
    parcel_propagation_core
from lagrangiancoherence_tpu_torch.ops import cuda_interp

torch.set_num_threads(1)

FTLE_RTOL = 1e-5
LOG_FTLE_P99_BOUND = 1.5e-3
DT = -6 * 3600.0
SETTLS_ORDER = 1


def _vortex():
    """The ideal vortex of tests/test_settls.py:12-15 (no exact pole rows)."""
    cfg = dict(flows.VORTEX_CONFIG_SUBTROPICAL)
    cfg.update(dx=4, dy=4, nt=5)
    u, v, lats, lons, _ = flows.ideal_vortex(**cfg)
    return u, v, lats, lons


def _global():
    """A small global grid whose first and last rows sit exactly on the
    poles, where conv_x = 1/cos(lat) flings the pole-home rows."""
    ny, nx, nt = 19, 36, 4
    lats = np.linspace(-90.0, 90.0, ny)
    lons = np.linspace(-180.0, 170.0, nx)
    LON, LAT = np.meshgrid(np.deg2rad(lons), np.deg2rad(lats))
    t = np.arange(nt)[:, None, None]
    u = (25.0 * np.cos(LAT) + 3.0 * np.cos(3 * LON) * np.sin(2 * LAT))[None] \
        * (1.0 + 0.05 * np.sin(2 * np.pi * t / nt))
    v = (3.0 * np.sin(3 * LON) * np.cos(2 * LAT))[None] \
        * (1.0 + 0.05 * np.cos(2 * np.pi * t / nt))
    return u, v, lats, lons


CASES = {"vortex": _vortex, "global": _global}


def _rows(case, sigma=None):
    """FTLE rows compared at FTLE_RTOL (see the module note on exact-pole
    rows); smoothing widens the band by the Gaussian's radius."""
    if case == "vortex":
        return slice(None)
    r = 3 + (0 if sigma is None else int(4.0 * sigma + 0.5))
    return slice(r, -r)


@lru_cache(maxsize=None)
def _jax_departures(case, nan_wind=False):
    """JAX departure points, one jit compile per grid."""
    u, v, lats, lons = _winds(case, nan_wind)
    px, py = jax_propagation(jnp.asarray(u), jnp.asarray(v), DT,
                             JaxGrid(lats=lats, lons=lons, cyclic_x=True),
                             settls_order=SETTLS_ORDER, interp_order=3)
    return px, py


def _jax_ftle(px, py, grid, sigma=None, compat=True):
    """The JAX pipeline's last two stages, as models/pipeline.py:54-55
    composes them (eager: the jitted ftle_from_departures cannot take
    ``sigma``, a traced argument)."""
    return np.asarray(JF.ftle_norm(JF.flowmap_gradient(px, py, grid,
                                                       sigma=sigma),
                                   compat=compat))


def _winds(case, nan_wind=False):
    u, v, lats, lons = CASES[case]()
    if nan_wind:
        u = u.copy()
        u[2, 9, 20] = np.nan
    return u, v, lats, lons


def _assert_rel(got, want, rtol=FTLE_RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    scale = np.nanmax(np.abs(want))
    assert np.nanmax(np.abs(got - want)) <= rtol * scale, (
        np.nanmax(np.abs(got - want)), scale)


@pytest.mark.parametrize("sigma", [None, 0.7])
@pytest.mark.parametrize("compat", [True, False])
@pytest.mark.parametrize("case", ["vortex", "global"])
def test_pipeline_matches_jax(case, compat, sigma):
    u, v, lats, lons = _winds(case)
    jgrid = JaxGrid(lats=lats, lons=lons, cyclic_x=True)
    px, py = _jax_departures(case)
    want = _jax_ftle(px, py, jgrid, sigma=sigma, compat=compat)
    got, flag = ftle_pipeline(
        torch.tensor(u), torch.tensor(v), DT, grid_from_jax(jgrid),
        settls_order=SETTLS_ORDER, interp_order=3, sigma=sigma,
        compat=compat, return_overflow=True)
    assert got.dtype == torch.float64 and got.shape == u.shape[1:]
    assert int(flag) == 0
    rows = _rows(case, sigma)
    _assert_rel(got.numpy()[rows], want[rows])


@pytest.mark.parametrize("case", ["vortex", "global"])
def test_pipeline_matches_oracle(case):
    u, v, lats, lons = _winds(case)
    want = O.oracle_ftle(u, v, lats, lons, DT, settls_order=SETTLS_ORDER,
                         interp_order=3, cyclic_x=True)
    got = ftle_pipeline(u, v, DT, JaxGrid(lats=lats, lons=lons,
                                          cyclic_x=True),
                        settls_order=SETTLS_ORDER, interp_order=3,
                        device="cpu").numpy()
    _assert_rel(got[_rows(case)], want[_rows(case)])


def test_exact_pole_rows_stay_in_bounds():
    """Departure points on the global grid: every row but the two exact-pole
    home rows within 1e-10 of JAX; those two inside the domain."""
    u, v, lats, lons = _winds("global")
    jx, jy = (np.asarray(a) for a in _jax_departures("global"))
    tx, ty = parcel_propagation_core(u, v, DT, grid_from_jax(JaxGrid(
        lats=lats, lons=lons, cyclic_x=True)), settls_order=SETTLS_ORDER,
        device="cpu")
    tx, ty = tx.numpy(), ty.numpy()
    np.testing.assert_allclose(tx[1:-1], jx[1:-1], rtol=0, atol=1e-10)
    np.testing.assert_allclose(ty[1:-1], jy[1:-1], rtol=0, atol=1e-10)
    assert ((tx >= -180.0) & (tx < 180.0)).all()
    assert ((ty >= -90.0) & (ty <= 90.0)).all()


def test_nan_wind_propagates_like_jax():
    """A NaN wind sample poisons the parcels that read it; the norm keeps
    NaN exactly where the JAX pipeline does (ftle.py:92)."""
    u, v, lats, lons = _winds("vortex", nan_wind=True)
    jgrid = JaxGrid(lats=lats, lons=lons, cyclic_x=True)
    px, py = _jax_departures("vortex", nan_wind=True)
    want = _jax_ftle(px, py, jgrid)
    got = ftle_pipeline(u, v, DT, jgrid, settls_order=SETTLS_ORDER,
                        device="cpu").numpy()
    assert np.isnan(want).any() and not np.isnan(want).all()
    _assert_rel(got, want)


def test_float32_pipeline_vs_jax_float32():
    u, v, lats, lons = _global()
    grid = JaxGrid(lats=lats, lons=lons, cyclic_x=True)
    with jax.enable_x64(False):
        want = np.asarray(jax_ftle_pipeline(
            jnp.asarray(u, jnp.float32), jnp.asarray(v, jnp.float32), DT,
            grid, settls_order=2, interp_order=3, kernel="xla"))
    got = ftle_pipeline(torch.tensor(u, dtype=torch.float32),
                        torch.tensor(v, dtype=torch.float32), DT, grid,
                        settls_order=2, interp_order=3).numpy()
    assert got.dtype == np.float32
    mask = np.isfinite(want) & np.isfinite(got) & (want > 0) & (got > 0)
    mask[:4] = mask[-4:] = False     # the order-1/'constant' pole band
    err = np.abs(np.log(got[mask]) - np.log(want[mask]))
    assert float(np.percentile(err, 99)) <= LOG_FTLE_P99_BOUND


@pytest.mark.parametrize("compat", [True, False])
def test_ftle_norm_and_nan_mask_match_jax(compat):
    rng = np.random.RandomState(11)
    tensor = rng.normal(size=(9, 6, 7))
    tensor[6:] = 0.0
    tensor[2, 1, 1] = np.nan
    want = np.asarray(JF.ftle_norm(jnp.asarray(tensor), compat=compat))
    got = TF.ftle_norm(torch.tensor(tensor), compat=compat).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-14, equal_nan=True)
    assert np.isnan(got[1, 1]) and np.isfinite(np.delete(got, 8)).all()


@pytest.mark.parametrize("sigma", [None, 1.2, 9.0])
def test_flowmap_gradient_matches_jax(sigma):
    """Includes a Gaussian radius wider than the grid (9.0 * 4 > 11 rows),
    where scipy's 'reflect' padding folds more than once."""
    rng = np.random.RandomState(4)
    lats = np.linspace(-80, 80, 11)
    lons = np.linspace(-180, 160, 18)
    grid = JaxGrid(lats=lats, lons=lons, cyclic_x=True)
    px0, py0 = np.meshgrid(lons, lats)
    px = px0 + rng.uniform(-3, 3, px0.shape)
    py = np.clip(py0 + rng.uniform(-3, 3, py0.shape), -80, 80)
    want = np.asarray(JF.flowmap_gradient(jnp.asarray(px), jnp.asarray(py),
                                          grid, sigma=sigma))
    got = TF.flowmap_gradient(torch.tensor(px), torch.tensor(py), grid,
                              sigma=sigma).numpy()
    _assert_rel(got, want)


def test_convert_round_trip():
    """Grid, winds and the JAX package's prefilter matrices cross as numpy
    arrays; a module loaded with them computes the same field."""
    u, v, lats, lons = _vortex()
    jgrid = JaxGrid(lats=lats, lons=lons, cyclic_x=True)
    grid = grid_from_jax(jgrid)
    assert grid.shape == jgrid.shape and grid.cyclic_x
    np.testing.assert_array_equal(grid.mesh_xy[0], jgrid.mesh_xy[0])
    np.testing.assert_array_equal(grid.mesh_xy[1], jgrid.mesh_xy[1])
    tu, tv = tensors_from_numpy((jnp.asarray(u), v), "cpu", torch.float64)
    d = tensors_from_numpy({"u": u}, "cpu")
    assert torch.equal(tu, torch.tensor(u)) and torch.equal(d["u"], tu)
    np.testing.assert_array_equal(tv.numpy(), v)

    model = FTLEPipeline(grid, settls_order=SETTLS_ORDER, dtype=torch.float64,
                         device="cpu")
    ny, nx = grid.shape
    model.load_numpy_state({"prefilter_y": spline_filter_matrix(ny, 3),
                            "prefilter_x": spline_filter_matrix(nx, 3)})
    np.testing.assert_array_equal(model.prefilter_x.numpy(),
                                  spline_filter_matrix(nx, 3))
    with pytest.raises(KeyError):
        model.load_numpy_state({"weights": np.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        model.load_numpy_state({"conv_x": np.zeros(3)})
    before = cuda_interp.LAUNCHES
    got = model(tu, tv, DT)
    assert cuda_interp.LAUNCHES == before
    want = ftle_pipeline(u, v, DT, grid, settls_order=SETTLS_ORDER,
                         device="cpu")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-13)


@pytest.mark.parametrize("truncate", [2.0, 4.0])
def test_gaussian_filter_truncate_matches_jax_and_scipy(truncate):
    """``gaussian_filter(truncate=)`` against the JAX package's and
    scipy's (mode='reflect'), float64, within 1e-13 (the same taps, summed
    in tap order)."""
    from scipy import ndimage

    from lagrangiancoherence_tpu.ops import filters as JFL
    from lagrangiancoherence_tpu_torch.ops import filters as TFL
    rng = np.random.RandomState(4)
    a = rng.randn(3, 21, 34)
    sigma = 1.7
    taps = TFL.gaussian_kernel1d(sigma, truncate)
    np.testing.assert_array_equal(taps, JFL.gaussian_kernel1d(sigma, truncate))
    assert taps.size == 2 * int(truncate * sigma + 0.5) + 1
    got = TFL.gaussian_filter(torch.tensor(a), sigma, truncate=truncate)
    want = np.asarray(JFL.gaussian_filter(jnp.asarray(a), sigma,
                                          truncate=truncate))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-13)
    ref = np.stack([ndimage.gaussian_filter(x, sigma, mode="reflect",
                                            truncate=truncate) for x in a])
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-13)
    if truncate == 4.0:
        assert torch.equal(got, TFL.gaussian_filter(torch.tensor(a), sigma))


@pytest.mark.parametrize("name", ["global_half_degree_grid",
                                  "global_quarter_degree_grid"])
def test_global_grids_match_jax(name):
    import lagrangiancoherence_tpu.grid as JG
    import lagrangiancoherence_tpu_torch.grid as TG
    got, want = getattr(TG, name)(), getattr(JG, name)()
    np.testing.assert_array_equal(got.lats, want.lats)
    np.testing.assert_array_equal(got.lons, want.lons)
    assert got.cyclic_x == want.cyclic_x and got.shape == want.shape
    for a, b in zip(got.mesh_xy, want.mesh_xy):
        np.testing.assert_array_equal(a, b)
    assert (got.x_min, got.x_max, got.y_min, got.y_max) == \
        (want.x_min, want.x_max, want.y_min, want.y_max)
    assert name in TG.__all__
