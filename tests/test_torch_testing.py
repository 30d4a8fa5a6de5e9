"""The port's ``testing/`` package against the JAX package's, on the CPU:
the analytic flows give equal arrays and the same time labels (numpy
``datetime64[ns]`` in place of ``pandas.date_range``, whose resolution
depends on the pandas version), and every oracle
function gives arrays equal to JAX's oracle on the same inputs (the same
numpy and scipy arithmetic)."""
import numpy as np
import pytest

from lagrangiancoherence_tpu.testing import flows as JF
from lagrangiancoherence_tpu.testing import oracle as JO
from lagrangiancoherence_tpu_torch.testing import flows as TF
from lagrangiancoherence_tpu_torch.testing import oracle as TO

CONFIGS = {
    "ideal_saddle": JF.SADDLE_CONFIG,
    "rotating_saddle": dict(JF.SADDLE_CONFIG, center=(-40.0, -40.0)),
    "shear_flow": JF.SHEAR_FLOW_CONFIG,
    "ideal_vortex": JF.VORTEX_CONFIG_EQUATOR,
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_flows_equal_jax(name):
    cfg = dict(CONFIGS[name], nt=6)
    got, want = getattr(TF, name)(**cfg), getattr(JF, name)(**cfg)
    for g, w in zip(got[:4], want[:4]):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    # the same instants; pandas gives its own resolution (ns or us)
    assert got[4].dtype == np.dtype("datetime64[ns]")
    np.testing.assert_array_equal(got[4], want[4].astype("datetime64[ns]"))


def test_flow_configs_equal_jax():
    for name in ("VORTEX_CONFIG_EQUATOR", "VORTEX_CONFIG_SUBTROPICAL",
                 "SADDLE_CONFIG", "SHEAR_FLOW_CONFIG"):
        assert getattr(TF, name) == getattr(JF, name)
    assert set(TF.__all__) == set(JF.__all__)
    assert TO.REFERENCE_SECONDS_PER_FIELD == JO.REFERENCE_SECONDS_PER_FIELD
    assert TO.EARTH_RADIUS == JO.EARTH_RADIUS


def _case(seed=0, ny=19, nx=24, nt=4):
    rng = np.random.RandomState(seed)
    lats = np.linspace(-80.0, 80.0, ny)
    lons = np.linspace(-180.0, 180.0 - 360.0 / nx, nx)
    u = 10.0 * rng.randn(nt, ny, nx)
    v = 5.0 * rng.randn(nt, ny, nx)
    return u, v, lats, lons


@pytest.mark.parametrize("order", [1, 3])
def test_oracle_interp_and_propagation_equal_jax(order):
    u, v, lats, lons = _case()
    px, py = np.meshgrid(lons + 1.3, lats - 0.7)
    np.testing.assert_array_equal(
        TO.oracle_map_coordinates(u[0], lats, lons, px, py, order),
        JO.oracle_map_coordinates(u[0], lats, lons, px, py, order))
    for cyclic, traj in ((True, False), (False, True)):
        kw = dict(settls_order=2, interp_order=order, cyclic_x=cyclic,
                  return_traj=traj)
        for g, w in zip(TO.oracle_parcel_propagation(u, v, lats, lons,
                                                     -3600.0, **kw),
                        JO.oracle_parcel_propagation(u, v, lats, lons,
                                                     -3600.0, **kw)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("sigma", [None, 1.0])
def test_oracle_gradient_norm_and_ftle_equal_jax(sigma):
    u, v, lats, lons = _case(1)
    xd, yd = np.meshgrid(lons, lats)
    xd = xd + 2.0 * np.sin(np.deg2rad(yd))
    yd = yd + 1.5 * np.cos(np.deg2rad(xd))
    for dim in (0, 1):
        for isglobal in (True, False):
            np.testing.assert_array_equal(
                TO.oracle_derivative_spherical(xd, lats, lons, dim, isglobal),
                JO.oracle_derivative_spherical(xd, lats, lons, dim, isglobal))
    tensor = TO.oracle_flowmap_gradient(xd, yd, lats, lons, sigma=sigma)
    np.testing.assert_array_equal(
        tensor, JO.oracle_flowmap_gradient(xd, yd, lats, lons, sigma=sigma))
    np.testing.assert_array_equal(TO.oracle_ftle_norm(tensor),
                                  JO.oracle_ftle_norm(tensor))
    np.testing.assert_array_equal(
        TO.oracle_ftle(u, v, lats, lons, -3600.0, settls_order=1,
                       gauss_sigma=sigma),
        JO.oracle_ftle(u, v, lats, lons, -3600.0, settls_order=1,
                       gauss_sigma=sigma))


def test_oracle_ridges_and_area_equal_jax():
    lats = np.linspace(-20.0, 20.0, 17)
    lons = np.linspace(-30.0, 30.0, 21)
    LON, LAT = np.meshgrid(lons, lats)
    field = np.exp(-((LAT - 0.3 * LON) / 4.0) ** 2) * 3.0
    got = TO.oracle_find_ridges(field, lats, lons, sigma=0.5,
                                tolerance_threshold=1e-3, isglobal=False)
    want = JO.oracle_find_ridges(field, lats, lons, sigma=0.5,
                                 tolerance_threshold=1e-3, isglobal=False)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    ridges, _, _, ev = got
    assert ridges.sum() > 0
    ftle = np.log(1.0 + field)
    r = np.where(ridges > 0, 1.0, np.nan)
    np.testing.assert_array_equal(
        TO.oracle_find_area(ftle, ev, r, lats, lons),
        JO.oracle_find_area(ftle, ev, r, lats, lons))
