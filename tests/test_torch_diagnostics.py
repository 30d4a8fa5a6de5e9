"""Port parity of the diagnostics: ``models/ridges.py``,
``ops/morphology.py``, ``models/ridge_filter.py``, ``models/area.py`` and
``ops/idw.py`` against the JAX package, on the CPU in float64.

Bounds:
* ``eigmin``, ``dt_prod``, ``eigvectors``, ``angle``: within 1e-10 of the
  quantity's largest value.  JAX runs under ``jax.disable_jit()``: under
  ``jit`` XLA fuses the float32 stencil stage (quirk Q6) and contracts its
  multiply-adds, which moves these by up to ~4e-6 of their largest value
  (measured on the ridge field below), while the eager JAX evaluation and
  the port agree to ~1e-12;
* ``ridges``, ``skeletonize``, ``filter_ridges`` and ``find_area`` masks and
  ``overflow``: exact (``find_area`` against the jitted JAX function);
* thresholds: within 1e-12; IDW within 1e-12.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from lagrangiancoherence_tpu.field import Field as JField
from lagrangiancoherence_tpu.grid import Grid as JaxGrid
from lagrangiancoherence_tpu.models import area as JAr
from lagrangiancoherence_tpu.models import ridge_filter as JRF
from lagrangiancoherence_tpu.models import ridges as JR
from lagrangiancoherence_tpu.ops import idw as JI
from lagrangiancoherence_tpu.ops import morphology as JM
from lagrangiancoherence_tpu_torch import (filter_ridges, find_area,
                                          find_ridges_spherical_hessian)
from lagrangiancoherence_tpu_torch.convert import field_from_jax
from lagrangiancoherence_tpu_torch.field import Field
from lagrangiancoherence_tpu_torch.grid import Grid
from lagrangiancoherence_tpu_torch.models import area as TAr
from lagrangiancoherence_tpu_torch.models import ridge_filter as TRF
from lagrangiancoherence_tpu_torch.models import ridges as TR
from lagrangiancoherence_tpu_torch.ops import idw as TI
from lagrangiancoherence_tpu_torch.ops import morphology as TM

torch.set_num_threads(1)

EIG_RTOL = 1e-10          # of the quantity's largest value
THRESH_ATOL = 1e-12
IDW_RTOL = 1e-12
DIMS = ("latitude", "longitude")


@pytest.fixture(scope="module", autouse=True)
def _float64():
    """The port's ridges follow torch's default dtype (JAX's x64 switch,
    on in tests/conftest.py)."""
    before = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(before)


def ridge_test_field():
    """tests/test_ridges_area.py:16-22: a clear straight ridge along lat=5."""
    lats = np.linspace(-30.0, 40.0, 36)
    lons = np.linspace(-60.0, 20.0, 41)
    LON, LAT = np.meshgrid(lons, lats)
    f = 3.0 * np.exp(-((LAT - 5.0) / 8.0) ** 2) + 0.1 * np.cos(LON / 30.0)
    return f, lats, lons


def wavy_field(seed=0):
    """A seeded field with several curved ridges, on a 0.25-degree box."""
    rng = np.random.RandomState(seed)
    lats = np.linspace(-40.0, -25.0, 61)
    lons = np.linspace(-70.0, -52.0, 73)
    LON, LAT = np.meshgrid(lons, lats)
    f = np.zeros_like(LON)
    for _ in range(4):
        c, a, k = rng.uniform(-38, -27), rng.uniform(1, 3), rng.uniform(.2, .6)
        f += a * np.exp(-((LAT - c - np.sin(k * LON)) / 1.5) ** 2)
    return f + 0.01 * rng.randn(*f.shape), lats, lons


def assert_rel(got, want, rtol=EIG_RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin], want[~fin])   # +-inf alike
    scale = max(np.abs(want[fin]).max(), 1e-300) if fin.any() else 1.0
    assert np.abs(got[fin] - want[fin]).max() <= rtol * scale


# ---------------------------------------------------------------------------
# ridges
# ---------------------------------------------------------------------------

def test_symmetric_eig_matches_jax_and_numpy():
    rng = np.random.RandomState(0)
    a, b, c = rng.randn(3, 50)
    want = JR.symmetric_eig_2x2(jnp.asarray(a), jnp.asarray(b),
                                jnp.asarray(c))
    got = TR.symmetric_eig_2x2(torch.tensor(a), torch.tensor(b),
                               torch.tensor(c))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-14,
                                   atol=1e-15)
    lam0, lam1 = got[0].numpy(), got[1].numpy()
    for i in range(50):
        w = np.linalg.eigvalsh(np.array([[a[i], b[i]], [b[i], c[i]]]))
        np.testing.assert_allclose([lam0[i], lam1[i]], w, rtol=1e-12,
                                   atol=1e-12)


def test_symmetric_eig_isotropic():
    lam0, _, v0, v1 = TR.symmetric_eig_2x2(*(torch.tensor(x, dtype=torch
                                                         .float64)
                                             for x in (2.0, 0.0, 2.0)))
    np.testing.assert_array_equal(v0.numpy(), [-0.0, 1.0])
    np.testing.assert_array_equal(v1.numpy(), [1.0, 0.0])
    assert float(lam0) == 2.0


RIDGE_CASES = {
    "straight": (ridge_test_field, dict(sigma=1.2, tol=5e-7)),
    "straight_wide_tol": (ridge_test_field, dict(sigma=1.2, tol=1e-5)),
    "wavy": (wavy_field, dict(sigma=1.2, tol=1e-3)),
    "wavy_unsmoothed": (wavy_field, dict(sigma=None, tol=1e-4)),
}


@pytest.mark.parametrize("compat", [True, False])
@pytest.mark.parametrize("isglobal", [False, True])
@pytest.mark.parametrize("case", sorted(RIDGE_CASES))
def test_find_ridges_core_matches_jax(case, isglobal, compat):
    make, kw = RIDGE_CASES[case]
    f, lats, lons = make()
    grid = Grid(lats=lats, lons=lons, cyclic_x=isglobal)
    with jax.disable_jit():
        want = JR.find_ridges_core(jnp.asarray(f),
                                   JaxGrid(lats=lats, lons=lons,
                                           cyclic_x=isglobal),
                                   kw["sigma"], kw["tol"], isglobal, compat)
    got = TR.find_ridges_core(torch.tensor(f), grid, kw["sigma"], kw["tol"],
                              isglobal, compat)
    for k in ("eigmin", "dt_prod", "eigvectors", "angle", "gradient"):
        assert_rel(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_array_equal(got["ridges"].numpy(),
                                  np.asarray(want["ridges"]))
    if case.startswith("straight") and kw["tol"] > 1e-6:
        assert got["ridges"].sum() > 0


def test_facade_six_outputs_match_jax():
    f, lats, lons = wavy_field()
    jf = JField(f, DIMS, {"latitude": lats, "longitude": lons}, name="ftle")
    kw = dict(sigma=1.2, tolerance_threshold=1e-3, return_eigvectors=True,
              isglobal=False)
    with jax.disable_jit():
        want = JR.find_ridges_spherical_hessian(jf, **kw)
    got = find_ridges_spherical_hessian(field_from_jax(jf), **kw,
                                        device="cpu")
    assert len(got) == 6
    for g, w in zip(got, want):
        assert g.dims == w.dims and g.name == w.name
        assert set(g.coords) == set(w.coords)
        if g.name == "ridges":
            np.testing.assert_array_equal(g.data, w.data)
        else:
            assert_rel(g.data, w.data)
    assert got[0].data.sum() > 0


def test_facade_two_outputs_scheme_ignored_and_crest():
    f, lats, lons = ridge_test_field()
    fld = Field(f, DIMS, {"latitude": lats, "longitude": lons})
    a = find_ridges_spherical_hessian(fld, sigma=1.2, tolerance_threshold=1e-5,
                                      scheme="first_order", isglobal=False,
                                      device="cpu")
    b = find_ridges_spherical_hessian(fld, sigma=1.2, tolerance_threshold=1e-5,
                                      scheme="second_order", isglobal=False,
                                      device="cpu")
    assert len(a) == 2
    np.testing.assert_array_equal(a[0].data, b[0].data)
    ridges, eigmin = a
    crest = np.argmin(np.abs(lats - 5.0))
    assert ridges.data[crest - 2:crest + 3].sum() > 0
    assert (eigmin.data[crest] < 0).all()


def test_facade_dtype_follows_default_dtype():
    f, lats, lons = ridge_test_field()
    fld = Field(f, DIMS, {"latitude": lats, "longitude": lons})
    torch.set_default_dtype(torch.float32)
    try:
        ridges, eigmin = find_ridges_spherical_hessian(fld, isglobal=False,
                                                       device="cpu")
    finally:
        torch.set_default_dtype(torch.float64)
    assert ridges.data.dtype == eigmin.data.dtype == np.float32


# ---------------------------------------------------------------------------
# thresholds and morphology
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method,block", [("gaussian", 31), ("gaussian", 301),
                                          ("mean", 9), ("mean", 41)])
def test_threshold_local_matches_jax(method, block):
    f, _, _ = wavy_field(1)
    want = np.asarray(JM.threshold_local(jnp.asarray(f), block, method=method,
                                         offset=-0.8))
    got = TM.threshold_local(torch.tensor(f), block, method=method,
                             offset=-0.8).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=THRESH_ATOL)


@pytest.mark.parametrize("block", [3, 7])
def test_threshold_local_median_matches_scipy(block):
    """The JAX package's median method imports
    ``jax.scipy.signal.medfilt2d``, which this JAX release does not have;
    the port is held to ``scipy.signal.medfilt2d`` (zero padding)."""
    from scipy.signal import medfilt2d
    f, _, _ = wavy_field(2)
    got = TM.threshold_local(torch.tensor(f), block, method="median",
                             offset=0.1).numpy()
    np.testing.assert_array_equal(got, medfilt2d(f, block) - 0.1)


def test_threshold_local_errors():
    with pytest.raises(ValueError):
        TM.threshold_local(np.zeros((8, 8)), 4, device="cpu")
    with pytest.raises(ValueError):
        TM.threshold_local(np.zeros((8, 8)), 3, method="nope",
                           device="cpu")


def test_otsu_matches_jax():
    rng = np.random.RandomState(0)
    img = np.concatenate([rng.normal(0, .5, 5000), rng.normal(10, .5, 5000)])
    assert TM.otsu_threshold(torch.tensor(img)) == JM.otsu_threshold(img)


def blobs(seed=0, shape=(40, 50)):
    from scipy import ndimage
    m = np.random.RandomState(seed).rand(*shape) > 0.5
    return ndimage.binary_closing(m, iterations=2).astype(float)


MASKS = {
    "bar": lambda: np.pad(np.ones((4, 16)), ((8, 8), (2, 2))),
    "line": lambda: np.pad(np.ones((1, 8)), ((5, 4), (1, 1))),
    "blobs": blobs,
    "blobs_edge": lambda: blobs(1, (33, 27)),
}


@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("mask", sorted(MASKS))
def test_dilation_erosion_match_jax(mask, connectivity):
    m = MASKS[mask]() > 0
    for j, t in ((JM.binary_dilation, TM.binary_dilation),
                 (JM.binary_erosion, TM.binary_erosion)):
        np.testing.assert_array_equal(
            t(torch.tensor(m), connectivity=connectivity).numpy(),
            np.asarray(j(m, connectivity=connectivity)))


def test_dilation_does_not_wrap():
    m = np.zeros((5, 5), bool)
    m[0, 0] = True
    d = TM.binary_dilation(m, device="cpu").numpy()
    assert d.sum() == 3 and not d[-1, 0] and not d[0, -1]


@pytest.mark.parametrize("max_iter", [1, 3, 8, 9, 256])
@pytest.mark.parametrize("mask", sorted(MASKS))
def test_skeletonize_matches_jax(mask, max_iter):
    """Exact, including caps that stop before, at and past a host check."""
    m = MASKS[mask]()
    want = np.asarray(JM.skeletonize(m, max_iter=max_iter))
    got = TM.skeletonize(torch.tensor(m), max_iter=max_iter).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


# ---------------------------------------------------------------------------
# filter_ridges
# ---------------------------------------------------------------------------

def component_mask():
    m = np.zeros((20, 20))
    m[2, 2:14] = 1.0           # long component (len 12)
    m[10:12, 5:7] = 1.0        # small blob (4 px)
    m[15:19, 15] = 1.0         # short vertical line
    return m


@pytest.mark.parametrize("criteria,thresholds", [
    (["major_axis_length"], [8.0]), (["mean_intensity"], [1.0]),
    (["area", "max_intensity"], [4, 2.0]),
    (["mean_intensity", "major_axis_length"], [1.2, 3.0])])
def test_filter_ridges_matches_jax(criteria, thresholds):
    m = component_mask()
    intensity = np.ones_like(m)
    intensity[2] = 5.0
    intensity[15:19] = 3.0
    want = JRF.filter_ridges(m, intensity, criteria, thresholds)
    for r, i in ((m, intensity), (torch.tensor(m), torch.tensor(intensity))):
        got = TRF.filter_ridges(r, i, criteria, thresholds)
        np.testing.assert_array_equal(got, want)


def test_filter_ridges_field_and_errors():
    m = component_mask()
    coords = {"latitude": np.arange(20.0), "longitude": np.arange(20.0)}
    want = JRF.filter_ridges(JField(m, DIMS, coords), np.ones_like(m),
                             ["area"], [5])
    got = filter_ridges(Field(m, DIMS, coords), np.ones_like(m), ["area"],
                        [5])
    assert isinstance(got, Field)
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(filter_ridges(np.zeros((4, 4)),
                                                np.zeros((4, 4)), ["area"],
                                                [1]), np.full((4, 4), np.nan))
    with pytest.raises(ValueError):
        filter_ridges(m, m, ["nope"], [1.0])
    with pytest.raises(ValueError):
        filter_ridges(m, m, ["area"], [1.0, 2.0])
    labels, n = TRF.label_components(m)
    props = TRF.component_properties(labels, n, m)
    assert n == 3 and sorted(props["area"]) == [4, 4, 12]


# ---------------------------------------------------------------------------
# find_area
# ---------------------------------------------------------------------------

def area_setup():
    """tests/test_ridges_area.py:115-128."""
    lats = np.linspace(-10.0, 10.0, 21)
    lons = np.linspace(-10.0, 10.0, 21)
    ftle = np.full((21, 21), 0.5)
    ridges = np.full((21, 21), np.nan)
    ev = np.zeros((21, 21, 2))
    ridges[10, 10] = 1.0
    ev[10, 10] = [1 / np.sqrt(2), 1 / np.sqrt(2)]
    ridges[5, 5] = 1.0
    ev[5, 5] = [0.0, 1.0]
    return ftle, ev, ridges, lats, lons


def area_random(seed=0):
    """Many ridge points with seeded directions and radii, NaN gaps."""
    rng = np.random.RandomState(seed)
    lats, lons = np.linspace(-40, 15, 56), np.linspace(-90, -32, 59)
    ftle = rng.uniform(-1.0, 1.5, (56, 59))
    ridges = np.where(rng.rand(56, 59) < 0.05, 1.0, np.nan)
    ang = rng.uniform(0, 2 * np.pi, (56, 59))
    ev = np.stack([np.cos(ang), np.sin(ang)], axis=-1)
    ev[rng.rand(56, 59) < 0.02] = np.nan
    return ftle, ev, ridges, lats, lons


@pytest.mark.parametrize("case,ratio,max_steps", [
    ("setup", 0.5, 64), ("setup", 0.5, 8), ("shifted", 0.5, 8),
    ("random", 0.5, 128), ("random", 0.9, 16)])
def test_find_area_core_matches_jax(case, ratio, max_steps):
    ftle, ev, ridges, lats, lons = (area_random() if case == "random"
                                    else area_setup())
    if case == "shifted":
        ftle = ftle + 5.0     # radius exp(5.5)/2 ~ 122 deg >> domain
    want, wover = JAr.find_area_core(jnp.asarray(ftle), jnp.asarray(ev),
                                     jnp.asarray(ridges),
                                     JaxGrid(lats=lats, lons=lons), ratio,
                                     max_steps=max_steps)
    got, over = TAr.find_area_core(torch.tensor(ftle), torch.tensor(ev),
                                   torch.tensor(ridges),
                                   Grid(lats=lats, lons=lons), ratio,
                                   max_steps=max_steps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool(over) == bool(wover)
    assert got.sum() > 0
    if case == "shifted":
        assert bool(over)


def test_find_area_facade_matches_jax(caplog):
    ftle, ev, ridges, lats, lons = area_random(1)
    coords = {"latitude": lats, "longitude": lons}
    evc = {**coords, "eigvectors": np.arange(2)}
    for qsat, qdpt in ((None, None), (10.0, 1.0), (10.0, 9.0)):
        jargs = (JField(ftle, DIMS, coords),
                 JField(np.moveaxis(ev, -1, 0), ("eigvectors",) + DIMS, evc),
                 JField(ridges, DIMS, coords))
        want = JAr.find_area(*jargs, qsat=qsat, qdpt=qdpt, max_steps=16)
        got = find_area(*(field_from_jax(a) for a in jargs), qsat=qsat,
                        qdpt=qdpt, max_steps=16, device="cpu")
        assert got.dims == DIMS and got.name == "bounds"
        np.testing.assert_array_equal(got.data, want.data)
    # an (ny, nx, 2) array for the eigenvectors, and the overflow warning
    with caplog.at_level("WARNING"):
        out = find_area(Field(ftle + 5.0, DIMS, coords), ev,
                        Field(ridges, DIMS, coords), max_steps=4,
                        device="cpu")
    assert out.data.sum() > 0
    assert any("max_steps=4" in r.message for r in caplog.records)


# ---------------------------------------------------------------------------
# IDW
# ---------------------------------------------------------------------------

def test_haversine_matches_jax():
    rng = np.random.RandomState(0)
    a = rng.uniform(-180, 180, (4, 50))
    a[1] = a[3] = rng.uniform(-90, 90, 50)[None]
    want = np.asarray(JI.haversine(*(jnp.asarray(x) for x in a)))
    got = TI.haversine(*(torch.tensor(x) for x in a)).numpy()
    np.testing.assert_allclose(got, want, rtol=IDW_RTOL)
    d = float(TI.haversine(*(torch.tensor(x, dtype=torch.float64)
                             for x in (0.0, 0.0, 1.0, 0.0))))
    assert abs(d - 6378.1 * np.pi / 180) < 0.5


def test_idw_matches_jax():
    rng = np.random.RandomState(1)
    x, y = rng.uniform(-10, 10, 50), rng.uniform(-10, 10, 50)
    z = rng.randn(50)
    xi, yi = rng.uniform(-9, 9, 30), rng.uniform(-9, 9, 30)
    for power in (1.0, 2.0, 3.5):
        want = np.asarray(JI.idw_interpolate(x, y, z, xi, yi, power=power))
        got = TI.idw_interpolate(x, y, z, xi, yi, power=power,
                                 device="cpu").numpy()
        np.testing.assert_allclose(got, want, rtol=IDW_RTOL)
    out = TI.idw_interpolate(x, y, np.full(50, 3.25), np.array([0.0]),
                             np.array([0.0]), device="cpu").numpy()
    np.testing.assert_allclose(out, 3.25, rtol=1e-12)


def test_idw_regrid_matches_jax():
    x, y = np.array([-5.0, 5.0, 0.3]), np.array([0.0, 0.0, 1.7])
    z = np.array([0.0, 10.0, 4.0])
    lats, lons = np.linspace(-2, 2, 5), np.linspace(-8, 8, 17)
    want = JI.idw_regrid(x, y, z, lons, lats)
    got = TI.idw_regrid(x, y, z, lons, lats, device="cpu")
    assert got.shape == (5, 17)
    np.testing.assert_allclose(got, want, rtol=IDW_RTOL)
    assert got[2, 1] < 2.0 and got[2, -2] > 8.0
