"""The area-of-influence case (``examples/area_of_influence.case``) on the
CPU in float64, on a small South-American box of seeded ERA5-like fields
(the benchmark's ``moisture.py``, latitude descending as ERA5 stores it):

* against the benchmark's plain reference (``benchmark/reference/aoi.py``):
  both log-FTLE fields within 1e-7 of the reference's largest value, the
  threshold and ridge masks equal wherever their tests lie outside
  ``BAND`` of their thresholds, the thinning and the components exactly
  equal given the same input, the rain sums within 1e-9;
* against the JAX package's public functions called in the example's
  order, each stage on the port's output of the stage before;
* the spans a case opens, their nesting under "AOI case", and the
  skeleton's sweep counter.
"""
import logging

import numpy as np
import pytest
import torch

from benchmark import moisture
from benchmark.reference import aoi as RA
from lagrangiancoherence_tpu_torch.examples import area_of_influence as A
from lagrangiancoherence_tpu_torch.field import Field
from lagrangiancoherence_tpu_torch.ops import morphology
from lagrangiancoherence_tpu_torch.utils import logging as L

torch.set_num_threads(1)

NY, NX, NT = 41, 45, 10
DIMS = ("time", "latitude", "longitude")
LATS = np.linspace(15.0, -40.0, NY)
LONS = np.linspace(-90.0, -32.0, NX)
TIMES = np.datetime64("2021-01-01T00", "ns") \
    + np.arange(NT) * np.timedelta64(6, "h")
SPEC = {"jet_lat": [-28, -18], "jet_flux": [300, 450], "jet_width": [3, 5],
        "meander_deg": [2, 5], "meander_wavelength_deg": [20, 40],
        "meander_drift": [-0.3, 0.3], "llj_flux": [100, 250],
        "llj_lon": [-65, -55], "trough_hpa": [5, 20],
        "trough_lon": [-75, -45], "trough_len_deg": [10, 20],
        "high_hpa": [15, 22], "subpolar_hpa": [8, 15],
        "band_rain": [15, 35], "vortices": 12, "vortex_lat": [-32, 6],
        "vortex_lon": [-80, -42], "vortex_flux": [300, 450],
        "vortex_deg": [2, 4], "vortex_rain": [5, 20], "drift_deg": 0.3,
        "background_rain": 1.0, "dry": 0.05, "tongue_offset": 2.0,
        "tcwv": [10, 65], "rain_mm_day": [0, 50]}
SEED = 2 ** 31 + 18
FTLE_RTOL = 1e-7        # of the reference's largest |log-FTLE|
RAIN_RTOL = 1e-9
BAND = 1e-9             # of the tested quantity's scale
STAGE_SPANS = ("Local threshold", "Hessian ridges", "Skeletonize",
               "Ridge filter", "Pressure-gradient classification",
               "Rain attribution")


def arrays(slot=0):
    return moisture.fields_numpy(moisture.draw(SPEC, SEED, slot), SPEC,
                                 LATS, LONS, NT)


def fields(arr):
    coords = {"time": TIMES, "latitude": LATS, "longitude": LONS}
    return {k: Field(a, DIMS, coords, name=k) for k, a in arr.items()}


@pytest.fixture(scope="module")
def run():
    """The port's case in float64 on the CPU, and its inputs."""
    arr = arrays()
    before = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        out = A.case(**fields(arr), device="cpu")
    finally:
        torch.set_default_dtype(before)
    return arr, out


def ascending():
    return np.sort(LATS), np.sort(LONS)


def test_every_stage_has_work(run):
    _, out = run
    for k in ("threshold_mask", "ridges_raw", "skeleton", "ridges",
              "ridges_high_gradient", "cz_mask", "local_strain"):
        a = out[k].data if hasattr(out[k], "dims") else out[k]
        assert np.nansum(np.asarray(a) > 0) > 0, k


def test_log_ftle_matches_the_reference(run):
    arr, out = run
    u, v = arr["viwve"] / arr["tcwv"], arr["viwvn"] / arr["tcwv"]
    for levels, resample, scale, key in (
            (8, "3h", lambda x: x / 2, "log_ftle"),
            (2, None, lambda x: x * 4, "log_ftle_local")):
        norm, _ = RA.regional_ftle(
            u[-levels:], v[-levels:], LATS, LONS, -21600.0, settls_order=4,
            times=TIMES[-levels:], resample=resample, device="cpu")
        want = scale(np.log(norm))
        got = out[key].data
        assert np.isfinite(want).all() and np.isfinite(got).all()
        assert np.abs(got - want).max() <= FTLE_RTOL * np.abs(want).max()
    assert out["stamps"] == (TIMES[-8], TIMES[-2])


def test_threshold_and_ridges_match_outside_the_band(run):
    _, out = run
    lat_a, lon_a = ascending()
    local = out["log_ftle_local"].data
    block = min(301, (min(local.shape) // 2) * 2 + 1)
    thr = RA.threshold_local(local, block, -0.8)
    far = np.abs(local - thr) > BAND * np.abs(thr).max()
    assert np.array_equal((out["threshold_mask"] > 0)[far], (local > thr)[far])
    r = RA.hessian_ridges(out["log_ftle"].data, lat_a, lon_a, 1.2, 1e-3)
    lam = max(np.abs(r["lam0"]).max(), np.abs(r["lam1"]).max())
    near = ((np.abs(r["eigmin"]) <= BAND * lam)
            | (np.abs(np.abs(r["lam0"]) - np.abs(r["lam1"])) <= BAND * lam)
            | (np.abs(np.abs(r["dt_prod"]) - 1e-3)
               <= BAND * np.abs(r["dt_prod"]).max()))
    assert np.array_equal((out["ridges_raw"] > 0)[~near],
                          (r["ridges"] > 0)[~near])
    np.testing.assert_allclose(out["eigvectors"].data[:, ~near],
                               r["eigvectors"][:, ~near], atol=1e-9)


def test_thinning_and_components_are_exact(run):
    arr, out = run
    lat_a, lon_a = ascending()
    assert np.array_equal(RA.zhang_suen(out["ridges_raw"]),
                          out["skeleton"] > 0)
    comp = RA.components(out["skeleton"], out["log_ftle"].data)
    keep = RA.kept(comp, {"mean_intensity": 1.2, "major_axis_length": 30.0})
    want = np.isin(comp["labels"], np.nonzero(keep)[0] + 1)
    assert np.array_equal(out["ridges"].data > 0, want)
    mslp = RA.interp_to(arr["mslpres"][-1], LATS, LONS, lat_a, lon_a)
    grad = RA.pressure_along_ridges(mslp, out["eigvectors"].data, lat_a,
                                    lon_a)
    ridges = out["ridges"].data
    comp = RA.components(ridges, ridges * grad)
    keep = RA.kept(comp, {"mean_intensity": 50.0})
    want = np.isin(comp["labels"], np.nonzero(keep)[0] + 1)
    assert np.array_equal(~np.isnan(out["ridges_high_gradient"].data), want)


def test_rain_matches_the_reference(run):
    arr, out = run
    lat_a, lon_a = ascending()
    pr = RA.interp_to(arr["pr"][-1], LATS, LONS, lat_a, lon_a)
    want = RA.rain(pr, out["ridges"].data, out["threshold_mask"], 12.0)
    for k, w in want.items():
        assert abs(out[k] - w) <= RAIN_RTOL * abs(want["total_rain"]), k
    assert out["rain_on_local_strain"] > 0 and out["rain_on_czs"] > 0


def test_interp_to_reads_a_descending_source():
    """ERA5 stores latitude descending: ``interp_to`` takes the source in
    either order, as xarray's ``interp`` does."""
    arr = arrays()["mslpres"][-1]
    f = Field(arr, ("latitude", "longitude"),
              {"latitude": LATS, "longitude": LONS})
    up = Field(arr[::-1], ("latitude", "longitude"),
               {"latitude": LATS[::-1], "longitude": LONS})
    lat_t = np.linspace(-41.0, 16.0, 23)
    lon_t = np.linspace(-91.0, -31.0, 19)
    got = f.interp_to(lat_t, lon_t, device="cpu").data
    want = up.interp_to(lat_t, lon_t, device="cpu").data
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(
        got, RA.interp_to(arr, LATS, LONS, lat_t, lon_t).astype(got.dtype),
        rtol=1e-6)


def test_stages_match_the_jax_package(run):
    """The JAX package's public functions in the example's order, each
    fed the port's output of the stage before (the JAX ``interp_to`` reads
    an ascending source, so its inputs are sorted first)."""
    import jax
    from lagrangiancoherence_tpu import (LCS as JLCS, filter_ridges as jfr,
                                         find_ridges_spherical_hessian as jfh)
    from lagrangiancoherence_tpu.field import Field as JField
    from lagrangiancoherence_tpu.ops.morphology import (skeletonize as jsk,
                                                        threshold_local as jtl)
    from scipy import ndimage as ndi
    arr, out = run
    lat_a, lon_a = ascending()
    coords = {"time": TIMES, "latitude": LATS, "longitude": LONS}
    jf = {k: JField(a, DIMS, coords, name=k) for k, a in arr.items()}
    u = (jf["viwve"] / jf["tcwv"]).rename("u")
    v = (jf["viwvn"] / jf["tcwv"]).rename("v")
    lcs = JLCS(timestep=-6 * 3600, timedim="time", SETTLS_order=4)
    ftle = lcs(u=u.isel(time=slice(-8, None)), v=v.isel(time=slice(-8, None)),
               verbose=False, resample="3h")
    local = lcs(u=u.isel(time=slice(-2, None)), v=v.isel(time=slice(-2, None)),
                verbose=False)
    for j, key, scale in ((ftle, "log_ftle", lambda x: x / 2),
                          (local, "log_ftle_local", lambda x: x * 4)):
        want = scale(np.log(np.asarray(j.data)[0]))
        got = out[key].data
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), key
    fl, fll = out["log_ftle"], out["log_ftle_local"]
    with jax.disable_jit():
        block = min(301, (min(fll.shape) // 2) * 2 + 1)
        thr = np.asarray(jtl(fll.data, block, offset=-0.8))
        assert np.array_equal((fll.data > thr).astype(float),
                              out["threshold_mask"])
        jfl = JField(fl.data, ("latitude", "longitude"),
                     {"latitude": lat_a, "longitude": lon_a})
        ridges, _, _, ev, _, _ = jfh(jfl, sigma=1.2, tolerance_threshold=1e-3,
                                     return_eigvectors=True, isglobal=False)
        assert np.array_equal(np.asarray(ridges.data), out["ridges_raw"])
        np.testing.assert_allclose(np.asarray(ev.data),
                                   out["eigvectors"].data, atol=1e-10)
        skel = np.asarray(jsk(out["ridges_raw"]))
        assert np.array_equal(skel > 0, out["skeleton"] > 0)
    kept = jfr(out["skeleton"], fl.data, ["mean_intensity",
                                          "major_axis_length"], [1.2, 30.0])
    assert np.array_equal(np.nan_to_num(kept), out["ridges"].data)
    ridges = out["ridges"].data
    last = {k: JField(jf[k].data[-1][::-1], ("latitude", "longitude"),
                      {"latitude": lat_a, "longitude": LONS})
            for k in ("mslpres", "pr")}
    mslp = last["mslpres"].interp_to(lat_a, lon_a)
    dpdx = np.asarray(mslp.differentiate("longitude").data)
    dpdy = np.asarray(mslp.differentiate("latitude").data)
    ev = out["eigvectors"].data
    grad = np.sqrt((dpdx * ev[0]) ** 2 + (dpdy * ev[1]) ** 2)
    high = jfr(ridges, ridges * grad, ["mean_intensity"], [50])
    np.testing.assert_array_equal(np.isnan(high),
                                  np.isnan(out["ridges_high_gradient"].data))
    pr = np.asarray(last["pr"].interp_to(lat_a, lon_a).data)
    dist = ndi.distance_transform_edt(~(ridges == 1))
    cz = (ridges > 0) | ((out["threshold_mask"] > 0) & (dist < 12))
    assert np.array_equal(cz, out["cz_mask"])
    total = float(np.nansum(pr))
    assert abs(out["total_rain"] - total) <= RAIN_RTOL * total
    assert abs(out["rain_on_czs"] - float(np.nansum(cz * pr))) \
        <= RAIN_RTOL * total


class Spans(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        if record.msg == "%s took %.3f s":
            self.records.append(record)


def test_spans_nest_under_the_case():
    log = logging.getLogger(L.LOGGER_NAME)
    level = log.level
    h = Spans()
    log.addHandler(h)
    log.setLevel(logging.INFO)
    sweeps = morphology.SWEEPS
    try:
        A.case(**fields(arrays(1)), device="cpu")
    finally:
        log.removeHandler(h)
        log.setLevel(level)
    names = [r.args[0] for r in h.records]
    root = h.records[-1]
    assert names[-1] == A.CASE_SPAN and root.parent_id is None
    assert names.count("LCS call") == 2 and names.count("Ridge filter") == 2
    for name in STAGE_SPANS:
        assert name in names, name
    by_id = {r.span_id: r for r in h.records}
    for r in h.records[:-1]:
        assert r.root_id == root.span_id, r.args[0]
    for r in h.records:
        if r.args[0] in STAGE_SPANS + ("LCS call",) \
                and r.args[0] != "Ridge filter":
            assert r.parent_id == root.span_id, r.args[0]
    # the second filter runs inside the classification's span
    filters = [r for r in h.records if r.args[0] == "Ridge filter"]
    assert filters[0].parent_id == root.span_id
    assert by_id[filters[1].parent_id].args[0] \
        == "Pressure-gradient classification"
    assert morphology.SWEEPS > sweeps
