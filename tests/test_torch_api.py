"""Port parity of the facade: ``lagrangiancoherence_tpu_torch.api`` (``LCS``,
``parcel_propagation``, ``flowmap_gradient``, ``latlonsel``, resample),
``field.py`` and ``utils/io.py`` against the JAX package, on the CPU in
float64.

The same numpy-seeded inputs go through both packages; the port's Fields
come from the JAX ones through ``convert.field_from_jax``.  Bounds:

* departure points within 1e-10 degrees of JAX's (as tests/test_torch_settls.py);
* FTLE within 1e-9 of JAX's float64 FTLE stage evaluated eagerly
  (``ftle_norm(flowmap_gradient(...))``) on JAX's own departure points,
  relative to the field's largest value.  No point is excluded;
* FTLE within 1e-6 of the JAX facade's own output.  That output comes from
  the jitted ``ftle_from_departures``, where XLA fuses the float32 stencil
  stage (quirk Q6) and contracts its multiply-adds: each stencil value moves
  by up to a float32 ulp, ~1e-7 of the field (measured 9.0e-8 on the saddle
  and 9.5e-8 on the global case), while the eager JAX evaluation and the
  port agree to ~2e-16.

The JAX facade calls are shared through module-scoped fixtures (five
compiles of the SETTLS scan in all).
"""
import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lagrangiancoherence_tpu import api as JA
from lagrangiancoherence_tpu.field import Field as JField
from lagrangiancoherence_tpu.grid import Grid as JaxGrid
from lagrangiancoherence_tpu.models import ftle as JF
from lagrangiancoherence_tpu.testing import flows
from lagrangiancoherence_tpu_torch import api as TA
from lagrangiancoherence_tpu_torch import devices as TD
from lagrangiancoherence_tpu_torch.convert import field_from_jax
from lagrangiancoherence_tpu_torch.devices import on_device, resolve_device
from lagrangiancoherence_tpu_torch.field import Field, as_field
from lagrangiancoherence_tpu_torch.ops import cuda_interp
from lagrangiancoherence_tpu_torch.utils.logging import logger

torch.set_num_threads(1)

POSITION_ATOL = 1e-10
FTLE_RTOL = 1e-9          # against JAX's eager FTLE stage
FTLE_JIT_RTOL = 1e-6      # against the JAX facade (jitted, fused f32 stencil)
DIMS = ("time", "latitude", "longitude")
SUB = {"latitude": slice(-50, -30), "longitude": slice(-60, -20)}


@pytest.fixture(scope="module", autouse=True)
def _float64():
    """The port's SETTLS dtype follows torch's default dtype (JAX's x64
    switch, which tests/conftest.py turns on)."""
    before = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(before)


def saddle(nt=5, times=None):
    """JAX Fields of the ideal saddle (tests/test_api.py:13-20)."""
    u, v, lats, lons, t = flows.ideal_saddle(**dict(flows.SADDLE_CONFIG,
                                                    nt=nt))
    coords = dict(time=t if times is None else times, latitude=lats,
                  longitude=lons)
    return JField(u, DIMS, coords, name="u"), JField(v, DIMS, coords, name="v")


def vortex_global():
    u, v, lats, lons, t = flows.ideal_vortex(
        **dict(flows.VORTEX_CONFIG_SUBTROPICAL, nt=4))
    coords = dict(time=t, latitude=lats, longitude=lons)
    return JField(u, DIMS, coords, name="u"), JField(v, DIMS, coords, name="v")


def port(*fields):
    return tuple(field_from_jax(f) for f in fields)


def eager_ftle(xd, yd, sigma=None, compat=True):
    """JAX's FTLE stage op by op (LCS.__call__'s ftle_from_departures,
    unjitted) on JAX departure Fields."""
    grid = JaxGrid(lats=xd.coords["latitude"], lons=xd.coords["longitude"])
    return np.asarray(JF.ftle_norm(JF.flowmap_gradient(
        jnp.asarray(xd.data), jnp.asarray(yd.data), grid, sigma=sigma),
        compat=compat))


def assert_rel(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    scale = np.nanmax(np.abs(want))
    err = np.nanmax(np.abs(got - want)) if np.isfinite(want).any() else 0.0
    assert err <= rtol * scale, (err, scale)


def assert_positions(got, want):
    np.testing.assert_allclose(got.data, want.data, rtol=0,
                               atol=POSITION_ATOL)
    assert got.dims == want.dims


def assert_coords(got, want, skip=()):
    assert got.dims == want.dims
    assert set(got.coords) - set(skip) == set(want.coords) - set(skip)
    for k in set(want.coords) - set(skip):
        np.testing.assert_array_equal(np.asarray(got.coords[k]),
                                      np.asarray(want.coords[k]))


@pytest.fixture(scope="module")
def backward():
    """Backward SETTLS-2 on the saddle with departures and trajectories:
    the JAX facade and the port, all four outputs beside the FTLE."""
    U, V = saddle()
    kw = dict(timestep=-6 * 3600, SETTLS_order=2, return_dpts=True)
    want = JA.LCS(**kw)(u=U, v=V, verbose=False, return_traj=True)
    got = TA.LCS(**kw, device="cpu")(u=port(U)[0], v=port(V)[0], verbose=False,
                       return_traj=True)
    return want, got


@pytest.fixture(scope="module")
def forward():
    U, V = saddle()
    kw = dict(timestep=6 * 3600, SETTLS_order=2, return_dpts=True)
    return (JA.LCS(**kw)(u=U, v=V, verbose=False),
            TA.LCS(**kw, device="cpu")(u=port(U)[0], v=port(V)[0],
                                       verbose=False))


@pytest.fixture(scope="module")
def global_runs():
    """isglobal with T10 truncation and without truncation (the common
    0.5-degree grid, odd nx = 721), each run when a test first asks."""
    U, V = vortex_global()
    out = {}

    def run(trunc):
        if trunc not in out:
            kw = dict(timestep=-6 * 3600, SETTLS_order=1, return_dpts=True)
            call = dict(verbose=False, isglobal=True, truncation=trunc)
            out[trunc] = (JA.LCS(**kw)(u=U, v=V, **call),
                          TA.LCS(**kw, device="cpu")(u=port(U)[0],
                                                     v=port(V)[0], **call))
        return out[trunc]
    return run


class TestReturnShapes:
    """The 4 return arities of LCS.__call__ (LagrangianCoherence
    LCS/LCS.py:161-168), each against the JAX facade's outputs."""

    @pytest.mark.parametrize("dpts,traj,n", [(False, False, 1),
                                             (True, False, 3),
                                             (False, True, 3),
                                             (True, True, 5)])
    def test_arity_and_values(self, backward, dpts, traj, n):
        want5, _ = backward
        U, V = port(*saddle())
        out = TA.LCS(timestep=-6 * 3600, SETTLS_order=2, return_dpts=dpts,
                     device="cpu")(
            u=U, v=V, verbose=False, return_traj=traj)
        out = out if isinstance(out, tuple) else (out,)
        assert len(out) == n
        if dpts and traj:
            want = want5
        elif dpts:
            want = want5[:3]
        elif traj:
            want = (want5[0],) + want5[3:]
        else:
            want = want5[:1]
        assert_rel(out[0].data, want[0].data, FTLE_JIT_RTOL)
        assert_coords(out[0], want[0])
        for g, w in zip(out[1:], want[1:]):
            assert_positions(g, w)
            # departures taken from trajectories carry no time label; the
            # final positions carry the last (Q2-reversed) one
            assert_coords(g, w, skip=("time",))
        if dpts and not traj:
            assert out[1].coords["time"][0] == U.coords["time"][0]

    def test_default_shape(self, backward):
        want, got = backward
        assert got[0].dims == ("time", "latitude", "longitude")
        assert got[0].shape == want[0].shape == (1, 60, 60)

    def test_trajectories_match_jax(self, backward):
        (_, _, _, jxt, jyt), (_, _, _, xt, yt) = backward
        assert xt.dims[0] == "time" and xt.shape[0] == 5
        assert_positions(xt, jxt)
        assert_positions(yt, jyt)
        # the labels keep the record's resolution, as JAX's pandas keeps it
        assert xt.coords["time"].dtype == np.asarray(jxt.coords["time"]).dtype
        np.testing.assert_array_equal(xt.coords["time"], jxt.coords["time"])


class TestAgainstJax:
    def test_backward_ftle_matches_eager_jax(self, backward):
        (_, jxd, jyd, *_), (got, xd, yd, *_) = backward
        assert_positions(xd, jxd)
        assert_positions(yd, jyd)
        assert_rel(got.data[0], eager_ftle(jxd, jyd), FTLE_RTOL)

    def test_forward_ftle_matches_eager_jax(self, forward):
        (want, jxd, jyd), (got, xd, yd) = forward
        assert_positions(xd, jxd)
        assert_rel(got.data[0], eager_ftle(jxd, jyd), FTLE_RTOL)
        assert_rel(got.data, want.data, FTLE_JIT_RTOL)

    @pytest.mark.parametrize("trunc", [10, None])
    def test_isglobal_matches_jax(self, global_runs, trunc):
        (want, jxd, jyd), (got, xd, yd) = global_runs(trunc)
        assert got.shape == want.shape == (1, 360, 721)
        assert_coords(got, want)
        assert np.isfinite(got.data[0, 5:-5]).all()
        assert_positions(xd, jxd)
        assert_positions(yd, jyd)
        assert_rel(got.data[0], eager_ftle(jxd, jyd), FTLE_RTOL)
        assert_rel(got.data, want.data, FTLE_JIT_RTOL)

    def test_truncation_changes_the_result(self, global_runs):
        assert not np.allclose(global_runs(10)[1][0].data,
                               global_runs(None)[1][0].data, equal_nan=True)

    @pytest.mark.parametrize("compat", [True, False])
    @pytest.mark.parametrize("sigma", [None, 0.7])
    def test_gauss_sigma_and_compat(self, backward, sigma, compat):
        """JAX's LCS cannot take gauss_sigma (ftle_from_departures is
        jitted without sigma among its static arguments), so the port's
        sigma path is held to JAX's unjitted FTLE stage."""
        (_, jxd, jyd, *_), _ = backward
        U, V = port(*saddle())
        got = TA.LCS(timestep=-6 * 3600, SETTLS_order=2, gauss_sigma=sigma,
                     compat=compat, device="cpu")(u=U, v=V, verbose=False)
        assert_rel(got.data[0], eager_ftle(jxd, jyd, sigma=sigma,
                                           compat=compat), FTLE_RTOL)


class TestTimestamping:
    """Forward runs stamp the last time; backward runs the first
    (LagrangianCoherence LCS/LCS.py:158)."""

    def test_forward_stamps_last(self, forward):
        (want, *_), (got, *_) = forward
        times = saddle()[0].coords["time"]
        assert got.coords["time"][0] == times[-1]
        assert_coords(got, want)

    def test_backward_stamps_first(self, backward):
        (want, *_), (got, *_) = backward
        assert got.coords["time"][0] == saddle()[0].coords["time"][0]
        assert_coords(got, want)


class TestSubdomain:
    def test_crop_matches_jax(self, backward):
        U, V = saddle()
        kw = dict(timestep=-6 * 3600, SETTLS_order=2, subdomain=SUB,
                  return_dpts=True)
        want, jxd, jyd, *_ = JA.LCS(**kw)(u=U, v=V, verbose=False,
                                          return_traj=True)
        got, xd, yd = TA.LCS(**kw, device="cpu")(u=port(U)[0], v=port(V)[0],
                                   verbose=False)
        assert_coords(got, want)
        assert got.coords["latitude"].min() > -50
        assert got.coords["latitude"].max() < -30
        assert got.coords["longitude"].min() > -60
        # departures stay uncropped, as in the reference
        assert xd.shape == jxd.shape == (60, 60)
        full = eager_ftle(jxd, jyd)
        lats, lons = jxd.coords["latitude"], jxd.coords["longitude"]
        ii = np.nonzero((lats > -50) & (lats < -30))[0]
        jj = np.nonzero((lons > -60) & (lons < -20))[0]
        assert_rel(got.data[0], full[np.ix_(ii, jj)], FTLE_RTOL)

    def test_isglobal_drops_subdomain(self, global_runs):
        _, (got, *_) = global_runs(10)
        lcs = TA.LCS(timestep=-6 * 3600, subdomain=SUB, device="cpu")
        U, V = port(*vortex_global())
        out = lcs(u=U, v=V, verbose=False, isglobal=True, truncation=10)
        assert lcs.subdomain is None and out.shape == got.shape

    @pytest.mark.parametrize("lat,lon", [
        (slice(-50, -30), slice(-60, -20)), ([-50, -30], [-60, -20]),
        (None, slice(-60, -20)), (slice(-50, -30), None)])
    def test_latlonsel_matches_jax(self, lat, lon):
        U = saddle()[0]
        want = JA.latlonsel(U, latitude=lat, longitude=lon)
        got = TA.latlonsel(port(U)[0], latitude=lat, longitude=lon)
        np.testing.assert_array_equal(got.data, want.data)
        assert_coords(got, want)


class TestResample:
    def test_resample_matches_jax(self):
        U, V = saddle(nt=4)
        kw = dict(timestep=-6 * 3600, SETTLS_order=2, return_dpts=True)
        want, jxd, jyd = JA.LCS(**kw)(u=U, v=V, verbose=False, resample="3h")
        got, xd, yd = TA.LCS(**kw, device="cpu")(u=port(U)[0], v=port(V)[0],
                                   verbose=False, resample="3h")
        assert got.shape == (1, 60, 60)
        assert_coords(got, want)
        assert_positions(xd, jxd)
        assert_rel(got.data[0], eager_ftle(jxd, jyd), FTLE_RTOL)
        assert_rel(got.data, want.data, FTLE_JIT_RTOL)

    @pytest.mark.parametrize("start,freq,step", [
        ("2000-01-01 01:00", "3h", 6), ("2000-01-01 00:00", "3h", 6),
        ("2000-01-01 13:30", "30min", 1), ("2000-01-01 05:00", "1D", 18),
        ("2000-01-02 22:00", "7h", 5), ("2000-01-01 01:00", "12h", 6)])
    def test_offbin_record_matches_pandas_labels(self, start, freq, step):
        """pandas/xarray resample anchors bins at the start of day, NOT at
        times[0] (LagrangianCoherence LCS/LCS.py:88-91); the port computes
        the labels in numpy and must give JAX's (pandas') labels and
        values, NaN before the record included."""
        t0 = np.datetime64(start.replace(" ", "T"), "ns")
        times = t0 + np.arange(4) * np.timedelta64(step, "h")
        U = saddle(nt=4, times=times)[0]
        want = JA._resample_linear(U, freq, "time")
        got = TA._resample_linear(port(U)[0], freq, "time")
        np.testing.assert_array_equal(got.coords["time"],
                                      want.coords["time"])
        np.testing.assert_allclose(got.data, want.data, rtol=1e-12,
                                   equal_nan=True)

    def test_offbin_first_label_is_nan(self):
        times = np.datetime64("2000-01-01T01:00", "ns") \
            + np.arange(4) * np.timedelta64(6, "h")
        got = TA._resample_linear(port(saddle(nt=4, times=times)[0])[0],
                                  "3h", "time")
        assert got.coords["time"][0] == np.datetime64("2000-01-01T00:00")
        assert np.isnan(got.data[0]).all()

    def test_calendar_frequency_goes_through_pandas(self):
        times = np.datetime64("2000-01-30", "ns") \
            + np.arange(4) * np.timedelta64(1, "D")
        got = TA._resample_labels(times, "MS")
        np.testing.assert_array_equal(
            got, np.array(["2000-01-01", "2000-02-01"], "datetime64[ns]"))


class TestParcelPropagationFacade:
    def test_backward_labels_match_jax(self):
        U, V = saddle()
        kw = dict(timestep=-6 * 3600, propdim="time", verbose=False,
                  return_traj=True, SETTLS_order=1, cyclic_xboundary=True)
        jx, jy = JA.parcel_propagation(U, V, **kw)
        x, y = TA.parcel_propagation(*port(U, V), **kw, device="cpu")
        # Q2: labels are reversed for backward integration
        times = U.coords["time"]
        assert x.coords["time"][0] == times[-1]
        assert x.coords["time"][-1] == times[0]
        assert_coords(x, jx)
        assert_positions(x, jx)
        assert_positions(y, jy)

    def test_final_positions_carry_last_label(self, backward):
        U, V = port(*saddle())
        x, _ = TA.parcel_propagation(U, V, timestep=-6 * 3600,
                                     SETTLS_order=2, verbose=False,
                                     device="cpu")
        (_, jxd, *_), _ = backward
        assert x.coords["time"][0] == U.coords["time"][0]
        assert_positions(x, jxd)

    def test_plain_numpy_rejected_without_dims(self):
        with pytest.raises(TypeError):
            TA.parcel_propagation(np.zeros((3, 4, 5)), np.zeros((3, 4, 5)),
                                  device="cpu")

    def test_traj_rejects_360day_calendar(self):
        class Datetime360Day:       # stand-in for cftime.Datetime360Day
            pass

        U, V = port(*saddle())
        t360 = np.array([Datetime360Day() for _ in U.coords["time"]],
                        dtype=object)
        coords = {**{k: U.coords[k] for k in ("latitude", "longitude")},
                  "time": t360}
        U2 = Field(U.data, U.dims, coords, name="u")
        V2 = Field(V.data, V.dims, dict(coords), name="v")
        with pytest.raises(AssertionError, match="Datetime360Day"):
            TA.parcel_propagation(U2, V2, timestep=6 * 3600, verbose=False,
                                  return_traj=True, cyclic_xboundary=True,
                                  device="cpu")

    def test_dtype_follows_default_dtype(self, backward):
        (_, jxd, *_), _ = backward
        U, V = port(*saddle())
        torch.set_default_dtype(torch.float32)
        try:
            x, _ = TA.parcel_propagation(U, V, timestep=-6 * 3600,
                                         SETTLS_order=2, verbose=False,
                                         device="cpu")
        finally:
            torch.set_default_dtype(torch.float64)
        assert x.data.dtype == np.float32
        np.testing.assert_allclose(x.data, jxd.data, atol=1e-3)

    def test_kernel_cuda_on_cpu_raises(self):
        U, V = port(*saddle())
        with pytest.raises(ValueError, match="CUDA tensors"):
            TA.parcel_propagation(U, V, timestep=3600.0, verbose=False,
                                  kernel="cuda", device="cpu")
        assert cuda_interp.LAUNCHES == 0

    def test_per_step_progress_lines(self, caplog):
        """verbose=True logs one line per step from the host loop, as the
        reference's verboseprint (LagrangianCoherence
        LCS/trajectory.py:81); verbose=False logs none."""
        U, V = port(*saddle())
        with caplog.at_level(logging.INFO, logger=logger.name):
            for verbose in (True, False):
                TA.parcel_propagation(U, V, timestep=6 * 3600.0,
                                      verbose=verbose, device="cpu")
        lines = [r.message for r in caplog.records
                 if "Propagating time index" in r.message]
        assert lines == [f"Propagating time index {t}/4"
                         for t in range(1, 5)], lines


def test_flowmap_gradient_facade_matches_jax(backward):
    (_, jxd, jyd, *_), _ = backward
    for sigma in (None, 1.1):
        want = JA.flowmap_gradient(jxd, jyd, sigma=sigma)
        got = TA.flowmap_gradient(*port(jxd, jyd), sigma=sigma,
                                  device="cpu")
        assert got.name == "def_tensor" and got.shape == (9, 60, 60)
        assert_coords(got, want)
        assert_rel(got.data, want.data, FTLE_RTOL)


class TestInputs:
    """``ds`` as a path, a dict or a duck-typed Dataset gives what ``u=`` /
    ``v=`` give (LagrangianCoherence LCS/LCS.py:81-87)."""

    def test_ds_forms_agree(self, tmp_path, backward):
        pytest.importorskip("h5py")
        from lagrangiancoherence_tpu_torch.utils.io import save_dataset
        _, (want, *_) = backward
        U, V = port(*saddle())
        lcs = TA.LCS(timestep=-6 * 3600, SETTLS_order=2, device="cpu")

        class Dataset:              # duck-typed xarray Dataset
            data_vars = ("u", "v")

            def __init__(self, **variables):
                self.variables = variables

            def __getitem__(self, name):
                return self.variables[name]

        path = str(tmp_path / "winds.nc")
        save_dataset({"u": U, "v": V}, path)
        for ds in ({"u": U, "v": V}, Dataset(u=U, v=V), path):
            got = lcs(ds=ds, verbose=False)
            np.testing.assert_array_equal(got.data, want.data)
        with pytest.raises(TypeError):
            lcs(ds=(U, V), verbose=False)
        with pytest.raises(ValueError):
            lcs(u=U, verbose=False)

    def test_create_arrays_list(self):
        f = Field(np.arange(12).reshape(3, 4), ("points", "x"),
                  {"points": np.arange(3), "x": np.arange(4)})
        groups = TA.create_arrays_list(f, "points")
        want = JA.create_arrays_list(JField(f.data, f.dims, f.coords),
                                     "points")
        assert len(groups) == 3
        for g, w in zip(groups, want):
            np.testing.assert_array_equal(g, w)


class TestDevices:
    def test_default_device_is_torchs(self):
        """No device= means the tensors' device, else the card, which
        must exist: no CPU fallback."""
        t = torch.zeros(2)
        assert resolve_device(None, np.zeros(2), t) == t.device
        assert resolve_device("cpu", t) == torch.device("cpu")
        if torch.cuda.is_available():
            assert TA.LCS().device == resolve_device(None) \
                == torch.device("cuda")
            return
        for make in (lambda: resolve_device(None), TA.LCS,
                     lambda: TA.parcel_propagation(*port(*saddle()),
                                                   verbose=False)):
            with pytest.raises(RuntimeError, match="device=cuda"):
                make()

    def test_cuda_without_a_card_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        for make in (lambda: TA.LCS(device="cuda"),
                     lambda: TA.flowmap_gradient(*port(*saddle()),
                                                 device="cuda")):
            with pytest.raises(RuntimeError, match="is_available"):
                make()

    def test_tensor_on_another_device_is_not_moved(self):
        t = torch.zeros(3)
        assert on_device(t, torch.device("cpu")) is t
        with pytest.raises(ValueError, match="move it there first"):
            on_device(t, torch.device("meta"))


def make_field(cls):
    """tests/test_field_io.py:12-18 for either package's Field."""
    times = np.datetime64("2001-06-01", "ns") \
        + np.arange(4) * np.timedelta64(6, "h")
    rng = np.random.RandomState(0)
    return cls(rng.randn(4, 7, 13), DIMS,
               dict(time=times, latitude=np.linspace(-30, 30, 7),
                    longitude=np.linspace(-60, 60, 13)), name="u")


FIELD_OPS = {
    "sortby": lambda f: type(f)(f.data[:, ::-1], f.dims,
                                {**f.coords,
                                 "latitude": f.coords["latitude"][::-1]}
                                ).sortby("latitude"),
    "sel_slice": lambda f: f.sel(latitude=slice(-10, 10)),
    "sel_nearest": lambda f: f.sel(latitude=1.0),
    "isel": lambda f: f.isel(time=0),
    "transpose": lambda f: f.transpose("longitude", "time", "latitude"),
    "expand_dims": lambda f: f.isel(time=0).expand_dims(
        "time", coord=np.datetime64("2001-06-01")),
    "arithmetic": lambda f: (f * 2 - f) / 1.0 + (-f) * 0.5,
    "mean": lambda f: f.mean("time"),
    "coarsen": lambda f: f.coarsen(latitude=2, longitude=3),
    "differentiate": lambda f: f.differentiate("longitude"),
    "assign_coords": lambda f: f.isel(time=0).assign_coords(
        time=np.datetime64("2001-06-01")),
}


@pytest.mark.parametrize("op", sorted(FIELD_OPS))
def test_field_ops_match_jax(op):
    got = FIELD_OPS[op](make_field(Field))
    want = FIELD_OPS[op](make_field(JField))
    np.testing.assert_array_equal(got.data, want.data)
    assert_coords(got, want)


def test_field_interp_to_matches_jax():
    f, jf = make_field(Field), make_field(JField)
    lats, lons = np.linspace(-40, 35, 11), np.linspace(-70, 50, 17)
    got = f.interp_to(lats, lons, device="cpu")
    want = jf.interp_to(lats, lons)
    np.testing.assert_allclose(got.data, want.data, rtol=0, atol=1e-12)
    assert_coords(got, want)


def test_field_validation():
    f = make_field(Field)
    assert as_field(f) is f
    with pytest.raises(TypeError):
        as_field(np.zeros((2, 2)))
    with pytest.raises(ValueError):
        Field(np.zeros((3, 4)), ("a", "b"), {"a": np.arange(5)})


class TestIO:
    """Files written by either package open in the other
    (tests/test_field_io.py::TestIO)."""

    @pytest.fixture(autouse=True)
    def _h5py(self):
        pytest.importorskip("h5py")

    @pytest.mark.parametrize("writer", ["port", "jax"])
    def test_roundtrip_across_packages(self, tmp_path, writer):
        from lagrangiancoherence_tpu.utils import io as JIO
        from lagrangiancoherence_tpu_torch.utils import io as TIO
        f = make_field(Field if writer == "port" else JField)
        path = str(tmp_path / "test.nc")
        save, read = ((TIO.save_field, JIO.open_dataarray)
                      if writer == "port" else
                      (JIO.save_field, TIO.open_dataarray))
        assert save(f, path)
        g = read(path)
        np.testing.assert_array_equal(g.data, f.data)
        assert g.dims == f.dims
        np.testing.assert_array_equal(
            np.asarray(g.coords["time"]).astype("datetime64[ns]"),
            f.coords["time"])
        np.testing.assert_array_equal(g.coords["latitude"],
                                      f.coords["latitude"])
        # and the same file reads the same in both packages
        h = (TIO.open_dataarray if writer == "port" else
             JIO.open_dataarray)(path)
        np.testing.assert_array_equal(np.asarray(h.coords["time"]),
                                      np.asarray(g.coords["time"]))

    def test_skip_if_exists_and_multi_var(self, tmp_path):
        from lagrangiancoherence_tpu_torch.utils.io import (open_dataset,
                                                            save_dataset,
                                                            save_field)
        f = make_field(Field)
        path = str(tmp_path / "out.nc")
        assert save_field(f, path) is True
        assert save_field(f, path, skip_if_exists=True) is False
        g = f.copy()
        g.name = "v"
        save_dataset({"u": f, "v": g}, str(tmp_path / "ds.nc"))
        assert set(open_dataset(str(tmp_path / "ds.nc"))) == {"u", "v"}

    def test_fractional_second_origin(self, tmp_path):
        from lagrangiancoherence_tpu.utils.io import open_dataarray
        from lagrangiancoherence_tpu_torch.utils.io import save_field
        f = make_field(Field)
        f.coords["time"] = f.coords["time"] + np.timedelta64(250, "ms")
        save_field(f, str(tmp_path / "t.nc"))
        g = open_dataarray(str(tmp_path / "t.nc"))
        np.testing.assert_array_equal(
            np.asarray(g.coords["time"]).astype("datetime64[ns]"),
            f.coords["time"])


# ---------------------------------------------------------------------------
# The record on the device: ordered there, one crossing each way
# ---------------------------------------------------------------------------

ERA5_LATS = np.linspace(87.5, -87.5, 36)        # descending, as ERA5 stores
ERA5_LONS = np.linspace(-180.0, 175.0, 72)
LON_SHUFFLE = np.random.RandomState(5).permutation(ERA5_LONS.size)


def era5_record(shuffle_lons=False, nt=3):
    """Port Fields of a smooth global wind record with latitude descending
    (90 -> -90, ERA5's order), longitudes ascending or shuffled."""
    lats = ERA5_LATS
    lons = ERA5_LONS[LON_SHUFFLE] if shuffle_lons else ERA5_LONS
    la, lo = np.deg2rad(lats)[:, None], np.deg2rad(lons)[None, :]
    t = np.arange(nt)[:, None, None]
    u = 15 * np.cos(la) + 4 * np.sin(2 * lo + 0.3 * t) * np.cos(la) ** 2
    v = 3 * np.cos(3 * lo - 0.2 * t) * np.cos(la) * np.sin(2 * la)
    times = np.datetime64("2001-01-01", "ns") \
        + np.arange(nt) * np.timedelta64(6, "h")
    coords = dict(time=times, latitude=lats, longitude=lons)
    return (Field(u, DIMS, coords, name="u"),
            Field(v, DIMS, dict(coords), name="v"))


def sorted_beforehand(f):
    """What the facade sorted on the host before: ``Field.sortby``."""
    return f.sortby("latitude").sortby("longitude")


def assert_same_fields(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.name == w.name and g.dims == w.dims
        assert g.data.dtype == w.data.dtype
        assert np.array_equal(g.data, w.data, equal_nan=True)
        assert set(g.coords) == set(w.coords)
        for k in w.coords:
            assert np.asarray(g.coords[k]).dtype == \
                np.asarray(w.coords[k]).dtype, k
            assert np.array_equal(g.coords[k], w.coords[k]), k


ORDER_CASES = (
    [("lcs", dict(isglobal=False), mode) for mode in ("plain", "dpts",
                                                       "traj")]
    + [("lcs", dict(isglobal=True, interp_to_common_grid=g, truncation=t),
        mode) for g in (True, False) for t in (20, None)
       for mode in ("plain", "dpts", "traj")]
    + [("propagation", dict(), mode) for mode in ("plain", "traj")])
_SORTED_RESULTS = {}


def _ordered_run(what, call, mode, U, V):
    if what == "propagation":
        return TA.parcel_propagation(
            U, V, timestep=-6 * 3600, SETTLS_order=2, verbose=False,
            cyclic_xboundary=True, return_traj=mode == "traj", device="cpu")
    return TA.LCS(timestep=-6 * 3600, SETTLS_order=2,
                  return_dpts=mode == "dpts", device="cpu")(
        u=U, v=V, verbose=False, return_traj=mode == "traj", **call)


@pytest.mark.parametrize("shuffle_lons", [False, True],
                         ids=["lons_ascending", "lons_shuffled"])
@pytest.mark.parametrize("what,call,mode", ORDER_CASES,
                         ids=[f"{w}-{'-'.join(f'{k}={v}' for k, v in c.items())}"
                              f"-{m}" for w, c, m in ORDER_CASES])
def test_record_order_gives_identical_outputs(what, call, mode,
                                              shuffle_lons):
    """An ERA5-ordered record (latitude 90 -> -90, longitudes ascending or
    shuffled), put in order on the device or read in its own order by the
    regrid's tables, gives exactly the outputs of the same record sorted
    ascending on the host beforehand, labels and coordinates included."""
    key = (what, tuple(sorted(call.items())), mode)
    if key not in _SORTED_RESULTS:
        U, V = era5_record()
        _SORTED_RESULTS[key] = _ordered_run(
            what, call, mode, sorted_beforehand(U), sorted_beforehand(V))
    U, V = era5_record(shuffle_lons)
    assert_same_fields(_ordered_run(what, call, mode, U, V),
                       _SORTED_RESULTS[key])


def _snapshot(*fields):
    return [(a, a.copy()) for f in fields
            for a in (f.data, *f.coords.values())]


@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("call", [
    dict(isglobal=False), dict(isglobal=True, truncation=None,
                               interp_to_common_grid=False),
    dict(isglobal=True, truncation=20), "propagation"])
def test_inputs_are_not_mutated(call, ascending):
    """On the CPU a record of the default dtype is not copied on its way
    to the device (``torch.as_tensor`` shares its memory): every host
    array passed in is byte-identical after the call."""
    U, V = era5_record(nt=3)
    if ascending:
        U, V = sorted_beforehand(U), sorted_beforehand(V)
    before = _snapshot(U, V)
    if call == "propagation":
        TA.parcel_propagation(U, V, timestep=-6 * 3600, verbose=False,
                              return_traj=True, cyclic_xboundary=True,
                              device="cpu")
    else:
        TA.LCS(timestep=-6 * 3600, return_dpts=True, device="cpu")(
            u=U, v=V, verbose=False, return_traj=True, **call)
    for a, copy in before:
        assert a.tobytes() == copy.tobytes()


@pytest.mark.parametrize("call,dpts,want", [
    (dict(isglobal=True, truncation=20), False, (2, 1, 0)),
    (dict(isglobal=True, truncation=20), True, (2, 3, 0)),
    (dict(isglobal=False), False, (2, 1, 0)),
    (dict(isglobal=False), True, (2, 3, 0)),
    ("transposed", False, (2, 1, 2)),
    ("propagation", False, (2, 2, 0))])
def test_transfer_counter(call, dpts, want):
    """``devices.TRANSFERS``: an ERA5-ordered record crosses up once a wind
    component and nothing comes back but what the caller receives; no
    host copy is reordered unless the record is stored in another order
    than (time, latitude, longitude)."""
    U, V = era5_record()
    TD.reset_transfers()
    if call == "propagation":
        TA.parcel_propagation(U, V, timestep=-6 * 3600, verbose=False,
                              device="cpu")
    elif call == "transposed":
        U, V = (Field(np.ascontiguousarray(np.moveaxis(f.data, 0, -1)),
                      ("latitude", "longitude", "time"), f.coords,
                      name=f.name) for f in (U, V))
        TA.LCS(timestep=-6 * 3600, device="cpu")(u=U, v=V, verbose=False)
    else:
        TA.LCS(timestep=-6 * 3600, return_dpts=dpts, device="cpu")(
            u=U, v=V, verbose=False, **call)
    assert (TD.TRANSFERS["uploads"], TD.TRANSFERS["downloads"],
            TD.TRANSFERS["host_reorders"]) == want, TD.TRANSFERS


@pytest.mark.parametrize("call", [dict(isglobal=False),
                                  dict(isglobal=True, truncation=20)])
def test_legacy_smoothing_factor_is_logged_as_from_the_sorted_record(call):
    """The unused smoothing factor, logged at debug level, reads the first
    level of the sorted (and on the global path regridded and truncated)
    record, as a host sort of the record gives it."""
    U, V = era5_record()
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    h = Keep(logging.DEBUG)
    level = logger.level
    logger.addHandler(h)
    logger.setLevel(logging.DEBUG)
    try:
        TD.reset_transfers()
        TA.LCS(timestep=-6 * 3600, device="cpu")(u=U, v=V, verbose=False,
                                                 **call)
    finally:
        logger.removeHandler(h)
        logger.setLevel(level)
    (line,) = [m for m in records if "smoothing factor" in m]
    record = sorted_beforehand(U)
    first = record.data[0]
    if call["isglobal"]:
        first = TA.sht_truncate(TA.regrid_linear_nearest(
            record.data, record.coords["latitude"],
            record.coords["longitude"], TA.COMMON_GRID_LATS,
            TA.COMMON_GRID_LONS, device="cpu"),
            TA.COMMON_GRID_LATS, 20, device="cpu").numpy()[0]
    want = int(10 * first.size * float(np.nanstd(first)))
    assert line == f"legacy smoothing factor s = {want} (unused)"
    assert TD.TRANSFERS["host_reorders"] == (0 if call["isglobal"] else 1)
