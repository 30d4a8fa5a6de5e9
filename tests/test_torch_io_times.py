"""Port parity of the time labels: ``utils/io.py``'s CF decode and encode,
``api.py``'s resample, trajectory and FTLE labels and ``ftle_series``'s
stamps, against the JAX package, on the CPU in float64.

The JAX package handles labels with pandas 3, which keeps each record's
resolution; the port does the same in numpy (``utils/times.py``).  So every
label here is held to JAX's exactly: the same instants (compared as integer
nanoseconds in Python, with no cast that could wrap) at the same resolution.
The records include CF origins that numpy's own parser refuses (the NCEP
reanalysis' ``"hours since 1800-1-1 00:00:0.0"``), zone suffixes, origins and
records outside datetime64[ns]'s 1678-2262 (a CMIP6 extension to 2300), and
fractional offsets.  The resampled winds are bit-identical to JAX's; the
SETTLS and FTLE stages are held to tests/test_torch_api.py's bounds.
"""
import sys
import warnings

import numpy as np
import pytest
import torch

from lagrangiancoherence_tpu import api as JA
from lagrangiancoherence_tpu.field import Field as JField
from lagrangiancoherence_tpu.runners import ftle_series as jax_series
from lagrangiancoherence_tpu.testing import flows
from lagrangiancoherence_tpu.utils import io as JIO
from lagrangiancoherence_tpu_torch import api as TA
from lagrangiancoherence_tpu_torch.convert import field_from_jax
from lagrangiancoherence_tpu_torch.ops import cuda_settls
from lagrangiancoherence_tpu_torch.runners import ftle_series
from lagrangiancoherence_tpu_torch.utils import io as TIO

torch.set_num_threads(1)

NCEP = "hours since 1800-1-1 00:00:0.0"
# hours from 1800-01-01 to 2300-01-01: 500 years of 365 days and 121 leap
# days (125 years divisible by 4, less 1800, 1900, 2100 and 2200)
H2300 = (500 * 365 + 121) * 24
DT = -6 * 3600
POSITION_ATOL = 1e-10     # tests/test_torch_api.py
FTLE_JIT_RTOL = 1e-6      # against the JAX facade (jitted, fused f32 stencil)
DIMS = ("time", "latitude", "longitude")
_NS = {"s": 10 ** 9, "ms": 10 ** 6, "us": 10 ** 3, "ns": 1}


@pytest.fixture(scope="module", autouse=True)
def _float64():
    before = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(before)


def instants(t):
    """Integer nanoseconds since 1970 (None for NaT), in Python ints."""
    t = np.asarray(t)
    unit, count = np.datetime_data(t.dtype)
    return [None if np.isnat(x) else int(x.astype(np.int64)) * _NS[unit]
            * count for x in t.ravel()]


def assert_same_labels(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert instants(got) == instants(want)


def hours_2300(nt=5, first=0):
    """``nt`` six-hourly offsets in NCEP's unit from 2300-01-01 + first h."""
    return H2300 + first + 6.0 * np.arange(nt)


def expected_2300(nt=5, step_h=6):
    """The 2300 instants from integers: seconds since 1970."""
    # 1800 → 1970: 41 leap days (43 years divisible by 4, less 1800, 1900)
    s0 = (H2300 - (170 * 365 + 41) * 24) * 3600
    return [(s0 + k * step_h * 3600) * 10 ** 9 for k in range(nt)]


def saddle(times):
    """JAX Fields of the ideal saddle (tests/test_api.py:13-20)."""
    u, v, lats, lons, _ = flows.ideal_saddle(**dict(flows.SADDLE_CONFIG,
                                                    nt=len(times)))
    coords = dict(time=times, latitude=lats, longitude=lons)
    return JField(u, DIMS, coords, name="u"), JField(v, DIMS, coords, name="v")


# ---------------------------------------------------------------------------
# CF decode and encode
# ---------------------------------------------------------------------------

WHOLE = [0.0, 6.0, 12.0, np.nan, -18.0]
DECODE_CASES = {
    "ncep": (NCEP, WHOLE),
    "unpadded date": ("days since 1990-1-1", WHOLE),
    "UTC suffix": ("hours since 1900-01-01 00:00:00 UTC", WHOLE),
    "fraction and +00:00": ("hours since 1900-01-01 00:00:00.000000 +00:00",
                            WHOLE),
    "Z suffix": ("hours since 2000-01-01T00:00:00Z", WHOLE),
    "+05:00": ("hours since 2000-01-01 00:00:00+05:00", WHOLE),
    "-0330": ("minutes since 2000-01-01 00:00:00-0330", WHOLE),
    "unpadded time": ("minutes since 2000-1-1 6:30", WHOLE),
    "origin 1600": ("hours since 1600-01-01", WHOLE),
    "day 200000": ("days since 2000-01-01", [200000.0, 0.0]),
    "record in 2300": (NCEP, list(hours_2300())),
    "0.5 h": ("hours since 2000-01-01", [0.5, 1.5, np.nan]),
    "1e-3 s": ("seconds since 2000-01-01", [1e-3, 2.0]),
    "1.0000001 s": ("seconds since 2000-01-01", [1.0000001, -2.5]),
    "origin with 7 digits": ("seconds since 2000-01-01 00:00:00.1234567",
                             [0.0, 1.0]),
    "other span": ("weeks since 2000-01-01", [1.0, 2.0]),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_times_matches_jax(case):
    units, values = DECODE_CASES[case]
    values = np.asarray(values)
    want = JIO._decode_times(values, units, None)
    with warnings.catch_warnings():
        warnings.simplefilter("error")   # numpy's timezone deprecation
        got = TIO._decode_times(values, units)
    if not np.issubdtype(np.asarray(want).dtype, np.datetime64):
        np.testing.assert_array_equal(got, want)
        return
    assert_same_labels(got, want)


def test_decode_2300_record_from_integers():
    got = TIO._decode_times(hours_2300(), NCEP)
    assert instants(got) == expected_2300()


def test_decode_raises_where_ns_cannot_hold_it():
    """A fractional offset puts the instants in nanoseconds, as pandas
    does; from a 1600 origin both packages raise rather than wrap."""
    units, values = "hours since 1600-01-01", np.array([0.5])
    with pytest.raises(ValueError):
        JIO._decode_times(values, units, None)
    with pytest.raises((OverflowError, ValueError)):
        TIO._decode_times(values, units)


@pytest.mark.parametrize("origin", [
    "1-1-1 00:00:0.0", "2000-02-30", "2000-01-01 24:00",
    "2000-01-01 UTC+05:00", "01/01/2000"])
def test_decode_refuses_an_origin_it_cannot_read(origin):
    """No silent misreading: pandas reads "1-1-1" as 2001-01-01 and
    "UTC+05:00" as -05:00; the port names the string and raises."""
    with pytest.raises(ValueError, match="CF time origin"):
        TIO._decode_times(np.zeros(2), f"hours since {origin}")


ENCODE_CASES = {
    "2300 hourly": np.datetime64("2300-01-01T00", "h")
    + np.arange(4) * np.timedelta64(6, "h"),
    "2300 us": np.datetime64("2300-01-01T00", "us")
    + np.arange(4) * np.timedelta64(6, "h"),
    "1600": np.datetime64("1600-06-01T07", "s")
    + np.arange(4) * np.timedelta64(6, "h"),
    "origin .5 s": np.datetime64("2000-01-01T00:00:00.5", "ns")
    + np.arange(4) * np.timedelta64(6, "h"),
    "origin 1 ns": np.datetime64("2000-01-01T00:00:00.000000001", "ns")
    + np.arange(4) * np.timedelta64(6, "h"),
    "origin .25 s in ms": np.datetime64("1969-12-31T23:59:59.250", "ms")
    + np.arange(4) * np.timedelta64(1, "D"),
}


@pytest.mark.parametrize("case", sorted(ENCODE_CASES))
def test_encode_times_matches_jax(case):
    t = ENCODE_CASES[case]
    want_s, want_units = JIO._encode_times(t)
    got_s, got_units = TIO._encode_times(t)
    assert got_units == want_units
    assert got_s.dtype == want_s.dtype
    np.testing.assert_array_equal(got_s, want_s)


def _write_ncep(path):
    """A netCDF4-flavoured file whose time axis is NCEP's: hours since
    1800-1-1 00:00:0.0, six-hourly from 2300-01-01."""
    h5py = pytest.importorskip("h5py")
    rng = np.random.RandomState(3)
    with h5py.File(path, "w") as f:
        scales = []
        for name, vals, units in (("time", hours_2300(), NCEP),
                                  ("latitude", np.linspace(-30, 30, 7), None),
                                  ("longitude", np.linspace(0, 60, 9), None)):
            d = f.create_dataset(name, data=vals)
            d.make_scale(name)
            if units:
                d.attrs["units"] = units
            scales.append(d)
        for name in ("u", "v"):
            var = f.create_dataset(name, data=rng.randn(5, 7, 9))
            for ax, d in enumerate(scales):
                var.dims[ax].attach_scale(d)


def test_open_dataset_ncep_file(tmp_path):
    path = str(tmp_path / "ncep.nc")
    _write_ncep(path)
    want = JIO.open_dataset(path)
    got = TIO.open_dataset(path)
    assert set(got) == set(want) == {"u", "v"}
    for k in want:
        np.testing.assert_array_equal(got[k].data, want[k].data)
        assert got[k].dims == want[k].dims
        assert_same_labels(got[k].coords["time"], want[k].coords["time"])
    assert instants(got["u"].coords["time"]) == expected_2300()


def test_2300_record_round_trips_across_packages(tmp_path):
    """The port writes a 2300 record; both packages read its instants."""
    pytest.importorskip("h5py")
    times = TIO._decode_times(hours_2300(), NCEP)
    U = field_from_jax(saddle(times)[0])
    path = str(tmp_path / "u2300.nc")
    TIO.save_field(U, path)
    for read in (JIO.open_dataarray, TIO.open_dataarray):
        assert instants(read(path).coords["time"]) == expected_2300()


# ---------------------------------------------------------------------------
# The facade and the series on a 2300 record
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lcs_2300():
    """``LCS(resample="12h", return_traj=True)`` on a six-hourly 2300
    record, in both packages; each labelled by its own decoder."""
    JU, JV = saddle(JIO._decode_times(hours_2300(), NCEP, None))
    U, V = (field_from_jax(f) for f in saddle(
        TIO._decode_times(hours_2300(), NCEP)))
    kw = dict(timestep=DT, SETTLS_order=2, return_dpts=True)
    call = dict(verbose=False, resample="12h", return_traj=True)
    return (JA.LCS(**kw)(u=JU, v=JV, **call),
            TA.LCS(**kw, device="cpu")(u=U, v=V, **call))


def test_resample_2300_bit_identical():
    """The resampled winds and labels equal JAX's bit for bit: the weights
    come from the int64 view at the labels' own unit."""
    for first in (0, 1):   # on and off the 12 h bins
        JU, _ = saddle(JIO._decode_times(hours_2300(first=first), NCEP,
                                         None))
        want = JA._resample_linear(JU, "12h", "time")
        got = TA._resample_linear(field_from_jax(JU), "12h", "time")
        assert_same_labels(got.coords["time"], want.coords["time"])
        assert np.array_equal(got.data, want.data, equal_nan=True)


def test_lcs_resample_2300_ftle(lcs_2300):
    want, got = lcs_2300
    assert_same_labels(got[0].coords["time"], want[0].coords["time"])
    # backward: the FTLE is stamped with the first label, 2300-01-01
    assert instants(got[0].coords["time"]) == expected_2300(1)
    w, g = np.asarray(want[0].data), got[0].data
    assert np.array_equal(np.isnan(g), np.isnan(w))
    assert np.nanmax(np.abs(g - w)) <= FTLE_JIT_RTOL * np.nanmax(np.abs(w))
    for gd, wd in zip(got[1:3], want[1:3]):
        np.testing.assert_allclose(gd.data, wd.data, rtol=0,
                                   atol=POSITION_ATOL)


def test_lcs_resample_2300_trajectory_labels(lcs_2300):
    want, got = lcs_2300
    for gt, wt in zip(got[3:], want[3:]):
        assert_same_labels(gt.coords["time"], wt.coords["time"])
        np.testing.assert_allclose(gt.data, wt.data, rtol=0,
                                   atol=POSITION_ATOL)
    # twelve-hourly, reversed by the backward step (quirk Q2)
    assert instants(got[3].coords["time"]) == expected_2300(3, 12)[::-1]


def test_parcel_propagation_traj_2300_labels():
    JU, JV = saddle(JIO._decode_times(hours_2300(), NCEP, None))
    U, V = (field_from_jax(f) for f in (JU, JV))
    want = JA.parcel_propagation(JU, JV, DT, verbose=False, return_traj=True,
                                 SETTLS_order=1)
    got = TA.parcel_propagation(U, V, DT, verbose=False, return_traj=True,
                                SETTLS_order=1, device="cpu")
    for g, w in zip(got, want):
        assert_same_labels(g.coords["time"], w.coords["time"])
        np.testing.assert_allclose(g.data, w.data, rtol=0,
                                   atol=POSITION_ATOL)
    assert instants(got[0].coords["time"]) == expected_2300()[::-1]


def test_ftle_series_2300_labels():
    JU, JV = saddle(JIO._decode_times(hours_2300(), NCEP, None))
    want = jax_series(JU, JV, DT, window=3, stride=1, settls_order=1,
                      batch=1, cyclic_x=False)
    got = ftle_series(field_from_jax(JU), field_from_jax(JV), DT, window=3,
                      stride=1, settls_order=1, batch=1, cyclic_x=False,
                      device="cpu")
    assert_same_labels(got.coords["time"], want.coords["time"])
    assert instants(got.coords["time"]) == expected_2300()[:3]


# ---------------------------------------------------------------------------
# resample aliases: accepted and rejected as JAX's pandas accepts them
# ---------------------------------------------------------------------------

REMOVED = ["H", "3H", "T", "45T", "S", "10S", "L", "U", "N", "2N"]
# each accepted alias, and the spacing of a record it resamples to a few
# labels (the record is in nanoseconds, which pandas needs for "ns")
ACCEPTED = {"h": (3, "h"), "3h": (5, "h"), "min": (3, "m"),
            "30min": (50, "m"), "s": (3, "s"), "ms": (3, "ms"),
            "us": (3, "us"), "ns": (3, "ns"), "D": (3, "D"), "2D": (5, "D"),
            "MS": (20, "D"), "W": (4, "D")}


@pytest.mark.parametrize("freq", REMOVED)
def test_removed_alias_raises_as_jax(freq):
    JU, JV = saddle(np.datetime64("2020-01-01", "ns")
                    + np.arange(5) * np.timedelta64(6, "h"))
    with pytest.raises(ValueError):
        JA._resample_linear(JU, freq, "time")
    U, V = (field_from_jax(f) for f in (JU, JV))
    cuda_settls.LAUNCHES = 0
    with pytest.raises(ValueError, match="Invalid frequency"):
        TA.LCS(timestep=DT, device="cpu")(u=U, v=V, verbose=False,
                                          resample=freq)
    assert cuda_settls.LAUNCHES == 0


@pytest.mark.parametrize("freq", sorted(ACCEPTED))
def test_accepted_alias_matches_jax(freq):
    n, unit = ACCEPTED[freq]
    JU, _ = saddle(np.datetime64("2020-01-01T06", "ns")
                   + np.arange(4) * np.timedelta64(n, unit))
    want = JA._resample_linear(JU, freq, "time")
    got = TA._resample_linear(field_from_jax(JU), freq, "time")
    assert_same_labels(got.coords["time"], want.coords["time"])
    assert np.array_equal(got.data, want.data, equal_nan=True)


def test_calendar_frequency_without_pandas_names_it(monkeypatch):
    """The card's machine has no pandas: a calendar frequency raises
    ``ImportError`` naming it, and fixed-length ones need no pandas."""
    times = np.datetime64("2300-01-01", "s") \
        + np.arange(4) * np.timedelta64(6, "h")
    monkeypatch.setitem(sys.modules, "pandas", None)
    with pytest.raises(ImportError, match="'MS'"):
        TA._resample_labels(times, "MS")
    got = TA._resample_labels(times, "12h")
    assert instants(got) == expected_2300(2, 12)
