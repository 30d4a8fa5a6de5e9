"""User-facing API with the reference's call signatures — PyTorch.

Counterpart of ``lagrangiancoherence_tpu/api.py``: ``LCS`` reproduces the
constructor/call contract of the reference class
(LagrangianCoherence LCS/LCS.py:19-168) and ``parcel_propagation`` that of
the reference integrator entry point (LagrangianCoherence
LCS/trajectory.py:8-18).  Labeled coordinates stop at this file: ``Field``
holds host numpy arrays, the stages below receive tensors on ``device``.  A
record crosses to the device once, in the order it is stored, and is put in
ascending latitude and longitude there (``devices.upload``); it stays a
tensor through the regrid, the truncation, the propagation and the
deformation, and only what the caller receives comes back to the host
(``devices.download``).

Differences from the reference, by design (as in the JAX package):

* inputs are ``Field`` objects, xarray DataArrays (duck-typed), dicts/Datasets
  of the two, or a path to an HDF5/netCDF4 file — xarray itself is optional;
* the destructive CLI behaviour (input deletion, SURVEY.md Q8) is not
  replicated;
* quirk Q1 (scrambled deformation tensor) is reproduced by default for
  parity; pass ``compat=False`` to the constructor for the corrected
  Cauchy-Green norm.

Besides the JAX signatures, every entry point takes ``device=`` (default:
the device of the tensors passed, else the CUDA card, which must exist; pass
``device="cpu"`` for the CPU; see ``devices.py``), and ``LCS`` takes
``kernel=`` as ``parcel_propagation`` does.  The SETTLS stage runs in
``torch.get_default_dtype()`` (JAX's x64 switch), the FTLE stage in float64.
Time labels are numpy ``datetime64`` at the record's own resolution, as the
JAX package's pandas keeps it (``utils/times.py``), so records outside
1678-2262 keep their instants; pandas is imported only for a calendar
``resample`` frequency ("MS", "W", ...).
"""
from __future__ import annotations

import logging
import re

import numpy as np
import torch

from .devices import TRANSFERS, download, on_device, resolve_device, upload
from .field import Field, as_field
from .grid import Grid
from .models.ftle import ftle_from_departures
from .models.settls import parcel_propagation_core
from .ops.regrid import regrid_linear_nearest
from .ops.sht import truncate as sht_truncate
from .utils.logging import configure_verbosity, logger, timed_stage
from .utils.times import as_labels, cast_labels

__all__ = ["LCS", "parcel_propagation", "flowmap_gradient", "latlonsel",
           "create_arrays_list"]


def create_arrays_list(field, groupdim: str = "points"):
    """Group a stacked Field along ``groupdim`` into a list of per-label
    value arrays — parity shim for the reference's (unused) helper
    (LagrangianCoherence LCS/LCS.py:228-233)."""
    field = as_field(field)
    ax = field.axis(groupdim)
    return [np.take(field.data, i, axis=ax)
            for i in range(field.shape[ax])]


# the span that puts a record in ascending latitude and longitude
SORT_SPAN = "Sort to ascending coordinates"

COMMON_GRID_LATS = np.linspace(-89.75, 89.75, 180 * 2)
COMMON_GRID_LONS = np.linspace(-180, 179.5, 360 * 2 + 1)


# ---------------------------------------------------------------------------
# Input normalisation helpers
# ---------------------------------------------------------------------------

def _extract_uv(ds, u, v, timedim: str) -> tuple[Field, Field]:
    """ds/u/v → (u, v) Fields; mirrors LagrangianCoherence LCS/LCS.py:81-87."""
    if ds is not None:
        if isinstance(ds, str):
            from .utils.io import open_dataset
            ds = open_dataset(ds)
        # a dict of Fields, or an xarray Dataset (duck-typed)
        if isinstance(ds, dict) or hasattr(ds, "data_vars"):
            u, v = ds["u"], ds["v"]
        else:
            raise TypeError(f"unsupported ds type {type(ds)}")
    if u is None or v is None:
        raise ValueError("provide either ds= or both u= and v=")
    u = as_field(u)
    v = as_field(v)
    for f in (u, v):
        if set(f.dims) != {"latitude", "longitude", timedim}:
            raise AssertionError(
                f"array dims should be latitude, longitude and {timedim}; "
                f"got {f.dims}")
    order = (timedim, "latitude", "longitude")
    return u.transpose(*order), v.transpose(*order)


# fixed-length pandas frequency aliases → numpy timedelta units
_FIXED_FREQ = re.compile(r"^(\d*)(D|h|min|s|ms|us|ns)$")
_FREQ_UNIT = {"D": "D", "h": "h", "min": "m", "s": "s", "ms": "ms",
              "us": "us", "ns": "ns"}
# the fixed-length aliases pandas 3 removed: JAX's resample raises on them
_REMOVED_FREQ = re.compile(r"^\d*(H|T|S|L|U|N)$")


def _resample_labels(times: np.ndarray, freq: str) -> np.ndarray:
    """The labels of pandas ``Series.resample(freq).asfreq()``: bins
    anchored at the start of the first record's day (pandas' default
    origin), from the bin holding the first time to the bin holding the
    last.  Labels keep the record's resolution (at least seconds, as
    pandas keeps it), made finer where the step needs it.  Fixed-length
    frequencies ("3h", "30min", "1D") are computed in numpy; calendar ones
    go through pandas, imported only for them; the aliases pandas 3
    removed ("H", "T", "S", "L", "U", "N") raise ``ValueError``."""
    if _REMOVED_FREQ.match(freq.strip()):
        raise ValueError(
            f"Invalid frequency: {freq}; pandas 3 removed the aliases H, T, "
            f"S, L, U and N: use h, min, s, ms, us or ns")
    times = as_labels(times)
    m = _FIXED_FREQ.match(freq.strip())
    if m is None:
        try:
            import pandas as pd
        except ImportError as e:
            raise ImportError(
                f"resample={freq!r} is not a fixed-length frequency "
                f"({', '.join(_FREQ_UNIT)}, with a count); calendar "
                f"frequencies need pandas") from e
        return pd.Series(0.0, index=pd.to_datetime(times)).resample(
            freq).asfreq().index.values
    step = np.timedelta64(int(m.group(1) or 1), _FREQ_UNIT[m.group(2)])
    unit = (times[:0] + step).dtype       # numpy's promotion of the units
    times = cast_labels(times, unit)
    step = step.astype(f"m8[{np.datetime_data(unit)[0]}]")
    t0, t1 = times.min(), times.max()
    origin = cast_labels(t0.astype("datetime64[D]"), unit)
    first = origin + (t0 - origin) // step * step
    last = origin + (t1 - origin) // step * step
    return np.arange(first, last + step, step)


def _resample_linear(f: Field, freq: str, timedim: str) -> Field:
    """Linear-in-time resample onto a regular frequency
    (xarray ``resample().interpolate('linear')`` semantics,
    LagrangianCoherence LCS/LCS.py:88-91).

    Bin labels follow pandas ``resample`` (origin = start of day, not
    ``times[0]``), so records that do not start on a bin edge align the way
    the reference's xarray resample does; labels outside the record's time
    span interpolate to NaN, matching scipy ``interp1d`` with
    ``bounds_error=False`` underneath xarray.  The weights come from the
    labels' int64 counts at their own unit, as JAX forms them."""
    times = as_labels(f.coords[timedim])
    new_times = _resample_labels(times, freq)
    times = cast_labels(times, new_times.dtype)
    t_src = times.view("int64").astype(np.float64)
    t_dst = new_times.view("int64").astype(np.float64)
    ax = f.axis(timedim)
    data = np.moveaxis(f.data, ax, 0)
    flat = data.reshape(data.shape[0], -1)
    # vectorised interpolation over all grid points at once
    idx = np.clip(np.searchsorted(t_src, t_dst, side="left"), 1, t_src.size - 1)
    t0, t1 = t_src[idx - 1], t_src[idx]
    w = ((t_dst - t0) / np.where(t1 > t0, t1 - t0, 1.0))[:, None]
    out = flat[idx - 1] * (1 - w) + flat[idx] * w
    oob = (t_dst < t_src[0]) | (t_dst > t_src[-1])
    if oob.any():
        out[oob] = np.nan
    data = out.reshape((t_dst.size,) + data.shape[1:])
    data = np.moveaxis(data, 0, ax)
    coords = {**f.coords, timedim: new_times}
    return Field(data=data, dims=f.dims, coords=coords, name=f.name)


def latlonsel(field: Field, latitude=None, longitude=None,
              latname: str = "latitude", lonname: str = "longitude") -> Field:
    """Lat/lon box crop with *strict* inequalities — boundary points are
    dropped, matching the reference's mask
    (LagrangianCoherence LCS/tools.py:158-187).  Accepts slices or
    [min, max] lists."""
    field = as_field(field)

    def bounds(sel):
        if isinstance(sel, slice):
            return sel.start, sel.stop
        return sel[0], sel[-1]

    data = field
    if longitude is not None:
        lon1, lon2 = bounds(longitude)
        c = data.coords[lonname]
        data = data.isel({lonname: np.nonzero((c > lon1) & (c < lon2))[0]})
    if latitude is not None:
        lat1, lat2 = bounds(latitude)
        c = data.coords[latname]
        data = data.isel({latname: np.nonzero((c > lat1) & (c < lat2))[0]})
    return data


# ---------------------------------------------------------------------------
# parcel_propagation — reference signature facade over the SETTLS loop
# ---------------------------------------------------------------------------

def parcel_propagation(U, V, timestep: float = 1, propdim: str = "time",
                       verbose: bool = True, return_traj: bool = False,
                       SETTLS_order: int = 0, copy: bool = False,
                       interp_order: int = 3, cyclic_xboundary: bool = False,
                       kernel: str = "auto", device=None):
    """Two-time-level semi-Lagrangian advection, reference contract
    (LagrangianCoherence LCS/trajectory.py:8-144).

    Returns ``(positions_x, positions_y)`` Fields: final departure points
    stamped with the last (possibly reversed, quirk Q2) time label, or the
    full trajectory stack when ``return_traj=True``.  ``kernel``: see
    ``models/settls.resolve_kernel`` (``"auto"`` takes the fused SETTLS
    step on CUDA at orders 1 and 3, its plain version otherwise).
    """
    configure_verbosity(verbose)
    device = resolve_device(device)
    order = (propdim, "latitude", "longitude")
    U = as_field(U).transpose(*order)
    V = as_field(V).transpose(*order)
    with timed_stage(SORT_SPAN):
        u, lats, lons = upload(U, device, ascending=True)
        v = upload(V, device, ascending=True)[0]
    px, py = _propagate(u, v, timestep, lats, lons, cyclic_xboundary,
                        SETTLS_order=SETTLS_order, interp_order=interp_order,
                        return_traj=return_traj, kernel=kernel,
                        verbose=verbose, device=device)
    return _positions(px, py, lats, lons, U.coords[propdim], timestep,
                      propdim, return_traj)


def _propagate(u: torch.Tensor, v: torch.Tensor, timestep, lats, lons,
               cyclic_xboundary: bool, *, SETTLS_order, interp_order,
               return_traj: bool, kernel: str, verbose: bool,
               device: torch.device):
    """The SETTLS loop on winds already on ``device`` in ascending
    latitude and longitude: departure points (or trajectories) as
    tensors there."""
    grid = Grid(lats=lats, lons=lons, cyclic_x=cyclic_xboundary)
    with timed_stage("Parcel propagation"):
        return parcel_propagation_core(
            u, v, float(timestep), grid,
            settls_order=int(SETTLS_order),
            interp_order=int(interp_order),
            return_traj=return_traj,
            kernel=kernel,
            # per-step progress lines, as the reference's verboseprint
            # (LagrangianCoherence LCS/trajectory.py:81)
            progress=bool(verbose),
            device=device)


def _positions(px: torch.Tensor, py: torch.Tensor, lats, lons, times,
               timestep, propdim: str, return_traj: bool):
    """Departure points (or trajectories) copied to the host as the
    reference's ``(positions_x, positions_y)`` Fields."""
    times = list(times)
    if timestep < 0:
        times = times[::-1]  # labels reverse; storage order does not (Q2)
    coords2d = {"latitude": lats, "longitude": lons}
    if return_traj:
        # 360-day-calendar guard (LagrangianCoherence LCS/trajectory.py:
        # 129-130): datetime64 cannot represent cftime.Datetime360Day
        # labels, so trajectories cannot carry them (type-name check —
        # cftime is an optional dependency and may not be installed)
        assert type(times[0]).__name__ != "Datetime360Day", (
            "Cannot return trajectories with time coordinates "
            "cftime.Datetime360Day.")
        tcoord = as_labels(times)
        dims = (propdim, "latitude", "longitude")
        fx = Field(download(px), dims, {**coords2d, propdim: tcoord},
                   name="positions_x")
        fy = Field(download(py), dims, {**coords2d, propdim: tcoord},
                   name="positions_y")
        return fx, fy
    fx = Field(download(px), ("latitude", "longitude"), dict(coords2d),
               name="positions_x")
    fy = Field(download(py), ("latitude", "longitude"), dict(coords2d),
               name="positions_y")
    fx = fx.assign_coords(**{propdim: times[-1]})
    fy = fy.assign_coords(**{propdim: times[-1]})
    return fx, fy


def flowmap_gradient(x_departure, y_departure, sigma=None,
                     device=None) -> Field:
    """Deformation-tensor facade (LagrangianCoherence LCS/LCS.py:171-225):
    returns a Field with a leading ``derivatives`` dim of length 9 in the
    reference's element order, computed in float64 on ``device``."""
    from .models.ftle import flowmap_gradient as _core
    device = resolve_device(device, x_departure, y_departure)
    x_departure = as_field(x_departure)
    y_departure = as_field(y_departure)
    lats = x_departure.coords["latitude"]
    lons = x_departure.coords["longitude"]
    grid = Grid(lats=lats, lons=lons)
    tensor = download(_core(
        on_device(x_departure.data, device, torch.float64),
        on_device(y_departure.data, device, torch.float64), grid,
        sigma=sigma))
    return Field(tensor, ("derivatives", "latitude", "longitude"),
                 {"latitude": lats, "longitude": lons,
                  "derivatives": np.arange(9)},
                 name="def_tensor")


# ---------------------------------------------------------------------------
# LCS — the FTLE pipeline
# ---------------------------------------------------------------------------

class LCS:
    """Finite-Time Lyapunov Exponent pipeline for 2-D wind fields.

    Constructor/call parameters mirror LagrangianCoherence LCS/LCS.py:25-51.
    ``compat`` additionally selects the quirk-Q1-compatible matrix norm
    (default True, see models/ftle.py); ``kernel`` is passed to
    ``parcel_propagation``; every stage runs on ``device``.
    """

    earth_r = 6371000  # metres

    def __init__(self, timestep: float = 1, timedim: str = "time",
                 SETTLS_order: int = 0, subdomain=None,
                 return_dpts: bool = False, gauss_sigma=None,
                 compat: bool = True, kernel: str = "auto", device=None):
        self.timestep = timestep
        self.SETTLS_order = SETTLS_order
        self.timedim = timedim
        self.subdomain = subdomain
        self.gauss_sigma = gauss_sigma
        self.return_dpts = return_dpts
        self.compat = compat
        self.kernel = kernel
        self.device = resolve_device(device)

    def __call__(self, ds=None, u=None, v=None, verbose: bool = True, s=None,
                 resample=None, s_is_error: bool = False,
                 isglobal: bool = False, return_traj: bool = False,
                 interp_to_common_grid: bool = True,
                 traj_interp_order: int = 3, truncation: int = 20):
        configure_verbosity(verbose)
        with timed_stage("LCS call"):
            timestep = self.timestep
            timedim = self.timedim

            u, v = _extract_uv(ds, u, v, timedim)

            if isinstance(resample, str):
                with timed_stage("Resample in time"):
                    u = _resample_linear(u, resample, timedim)
                    v = _resample_linear(v, resample, timedim)
                    tvals = u.coords[timedim]
                    timestep = float(np.sign(timestep)) * float(
                        (tvals[1] - tvals[0]) / np.timedelta64(1, "s"))

            dev = self.device
            regrid = isglobal and interp_to_common_grid
            with timed_stage(SORT_SPAN):
                # the host sorts coordinates only.  Where the regrid
                # follows, its index tables read the record in the order
                # it is stored; elsewhere the record goes up as stored and
                # is put in order on the device.
                if not regrid:
                    ut, lats, lons = upload(u, dev, ascending=True)
                    vt = upload(v, dev, ascending=True)[0]

            if isglobal:
                if regrid:
                    with timed_stage("Regrid to common global grid"):
                        ut = self._to_common_grid(u, dev)
                        vt = self._to_common_grid(v, dev)
                    lats, lons = COMMON_GRID_LATS, COMMON_GRID_LONS
                if truncation is not None:
                    with timed_stage(f"Spectral truncation T{truncation}"):
                        ut = sht_truncate(ut, lats, truncation, device=dev)
                        vt = sht_truncate(vt, lats, truncation, device=dev)
                cyclic_xboundary = True
                self.subdomain = None
            else:
                cyclic_xboundary = False

            if s is None and logger.isEnabledFor(logging.DEBUG):
                # The reference computes-and-prints an unused smoothing
                # factor (LagrangianCoherence LCS/LCS.py:124-126, SURVEY.md
                # Q7); nothing consumes it, so it is computed only where it
                # is logged, from the first level as the record stands:
                # regridded or truncated on the device, else the input's
                # values in ascending order.
                if regrid or (isglobal and truncation is not None):
                    first = download(ut[0])
                else:
                    level = u.isel({timedim: 0})
                    sorted_level = level.sortby("latitude").sortby(
                        "longitude")
                    TRANSFERS["host_reorders"] += sorted_level is not level
                    first = sorted_level.data
                s = int(10 * first.size * float(np.nanstd(first)))
                logger.debug("legacy smoothing factor s = %s (unused)", s)

            px, py = _propagate(
                ut, vt, timestep, lats, lons, cyclic_xboundary,
                SETTLS_order=self.SETTLS_order,
                interp_order=traj_interp_order, return_traj=return_traj,
                kernel=self.kernel, verbose=verbose, device=dev)
            times = u.coords[timedim]

            if return_traj:
                x_trajs, y_trajs = _positions(px, py, lats, lons, times,
                                              timestep, timedim, True)
                x_departure = x_trajs.isel({timedim: -1})
                y_departure = y_trajs.isel({timedim: -1})
                px, py = px[-1], py[-1]
            elif self.return_dpts:
                x_departure, y_departure = _positions(
                    px, py, lats, lons, times, timestep, timedim, False)

            with timed_stage("Deformation tensor + eigenvalues"):
                grid = Grid(lats=lats, lons=lons)
                norm = download(ftle_from_departures(
                    px.to(torch.float64), py.to(torch.float64), grid,
                    sigma=self.gauss_sigma, compat=self.compat))

            timestamp = times[-1] if np.sign(timestep) == 1 else times[0]
            eigenvalues = Field(
                norm, ("latitude", "longitude"),
                {"latitude": lats, "longitude": lons}, name="ftle")
            if isinstance(self.subdomain, dict):
                # The reference computes the gradient on the FULL field and
                # crops the tensor afterwards (LagrangianCoherence
                # LCS/LCS.py:142-144), so subdomain-interior points keep
                # centred stencils fed by data outside the crop.  The norm is
                # pointwise, so cropping the norm here is exactly equivalent
                # to cropping the tensor there.  Departure points are
                # returned uncropped, as in the reference.
                eigenvalues = latlonsel(eigenvalues, **self.subdomain)
            eigenvalues = eigenvalues.expand_dims(timedim, coord=timestamp)

            if self.return_dpts and return_traj:
                return (eigenvalues, x_departure, y_departure, x_trajs,
                        y_trajs)
            elif self.return_dpts:
                return eigenvalues, x_departure, y_departure
            elif return_traj:
                return eigenvalues, x_trajs, y_trajs
            return eigenvalues

    @staticmethod
    def _to_common_grid(f: Field, device: torch.device) -> torch.Tensor:
        """``f`` uploaded as stored and regridded on ``device``: the
        regrid's index tables read the source in either order."""
        return regrid_linear_nearest(
            upload(f, device), f.coords["latitude"],
            f.coords["longitude"], COMMON_GRID_LATS, COMMON_GRID_LONS,
            device=device)
