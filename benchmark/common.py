"""What the entry points share: the configuration's coordinates and time
labels, seeded host records, and the comparison that decides ``correct``.

Each entry point a traffic mix can drive is a file of its own,
``entries/<entry>.py``, holding a class ``Entry`` that sets up and warms up
its cell in ``__init__`` and then has:

* ``call(i)``: the ``i``-th call of the window, on the ``i``-th input of
  its ring; returns the call's output;
* ``units_per_call``: the FTLE fields a call completes;
* ``keep(i, out)``: the (key, answer) pairs a sampled call leaves for the
  comparison, moved to the host; the key names the input it answers;
* ``release()``: frees the program's state before the reference runs;
* ``reference(key, device, precision)``: the plain reference's answer to
  the input ``key`` in one of ``PRECISIONS``;
* ``check(answers, device, stand_in=None)``: the numbers compared with
  their limits, each per answer (the worst answer counts) or over the
  whole window.

Inputs are made from the seed by ``winds.py``; on the card for winds that
live there, by numpy in the configuration's dtype for host records.  The
program gets only those inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from . import winds as W
from .reference import ftle as RF_ftle

START = np.datetime64("2021-01-01T00", "h")


def coords(cfg: dict):
    """The configuration's latitudes and longitudes, in its record's
    order."""
    g = cfg["grid"]
    return (np.linspace(g["lat_first"], g["lat_last"], g["ny"]),
            np.linspace(g["lon_first"], g["lon_last"], g["nx"]))


def labels(cfg: dict, n: int) -> np.ndarray:
    return START + np.arange(n) * np.timedelta64(int(cfg["step_hours"]), "h")


# a point is compared where the reference's own float32 run lies within
# this share of its float64 run: float32 is enough for an answer there
STABLE = 1e-3
# a row or column is read by its own median where at least this share of
# its points is compared: in a line where the flow's chaos leaves fewer,
# the few left read its rounding, not the program
LINE_SHARE = 0.25


def field_errors(got: np.ndarray, want: np.ndarray, twin: np.ndarray,
                 rows) -> dict:
    """The gap between a program's field and the reference's.

    Each point's gap is |got - want| over the larger of |want| and the
    median |want| (FTLE norms near 0 occur where parcels pile up at a
    clamp).  Over 8 days the flow's chaos amplifies float32's rounding at
    some points (near the poles, along ridges; a tenth to half of the
    globe, by the seed) to gaps of order 1, as much in the reference run in
    float32 (``twin``) as in the program.  So the gaps compared are those
    at the points of ``rows`` where ``twin`` lies within ``STABLE`` of
    ``want``: their median, 90th and 99th percentiles, and the largest
    median of any one row or column (a fault confined to a few rows or
    columns, such as the pole-home rows or a block's edge, shows there
    and in none of the percentiles).  NaN is compared at every point of
    ``rows``.
    """
    g, w, f = (a[rows].astype(np.float64) for a in (got, want, twin))
    nan_g, nan_w = np.isnan(g), np.isnan(w)
    scale = np.maximum(np.abs(w), np.nanmedian(np.abs(w)))
    stable = (np.abs(f - w) <= STABLE * scale) & ~nan_g & ~nan_w
    e = np.where(stable, np.abs(g - w) / scale, np.nan)
    flat = e[stable]
    pct = (np.percentile(flat, [50, 90, 99]) if flat.size
           else (np.inf,) * 3)
    return {"ftle_err_p50": float(pct[0]), "ftle_err_p90": float(pct[1]),
            "ftle_err_p99": float(pct[2]),
            "ftle_err_line_max": line_max(e),
            "nan_mismatch": int((nan_g != nan_w).sum()),
            "stable_share": float(stable.mean())}


def line_max(e: np.ndarray) -> float:
    """The largest median gap of a row or a column of ``e`` (NaN where a
    point is not compared) of which ``LINE_SHARE`` or more is compared."""
    worst = 0.0
    for ax in (0, 1):
        n = np.sum(~np.isnan(e), axis=ax)
        keep = n >= LINE_SHARE * e.shape[ax]
        if keep.any():
            sub = e[:, keep] if ax == 0 else e[keep]
            worst = max(worst, float(np.nanmax(np.nanmedian(sub, axis=ax))))
    return worst


def field(cfg, lats, lons, data: np.ndarray, name: str):
    from lagrangiancoherence_tpu_torch.field import Field
    return Field(data, ("time", "latitude", "longitude"),
                 {"time": labels(cfg, data.shape[0]), "latitude": lats,
                  "longitude": lons}, name=name)


def host_record(cfg, traffic, seed, slot, nt):
    """A host record in the configuration's order and input dtype, as
    (u, v) Fields, and its (u, v) arrays."""
    lats, lons = coords(cfg)
    params = W.draw(traffic["winds"], seed, slot, traffic.get("ring", 1))
    u, v = W.stack_numpy(params, lats, lons, nt,
                         np.dtype(cfg["input_dtype"]))
    return (field(cfg, lats, lons, u, "u"), field(cfg, lats, lons, v, "v"),
            (u, v))


def ascending(u: np.ndarray, lats, lons):
    """A (T, ny, nx) host record and its coordinates sorted ascending."""
    iy, ix = np.argsort(lats, kind="stable"), np.argsort(lons, kind="stable")
    return u[:, iy][:, :, ix], lats[iy], lons[ix]


def compared_rows(lats) -> np.ndarray:
    """Every row but those at +-90 degrees and those whose meridional
    stencil reads them.  A parcel that starts at a pole moves zonally by
    its wind times 1/cos(90 degrees), about 1e16: its longitude, and so its
    departure point, is rounding noise in any precision.  The gradient's
    five-point stencil (rows j-2 .. j+2, at rows 2 .. n-3) carries that
    noise into the second row from each pole (+-89.5 degrees on the 0.25
    degree grid), where the program in float64 and the reference in
    float64 differ by order 1 while they agree to 1e-15 elsewhere."""
    lats = np.asarray(lats)
    pole = np.abs(lats) >= 90.0
    keep = ~pole
    for j in range(2, lats.size - 2):
        keep[j] &= not pole[j - 2:j + 3].any()
    return keep


def compare(drv, answers, device, lats, stand_in=None) -> list[dict]:
    """``field_errors`` of each answer against the reference of its input
    (float64, and float32 for the points compared), each computed once per
    input.  ``stand_in``: a precision of the reference ("control": float32
    with TF32 matmuls; "float32") put in the program's place."""
    rows = compared_rows(lats)
    refs = drv.__dict__.setdefault("references", {})

    def ref(key, precision):
        if (key, precision) not in refs:
            refs[key, precision] = drv.reference(key, device, precision)
        return refs[key, precision]

    return [field_errors(np.asarray(ref(key, stand_in) if stand_in else got),
                         ref(key, "float64"), ref(key, "float32"), rows)
            for key, got in answers]


# the reference's precisions: its own, the configuration's, the control's
PRECISIONS = {"float64": (torch.float64, False),
              "float32": (torch.float32, False),
              "control": (torch.float32, True)}


def reference_ftle(cfg, u, v, lats, lons, precision) -> np.ndarray:
    dtype, tf32 = PRECISIONS[precision]
    f = RF_ftle.ftle(u.to(dtype), v.to(dtype), lats, lons, cfg["timestep_s"],
                     settls_order=cfg["settls_order"],
                     order=cfg["interp_order"], cyclic_x=cfg["cyclic_x"],
                     tf32=tf32)
    return f.to(torch.float64).cpu().numpy()


class Base:
    units_per_call = 1

    def release(self) -> None:
        for k in [k for k, v in vars(self).items()
                  if k.startswith("prog_")]:
            delattr(self, k)
