"""Seeded regional fields for an area-of-influence case: vertically
integrated vapour flux, column water vapour, mean sea-level pressure and
rain over South America, in ERA5's ranges.

Closed forms, drawn from the seed and the slot of a ring of cases, on the
configuration's grid (latitude in its record's order) and six-hourly
levels; the traffic file's ``fields`` block sets the ranges:

* a moisture conveyor: an eastward flux jet along a meandering axis
  (latitude ``jet_lat`` plus a drifting wave), peak ``jet_flux``, and a
  northerly low-level jet east of the Andes (peak ``llj_flux``);
* ``vortices`` Gaussian vortices of flux (peak ``vortex_flux``, radius
  ``vortex_deg``, a drift of up to ``drift_deg`` a level): each strains
  the flow on its flanks, so the window's FTLE has ridges inside the box
  and the one-step "local" FTLE features away from them;
* TCWV: a moist tongue ``tongue_offset`` jet widths poleward of the jet
  over a dry background (``dry`` of the range), within ``tcwv``;
* MSLP: 1010 hPa, the subtropical highs of both oceans (``high_hpa``,
  centred west and east of the box), the subpolar trough (``subpolar_hpa``)
  at its southern edge, a trough (``trough_hpa``) along the jet's poleward
  flank, and a low under each cyclonic vortex (a high of half that under an
  anticyclonic one);
* rain (mm a day, clipped to ``rain_mm_day``): a band along the jet, a
  core under each vortex and a light background everywhere.

Every stage of a case has work on every slot.  The facade's deformation
stencil is cyclic in longitude (quirk Q6's ``derivative_spherical_coords``
default, as the reference computes it on a box), so the box's edge columns
read a high FTLE and carry a ridge in every case; the oceanic highs put
those ridges in a zonal pressure gradient, so the pressure-gradient filter
keeps some ridge in every case, and the vortices' ridges and strain give
the other stages their work inside the box.
"""
from __future__ import annotations

import numpy as np

__all__ = ["draw", "fields_numpy"]

NAMES = ("viwve", "viwvn", "tcwv", "mslpres", "pr")


def _rng(seed: int, slot: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), int(slot), 7])


def draw(spec: dict, seed: int, slot: int = 0) -> dict:
    """The host scalars of case ``slot`` from ``seed``, each uniform over
    its range in ``spec``."""
    rng = _rng(seed, slot)

    def u(key):
        lo, hi = spec[key]
        return float(rng.uniform(lo, hi))

    lat0, lat1 = spec["vortex_lat"]
    lon0, lon1 = spec["vortex_lon"]
    vortices = [dict(lat=float(rng.uniform(lat0, lat1)),
                     lon=float(rng.uniform(lon0, lon1)),
                     flux=u("vortex_flux") * float(rng.choice((-1.0, 1.0))),
                     radius=u("vortex_deg"),
                     dlat=float(rng.uniform(-1.0, 1.0)) * spec["drift_deg"],
                     dlon=float(rng.uniform(-1.0, 1.0)) * spec["drift_deg"],
                     rain=u("vortex_rain"), low=u("trough_hpa") * 100.0)
                for _ in range(spec["vortices"])]
    return dict(jet_lat=u("jet_lat"), jet_flux=u("jet_flux"),
                jet_width=u("jet_width"), meander=u("meander_deg"),
                meander_k=u("meander_wavelength_deg"),
                meander_phase=float(rng.uniform(0.0, 2 * np.pi)),
                meander_drift=u("meander_drift"),
                llj_flux=u("llj_flux"), llj_lon=u("llj_lon"),
                trough=u("trough_hpa") * 100.0, trough_lon=u("trough_lon"),
                trough_len=u("trough_len_deg"),
                pacific_high=u("high_hpa") * 100.0,
                atlantic_high=u("high_hpa") * 100.0,
                subpolar=u("subpolar_hpa") * 100.0,
                band_rain=u("band_rain"), vortices=vortices)


def fields_numpy(params: dict, spec: dict, lats, lons, nt: int) -> dict:
    """The five (nt, ny, nx) float64 host arrays of one case, by name."""
    lats = np.asarray(lats, dtype=np.float64)
    lons = np.asarray(lons, dtype=np.float64)
    t = np.arange(nt, dtype=np.float64)[:, None, None]
    lat = lats[None, :, None]
    lon = lons[None, None, :]
    p = params
    axis = p["jet_lat"] + p["meander"] * np.sin(
        2 * np.pi * (lon + 90.0) / p["meander_k"] + p["meander_phase"]
        + p["meander_drift"] * t)
    across = (lat - axis) / p["jet_width"]
    jet = np.exp(-across ** 2)
    viwve = p["jet_flux"] * jet
    llj_shape = np.exp(-((lon - p["llj_lon"]) / 6.0) ** 2) \
        * np.clip((lat + 40.0) / 50.0, 0.0, 1.0) * np.clip(
            (10.0 - lat) / 10.0, 0.0, 1.0)
    viwvn = -p["llj_flux"] * llj_shape * np.ones_like(t)
    # the trough hugs the jet's poleward flank, so the ridges along the jet
    # lie in its gradient
    trough = -p["trough"] * np.exp(-((lat - axis + 1.5 * p["jet_width"])
                                     / p["jet_width"]) ** 2
                                   - ((lon - p["trough_lon"])
                                      / p["trough_len"]) ** 2)
    # the subtropical highs over both oceans, west and east of the box, so
    # its edge columns lie in their zonal gradient, and the subpolar trough
    # at its southern edge
    highs = (p["pacific_high"] * np.exp(-((lon + 95.0) / 10.0) ** 2)
             + p["atlantic_high"] * np.exp(-((lon + 27.0) / 10.0) ** 2)) \
        * np.exp(-((lat + 25.0) / 25.0) ** 2)
    mslp = 101000.0 + highs - p["subpolar"] * np.exp(
        -((lat + 45.0) / 6.0) ** 2) + trough
    rain = p["band_rain"] * np.exp(-((lat - axis) / 2.0) ** 2) \
        + spec["background_rain"] * (1.0 + 0.5 * np.sin(np.deg2rad(3 * lon)))
    for v in p["vortices"]:
        cy = v["lat"] + v["dlat"] * t
        cx = v["lon"] + v["dlon"] * t
        dy, dx = lat - cy, lon - cx
        g = np.exp(-(dx * dx + dy * dy) / v["radius"] ** 2)
        # flux from the streamfunction F R g / 2: u = -d/dy, v = d/dx
        viwve = viwve + v["flux"] * (dy / v["radius"]) * g
        viwvn = viwvn - v["flux"] * (dx / v["radius"]) * g
        # a cyclone's low, an anticyclone's high, wider than its flux
        mslp = mslp - (v["low"] if v["flux"] > 0 else -0.5 * v["low"]) \
            * g ** (1.0 / 2.25)
        rain = rain + v["rain"] * g
    lo, hi = spec["tcwv"]
    moist = np.exp(-((lat - axis + spec["tongue_offset"] * p["jet_width"])
                     / (2.0 * p["jet_width"])) ** 2)
    tcwv = lo + (hi - lo) * (spec["dry"] + (1.0 - spec["dry"]) * moist) \
        * np.ones_like(t)
    rain = np.clip(rain * np.ones_like(t), *spec["rain_mm_day"])
    return dict(viwve=viwve, viwvn=viwvn * np.ones_like(viwve), tcwv=tcwv,
                mslpres=mslp * np.ones_like(t), pr=rain)
