"""Analytic flow generators — library fixtures for validation (numpy only).

Counterpart of ``lagrangiancoherence_tpu/testing/flows.py``: vectorised
re-implementations of the reference's synthetic test flows
(LagrangianCoherence examples/ideal_vortex.py:11-208): ideal saddle,
rotating saddle, uniform shear, and the Rankine-like moving vortex.  All
return ``(u, v, lats, lons, times)`` with winds shaped (T, ny, nx) [m/s],
time first.  The time labels are numpy ``datetime64[ns]`` at 6-hour steps
from 2000-01-01, the values ``pandas.date_range`` gives, without pandas.
"""
from __future__ import annotations

import numpy as np

__all__ = ["ideal_saddle", "rotating_saddle", "shear_flow", "ideal_vortex",
           "VORTEX_CONFIG_EQUATOR", "VORTEX_CONFIG_SUBTROPICAL",
           "SADDLE_CONFIG", "SHEAR_FLOW_CONFIG"]


def _grid(lat_min, lat_max, lon_min, lon_max, dx, dy, nt):
    lats = np.arange(lat_min, lat_max, dy, dtype=np.float64)
    lons = np.arange(lon_min, lon_max, dx, dtype=np.float64)
    times = np.datetime64("2000-01-01", "ns") \
        + np.arange(nt) * np.timedelta64(6, "h")
    return lats, lons, times


def ideal_saddle(lat_min, lat_max, lon_min, lon_max, dx, dy, nt,
                 max_intensity=10):
    """Steady saddle: u grows with row index, v with column index
    (LagrangianCoherence examples/ideal_vortex.py:34-38)."""
    lats, lons, times = _grid(lat_min, lat_max, lon_min, lon_max, dx, dy, nt)
    ny, nx = lats.size, lons.size
    yy = np.arange(ny)[:, None]
    xx = np.arange(nx)[None, :]
    u2d = max_intensity * yy / ny - 0.5 * max_intensity + 0.0 * xx
    v2d = max_intensity * xx / nx - 0.5 * max_intensity + 0.0 * yy
    u = np.broadcast_to(u2d, (nt, ny, nx)).copy()
    v = np.broadcast_to(v2d, (nt, ny, nx)).copy()
    return u, v, lats, lons, times


def rotating_saddle(lat_min, lat_max, lon_min, lon_max, dx, dy, nt,
                    max_intensity=10, center=(0.0, 0.0)):
    """Time-rotating saddle (LagrangianCoherence examples/ideal_vortex.py:69-76)."""
    lats, lons, times = _grid(lat_min, lat_max, lon_min, lon_max, dx, dy, nt)
    LON, LAT = np.meshgrid(lons, lats)
    nx_ = (LON - center[0]) / 180.0
    ny_ = (LAT - center[1]) / 90.0
    t = np.arange(nt)[:, None, None]
    s = np.sin(4 * t / nt)
    c = np.cos(4 * t / nt)
    u = np.sqrt(2) * max_intensity * (s * nx_ + (2 + c) * ny_)
    v = np.sqrt(2) * max_intensity * ((-2 * c) * nx_ - s * ny_)
    return u, v, lats, lons, times


def shear_flow(lat_min, lat_max, lon_min, lon_max, dx, dy, nt,
               max_intensity=10, **_ignored):
    """Uniform zonal flow (LagrangianCoherence examples/ideal_vortex.py:111-119)."""
    lats, lons, times = _grid(lat_min, lat_max, lon_min, lon_max, dx, dy, nt)
    ny, nx = lats.size, lons.size
    u = np.full((nt, ny, nx), float(max_intensity))
    v = np.zeros((nt, ny, nx))
    return u, v, lats, lons, times


def ideal_vortex(lat_min, lat_max, lon_min, lon_max, dx, dy, nt,
                 max_intensity=10, radius=5, center=None, u_c=0, v_c=0,
                 diag_factor=0, basic_zonal=2, k=0):
    """Rankine-like moving vortex plus background zonal flow
    (LagrangianCoherence examples/ideal_vortex.py:174-201)."""
    lats, lons, times = _grid(lat_min, lat_max, lon_min, lon_max, dx, dy, nt)
    LON, LAT = np.meshgrid(lons, lats)
    ny, nx = lats.size, lons.size
    u = np.zeros((nt, ny, nx))
    v = np.zeros((nt, ny, nx))
    for t in range(nt):
        new_x = LON - center[0] - u_c * t
        if k > 0:
            new_y = LAT - center[1] - v_c * np.sin(k * 2 * np.pi * t / nt)
        elif k == 0:
            new_y = LAT - center[1] - v_c * t
        else:
            raise ValueError("Meridional wavenumber k must be >= 0.")
        distance = np.sqrt(new_x ** 2 + new_y ** 2)
        theta = np.arccos(np.clip(new_y / (distance + 1e-8), -1.0, 1.0))
        mag = np.where(distance > radius,
                       max_intensity * radius ** 2 / (2 * np.maximum(distance, 1e-30)),
                       max_intensity * 0.5 * distance)
        u[t] = np.cos(theta) * mag + basic_zonal
        v[t] = np.where(new_x < 0, np.sin(theta), np.sin(theta + np.pi)) * mag
    return u, v, lats, lons, times


VORTEX_CONFIG_EQUATOR = dict(lat_min=-88, lat_max=89, lon_min=-180, lon_max=180,
                             dx=2, dy=2, u_c=0, k=4, v_c=0, nt=30, radius=2,
                             max_intensity=40, center=[-55, -20])

VORTEX_CONFIG_SUBTROPICAL = dict(lat_min=-88, lat_max=89, lon_min=-180,
                                 lon_max=180, dx=2, dy=2, u_c=0, k=0, v_c=0,
                                 nt=8, radius=2, max_intensity=60,
                                 center=[-55, -20], basic_zonal=0)

SADDLE_CONFIG = dict(lat_min=-70, lat_max=-10, lon_min=-70, lon_max=-10,
                     dx=1, dy=1, nt=10, max_intensity=10)

SHEAR_FLOW_CONFIG = dict(lat_min=-40, lat_max=40, lon_min=-60, lon_max=20,
                         dx=1, dy=1, nt=30, max_intensity=1)
