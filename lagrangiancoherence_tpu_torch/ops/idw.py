"""Haversine distance + inverse-distance-weighted scattered interpolation — PyTorch.

Counterpart of ``lagrangiancoherence_tpu/ops/idw.py``, the re-design of the
reference's numba kernels (LagrangianCoherence LCS/tools.py:271-299): the
O(N*M) double loop becomes one broadcast distance matrix and two reductions.
``idw_regrid`` replaces the xarray wrapper ``xr_idx_interp``
(LagrangianCoherence LCS/tools.py:302-333).
"""
from __future__ import annotations

import numpy as np
import torch

from ..devices import on_device, resolve_device

__all__ = ["haversine", "idw_interpolate", "idw_regrid"]

EQUATOR_RADIUS_KM = 6378.1  # the reference uses the equatorial radius here
# (LagrangianCoherence LCS/tools.py:274), unlike the mean radius elsewhere


def haversine(lon1, lat1, lon2, lat2):
    """Great-circle distance in km, broadcasting over tensor arguments.

    Matches the reference formula (LagrangianCoherence LCS/tools.py:271-281)
    as the JAX package reads it: numpy's two-argument ``arctan(sqrt(a),
    sqrt(1-a))`` writes into ``out=`` and returns plain
    ``arctan(sqrt(a))``, so the distance is ``2*arctan(sqrt(a))`` times the
    radius.
    """
    rad = np.pi / 180.0
    dlon = (lon2 - lon1) * rad
    dlat = (lat2 - lat1) * rad
    a = torch.sin(dlat / 2.0) ** 2 + torch.cos(lat1 * rad) \
        * torch.cos(lat2 * rad) * torch.sin(dlon / 2.0) ** 2
    c = 2.0 * torch.atan(torch.sqrt(torch.clamp(a, 0.0, 1.0)))
    return EQUATOR_RADIUS_KM * c


def idw_interpolate(x, y, z, xi, yi, power: float = 2.0,
                    device=None) -> torch.Tensor:
    """Inverse-distance-weighted interpolation of scattered samples
    ``(x, y, z)`` onto query points ``(xi, yi)`` on ``device``
    (LagrangianCoherence LCS/tools.py:284-299).  Computes the full
    (n_query, n_sample) haversine matrix in one shot."""
    device = resolve_device(device, x, y, z, xi, yi)
    x, y, z, xi, yi = (on_device(a, device) for a in (x, y, z, xi, yi))
    d = haversine(x[None, :], y[None, :], xi[:, None], yi[:, None])
    w = 1.0 / torch.pow(d, power)
    return (w @ z) / torch.sum(w, dim=1)


def idw_regrid(sample_lons, sample_lats, sample_vals, lons, lats,
               power: float = 2.0, device=None) -> np.ndarray:
    """Regrid scattered samples onto a regular (lats, lons) mesh — the
    ``xr_idx_interp`` contract (LagrangianCoherence LCS/tools.py:302-333)
    without the xarray wrapper.  Returns an (n_lat, n_lon) host array."""
    LON, LAT = np.meshgrid(np.asarray(lons), np.asarray(lats))
    out = idw_interpolate(sample_lons, sample_lats, sample_vals,
                          LON.ravel(), LAT.ravel(), power=power,
                          device=device)
    return out.cpu().numpy().reshape(LAT.shape)
