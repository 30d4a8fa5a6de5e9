"""Finite-difference stencils on the sphere — PyTorch.

Counterpart of ``lagrangiancoherence_tpu/ops/stencil.py``:

* ``fourth_order_derivative`` (LagrangianCoherence LCS/tools.py:190-245): the
  4th-order centred stencil ``(4/3)(f[+1]-f[-1])/2 - (1/3)(f[+2]-f[-2])/4``
  with one-sided ``(f[+1]-f)/2`` / ``(f-f[-1])/2`` within two rows of the
  latitude edges, and cyclic indexing in longitude (the ``isglobal`` case,
  the only one the FTLE path uses);
* ``derivative_spherical_coords`` (LagrangianCoherence LCS/tools.py:248-267):
  metric scaling ``dx = (pi/180) dlon R cos(lat)``, ``dy = (pi/180) dlat R``,
  with the stencil stage in float32 even for float64 input (quirk Q6,
  LagrangianCoherence LCS/tools.py:258).
"""
from __future__ import annotations

import numpy as np
import torch

from ..grid import EARTH_RADIUS
from .interp import _div

__all__ = ["fourth_order_derivative", "derivative_spherical_coords"]


def _centered(arr: torch.Tensor, dim: int) -> torch.Tensor:
    """4th-order centred difference with periodic wraparound along ``dim``."""
    p1 = torch.roll(arr, -1, dims=dim)
    m1 = torch.roll(arr, 1, dims=dim)
    p2 = torch.roll(arr, -2, dims=dim)
    m2 = torch.roll(arr, 2, dims=dim)
    return (4.0 / 3.0) * (p1 - m1) / 2.0 - (1.0 / 3.0) * (p2 - m2) / 4.0


def fourth_order_derivative(arr: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Semantics of the reference numba stencil on a 2-D [lat, lon] array.

    dim=0 (latitude): centred interior, one-sided within 2 rows of each edge
    (tools.py:209-217).  dim=1 (longitude): fully cyclic.
    """
    if dim not in (0, 1):
        raise ValueError("dim must be 0 or 1")
    out = _centered(arr, dim)
    if dim == 1:
        return out
    fwd = (torch.roll(arr, -1, dims=0) - arr) / 2.0
    bwd = (arr - torch.roll(arr, 1, dims=0)) / 2.0
    row = torch.arange(arr.shape[0], device=arr.device)[:, None]
    out = torch.where(row < 2, fwd, out)
    return torch.where(row >= arr.shape[0] - 2, bwd, out)


def derivative_spherical_coords(values: torch.Tensor, lats: np.ndarray,
                                lons: np.ndarray,
                                dim: int = 0) -> torch.Tensor:
    """Metric-scaled spherical derivative (LagrangianCoherence LCS/tools.py:248-267).

    The stencil stage runs in float32 (quirk Q6); the metric division
    promotes back to the dtype of ``values``.
    """
    out_dtype = values.dtype
    deriv = fourth_order_derivative(values.to(torch.float32),
                                    dim=dim).to(out_dtype)
    if dim == 0:
        dy = (np.pi / 180.0) * (lats[1] - lats[0]) * EARTH_RADIUS
        return _div(deriv, float(dy))
    y = torch.tensor(lats, dtype=out_dtype,
                     device=values.device) * (np.pi / 180.0)
    dx = float((np.pi / 180.0) * (lons[1] - lons[0]) * EARTH_RADIUS) \
        * torch.cos(y)
    return deriv / dx[:, None]
