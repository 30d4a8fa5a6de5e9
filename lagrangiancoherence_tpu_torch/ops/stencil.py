"""Finite-difference stencils on the sphere — PyTorch.

Counterpart of ``lagrangiancoherence_tpu/ops/stencil.py``:

* ``fourth_order_derivative`` (LagrangianCoherence LCS/tools.py:190-245): the
  4th-order centred stencil ``(4/3)(f[+1]-f[-1])/2 - (1/3)(f[+2]-f[-2])/4``
  with one-sided ``(f[+1]-f)/2`` / ``(f-f[-1])/2`` within two rows of the
  latitude edges, and in longitude cyclic indexing when ``isglobal`` or the
  same one-sided columns at the two edges otherwise;
* ``derivative_spherical_coords`` (LagrangianCoherence LCS/tools.py:248-267):
  metric scaling ``dx = (pi/180) dlon R cos(lat)``, ``dy = (pi/180) dlat R``,
  with the stencil stage in float32 even for float64 input (quirk Q6,
  LagrangianCoherence LCS/tools.py:258).

``row_scale`` keeps ``dx`` on the device, once a grid, dtype and device,
for the gradient kernel (``ops/cuda_ftle.py``); ``derivative_spherical_coords``
forms the same tensor at every call.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..grid import EARTH_RADIUS
from .interp import _div

__all__ = ["fourth_order_derivative", "derivative_spherical_coords",
           "lat_scale", "row_scale"]


def _centered(arr: torch.Tensor, dim: int) -> torch.Tensor:
    """4th-order centred difference with periodic wraparound along ``dim``."""
    p1 = torch.roll(arr, -1, dims=dim)
    m1 = torch.roll(arr, 1, dims=dim)
    p2 = torch.roll(arr, -2, dims=dim)
    m2 = torch.roll(arr, 2, dims=dim)
    return (4.0 / 3.0) * (p1 - m1) / 2.0 - (1.0 / 3.0) * (p2 - m2) / 4.0


def fourth_order_derivative(arr: torch.Tensor, dim: int = 0,
                            isglobal: bool = True) -> torch.Tensor:
    """Semantics of the reference numba stencil on a 2-D [lat, lon] array.

    dim=0 (latitude): centred interior, one-sided within 2 rows of each edge
    (tools.py:209-217).  dim=1 (longitude): fully cyclic when ``isglobal``;
    otherwise one-sided at the two columns nearest each boundary.
    """
    if dim not in (0, 1):
        raise ValueError("dim must be 0 or 1")
    out = _centered(arr, dim)
    if dim == 1 and isglobal:
        return out
    fwd = (torch.roll(arr, -1, dims=dim) - arr) / 2.0
    bwd = (arr - torch.roll(arr, 1, dims=dim)) / 2.0
    n = arr.shape[dim]
    pos = torch.arange(n, device=arr.device)
    pos = pos[:, None] if dim == 0 else pos[None, :]
    out = torch.where(pos < 2, fwd, out)
    return torch.where(pos >= n - 2, bwd, out)


def derivative_spherical_coords(values: torch.Tensor, lats: np.ndarray,
                                lons: np.ndarray, dim: int = 0,
                                isglobal: bool = True,
                                out_dtype: torch.dtype | None = None
                                ) -> torch.Tensor:
    """Metric-scaled spherical derivative (LagrangianCoherence LCS/tools.py:248-267).

    The stencil stage runs in float32 (quirk Q6); the metric division
    promotes back to ``out_dtype`` (default: the dtype of ``values``), and
    in longitude to at least ``torch.get_default_dtype()``, as JAX's does.
    """
    if out_dtype is None:
        out_dtype = values.dtype
    deriv = fourth_order_derivative(values.to(torch.float32), dim=dim,
                                    isglobal=isglobal).to(out_dtype)
    if dim == 0:
        return _div(deriv, lat_scale(lats))
    return deriv / _row_scale(lats, lons[1] - lons[0], out_dtype,
                              values.device)[:, None]


def lat_scale(lats: np.ndarray) -> float:
    """``dy = (pi/180) dlat R``, the latitude derivative's divisor."""
    return float((np.pi / 180.0) * (lats[1] - lats[0]) * EARTH_RADIUS)


def _row_scale(lats: np.ndarray, dlon: float, dtype: torch.dtype,
               device) -> torch.Tensor:
    """``dx = (pi/180) dlon R cos(lat)`` a row, ``cos`` in ``dtype``, the
    product in ``dtype`` widened to the default dtype."""
    y = torch.tensor(lats, dtype=dtype, device=device) * (np.pi / 180.0)
    # JAX scales by a numpy float64, which widens the result to the widest
    # float its x64 switch allows; the default dtype is that switch here
    wide = torch.promote_types(dtype, torch.get_default_dtype())
    return float((np.pi / 180.0) * dlon * EARTH_RADIUS) \
        * torch.cos(y).to(wide)


@lru_cache(maxsize=32)
def _cached_row_scale(lats: bytes, dlon: float, dtype: torch.dtype,
                      default: torch.dtype,
                      device: torch.device) -> torch.Tensor:
    return _row_scale(np.frombuffer(lats), dlon, dtype, device)


def row_scale(lats: np.ndarray, lons: np.ndarray, dtype: torch.dtype,
              device) -> torch.Tensor:
    """``derivative_spherical_coords``' row scale ``dx`` (ny,) for values in
    ``dtype`` on ``device``, built by the same expression on first use and
    kept there, one tensor per latitudes, longitude spacing, dtype, default
    dtype and device.  Read-only: the caller shares it."""
    lats = np.ascontiguousarray(lats, dtype=np.float64)
    return _cached_row_scale(lats.tobytes(), float(lons[1] - lons[0]), dtype,
                             torch.get_default_dtype(), torch.device(device))
