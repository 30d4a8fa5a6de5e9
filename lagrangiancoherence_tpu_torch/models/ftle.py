"""Flow-map deformation gradient and FTLE norm — PyTorch.

Counterpart of ``lagrangiancoherence_tpu/models/ftle.py``
(LagrangianCoherence LCS/LCS.py:142-157,171-225): the deformation tensor and its
largest singular value in closed form, with no per-point SVD.

* ``compat=True`` (default) reproduces quirk Q1: the reference reshapes its
  9-element derivative stack row-major to [3,3], so the matrix is the
  *scrambled* ``[[dXdx,dXdy,dYdx],[dYdy,dZdx,dZdy],[0,0,0]]``; its largest
  singular value is sqrt(lambda_max(A A^T)) for the 2x3 top block A.
* ``compat=False`` computes the textbook Cauchy-Green norm from the true
  Jacobian ``[[dXdx,dXdy],[dYdx,dYdy],[dZdx,dZdy]]``.

A point with a NaN anywhere in its tensor is NaN in the output, as the
reference's stack/dropna/unstack round trip leaves it
(LagrangianCoherence LCS/LCS.py:145-157).
"""
from __future__ import annotations

import numpy as np
import torch

from ..grid import EARTH_RADIUS
from ..ops.filters import gaussian_filter
from ..ops.stencil import derivative_spherical_coords

__all__ = ["flowmap_gradient", "ftle_norm", "ftle_from_departures"]


def flowmap_gradient(x_dep: torch.Tensor, y_dep: torch.Tensor, grid,
                     sigma=None) -> torch.Tensor:
    """Departure lon/lat -> (9, ny, nx) deformation stack in the reference's
    element order [dXdx, dXdy, dYdx, dYdy, dZdx, dZdy, 0, 0, 0]
    (LagrangianCoherence LCS/LCS.py:171-225)."""
    if sigma is not None:
        x_dep = gaussian_filter(x_dep, sigma=sigma)
        y_dep = gaussian_filter(y_dep, sigma=sigma)
    lon = x_dep * (np.pi / 180.0)
    colat = (y_dep - 90.0) * (np.pi / 180.0)  # colatitude (LCS.py:196)
    sin_colat = torch.sin(colat)
    X = EARTH_RADIUS * sin_colat * torch.cos(lon)
    Y = EARTH_RADIUS * sin_colat * torch.sin(lon)
    Z = EARTH_RADIUS * torch.cos(colat)

    def d(f, dim):
        return derivative_spherical_coords(f, grid.lats, grid.lons, dim=dim)

    zero = torch.zeros_like(X)
    return torch.stack([d(X, 1), d(X, 0), d(Y, 1), d(Y, 0), d(Z, 1), d(Z, 0),
                        zero, zero, zero])


def _sigma_max_2xk(rows) -> torch.Tensor:
    """Largest singular value of a 2xK matrix given its two rows (each a list
    of equal-shaped tensors), via the closed-form 2x2 Gram eigenvalue."""
    r0, r1 = rows
    g11 = sum(a * a for a in r0)
    g22 = sum(a * a for a in r1)
    g12 = sum(a * b for a, b in zip(r0, r1))
    tr = g11 + g22
    disc = torch.sqrt(torch.clamp((g11 - g22) ** 2 + 4.0 * g12 * g12,
                                  min=0.0))
    lam_max = 0.5 * (tr + disc)
    return torch.sqrt(torch.clamp(lam_max, min=0.0))


def ftle_norm(def_tensor: torch.Tensor, compat: bool = True) -> torch.Tensor:
    """Per-point matrix 2-norm of the (9, ny, nx) deformation stack."""
    t = def_tensor
    if compat:
        rows = ([t[0], t[1], t[2]], [t[3], t[4], t[5]])
    else:
        # F^T F with F columns (dX/dx,dY/dx,dZ/dx) and (dX/dy,dY/dy,dZ/dy)
        rows = ([t[0], t[2], t[4]], [t[1], t[3], t[5]])
    out = _sigma_max_2xk(rows)
    bad = torch.isnan(def_tensor).any(dim=0)
    return torch.where(bad, torch.full((), float("nan"), dtype=out.dtype,
                                       device=out.device), out)


def ftle_from_departures(x_dep: torch.Tensor, y_dep: torch.Tensor, grid,
                         sigma=None, compat: bool = True) -> torch.Tensor:
    """Departure points -> (ny, nx) FTLE-norm field."""
    return ftle_norm(flowmap_gradient(x_dep, y_dep, grid, sigma=sigma),
                     compat=compat)
