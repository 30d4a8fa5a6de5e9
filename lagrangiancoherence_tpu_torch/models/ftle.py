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

On CUDA tensors of float32 or float64 each function launches one
hand-written kernel (``ops/cuda_ftle.py``) that computes the same values as
the PyTorch path below, with the row scale kept on the card
(``ops/stencil.row_scale``), so a field neither waits on the host nor
issues the path's ~60 small launches.  The CPU, other dtypes and grids
below 5 x 5 take the PyTorch path.
"""
from __future__ import annotations

import numpy as np
import torch

from ..grid import EARTH_RADIUS
from ..ops import cuda_ftle
from ..ops.filters import gaussian_filter
from ..ops.stencil import derivative_spherical_coords, lat_scale, row_scale

__all__ = ["flowmap_gradient", "flowmap_gradient_torch", "ftle_norm",
           "ftle_norm_torch", "ftle_from_departures"]


def flowmap_gradient(x_dep: torch.Tensor, y_dep: torch.Tensor, grid,
                     sigma=None) -> torch.Tensor:
    """Departure lon/lat -> (9, ny, nx) deformation stack in the reference's
    element order [dXdx, dXdy, dYdx, dYdy, dZdx, dZdy, 0, 0, 0]
    (LagrangianCoherence LCS/LCS.py:171-225)."""
    if sigma is not None:
        x_dep = gaussian_filter(x_dep, sigma=sigma)
        y_dep = gaussian_filter(y_dep, sigma=sigma)
    if _gradient_kernel_applies(x_dep, y_dep, grid):
        dx = row_scale(grid.lats, grid.lons, x_dep.dtype, x_dep.device)
        return cuda_ftle.ftle_gradient(x_dep.contiguous(), y_dep.contiguous(),
                                       dx, lat_scale(grid.lats))
    return flowmap_gradient_torch(x_dep, y_dep, grid)


def flowmap_gradient_torch(x_dep: torch.Tensor, y_dep: torch.Tensor,
                           grid) -> torch.Tensor:
    """``flowmap_gradient``'s PyTorch path (no smoothing), on any device:
    the plain version that the gradient kernel is held against."""
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


def _gradient_kernel_applies(x_dep: torch.Tensor, y_dep: torch.Tensor,
                             grid) -> bool:
    """Whether ``flowmap_gradient`` launches the kernel: (ny, nx) CUDA
    tensors of one float dtype, a row a latitude, ny, nx >= 5."""
    return (x_dep.device.type == "cuda" and x_dep.dtype in cuda_ftle.DTYPES
            and y_dep.dtype == x_dep.dtype and y_dep.device == x_dep.device
            and x_dep.ndim == 2 and y_dep.shape == x_dep.shape
            and x_dep.shape[0] == grid.lats.shape[0]
            and min(x_dep.shape) >= cuda_ftle.MIN_SIZE)


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
    if def_tensor.device.type == "cuda" \
            and def_tensor.dtype in cuda_ftle.DTYPES \
            and def_tensor.ndim >= 1 and def_tensor.shape[0] == 9:
        return cuda_ftle.ftle_norm(def_tensor.contiguous(), compat=compat)
    return ftle_norm_torch(def_tensor, compat=compat)


def ftle_norm_torch(def_tensor: torch.Tensor,
                    compat: bool = True) -> torch.Tensor:
    """``ftle_norm``'s PyTorch path, on any device: the plain version that
    the norm kernel is held against."""
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
