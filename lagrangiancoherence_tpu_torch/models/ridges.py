"""FTLE ridge extraction via the spherical Hessian — PyTorch, no LAPACK.

Counterpart of ``lagrangiancoherence_tpu/models/ridges.py``, the re-design
of the reference's ``find_ridges_spherical_hessian``
(LagrangianCoherence LCS/tools.py:52-155): Gaussian smooth → gradient →
Hessian → closed-form symmetric 2x2 eigensolve → masks, vectorised over
the grid on one device.

Quirk-Q7 note (SURVEY.md): the reference indexes ``eig[1][argmin(eig[0])]``,
taking a *row* of the eigenvector matrix where numpy stores eigenvectors as
*columns*; and its ``eigmin`` is the eigenvalue of **largest magnitude**
(``eig[0][argmax(abs(eig[0]))]``, tools.py:119).  Both quirks are reproduced
with ``compat=True``, under the JAX package's deterministic convention:
eigenvalues ascending (λ0 <= λ1), first eigenvector perpendicular to
``(half_diff + disc, b)``.  ``compat=False`` returns the textbook
min-eigenvalue *column* eigenvector.
"""
from __future__ import annotations

import numpy as np
import torch

from ..devices import download, resolve_device, upload
from ..grid import Grid
from ..ops.filters import gaussian_filter
from ..ops.stencil import derivative_spherical_coords
from ..utils.logging import timed_stage

__all__ = ["symmetric_eig_2x2", "find_ridges_core",
           "find_ridges_spherical_hessian"]


def symmetric_eig_2x2(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """Closed-form eigendecomposition of [[a, b], [b, c]] per point.

    Returns (lam0, lam1, v0, v1): eigenvalues ascending and unit column
    eigenvectors, v0 for lam0, v1 = perp(v0), with a trailing length-2
    component axis.
    """
    half_tr = 0.5 * (a + c)
    half_diff = 0.5 * (a - c)
    disc = torch.sqrt(half_diff * half_diff + b * b)
    lam0 = half_tr - disc
    lam1 = half_tr + disc
    # v1 (for lam1, the + root): direction (half_diff + disc, b), which is
    # non-degenerate whenever b != 0 or a != c; fall back to e_x when the
    # matrix is isotropic.
    vx = half_diff + disc
    vy = b
    norm = torch.sqrt(vx * vx + vy * vy)
    safe = norm > 0
    inv = torch.where(safe, 1.0 / torch.where(safe, norm, 1.0), 0.0)
    v1x = torch.where(safe, vx * inv, 1.0)
    v1y = torch.where(safe, vy * inv, 0.0)
    # v0 orthogonal to v1
    v0x = -v1y
    v0y = v1x
    v0 = torch.stack([v0x, v0y], dim=-1)
    v1 = torch.stack([v1x, v1y], dim=-1)
    return lam0, lam1, v0, v1


def find_ridges_core(field: torch.Tensor, grid: Grid, sigma,
                     tolerance_threshold: float = 0.0005e-3,
                     isglobal: bool = True, compat: bool = True):
    """Ridge pipeline on a (ny, nx) FTLE tensor, on its device and dtype.

    Returns a dict of tensors:
      ridges      — binary mask (1 on ridge points)
      eigmin      — quirk-Q7 "min" eigenvalue (largest-|λ|, compat) or true λmin
      dt_prod     — raw eigvector·gradient (the ridge alignment residual)
      eigvectors  — (ny, nx, 2) quirk rows (compat) or min-λ column vectors,
                    zeroed where eigmin >= 0 (tools.py:132)
      gradient    — (2, ny, nx) spherical gradient (d/dx, d/dy)
      angle       — orientation angle in degrees (tools.py:125)
    """
    lats, lons = grid.lats, grid.lons
    if sigma is not None:
        field = gaussian_filter(field, sigma=sigma)

    def d(f, dim):
        return derivative_spherical_coords(f, lats, lons, dim=dim,
                                           isglobal=isglobal)

    ddadx = d(field, 1)
    ddady = d(field, 0)
    d2dadx2 = d(ddadx, 1)
    d2dady2 = d(ddady, 0)
    d2dadxdy = d(ddadx, 0)  # the reference uses d/dy(d/dx) for both
    # off-diagonal entries (tools.py:82-83)

    # inf/NaN → 0 before the eigensolve (tools.py:93-94)
    def clean(x):
        return torch.where(torch.isfinite(x), x, 0.0)

    a = clean(d2dadx2)
    b = clean(d2dadxdy)
    c = clean(d2dady2)
    gx = ddadx
    gy = ddady

    lam0, lam1, v0, v1 = symmetric_eig_2x2(a, b, c)

    if compat:
        # quirk Q7: "eigvector" = matrix row at argmin(λ); with ascending
        # order that is row 0 = (v0[0], v1[0])
        ev = torch.stack([v0[..., 0], v1[..., 0]], dim=-1)
        # quirk: "eigmin" = eigenvalue of largest magnitude (tools.py:119)
        eigmin = torch.where(torch.abs(lam0) >= torch.abs(lam1), lam0, lam1)
    else:
        ev = v0
        eigmin = lam0

    dt_prod_raw = ev[..., 0] * gx + ev[..., 1] * gy

    on_ridge = (torch.abs(dt_prod_raw) <= tolerance_threshold) \
        & (torch.sign(eigmin) == -1)
    ridges = on_ridge.to(field.dtype)

    eigvectors = torch.where((eigmin < 0)[..., None], ev, 0.0)
    angle = (180.0 / np.pi) * torch.atan(
        eigvectors[..., 0] / eigvectors[..., 1])

    return dict(ridges=ridges, eigmin=eigmin, dt_prod=dt_prod_raw,
                eigvectors=eigvectors,
                gradient=torch.stack([gx, gy]), angle=angle)


def find_ridges_spherical_hessian(da, sigma=0.5, scheme: str = "first_order",
                                  tolerance_threshold: float = 0.0005e-3,
                                  return_eigvectors: bool = False,
                                  isglobal: bool = True, compat: bool = True,
                                  device=None):
    """Reference-signature facade (LagrangianCoherence LCS/tools.py:52-54).

    ``scheme`` is accepted and unused, exactly as in the reference (its body
    never reads it — SURVEY.md Q7).  Runs on ``device`` in
    ``torch.get_default_dtype()``, as the JAX facade follows the x64 switch.
    Returns host Fields: ``(ridges, eigmin)`` or, with
    ``return_eigvectors=True``,
    ``(ridges, eigmin, dt_prod, eigvectors, gradient, angle)``.  The span
    "Hessian ridges" (INFO) covers the call, its copies to the host
    included.
    """
    from ..field import Field, as_field
    with timed_stage("Hessian ridges"):
        device = resolve_device(device, da)
        dims = ("latitude", "longitude")
        field, lats, lons = upload(as_field(da).transpose(*dims), device,
                                   ascending=True)
        grid = Grid(lats=lats, lons=lons, cyclic_x=isglobal)
        out = find_ridges_core(field, grid, sigma, float(tolerance_threshold),
                               isglobal, compat)
        coords = {"latitude": lats, "longitude": lons}

        def host(name):
            return download(out[name])

        def f2(name):
            return Field(host(name), dims, dict(coords), name=name)

        ridges = f2("ridges")
        eigmin = f2("eigmin")
        if not return_eigvectors:
            return ridges, eigmin
        dt_prod = f2("dt_prod")
        eigvectors = Field(np.moveaxis(host("eigvectors"), -1, 0),
                           ("eigvectors",) + dims,
                           {**coords, "eigvectors": np.arange(2)},
                           name="eigvectors")
        gradient = Field(host("gradient"), ("elements",) + dims,
                         {**coords, "elements": np.arange(2)}, name="gradient")
        angle = f2("angle")
        return ridges, eigmin, dt_prod, eigvectors, gradient, angle
