"""Area of influence of attracting LCS ridges — vectorised walk + scatter, PyTorch.

Counterpart of ``lagrangiancoherence_tpu/models/area.py``, the re-design of
the reference's ``find_area`` (LagrangianCoherence
LCS/area_of_influence.py:17-87), which walks along the Hessian eigenvector
from every ridge point in a Python ``while`` loop, marking grid cells until
the walked distance exceeds ``2 * normal_radius``.  Here every ridge point
walks **in parallel**: a fixed-trip-count candidate sweep (``max_steps``)
generates all walk positions at once, nearest-grid-index snapping
(``torch.searchsorted``) replicates the reference's
``argmin(|coord - x|)`` (first-minimum tie-breaking), and one
``scatter_reduce(..., "amax")`` writes the influence mask.

Reference semantics kept exactly (see the JAX module for the line
citations): ``saturation_ratio = qdpt/qsat`` when both are given, else 0.5;
walk radius ``exp(ftle) * ridges * saturation_ratio``; the walk starts at
``pt - |ev| * r`` and marks the first position beyond the start; the
y-step uses eigvector component 0 and the x-step component 1; points whose
``sigma`` or eigvector is NaN are excluded.  ``overflow`` reports whether
any point wanted more steps than ``max_steps``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..devices import on_device, resolve_device
from ..grid import Grid

__all__ = ["find_area_core", "find_area"]


def _nearest_index(coords: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Index of the coordinate nearest to ``x`` with numpy-argmin
    first-minimum tie-breaking (lower index wins ties)."""
    n = coords.shape[0]
    hi = torch.clamp(torch.searchsorted(coords, x, side="left"), 1, n - 1)
    lo = hi - 1
    d_lo = torch.abs(x - coords[lo])
    d_hi = torch.abs(coords[hi] - x)
    return torch.where(d_lo <= d_hi, lo, hi)


def find_area_core(ftle: torch.Tensor, eigvectors: torch.Tensor,
                   ridges: torch.Tensor, grid: Grid, saturation_ratio,
                   max_steps: int = 128):
    """Influence mask from (ny, nx) FTLE, (ny, nx, 2) eigvectors and a ridge
    weight field (1 on ridges; NaN excludes a point entirely), on their
    device and in ``ftle``'s dtype.

    Returns ``(bounds, overflow)``: the binary (ny, nx) mask and a 0-dim
    bool tensor set when ``max_steps`` truncated any walk.
    """
    ny, nx = ftle.shape
    kw = dict(dtype=ftle.dtype, device=ftle.device)
    lats = torch.as_tensor(grid.lats, **kw)
    lons = torch.as_tensor(grid.lons, **kw)
    res = lats[1] - lats[0]

    sigma = torch.exp(ftle) * ridges
    normal_radius = sigma * saturation_ratio

    ev_y = eigvectors[..., 0]   # reference walks y with component 0
    ev_x = eigvectors[..., 1]   # and x with component 1
    valid = (~torch.isnan(sigma)) & (~torch.isnan(ev_x)) & (~torch.isnan(ev_y))

    lat_mesh, lon_mesh = torch.meshgrid(lats, lons, indexing="ij")
    r = torch.where(valid, normal_radius, 0.0)
    x_lower = lon_mesh - torch.abs(ev_x) * r
    y_lower = lat_mesh - torch.abs(ev_y) * r

    # step k (k = 1..max_steps) lands at lower + k*|ev|*res; the reference
    # marks step k iff the *previous* distance D_{k-1} = (k-1)*res*|ev| was
    # still <= 2r (while-condition checked before the increment+mark).
    k = torch.arange(1, max_steps + 1, **kw)[:, None, None]
    step_len = torch.sqrt(ev_x * ev_x + ev_y * ev_y) * res   # per-step distance
    d_prev = (k - 1.0) * step_len[None]
    marked = valid[None] & (d_prev <= 2.0 * r[None])

    xx = x_lower[None] + k * torch.abs(ev_x)[None] * res
    yy = y_lower[None] + k * torch.abs(ev_y)[None] * res
    xi = _nearest_index(lons, xx)
    yi = _nearest_index(lats, yy)

    bounds = torch.zeros(ny * nx, **kw).scatter_reduce(
        0, (yi * nx + xi).reshape(-1), marked.reshape(-1).to(ftle.dtype),
        "amax").reshape(ny, nx)

    # a walk overflows when even the last step's previous-distance was within
    # the radius (more marks wanted beyond the cap)
    overflow = (valid & ((max_steps - 1.0) * step_len <= 2.0 * r)
                & (step_len > 0)).any()
    return bounds, overflow


def find_area(ftle, eigvectors, ridges, qsat=None, qdpt=None,
              max_steps: int = 128, device=None):
    """Reference-signature facade
    (LagrangianCoherence LCS/area_of_influence.py:17), on ``device``.

    ``ftle``/``ridges``: Fields or arrays on (latitude, longitude);
    ``eigvectors``: Field with a leading ``eigvectors`` dim of length 2 (as
    returned by ``find_ridges_spherical_hessian``) or an (ny, nx, 2) array.
    Host arrays are computed in ``torch.get_default_dtype()``.  Returns the
    binary influence mask as a host Field.
    """
    from ..field import Field, as_field
    from ..utils.logging import logger
    device = resolve_device(device, ftle, eigvectors, ridges)
    ftle = as_field(ftle).sortby("latitude").sortby("longitude")
    ridges = as_field(ridges).sortby("latitude").sortby("longitude")
    if hasattr(eigvectors, "dims"):
        eigvectors = as_field(eigvectors).sortby("latitude").sortby("longitude")
        ev = np.moveaxis(np.asarray(eigvectors.data), 0, -1) \
            if eigvectors.dims[0] == "eigvectors" else np.asarray(eigvectors.data)
    else:
        ev = np.asarray(eigvectors)

    if qsat is None or qdpt is None:
        saturation_ratio = 0.5
    else:
        saturation_ratio = qdpt / qsat

    lats = ftle.coords["latitude"]
    lons = ftle.coords["longitude"]
    grid = Grid(lats=lats, lons=lons)
    bounds, overflow = find_area_core(
        on_device(ftle.data, device), on_device(ev, device),
        on_device(ridges.data, device), grid, saturation_ratio,
        max_steps=max_steps)
    if bool(overflow):
        logger.warning("find_area: max_steps=%d truncated at least one walk; "
                       "increase max_steps for full coverage", max_steps)
    return Field(bounds.cpu().numpy(), ("latitude", "longitude"),
                 {"latitude": lats, "longitude": lons}, name="bounds")
