"""Regridding to the reference's common global grid — PyTorch.

Counterpart of ``lagrangiancoherence_tpu/ops/regrid.py``: the xarray pair
``interp(method='linear')`` + ``reindex(method='nearest')`` with NaN
fallback of the ``isglobal`` preprocessing path
(LagrangianCoherence LCS/LCS.py:107-114) — bilinear interpolation wherever
the target point is inside the source hull, nearest neighbour outside.  The
per-axis weights are numpy on the host; the taps are ``index_select``
gathers on the device, combined in JAX's expression order.
"""
from __future__ import annotations

import numpy as np
import torch

from ..devices import on_device, resolve_device

__all__ = ["regrid_linear_nearest"]


def _axis_weights(src: np.ndarray, dst: np.ndarray):
    """For each dst coordinate: bracketing src indices, linear weight, and an
    in-hull mask; plus the nearest src index (ties resolve to the lower
    coordinate, matching xarray/pandas nearest reindex).  ``src`` may run in
    either order, as xarray's ``interp`` takes it (an ERA5 record's
    latitudes descend): the brackets are found on the ascending coordinates
    and mapped back to ``src``'s own indices."""
    order = np.argsort(np.asarray(src, dtype=np.float64), kind="stable")
    lo, hi, t, inside, nearest = _ascending_weights(
        np.asarray(src, dtype=np.float64)[order], dst)
    return order[lo], order[hi], t, inside, order[nearest]


def _ascending_weights(src: np.ndarray, dst: np.ndarray):
    dst = np.asarray(dst, dtype=np.float64)
    n = src.shape[0]
    hi = np.searchsorted(src, dst, side="left")
    lo = np.clip(hi - 1, 0, n - 1)
    hi = np.clip(hi, 0, n - 1)
    denom = np.where(src[hi] > src[lo], src[hi] - src[lo], 1.0)
    t = np.clip((dst - src[lo]) / denom, 0.0, 1.0)
    inside = (dst >= src[0]) & (dst <= src[-1])
    # nearest: compare distance to lo/hi brackets, clip outside to edge
    d_lo = np.abs(dst - src[lo])
    d_hi = np.abs(src[hi] - dst)
    nearest = np.where(d_hi < d_lo, hi, lo)
    return lo, hi, t, inside, nearest


def regrid_linear_nearest(field, src_lats: np.ndarray, src_lons: np.ndarray,
                          dst_lats: np.ndarray, dst_lons: np.ndarray,
                          device=None) -> torch.Tensor:
    """Regrid ``field`` (..., ny_src, nx_src) onto (dst_lats, dst_lons) on
    ``device``: bilinear inside the source domain, nearest-neighbour outside
    (the reference's NaN-fallback composite,
    LagrangianCoherence LCS/LCS.py:109-114).  A host array is computed in
    ``torch.get_default_dtype()``, a tensor in its own dtype."""
    device = resolve_device(device, field)
    f = on_device(field, device)
    ylo, yhi, ty, y_in, y_near = _axis_weights(src_lats, dst_lats)
    xlo, xhi, tx, x_in, x_near = _axis_weights(src_lons, dst_lons)

    def idx(a):
        return torch.as_tensor(a, dtype=torch.int64, device=device)

    ty_t = torch.as_tensor(ty, dtype=f.dtype, device=device)[:, None]
    tx_t = torch.as_tensor(tx, dtype=f.dtype, device=device)[None, :]

    def take_yx(yi, xi):
        return torch.index_select(torch.index_select(f, -2, idx(yi)), -1,
                                  idx(xi))

    v00 = take_yx(ylo, xlo)
    v01 = take_yx(ylo, xhi)
    v10 = take_yx(yhi, xlo)
    v11 = take_yx(yhi, xhi)
    linear = (v00 * (1 - ty_t) * (1 - tx_t) + v01 * (1 - ty_t) * tx_t
              + v10 * ty_t * (1 - tx_t) + v11 * ty_t * tx_t)
    nearest = take_yx(y_near, x_near)
    inside = torch.as_tensor(y_in[:, None] & x_in[None, :], device=device)
    return torch.where(inside, linear, nearest)
