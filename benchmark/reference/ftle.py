"""Plain reference of the FTLE field: winds in, FTLE norm out.

The semantics of LagrangianCoherence's ``LCS`` core path, stated plainly in
PyTorch and scipy (it imports nothing of the measured program):

* ``map_coordinates(mode='wrap', order=3)`` at each parcel, for every row
  but the ``order`` rows nearest each pole (LCS/tools.py:11-48): the
  index scaling ``n * (p - min) / (max - min)`` (quirk Q4), the coordinate
  folded with period ``n - 1``, taps mirrored about the edge samples, on
  coefficients of scipy's own prefilter (``spline_filter1d`` applied to the
  identity gives its matrix);
* ``map_coordinates(mode='constant', order=1)`` on the raw winds for the
  pole rows, keyed on the parcel's home row;
* the SETTLS loop of LCS/trajectory.py:80-124 (winds indexed forward for a
  backward step, quirk Q2; the cumulative correction, quirk Q3; the wrap and
  clamp of quirk Q5);
* the deformation gradient of LCS/LCS.py:171-225 with the stencil in
  float32 (quirk Q6) and the 2-norm of the row-major [3, 3] reshape of the
  nine derivatives (quirk Q1), the root of the larger eigenvalue of a
  2x2 Gram matrix.

``dtype`` is the precision of the reference (float64) or of the control
(float32, with ``tf32=True`` rounding every matmul operand to TF32's 10-bit
mantissa, as the tensor cores do when TF32 is on).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import scipy.ndimage
import torch

EARTH_RADIUS = 6371000.0


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to the nearest TF32 value (10-bit mantissa)."""
    if x.is_complex():
        return torch.complex(round_tf32(x.real.contiguous()),
                             round_tf32(x.imag.contiguous()))
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def matmul(a, b, tf32: bool):
    if tf32:
        a, b = round_tf32(a), round_tf32(b)
    return torch.matmul(a, b)


@lru_cache(maxsize=8)
def filter_matrix(n: int, order: int) -> np.ndarray:
    """scipy's spline prefilter along one axis as a matrix: the filter of
    the identity (``mode='wrap'``, as ``map_coordinates`` prefilters)."""
    return scipy.ndimage.spline_filter1d(np.eye(n), order=order, axis=0,
                                         mode="wrap")


def prefilter(f: torch.Tensor, order: int, tf32: bool = False):
    """Coefficients of (..., ny, nx) fields: ``M_y @ f @ M_x^T``."""
    ny, nx = f.shape[-2:]
    kw = dict(dtype=f.dtype, device=f.device)
    my = torch.tensor(filter_matrix(ny, order), **kw)
    mxt = torch.tensor(filter_matrix(nx, order).T.copy(), **kw)
    return matmul(matmul(my, f, tf32), mxt, tf32)


def _fold(x, n: int):
    sz = float(n - 1)
    return torch.where(x < 0, x + sz * (torch.floor(-x / sz) + 1.0),
                       torch.where(x > sz, x - sz * torch.floor(x / sz), x))


def _mirror(i, n: int):
    i = torch.where(i < 0, -i, i)
    return torch.where(i > n - 1, 2 * (n - 1) - i, i)


def _cubic(t):
    s = 1.0 - t
    return torch.stack([s * s * s / 6.0, 2.0 / 3.0 - t * t + 0.5 * t * t * t,
                        2.0 / 3.0 - s * s + 0.5 * s * s * s, t * t * t / 6.0],
                       dim=-1)


def _taps(x, n: int):
    """(N, 4) mirrored tap indices and cubic weights at the folded index."""
    x = _fold(x, n)
    i0 = torch.floor(x)
    t = x - i0
    idx = i0.to(torch.int64)[:, None] + torch.arange(-1, 3, device=x.device)
    return _mirror(idx, n), _cubic(t)


class Interpolator:
    """Evaluates F fields (raw and coefficients, (F, ny, nx)) at parcel
    positions with the pole rows' special case."""

    def __init__(self, lats, lons, order: int, device):
        if order != 3:
            raise NotImplementedError(f"cubic taps only, not order {order}")
        self.ny, self.nx = len(lats), len(lons)
        self.order = order
        self.x0, self.x1 = float(np.min(lons)), float(np.max(lons))
        self.y0, self.y1 = float(np.min(lats)), float(np.max(lats))
        rows = torch.arange(self.ny, device=device)
        self.pole = (rows < order) | (rows >= self.ny - order)

    def __call__(self, raw, coeffs, px, py):
        ny, nx = self.ny, self.nx
        xi = nx * (px - self.x0) / (self.x1 - self.x0)
        yi = ny * (py - self.y0) / (self.y1 - self.y0)
        flat_x, flat_y = xi.reshape(-1), yi.reshape(-1)
        iy, wy = _taps(flat_y, ny)
        ix, wx = _taps(flat_x, nx)
        f = coeffs.shape[0]
        table = coeffs.reshape(f, ny * nx)
        out = torch.zeros((f, flat_x.numel()), dtype=coeffs.dtype,
                          device=coeffs.device)
        for j in range(4):
            for k in range(4):
                w = (wy[:, j] * wx[:, k]).to(coeffs.dtype)
                out += table[:, iy[:, j] * nx + ix[:, k]] * w
        out = out.reshape((f,) + px.shape)
        # order-1, mode='constant' (cval 0) on the raw fields, pole rows
        pr = self.pole
        ys, xs = yi[pr], xi[pr]
        inside = (ys >= 0) & (ys <= ny - 1) & (xs >= 0) & (xs <= nx - 1)
        y0 = torch.clamp(torch.floor(ys), 0, ny - 2)
        x0 = torch.clamp(torch.floor(xs), 0, nx - 2)
        ty, tx = ys - y0, xs - x0
        base = (y0.to(torch.int64) * nx + x0.to(torch.int64)).reshape(-1)
        rawt = raw.reshape(f, ny * nx)

        def tap(off, w):
            return rawt[:, base + off].reshape((f,) + ys.shape) * w

        lin = (tap(0, (1 - ty) * (1 - tx)) + tap(1, (1 - ty) * tx)
               + tap(nx, ty * (1 - tx)) + tap(nx + 1, ty * tx))
        out[:, pr] = torch.where(inside, lin, torch.zeros((), dtype=lin.dtype,
                                                          device=lin.device))
        return out


def departure_points(u, v, lats, lons, timestep: float, *, settls_order: int,
                     order: int, cyclic_x: bool, tf32: bool = False):
    """Final positions after ``T - 1`` SETTLS steps from the grid mesh."""
    dev, dtype = u.device, u.dtype
    lats_t = torch.tensor(np.asarray(lats), dtype=dtype, device=dev)
    lons_t = torch.tensor(np.asarray(lons), dtype=dtype, device=dev)
    py, px = torch.meshgrid(lats_t, lons_t, indexing="ij")
    conv_y = 180.0 / (EARTH_RADIUS * np.pi)
    conv_x = (conv_y / torch.abs(torch.cos(lats_t * np.pi / 180.0)))[:, None]
    y_min, y_max = float(np.min(lats)), float(np.max(lats))
    x_min, x_max = float(np.min(lons)), float(np.max(lons))

    def clamp_wrap(px, py):
        py = torch.where(py > y_min, py, y_min)
        py = torch.where(py < y_max, py, y_max)
        if cyclic_x:
            px = torch.where(px > -180.0, px, torch.remainder(px, 180.0))
            px = torch.where(px < 180.0, px,
                             -180.0 + torch.remainder(px, 180.0))
        else:
            px = torch.clamp(px, x_min, x_max)
        return px, py

    interp = Interpolator(lats, lons, order, dev)
    cu = prefilter(u, order, tf32)
    cv = prefilter(v, order, tf32)
    dt = float(timestep)
    for t in range(u.shape[0] - 1):
        raw = torch.stack([u[t], v[t]])
        ua, va = interp(raw, torch.stack([cu[t], cv[t]]), px, py)
        py = py + dt * conv_y * va
        px = px + dt * conv_x * ua
        px, py = clamp_wrap(px, py)
        raw4 = torch.stack([u[t], v[t], u[t + 1], v[t + 1]])
        c4 = torch.stack([cu[t], cv[t], cu[t + 1], cv[t + 1]])
        for _ in range(settls_order):
            ut, vt, un, vn = interp(raw4, c4, px, py)
            py = py + 0.5 * dt * conv_y * (va + 2 * vt - vn)
            px = px + 0.5 * dt * conv_x * (ua + 2 * ut - un)
            px, py = clamp_wrap(px, py)
    return px, py


def _stencil(f, dim: int):
    """LCS/tools.py:190-245 on a global field, in ``f``'s dtype."""
    n = f.shape[dim]
    if dim == 1:
        p1, m1 = torch.roll(f, -1, 1), torch.roll(f, 1, 1)
        p2, m2 = torch.roll(f, -2, 1), torch.roll(f, 2, 1)
        return (4 / 3) * (p1 - m1) / 2 - (1 / 3) * (p2 - m2) / 4
    out = torch.zeros_like(f)
    out[2:n - 2] = ((4 / 3) * (f[3:n - 1] - f[1:n - 3]) / 2
                    - (1 / 3) * (f[4:] - f[:n - 4]) / 4)
    out[0:2] = (f[1:3] - f[0:2]) / 2
    out[n - 2:] = (f[n - 2:] - f[n - 3:n - 1]) / 2
    return out


def _derivative(f, lats, lons, dim: int):
    """LCS/tools.py:248-267: the stencil in float32 (quirk Q6), then the
    metric in ``f``'s dtype."""
    d = _stencil(f.to(torch.float32), dim).to(f.dtype)
    if dim == 0:
        return d / ((np.pi / 180.0) * (lats[1] - lats[0]) * EARTH_RADIUS)
    lat = torch.tensor(np.asarray(lats), dtype=f.dtype, device=f.device)
    dx = (np.pi / 180.0) * (lons[1] - lons[0]) * EARTH_RADIUS \
        * torch.cos(lat * np.pi / 180.0)
    return d / dx[:, None]


def ftle_from_departures(px, py, lats, lons):
    """The deformation gradient's Q1 2-norm, in ``px``'s dtype."""
    lon = px * np.pi / 180.0
    colat = (py - 90.0) * np.pi / 180.0
    X = EARTH_RADIUS * torch.sin(colat) * torch.cos(lon)
    Y = EARTH_RADIUS * torch.sin(colat) * torch.sin(lon)
    Z = EARTH_RADIUS * torch.cos(colat)
    lats, lons = np.asarray(lats), np.asarray(lons)
    comps = [_derivative(c, lats, lons, d) for c in (X, Y, Z) for d in (1, 0)]
    # the nine values [dXdx, dXdy, dYdx, dYdy, dZdx, dZdy, 0, 0, 0] read
    # row-major as a 3x3 matrix whose last row is zero: its 2-norm is the
    # root of the largest eigenvalue of the 2x2 Gram matrix [[p, q], [q, r]]
    # of the top 2x3 block's rows
    r0, r1 = comps[0:3], comps[3:6]
    p = sum(x * x for x in r0)
    r = sum(x * x for x in r1)
    q = sum(x * y for x, y in zip(r0, r1))
    lam = 0.5 * (p + r) + torch.sqrt(0.25 * (p - r) ** 2 + q * q)
    bad = torch.stack(comps).isnan().any(0)
    out = torch.sqrt(lam)
    return torch.where(bad, torch.full((), float("nan"), dtype=out.dtype,
                                       device=out.device), out)


def ftle(u, v, lats, lons, timestep: float, *, settls_order: int, order: int,
         cyclic_x: bool = True, tf32: bool = False):
    """(T, ny, nx) winds on ascending ``lats``/``lons`` → (ny, nx) FTLE in
    the winds' dtype."""
    px, py = departure_points(u, v, lats, lons, timestep,
                              settls_order=settls_order, order=order,
                              cyclic_x=cyclic_x, tf32=tf32)
    return ftle_from_departures(px, py, lats, lons)
