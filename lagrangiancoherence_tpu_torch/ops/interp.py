"""Spline interpolation of gridded fields at parcel positions — plain PyTorch.

Counterpart of ``lagrangiancoherence_tpu/ops/interp.py`` with the same
``scipy.ndimage.map_coordinates`` contract (LagrangianCoherence LCS/tools.py:11-48):

* index scaling ``size * (p - min) / (max - min)`` (quirk Q4);
* spline order 0-5 with ``mode='wrap'`` for rows away from the poles:
  coordinates fold with period ``n-1`` and taps mirror about the edge
  samples;
* order-1 ``mode='constant'`` (cval=0) on the raw fields for the ``order``
  rows nearest each pole.

This module is the plain version that the CUDA gather kernel
(``ops/cuda_interp.py``) is held against, and the path that every CPU tensor
takes.  Two rules keep it value-for-value with the JAX package:

* Division by a constant goes through ``_div``, which divides by a 0-dim
  tensor on the operand's device.  PyTorch's CUDA division by a Python
  scalar multiplies by the reciprocal, one ulp off exactly at the fold
  boundary, where a grid's own last column scales to exactly ``n``.
* Tap indices are made safe before any gather.  ``jnp.take`` fills
  out-of-range reads with NaN, and XLA casts ``floor(NaN)`` to 0 where
  torch gives INT_MIN.  So a NaN floor becomes index 0, indices are clamped
  into range, and a read that JAX would fill comes back NaN.
"""
from __future__ import annotations

from functools import lru_cache
from math import comb, factorial

import numpy as np
import torch

from . import cuda_prefilter

__all__ = [
    "spline_filter_matrix",
    "spline_band_factors",
    "prefilter",
    "prefilter_dense",
    "scale_positions",
    "eval_spline_wrap",
    "eval_linear_constant",
    "interp_at_parcels",
    "interp_at_parcels_multi",
]

# floor() results are clamped to +-2**30 before the int cast, so tap and
# mirror arithmetic cannot overflow; real positions fold far inside it
_INDEX_LIMIT = float(2 ** 30)


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` correctly rounded on every device (see the module note)."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


# ---------------------------------------------------------------------------
# Spline prefilter as a dense matrix (host-side, cached)
# ---------------------------------------------------------------------------

def _bspline_int_samples(order: int) -> np.ndarray:
    """Centered cardinal B-spline of degree ``order`` sampled at the integers
    ``-(order//2) .. order//2`` (the prefilter system's band)."""
    half = order // 2
    ks = np.arange(-half, half + 1, dtype=np.float64)
    k1 = order + 1
    tt = ks[:, None] + k1 / 2.0 - np.arange(k1 + 1)[None, :]
    signs = (-1.0) ** np.arange(k1 + 1)
    binom = np.array([comb(k1, j) for j in range(k1 + 1)], dtype=np.float64)
    w = signs[None, :] * binom * np.maximum(tt, 0.0) ** order
    return w.sum(axis=1) / factorial(order)


def _spline_forward_band(n: int, order: int) -> np.ndarray:
    """Dense float64 forward system of scipy's ``mode='wrap'`` prefilter
    (orders 2-5, ``n >= 2``).  Row ``i`` sums the B-spline's integer
    samples over taps ``i+k``, with out-of-range taps mirrored about the
    edge samples."""
    w = _bspline_int_samples(order)
    half = order // 2
    fwd = np.zeros((n, n), dtype=np.float64)
    for i in range(n):
        for k, wk in zip(range(-half, half + 1), w):
            j = i + k
            if j < 0:
                j = -j
            if j > n - 1:
                j = 2 * (n - 1) - j
            fwd[i, j] += wk
    return fwd


@lru_cache(maxsize=64)
def spline_filter_matrix(n: int, order: int = 3) -> np.ndarray:
    """Dense inverse of scipy's ``mode='wrap'`` prefilter system (read-only).

    ``c = M @ x`` reproduces ``scipy.ndimage.spline_filter1d(x, order,
    mode='wrap')`` for orders 2-5; orders 0 and 1 need no prefilter.  The
    forward system is ``_spline_forward_band``'s.
    """
    if order in (0, 1) or n < 2:
        m = np.eye(n)
    elif order in (2, 3, 4, 5):
        m = np.linalg.inv(_spline_forward_band(n, order))
    else:
        raise NotImplementedError(
            f"spline order {order} not supported (scipy surface is 0-5)")
    m.setflags(write=False)
    return m


@lru_cache(maxsize=64)
def spline_band_factors(n: int, order: int = 3) -> np.ndarray:
    """LU factors of the tridiagonal forward system that
    ``spline_filter_matrix`` inverts at order 3, read-only float64.

    Returns a (3, n) array of per-row factors: ``l`` (row 0), the
    sub-diagonal multipliers of L (``l[0] = 0``); ``r`` (row 1), the
    reciprocals of U's pivots; ``c`` (row 2), U's super-diagonal, which is
    the system's own (``c[n-1] = 0``).  The mirrored edge rows are in the
    band, and no pivoting is needed: every row is strictly diagonally
    dominant (4/6 against at most 2/6 at order 3).  With them the system
    solves line by line: ``y[i] = x[i] - l[i] * y[i-1]``, then
    ``c_[i] = (y[i] - c[i] * c_[i+1]) * r[i]`` from the last row back.
    For ``n < 2`` the system is the identity, as in ``spline_filter_matrix``.
    """
    if order != 3:
        raise NotImplementedError(
            f"spline order {order}: the band solve covers order 3")
    f = np.zeros((3, n), dtype=np.float64)
    if n < 2:
        f[1] = 1.0
    else:
        fwd = _spline_forward_band(n, order)
        pivot = fwd[0, 0]
        f[1, 0] = 1.0 / pivot
        for i in range(1, n):
            f[0, i] = fwd[i, i - 1] / pivot
            pivot = fwd[i, i] - f[0, i] * fwd[i - 1, i]
            f[1, i] = 1.0 / pivot
        f[2, :-1] = np.diagonal(fwd, 1)
    f.setflags(write=False)
    return f


def _check_matmul_precision() -> None:
    """Raise unless float32 matmuls run in full float32.

    The prefilter's JAX counterpart runs at ``Precision.HIGHEST``; TF32 keeps
    about three decimal digits, which costs ~0.06 p99 log-FTLE over a full
    integration.  The port checks the global settings instead of changing
    them behind the caller's back.
    """
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("prefilter needs torch.backends.cuda.matmul."
                           "allow_tf32 = False")
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("prefilter needs torch.set_float32_matmul_"
                           "precision('highest')")


def _band_solve_applies(device_type: str, order: int,
                        dtype: torch.dtype) -> bool:
    """Whether ``prefilter`` takes the banded kernel: a CUDA tensor at
    order 3 in float32 or float64."""
    return (device_type == "cuda" and order == 3
            and dtype in (torch.float32, torch.float64))


@lru_cache(maxsize=16)
def _band_tensor(n: int, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """``spline_band_factors(n)`` in ``dtype`` on ``device``, uploaded
    once."""
    return torch.tensor(spline_band_factors(n), dtype=dtype, device=device)


def prefilter(field: torch.Tensor, order: int = 3,
              matrices: tuple[torch.Tensor, torch.Tensor] | None = None
              ) -> torch.Tensor:
    """Separable 2-D spline prefilter over the trailing (lat, lon) axes;
    leading axes (time, component) are batched.

    On a CUDA tensor at order 3 in float32 or float64 the hand-written
    banded solve of ``ops/cuda_prefilter.py`` runs (a latitude and a
    longitude sweep), with the ``spline_band_factors`` of the field's
    shape, uploaded once a device and dtype; ``matrices`` is not read
    there.  Everywhere else (the CPU, orders 2/4/5, other dtypes)
    ``prefilter_dense`` runs.  Both solve the same mirrored band, in the
    field's precision.
    """
    if order in (0, 1):
        return field
    if _band_solve_applies(field.device.type, order, field.dtype):
        ny, nx = field.shape[-2], field.shape[-1]
        return cuda_prefilter.spline_prefilter(
            field.contiguous(), _band_tensor(ny, field.dtype, field.device),
            _band_tensor(nx, field.dtype, field.device))
    return prefilter_dense(field, order, matrices)


def prefilter_dense(field: torch.Tensor, order: int = 3,
                    matrices: tuple[torch.Tensor, torch.Tensor] | None = None
                    ) -> torch.Tensor:
    """The prefilter as two dense matmuls by the inverse, on any device.

    ``matrices`` = (``M_y``, ``M_x``) on the field's device and dtype, as
    ``FTLEPipeline`` holds them; by default they are built from
    ``spline_filter_matrix``.
    """
    if order in (0, 1):
        return field
    _check_matmul_precision()
    if matrices is None:
        ny, nx = field.shape[-2], field.shape[-1]
        kw = dict(dtype=field.dtype, device=field.device)
        matrices = (torch.tensor(spline_filter_matrix(ny, order), **kw),
                    torch.tensor(spline_filter_matrix(nx, order), **kw))
    my, mx = matrices
    return torch.matmul(torch.matmul(my, field), mx.transpose(0, 1))


# ---------------------------------------------------------------------------
# Coordinate folding and tap mirroring (scipy C semantics)
# ---------------------------------------------------------------------------

def _fold_coord_wrap(x: torch.Tensor, n: int) -> torch.Tensor:
    """scipy map_coordinate() for mode='wrap': period ``n-1`` fold."""
    sz = float(n - 1)
    neg = x + sz * (torch.floor(_div(-x, sz)) + 1.0)
    pos = x - sz * torch.floor(_div(x, sz))
    return torch.where(x < 0, neg, torch.where(x > sz, pos, x))


def _mirror_tap(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Mirror out-of-range integer tap indices about the edge samples."""
    idx = torch.where(idx < 0, -idx, idx)
    return torch.where(idx > n - 1, 2 * (n - 1) - idx, idx)


def _to_index(fl: torch.Tensor) -> torch.Tensor:
    """int64 index of a floor() result: NaN -> 0 (XLA's cast), clamped."""
    fl = torch.nan_to_num(fl, nan=0.0).clamp(-_INDEX_LIMIT, _INDEX_LIMIT)
    return fl.to(torch.int64)


def _cubic_weights(t: torch.Tensor):
    """Cubic B-spline weights for taps at offsets (-1, 0, 1, 2) from floor(x)."""
    one_t = 1.0 - t
    w0 = _div(one_t * one_t * one_t, 6.0)
    w1 = 2.0 / 3.0 - t * t + 0.5 * t * t * t
    w2 = 2.0 / 3.0 - one_t * one_t + 0.5 * one_t * one_t * one_t
    w3 = _div(t * t * t, 6.0)
    return [w0, w1, w2, w3]


def _int_pow(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x ** n`` by square-and-multiply in ``lax.integer_pow``'s order
    (x**5 = x * ((x*x) * (x*x))); ``torch.pow`` rounds differently, and the
    B-spline's alternating sum amplifies the difference to ~1e-12."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def _bspline_weight(order: int, s: torch.Tensor) -> torch.Tensor:
    """Centered cardinal B-spline of degree ``order`` at ``s = t - k``
    (orders 2/4/5; orders 0/1/3 use the dedicated paths)."""
    k1 = order + 1
    acc = torch.zeros_like(s)
    for j in range(k1 + 1):
        term = _int_pow(torch.clamp(s + k1 / 2.0 - j, min=0.0), order)
        acc = acc + ((-1.0) ** j * comb(k1, j)) * term
    return _div(acc, float(factorial(order)))


def _axis_taps(f: torch.Tensor, n: int, order: int):
    """Per-axis tap indices and weights for ``mode='wrap'``-folded
    fractional indices ``f``: even orders anchor at ``floor(f + 0.5)``, odd
    orders at ``floor(f)``; order 0 is one unit-weight tap."""
    if order == 0:
        i0 = _to_index(torch.floor(f + 0.5))
        return [_mirror_tap(i0, n)], [torch.ones_like(f)]
    if order % 2 == 0:
        fl = torch.floor(f + 0.5)
        offs = range(-(order // 2), order // 2 + 1)
    else:
        fl = torch.floor(f)
        offs = range(-(order // 2), order // 2 + 2)
    t = f - fl
    i0 = _to_index(fl)
    idx = [_mirror_tap(i0 + k, n) for k in offs]
    if order == 1:
        return idx, [1.0 - t, t]
    if order == 3:
        return idx, _cubic_weights(t)
    return idx, [_bspline_weight(order, t - k) for k in offs]


def _take(flat: torch.Tensor, lin: torch.Tensor) -> torch.Tensor:
    """``jnp.take(flat, lin, axis=-1)`` with JAX's fill mode: reads outside
    ``[0, flat.shape[-1])`` come back NaN.  ``flat``: (F, N) or (N,)."""
    size = flat.shape[-1]
    ok = (lin >= 0) & (lin < size)
    vals = torch.index_select(flat, flat.ndim - 1,
                              lin.clamp(0, size - 1).reshape(-1))
    vals = vals.reshape(flat.shape[:-1] + lin.shape)
    return torch.where(ok, vals, torch.full((), float("nan"),
                                            dtype=flat.dtype,
                                            device=flat.device))


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------

def eval_spline_wrap(coeffs: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                     order: int = 3) -> torch.Tensor:
    """Evaluate a (prefiltered) (ny, nx) field at fractional grid indices
    ``(ys, xs)`` with scipy ``mode='wrap'`` semantics on both axes."""
    ny, nx = coeffs.shape
    yi_l, wy_l = _axis_taps(_fold_coord_wrap(ys, ny), ny, order)
    xi_l, wx_l = _axis_taps(_fold_coord_wrap(xs, nx), nx, order)
    yi = torch.stack(yi_l, dim=-1)
    xi = torch.stack(xi_l, dim=-1)
    wy = torch.stack(wy_l, dim=-1)
    wx = torch.stack(wx_l, dim=-1)
    ntaps = len(yi_l)
    lin = (yi[..., :, None] * nx + xi[..., None, :]).reshape(
        *ys.shape, ntaps * ntaps)
    vals = _take(coeffs.reshape(-1), lin)
    w = (wy[..., :, None] * wx[..., None, :]).reshape(*ys.shape, ntaps * ntaps)
    return torch.sum(vals * w.to(vals.dtype), dim=-1)


def eval_linear_constant(field: torch.Tensor, ys: torch.Tensor,
                         xs: torch.Tensor) -> torch.Tensor:
    """Order-1 interpolation with scipy ``mode='constant'`` (cval=0): a query
    with either coordinate outside ``[0, n-1]`` (or NaN) returns 0
    (LagrangianCoherence LCS/tools.py:35-39 pole handling)."""
    return _bilinear_constant(field.reshape(1, -1), ys, xs, *field.shape)[0]


def _bilinear_constant(raw: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                       ny: int, nx: int) -> torch.Tensor:
    """Shared body of the pole path: ``raw`` is (F, ny*nx)."""
    in_range = (ys >= 0) & (ys <= ny - 1) & (xs >= 0) & (xs <= nx - 1)
    y0 = torch.clamp(torch.floor(ys), 0, ny - 2)
    x0 = torch.clamp(torch.floor(xs), 0, nx - 2)
    ty = (ys - y0).to(raw.dtype)
    tx = (xs - x0).to(raw.dtype)
    base = _to_index(y0) * nx + _to_index(x0)
    out = (_take(raw, base) * ((1 - ty) * (1 - tx))[None]
           + _take(raw, base + 1) * ((1 - ty) * tx)[None]
           + _take(raw, base + nx) * (ty * (1 - tx))[None]
           + _take(raw, base + nx + 1) * (ty * tx)[None])
    return torch.where(in_range[None], out,
                       torch.zeros((), dtype=raw.dtype, device=raw.device))


# ---------------------------------------------------------------------------
# The reference's xr_map_coordinates contract
# ---------------------------------------------------------------------------

def scale_positions(px: torch.Tensor, py: torch.Tensor, *, x_min, x_max,
                    y_min, y_max, nx: int, ny: int):
    """Quirk-Q4 index scaling ``size * (p - min) / (max - min)``
    (LagrangianCoherence LCS/tools.py:21-22), in the JAX op order: subtract,
    multiply, then one correctly rounded division."""
    xi = _div(nx * (px - float(x_min)), float(x_max) - float(x_min))
    yi = _div(ny * (py - float(y_min)), float(y_max) - float(y_min))
    return xi, yi


def _pole_rows(shape, order: int, ny: int, row_offset: int, device,
               home_rows=None) -> torch.Tensor:
    """Boolean, broadcastable to ``shape``: the parcel's home row is one of
    the ``order`` rows nearest a pole — the reference keys the pole special
    case on the home row, not the current position.  The home row is axis 0
    plus ``row_offset``, or ``home_rows`` (global rows, broadcastable to
    ``shape``) when given."""
    if home_rows is None:
        row = torch.arange(shape[0], device=device) + row_offset
        row = row.reshape((-1,) + (1,) * (len(shape) - 1))
    else:
        row = torch.as_tensor(home_rows, device=device).broadcast_to(shape)
    return (row < order) | (row >= ny - order)


def interp_at_parcels(field: torch.Tensor, coeffs: torch.Tensor,
                      px: torch.Tensor, py: torch.Tensor, *,
                      x_min, x_max, y_min, y_max, order: int = 3,
                      row_offset: int = 0, home_rows=None) -> torch.Tensor:
    """Full ``xr_map_coordinates(isglobal=True)`` semantics for one (ny, nx)
    field (LagrangianCoherence LCS/tools.py:11-48).  ``coeffs`` are the
    prefiltered coefficients (equal to ``field`` for orders 0 and 1).
    ``px``/``py`` may be a block of parcels whose home rows are grid rows
    ``row_offset ..``; ``home_rows`` (an integer tensor broadcastable to the
    positions' shape, e.g. (rows, 1)) gives each parcel's global home row
    instead, as a latitude block with reflected pad rows needs.  The grid
    is the field's whatever the block."""
    ny, nx = field.shape
    xi, yi = scale_positions(px, py, x_min=x_min, x_max=x_max,
                             y_min=y_min, y_max=y_max, nx=nx, ny=ny)
    interior = eval_spline_wrap(coeffs, yi, xi, order=order)
    poles = eval_linear_constant(field, yi, xi)
    return torch.where(_pole_rows(px.shape, order, ny, row_offset, px.device,
                                  home_rows), poles, interior)


def interp_at_parcels_multi(fields: torch.Tensor, coeffs: torch.Tensor,
                            px: torch.Tensor, py: torch.Tensor, *,
                            x_min, x_max, y_min, y_max, order: int = 3,
                            row_offset: int = 0,
                            home_rows=None) -> torch.Tensor:
    """``interp_at_parcels`` for F stacked fields at shared positions (the
    home rows as there).

    ``fields``/``coeffs``: (F, ny, nx); returns (F,) + px.shape.  Taps
    accumulate in the JAX order: y taps outer, x taps inner, the weight
    ``wy[j] * wx[k]`` formed first.  A tap reads a grid point's F
    coefficients at once, and a tap outside the grid makes the parcel's
    value NaN (``_take``'s fill: NaN times a weight, summed, stays NaN).
    Without ``home_rows`` the pole rows are a run at each end of axis 0,
    and only they take the bilinear pass.
    """
    nf, ny, nx = fields.shape
    size = ny * nx
    xi_f, yi_f = scale_positions(px, py, x_min=x_min, x_max=x_max,
                                 y_min=y_min, y_max=y_max, nx=nx, ny=ny)
    table = coeffs.reshape(nf, size)
    yi, wy = _axis_taps(_fold_coord_wrap(yi_f, ny), ny, order)
    xi, wx = _axis_taps(_fold_coord_wrap(xi_f, nx), nx, order)

    interior = outside = None
    term = table.new_empty((nf, px.numel()))
    for j in range(len(yi)):
        row_base = yi[j] * nx
        for k in range(len(xi)):
            lin = row_base + xi[k]
            idx = lin.clamp(0, size - 1)
            off = idx != lin
            outside = off if outside is None else outside.logical_or_(off)
            torch.index_select(table, 1, idx.reshape(-1), out=term)
            w = (wy[j] * wx[k]).to(fields.dtype)
            term.mul_(w.reshape(1, -1))
            if interior is None:
                interior, term = term, torch.empty_like(term)
            else:
                interior.add_(term)
    interior.masked_fill_(outside.reshape(1, -1), float("nan"))
    interior = interior.reshape((nf,) + px.shape)

    raw = fields.reshape(nf, size)
    if home_rows is not None:
        poles = _bilinear_constant(raw, yi_f, xi_f, ny, nx)
        is_pole = _pole_rows(px.shape, order, ny, row_offset, px.device,
                             home_rows)
        return torch.where(is_pole[None], poles, interior)
    # the rows r with r + row_offset < order, and with r + row_offset >=
    # ny - order
    rows = px.shape[0]
    south = min(max(order - row_offset, 0), rows)
    north = max(min(ny - order - row_offset, rows), south)
    for sl in (slice(0, south), slice(north, rows)):
        if sl.stop > sl.start:
            interior[:, sl] = _bilinear_constant(raw, yi_f[sl], xi_f[sl],
                                                 ny, nx)
    return interior
