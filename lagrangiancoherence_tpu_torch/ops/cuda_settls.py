"""The fused SETTLS step: one kernel launch per step of the main path.

Counterpart of the scan body of ``lagrangiancoherence_tpu/models/settls.py``
(:581-643) on the default ``dma-all`` engine, whose gathers are the Pallas
``_engine_kernel`` (``ops/pallas_interp.py:793``).  The kernel
(``csrc/settls_step.cu``) is K1 (``ops/cuda_interp.py``) redesigned for
Hopper: one thread per parcel runs the F=2 Euler gather, the update and the
Q5 clamp/wrap, then ``settls_order`` F=4 gathers at levels (t, t+1) with
their updates and clamp/wraps, with the position in registers, and writes
the end position once.  It reads the prefiltered coefficients as a
(T, ny, nx, 2) interleaved (u, v) stack (``interleave``), one 2-vector load
per tap per level; the raw winds, read only by the pole-home rows, are the
caller's (T, ny, nx) ``u`` and ``v``, not copied.  The parcels may be a
block of the grid (a latitude band, or a band of it in longitude): the
winds stay whole, ``conv_x`` has one value per block row, and ``home_rows``
gives each block row's global home row for the pole-row test, as JAX's
sharded blocks pass it (``models/settls.py:288-303``).

``settls_step_torch`` is its plain version: the per-group loop body of the
SETTLS scan, with the gather taken as an argument (the plain
``interp_at_parcels_multi`` by default).  Tensors on the CPU take it;
CUDA tensors launch the kernel or raise — there is no fallback.
``LAUNCHES`` counts kernel launches, so a run can show that its main path
went through the kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from ..grid import EARTH_RADIUS
from ._launch import SUFFIX, entry, stream
from .interp import interp_at_parcels_multi

__all__ = ["CONV_Y", "LAUNCHES", "clamp_wrap", "euler_guess", "interleave",
           "settls_correction", "settls_step", "settls_step_torch"]

LAUNCHES = 0
_MAX_GRID_ROWS = 65535   # gridDim.y: blocks of 4 rows
CONV_Y = 180.0 / (EARTH_RADIUS * np.pi)    # m/s -> deg/s of latitude


def clamp_wrap(px, py, *, y_min, y_max, x_min, x_max, cyclic_x):
    """Q5 boundary handling (LagrangianCoherence LCS/trajectory.py:89-97):
    latitude clamped (a NaN latitude becomes ``y_min``), longitude wrapped
    with ``torch.remainder`` (``jnp.mod``'s sign convention) when cyclic,
    else clamped."""
    py = torch.where(py > y_min, py, y_min)
    py = torch.where(py < y_max, py, y_max)
    if cyclic_x:
        px = torch.where(px > -180.0, px, torch.remainder(px, 180.0))
        px = torch.where(px < 180.0, px, -180.0 + torch.remainder(px, 180.0))
    else:
        px = torch.where(px < x_min, x_min, px)
        px = torch.where(px > x_max, x_max, px)
    return px, py


def euler_guess(x, y, c, ua, va, dt, conv_y):
    """The Euler first guess before the clamp
    (LagrangianCoherence LCS/trajectory.py:82-87)."""
    return x + dt * c * ua, y + dt * conv_y * va


def settls_correction(x, y, c, ua, va, d, dt, conv_y):
    """One SETTLS iteration in the cumulative form (Q3) before the clamp
    (LagrangianCoherence LCS/trajectory.py:100-124); ``d`` holds
    (u_t, v_t, u_t+1, v_t+1) at the iterate."""
    return (x + 0.5 * dt * c * (ua + 2.0 * d[0] - d[2]),
            y + 0.5 * dt * conv_y * (va + 2.0 * d[1] - d[3]))


def interleave(cu: torch.Tensor, cv: torch.Tensor) -> torch.Tensor:
    """(T, ny, nx) u and v coefficients → the (T, ny, nx, 2) interleaved
    stack the kernel reads: element [t, i, j, c] is (cu, cv)[c][t, i, j]."""
    return torch.stack([cu, cv], dim=-1)


def settls_step_torch(fields, coeffs, px, py, conv_x, dt, t: int, *,
                      settls_order: int, order: int, x_min, x_max, y_min,
                      y_max, cyclic_x: bool, gather=interp_at_parcels_multi,
                      home_rows=None, out=None):
    """One SETTLS step of every parcel, one gather group at a time.

    ``fields``/``coeffs``: the raw and prefiltered planar stacks of the
    grid, whose leading axes flatten to the field index ((2T, ny, nx) or
    (T, 2, ny, nx)): fields 2t, 2t+1 are (u, v) at level t.  ``px``/``py``:
    (rows, cols) positions, the whole grid or a block of it.  ``conv_x``:
    (rows, 1), one value per block row; ``dt``: 0-dim tensor.
    ``home_rows``: the global home row of each block row (an integer tensor
    of ``rows`` values) for the pole-row test; by default the block rows
    themselves.  ``gather(fields, coeffs, px, py, *, order, x_min, x_max,
    y_min, y_max[, home_rows])`` evaluates a group's (F, ny, nx) slices at
    the positions (``home_rows`` as a (rows, 1) tensor, passed only when
    given).  Returns the end positions, written into ``out`` when given.
    """
    ny, nx = fields.shape[-2:]
    fields = fields.reshape(-1, ny, nx)
    coeffs = coeffs.reshape(-1, ny, nx)
    bounds = dict(x_min=x_min, x_max=x_max, y_min=y_min, y_max=y_max)
    if home_rows is not None:
        bounds["home_rows"] = home_rows.reshape(-1, 1)
    conv_y = torch.full((), CONV_Y, dtype=px.dtype, device=px.device)

    def group(x, y, nf):
        return gather(fields[2 * t:2 * t + nf], coeffs[2 * t:2 * t + nf], x,
                      y, order=order, **bounds)

    def clamp(x, y):
        return clamp_wrap(x, y, cyclic_x=cyclic_x, x_min=x_min, x_max=x_max,
                          y_min=y_min, y_max=y_max)

    ua, va = group(px, py, 2)
    x, y = clamp(*euler_guess(px, py, conv_x, ua, va, dt, conv_y))
    for _ in range(settls_order):
        x, y = clamp(*settls_correction(x, y, conv_x, ua, va,
                                        group(x, y, 4), dt, conv_y))
    if out is None:
        return x, y
    out[0].copy_(x)
    out[1].copy_(y)
    return out


def settls_step(u, v, coeffs, px, py, conv_x, dt, t: int, *,
                settls_order: int, order: int, x_min, x_max, y_min, y_max,
                cyclic_x: bool, home_rows=None, out=None):
    """One SETTLS step of every parcel in one kernel launch.

    ``u``/``v``: the (T, ny, nx) raw winds; ``coeffs``: the (T, ny, nx, 2)
    interleaved coefficient stack (``interleave``); ``px``/``py``: (rows,
    cols) positions, the whole grid or a block of it; ``home_rows``: None
    or an int32 tensor of ``rows`` values, the global home row of each
    block row; the rest as ``settls_step_torch``.  ``out``: a (px, py) pair
    to write the end positions into — it may be (``px``, ``py``) themselves
    (each parcel reads and writes only its own position); by default a new
    pair.
    """
    global LAUNCHES
    kw = dict(settls_order=settls_order, order=order, x_min=x_min,
              x_max=x_max, y_min=y_min, y_max=y_max, cyclic_x=cyclic_x)
    tensors = (u, v, coeffs, px, py, conv_x, dt) + tuple(out or ())
    hr = () if home_rows is None else (home_rows,)
    devices = {a.device for a in tensors + hr}
    if devices == {torch.device("cpu")}:
        ny, nx = coeffs.shape[1:3]
        planar = coeffs[t:t + 2].permute(0, 3, 1, 2).reshape(4, ny, nx)
        raw = torch.stack([u[t:t + 2], v[t:t + 2]], dim=1).reshape(4, ny, nx)
        return settls_step_torch(raw, planar, px, py, conv_x, dt, 0,
                                 home_rows=home_rows, out=out, **kw)

    if len(devices) != 1 or px.device.type != "cuda":
        raise ValueError(f"settls_step: tensors must all be on one CUDA "
                         f"device or all on the CPU, got {devices}")
    if px.dtype not in SUFFIX:
        raise TypeError(f"settls_step: dtype {px.dtype} not supported "
                        f"(float32, float64)")
    if any(a.dtype != px.dtype for a in tensors):
        raise TypeError("settls_step: every tensor must share one dtype")
    if any(not a.is_contiguous() for a in tensors + hr):
        raise ValueError("settls_step: tensors must be contiguous")
    if coeffs.ndim != 4 or coeffs.shape[-1] != 2:
        raise ValueError(f"settls_step: coeffs must be (T, ny, nx, 2), got "
                         f"{tuple(coeffs.shape)}")
    levels, ny, nx = coeffs.shape[:3]
    if u.shape != (levels, ny, nx) or v.shape != u.shape:
        raise ValueError(f"settls_step: winds {tuple(u.shape)}/"
                         f"{tuple(v.shape)} do not match coeffs "
                         f"{tuple(coeffs.shape)}")
    out = (torch.empty_like(px), torch.empty_like(py)) if out is None \
        else tuple(out)
    if px.ndim != 2 or any(a.shape != px.shape for a in (py,) + out):
        raise ValueError(f"settls_step: positions and out must be one "
                         f"(rows, cols) shape, got {tuple(px.shape)}")
    rows, cols = px.shape
    if conv_x.numel() != rows or dt.numel() != 1:
        raise ValueError("settls_step: conv_x must hold one value per row, "
                         "dt one")
    if hr and (home_rows.dtype != torch.int32 or home_rows.numel() != rows):
        raise ValueError("settls_step: home_rows must be int32, one value "
                         "per row")
    if order not in (1, 3):
        raise NotImplementedError(f"the CUDA kernel implements spline "
                                  f"orders 1 and 3, got {order}")
    if not 0 <= t <= levels - 2 or settls_order < 0:
        raise ValueError(f"settls_step: step {t} outside [0, {levels - 2}] "
                         f"or settls_order {settls_order} < 0")
    if ny < 4 or nx < 4 or ny * nx >= 2 ** 31 or rows * cols >= 2 ** 31 \
            or -(-rows // 4) > _MAX_GRID_ROWS:
        raise ValueError(f"settls_step: grid {ny}x{nx} or block "
                         f"{rows}x{cols} outside the kernel's range")
    if coeffs.data_ptr() % (2 * coeffs.element_size()):
        raise ValueError("settls_step: coeffs not aligned to a (u, v) pair")

    rc = entry("settls_step", px.dtype)(
        u.data_ptr(), v.data_ptr(), coeffs.data_ptr(), px.data_ptr(),
        py.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
        conv_x.data_ptr(), dt.data_ptr(),
        None if home_rows is None else home_rows.data_ptr(), ny, nx, rows,
        cols, t, order, settls_order, int(bool(cyclic_x)), CONV_Y,
        float(x_min), float(x_max), float(y_min), float(y_max),
        stream(px.get_device()))
    if rc != 0:
        raise RuntimeError(f"settls_step launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out
