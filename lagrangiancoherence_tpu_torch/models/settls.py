"""SETTLS two-time-level semi-Lagrangian parcel advection (Hortal 2002) — PyTorch.

Counterpart of ``lagrangiancoherence_tpu/models/settls.py``: the winds are
cubic-prefiltered once up front, then each of the ``T-1`` steps evaluates
one F=2 gather group for the Euler guess and ``settls_order`` F=4 groups for
the SETTLS iterations over the whole parcel grid.  The ``lax.scan`` becomes
a Python loop over steps.

Reference semantics replicated exactly (SURVEY.md quirks):

* Q2 — winds are indexed positionally **forward** even for backward
  (timestep < 0) integration (LagrangianCoherence LCS/trajectory.py:59-60);
* Q3 — each SETTLS iteration *adds* the correction to the already-displaced
  iterate (LagrangianCoherence LCS/trajectory.py:110-112);
* Q5 — cyclic wrap ``x % 180`` below -180 and ``-180 + (x % 180)`` above
  +180 (``torch.remainder``, which has ``jnp.mod``'s sign convention;
  ``torch.fmod`` does not); hard clamp of latitude to [y_min, y_max] and,
  when non-cyclic, of longitude to [x_min, x_max]
  (LagrangianCoherence LCS/trajectory.py:89-97);
* ``conv_y = 180/(R*pi)`` and ``conv_x = conv_y/|cos(lat_grid)|`` on the
  parcels' *home* latitudes (LagrangianCoherence LCS/trajectory.py:54-57).

The JAX package's TPU layout machinery (sort-binning, the pole hoist and
their ``LCS_*`` knobs) has no counterpart: the CUDA gather reads each
parcel's taps directly.
"""
from __future__ import annotations

import numpy as np
import torch

from ..grid import EARTH_RADIUS
from ..ops.cuda_interp import cuda_interp_multi
from ..ops.interp import (interp_at_parcels_multi, prefilter,
                          spline_filter_matrix)

__all__ = ["grid_state", "parcel_propagation_core", "resolve_kernel",
           "settls_scan"]

KERNELS = ("auto", "cuda", "torch")


def resolve_kernel(kernel: str, device: torch.device, order: int) -> str:
    """``"auto"`` → ``"cuda"`` for CUDA tensors at the orders the kernel
    implements ({1, 3}, the orders the reference's workflows use —
    LagrangianCoherence LCS/LCS.py:51), else ``"torch"`` (the plain version).
    ``"cuda"`` on a CPU device or at another order raises."""
    if kernel not in KERNELS:
        raise ValueError(f"kernel={kernel!r}: expected one of {KERNELS}")
    device = torch.device(device)
    if kernel == "auto":
        return "cuda" if device.type == "cuda" and order in (1, 3) \
            else "torch"
    if kernel == "cuda":
        if device.type != "cuda":
            raise ValueError(f"kernel='cuda' needs CUDA tensors, got device "
                             f"{device}; use kernel='torch' on the CPU")
        if order not in (1, 3):
            raise NotImplementedError(
                f"kernel='cuda' implements spline orders 1 and 3; got "
                f"interp_order={order}.  Use kernel='torch' (or 'auto') for "
                f"scipy orders 0/2/4/5.")
    return kernel


def grid_state(grid, order: int, *, dtype: torch.dtype,
               device) -> dict[str, torch.Tensor]:
    """The grid-derived tensors the integrator needs: the two prefilter
    matrices (``prefilter_y`` (ny, ny), ``prefilter_x`` (nx, nx)), the
    per-home-row ``conv_x`` (ny, 1) m/s → deg/s factor and the initial mesh
    ``px0``/``py0`` (ny, nx)."""
    kw = dict(dtype=dtype, device=device)
    ny, nx = grid.shape
    conv_y = torch.full((), 180.0 / (EARTH_RADIUS * np.pi), **kw)
    lat = torch.tensor(grid.lats, **kw)
    px0, py0 = grid.mesh_xy
    return {
        "prefilter_y": torch.tensor(spline_filter_matrix(ny, order), **kw),
        "prefilter_x": torch.tensor(spline_filter_matrix(nx, order), **kw),
        "conv_x": (conv_y / torch.abs(torch.cos(lat * (np.pi / 180.0))))[:, None],
        "px0": torch.tensor(px0, **kw),
        "py0": torch.tensor(py0, **kw),
    }


def _clamp_wrap(px, py, *, y_min, y_max, x_min, x_max, cyclic_x):
    """Boundary handling per LagrangianCoherence LCS/trajectory.py:89-97."""
    py = torch.where(py > y_min, py, y_min)
    py = torch.where(py < y_max, py, y_max)
    if cyclic_x:
        px = torch.where(px > -180.0, px, torch.remainder(px, 180.0))
        px = torch.where(px < 180.0, px, -180.0 + torch.remainder(px, 180.0))
    else:
        px = torch.where(px < x_min, x_min, px)
        px = torch.where(px > x_max, x_max, px)
    return px, py


def settls_scan(u, v, cu, cv, px0, py0, dt, conv_x, grid, *,
                settls_order: int, interp_order: int, return_traj: bool,
                kernel: str = "torch"):
    """The SETTLS time loop over a position block.

    ``u``/``v``: (T, ny, nx) winds; ``cu``/``cv``: their prefiltered
    coefficients.  ``px0``/``py0``: (ny, nx) initial positions (home rows =
    grid rows).  ``dt``: 0-dim tensor.  ``conv_x``: (ny, 1) per-home-latitude
    factor.  ``kernel``: ``"cuda"`` (K1, ``ops/cuda_interp.py``) or
    ``"torch"`` (the plain gather).

    Returns ``(px, py, overflow)`` — (T, ny, nx) trajectories including
    the initial positions when ``return_traj`` — where ``overflow`` is an
    int32 0-dim tensor, always 0.
    """
    if kernel not in ("cuda", "torch"):
        raise ValueError(f"settls_scan: kernel={kernel!r} (resolve 'auto' "
                         f"with resolve_kernel first)")
    T, ny, nx = u.shape
    dtype, device = u.dtype, u.device
    conv_y = torch.full((), 180.0 / (EARTH_RADIUS * np.pi), dtype=dtype,
                        device=device)
    bounds = dict(y_min=grid.y_min, y_max=grid.y_max,
                  x_min=grid.x_min, x_max=grid.x_max)
    # resident (T*2, ny, nx) stacks: fields 2t, 2t+1 are (u, v) at level t,
    # so the group at (t, t+1) is the contiguous window [2t, 2t + 4)
    W = torch.stack([u, v], dim=1).reshape(T * 2, ny, nx)
    CW = torch.stack([cu, cv], dim=1).reshape(T * 2, ny, nx)
    zero_flag = torch.zeros((), dtype=torch.int32, device=device)

    def gather(t, px, py, nf):
        if kernel == "cuda":
            return cuda_interp_multi(W, CW, px, py, order=interp_order,
                                     f0=2 * t, nf=nf, **bounds)
        out = interp_at_parcels_multi(W[2 * t:2 * t + nf],
                                      CW[2 * t:2 * t + nf], px, py,
                                      order=interp_order, **bounds)
        return out, zero_flag

    px, py, flag = px0, py0, zero_flag
    traj_x, traj_y = [px0], [py0]
    for t in range(T - 1):
        # Euler first guess (LagrangianCoherence LCS/trajectory.py:82-87)
        arr, fl = gather(t, px, py, 2)
        flag = flag | fl
        ua, va = arr[0], arr[1]
        py = py + dt * conv_y * va
        px = px + dt * conv_x * ua
        px, py = _clamp_wrap(px, py, cyclic_x=grid.cyclic_x, **bounds)
        # SETTLS fixed-point iterations, cumulative form (Q3)
        # (LagrangianCoherence LCS/trajectory.py:100-124)
        for _ in range(settls_order):
            dep, fl = gather(t, px, py, 4)
            flag = flag | fl
            u_t_d, v_t_d, u_n_d, v_n_d = dep[0], dep[1], dep[2], dep[3]
            py = py + 0.5 * dt * conv_y * (va + 2.0 * v_t_d - v_n_d)
            px = px + 0.5 * dt * conv_x * (ua + 2.0 * u_t_d - u_n_d)
            px, py = _clamp_wrap(px, py, cyclic_x=grid.cyclic_x, **bounds)
        if return_traj:
            traj_x.append(px)
            traj_y.append(py)
    if return_traj:
        return torch.stack(traj_x), torch.stack(traj_y), flag
    return px, py, flag


def _as_tensor(a, device, dtype=None) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def parcel_propagation_core(u, v, timestep, grid, *, settls_order: int = 0,
                            interp_order: int = 3, return_traj: bool = False,
                            kernel: str = "auto",
                            return_overflow: bool = False, device=None,
                            state: dict[str, torch.Tensor] | None = None):
    """Integrate parcel positions through ``T-1`` SETTLS steps.

    Parameters
    ----------
    u, v : (T, ny, nx) zonal/meridional wind [m/s] (tensors or arrays),
        lat/lon ascending, time in storage order (Q2: forward positional
        indexing regardless of the sign of ``timestep``).
    timestep : seconds (scalar; negative for backward integration).
    grid : Grid (this package's, or any object with the same fields).
    kernel : ``"auto"``, ``"cuda"`` or ``"torch"`` (see ``resolve_kernel``).
    device : where to compute; default: ``u``'s device (the CPU for arrays).
    state : ``grid_state`` tensors on that device and dtype, as
        ``FTLEPipeline`` holds them; built from ``grid`` when omitted.

    Returns
    -------
    (positions_x, positions_y), plus the int32 ``overflow`` tensor (always
    0) when ``return_overflow``; (T, ny, nx) trajectories including the
    initial mesh when ``return_traj``.
    """
    if device is None:
        device = u.device if isinstance(u, torch.Tensor) else "cpu"
    u = _as_tensor(u, device)
    v = _as_tensor(v, device, u.dtype)
    if u.shape[-2:] != tuple(grid.shape) or v.shape != u.shape:
        raise ValueError(f"winds {tuple(u.shape)}/{tuple(v.shape)} do not "
                         f"match grid {grid.shape}")
    kernel = resolve_kernel(kernel, u.device, interp_order)
    if state is None:
        state = grid_state(grid, interp_order, dtype=u.dtype, device=u.device)

    # prefilter every time slice once; raw fields are still needed for the
    # pole rows' order-1/constant path
    mats = (state["prefilter_y"], state["prefilter_x"])
    cu = prefilter(u, order=interp_order, matrices=mats)
    cv = prefilter(v, order=interp_order, matrices=mats)
    dt = torch.full((), float(timestep), dtype=u.dtype, device=u.device)
    *pos, overflow = settls_scan(
        u, v, cu, cv, state["px0"], state["py0"], dt, state["conv_x"], grid,
        settls_order=settls_order, interp_order=interp_order,
        return_traj=return_traj, kernel=kernel)
    if return_overflow:
        return tuple(pos) + (overflow,)
    return tuple(pos)
