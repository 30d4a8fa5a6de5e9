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

Two gather routes, chosen by ``engine`` (JAX's ``pallas_engine``):

* ``"auto"`` / ``"dma-all"``: the direct per-parcel gather (K1,
  ``ops/cuda_interp.py``), with no windows; the overflow flag stays 0;
* ``"blockspec"``: the windowed gather (K2-K4, ``ops/window_interp.py``)
  with JAX's scan structure around it (models/settls.py:92-272, 463-715):
  the polar bands are sort-binned into spatial-tile storage order every
  ``SORT_K`` steps, the gathers take the sort ladder, and the pole-home
  rows are sorted once per step and evaluated by a second, pole-only
  gather.  The overflow word is ORed over every gather group.

JAX's trace-time ``LCS_*`` environment knobs are module constants at JAX's
defaults; the port reads no environment variable.
"""
from __future__ import annotations

import numpy as np
import torch

from ..grid import EARTH_RADIUS
from ..ops import pole as P
from ..ops.cuda_interp import cuda_interp_multi
from ..ops.interp import (_to_index, interp_at_parcels_multi, prefilter,
                          spline_filter_matrix)
from ..ops.tiles import SORT_LADDER, TILE_C, TILE_R
from ..ops.window_interp import windowed_interp_multi

__all__ = ["grid_state", "parcel_propagation_core", "resolve_engine",
           "resolve_kernel", "settls_scan"]

KERNELS = ("auto", "cuda", "torch")
ENGINES = ("auto", "dma-all", "blockspec", "dma")
# JAX's trace-time knobs at their defaults (models/settls.py:49-66):
SORT_LAT = 60.0     # LCS_SORT_LAT: |lat| >= this is sort-binned
SORT_K = 2          # LCS_SORT_K: re-bin every K steps
SORT_BX = 32        # LCS_SORT_BX: longitude key block, cells
WY = 32             # the windowed gathers' base window rows (pallas_wy)


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


def resolve_engine(engine: str) -> str:
    """``"auto"`` → ``"dma-all"`` (JAX's default engine,
    ops/pallas_interp.py:102): the direct K1 gather.  ``"blockspec"``
    takes the windowed route.  ``"dma"`` is not ported yet."""
    if engine not in ENGINES:
        raise ValueError(f"engine={engine!r}: expected one of {ENGINES}")
    if engine == "dma":
        raise NotImplementedError(
            "engine='dma' is not ported yet (ROADMAP.md Queue 1, the 'dma' "
            "engine); use 'auto', 'dma-all' or 'blockspec'")
    return "dma-all" if engine == "auto" else engine


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


def _sort_bands(grid, order: int):
    """Static (row0, nrows) of the south/north sort-binned latitude bands:
    rows with |lat| >= SORT_LAT, the pole-home rows excluded, starts
    rounded up to and lengths cut to multiples of 8 so that sort groups
    are the gather's (8, 128) tiles (models/settls.py:92-117)."""
    lat = np.asarray(grid.lats)
    ny = lat.shape[0]
    polar = np.abs(lat) >= SORT_LAT
    bands = []
    s_hi = int(np.searchsorted(lat, -SORT_LAT, side="right"))
    n_lo = int(np.searchsorted(lat, SORT_LAT, side="left"))
    r0_s = -(-order // TILE_R) * TILE_R
    len_s = ((s_hi - r0_s) // TILE_R) * TILE_R
    if polar[0] and len_s >= TILE_R:
        bands.append((r0_s, len_s))
    r0_n = -(-n_lo // TILE_R) * TILE_R
    len_n = ((ny - order - r0_n) // TILE_R) * TILE_R
    if polar[-1] and len_n >= TILE_R:
        bands.append((r0_n, len_n))
    return bands


def _to_tile_storage(flat, nrows: int, nx: int):
    """Rank-ordered flat array → (nrows, nx) storage in which each (8, 128)
    tile (the last one possibly narrower) holds consecutive ranks
    (models/settls.py:120-133)."""
    gy, nxc = nrows // TILE_R, nx // TILE_C
    rem = nx - nxc * TILE_C
    a2 = flat.reshape(gy, TILE_R * nx)
    main = (a2[:, :nxc * TILE_R * TILE_C].reshape(gy, nxc, TILE_R, TILE_C)
            .transpose(1, 2).reshape(gy, TILE_R, nxc * TILE_C))
    if rem:
        tail = a2[:, nxc * TILE_R * TILE_C:].reshape(gy, TILE_R, rem)
        main = torch.cat([main, tail], dim=-1)
    return main.reshape(nrows, nx)


def _anchored_cells(xi, nx: int):
    """Longitude cells relative to each 8-row group's circular-mean
    longitude, shifted half a period, so that a narrow arc of parcels never
    straddles the key's wrap (models/settls.py:136-147); float32, as JAX."""
    g = xi.shape[0] // TILE_R
    ang = xi.to(torch.float32) * (2.0 * np.pi / nx)
    s = torch.sin(ang).reshape(g, -1).mean(dim=1)
    c = torch.cos(ang).reshape(g, -1).mean(dim=1)
    anc = torch.remainder(_to_index(torch.floor(
        torch.atan2(s, c) * (nx / (2.0 * np.pi)))), nx)
    anc = anc[:, None].expand(g, TILE_R).reshape(-1, 1)
    return torch.remainder(xi - anc + nx // 2, nx)


def _sort_bin_bands(arrs, px, bands, grid):
    """Sort each band's parcels into spatial-tile storage order: pinned to
    their 8-row group and sorted by the SORT_BX-cell block of their
    current, seam-anchored longitude (models/settls.py:150-189).  ``arrs``
    are permuted alike."""
    ny, nx = grid.shape
    sx = nx / (grid.x_max - grid.x_min)
    nbx = -(-nx // SORT_BX)
    out = [a.clone() for a in arrs]
    for r0, nr in bands:
        rows = slice(r0, r0 + nr)
        xi = _to_index(torch.remainder(
            torch.floor(sx * (px[rows] - grid.x_min)), nx))
        group = (torch.arange(nr, device=px.device) // TILE_R)[:, None]
        key = (group * nbx + _anchored_cells(xi, nx) // SORT_BX).reshape(-1)
        order = torch.argsort(key, stable=True)
        for a, src in zip(out, arrs):
            a[rows] = _to_tile_storage(src[rows].reshape(-1)[order], nr, nx)
    return tuple(out)


def _unsort_bands(arrs, perm, bands):
    """Invert the cumulative sort-binning: order each band by the carried
    original linear index (models/settls.py:260-272)."""
    if not bands:
        return arrs
    out = [a.clone() for a in arrs]
    for r0, nr in bands:
        rows = slice(r0, r0 + nr)
        order = torch.argsort(perm[rows].reshape(-1), stable=True)
        for a, src in zip(out, arrs):
            a[rows] = src[rows].reshape(-1)[order].reshape(nr, -1)
    return tuple(out)


def settls_scan(u, v, cu, cv, px0, py0, dt, conv_x, grid, *,
                settls_order: int, interp_order: int, return_traj: bool,
                kernel: str = "torch", engine: str = "auto",
                rebin="sort"):
    """The SETTLS time loop over the parcel grid.

    ``u``/``v``: (T, ny, nx) winds; ``cu``/``cv``: their prefiltered
    coefficients.  ``px0``/``py0``: (ny, nx) initial positions (home rows =
    grid rows).  ``dt``: 0-dim tensor.  ``conv_x``: (ny, 1) per-home-latitude
    factor.  ``kernel``: ``"cuda"`` (the hand-written kernels) or
    ``"torch"`` (their plain versions).  ``engine``: ``"auto"`` /
    ``"dma-all"`` (K1's direct gather) or ``"blockspec"`` (the windowed
    gather); see ``resolve_engine``.  ``rebin`` applies to
    ``"blockspec"``: ``"sort"`` sort-bins the polar bands, False keeps the
    grid layout.  Nothing in the loop waits for the device.

    Returns ``(px, py, overflow)`` — (T, ny, nx) trajectories including
    the initial positions when ``return_traj`` — where ``overflow`` is the
    int32 0-dim overflow bitmask (always 0 on the K1 route).
    """
    if kernel not in ("cuda", "torch"):
        raise ValueError(f"settls_scan: kernel={kernel!r} (resolve 'auto' "
                         f"with resolve_kernel first)")
    if rebin not in ("sort", False):
        raise ValueError(f"rebin={rebin!r}: expected 'sort' or False")
    T, ny, nx = u.shape
    order = interp_order
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

    if resolve_engine(engine) == "blockspec":
        if order not in (1, 3):
            raise NotImplementedError(
                f"engine='blockspec' implements spline orders 1 and 3; got "
                f"interp_order={order}")
        bands = _sort_bands(grid, order) if rebin else []
        ladder = SORT_LADDER if bands else None
        # the pole-home rows are sorted once per step and gathered by a
        # pole-only call (JAX's LCS_POLE_HOIST, on)
        hoist = ny > 2 * order

        def gather(t, px, py, nf, **kw):
            # F=2 groups take 64-row base windows (128 // nf), as JAX's
            return windowed_interp_multi(
                W, CW, px, py, order=order, wy=max(WY, 128 // nf), f0=2 * t,
                nf=nf, ladder=ladder, kernel=kernel,
                **bounds, **kw)
    else:
        bands, hoist = [], False

        def gather(t, px, py, nf):
            if kernel == "cuda":
                return cuda_interp_multi(W, CW, px, py, order=order,
                                         f0=2 * t, nf=nf, **bounds)
            out = interp_at_parcels_multi(W[2 * t:2 * t + nf],
                                          CW[2 * t:2 * t + nf], px, py,
                                          order=order, **bounds)
            return out, zero_flag

    def group(t, sets, nf):
        """One gather group: the values at each parcel set, and the flag."""
        if not hoist:
            arr, fl = gather(t, sets[0][0], sets[0][1], nf)
            return [arr], fl
        (px, py, _), (pxp, pyp, _) = sets
        arr, fl = gather(t, px, py, nf, skip_pole=True)
        valsp, flp = gather(t, pxp, pyp, nf, pole_block=True,
                            pole_presorted=True)
        return [arr, valsp], fl | flp

    def clamp(px, py):
        return _clamp_wrap(px, py, cyclic_x=grid.cyclic_x, **bounds)

    px, py, flag = px0, py0, zero_flag
    cx = conv_x.expand(ny, nx).contiguous() if bands else conv_x
    perm = (torch.arange(ny * nx, dtype=torch.int32, device=device)
            .reshape(ny, nx))
    pole_geom = dict(order=order, nx=nx)
    traj_x, traj_y = [px0], [py0]
    for t in range(T - 1):
        # JAX unrolls K steps per scan iteration when K divides the step
        # count and takes a lax.cond otherwise; both re-bin at t % K == 0
        if bands and t % SORT_K == 0:
            px, py, cx, perm = _sort_bin_bands((px, py, cx, perm), px,
                                               bands, grid)
        # parcel sets (px, py, conv_x): the grid, then with the hoist the
        # pole-home rows as sorted point lists
        sets = [(px, py, cx)]
        if hoist:
            rx, ry = P.pole_rows(px, order), P.pole_rows(py, order)
            perm_p, inv_p = P.pole_sort_state(rx, ry, order=order, ny=ny,
                                              nx=nx, **bounds)
            sets.append(tuple(
                P.pole_apply_perm(a, perm_p, **pole_geom)
                for a in (rx, ry, P.pole_rows(cx.expand(ny, nx), order))))
        # Euler first guess (LagrangianCoherence LCS/trajectory.py:82-87)
        vals, fl = group(t, sets, 2)
        flag = flag | fl
        winds = [(a[0], a[1]) for a in vals]
        sets = [(*clamp(x + dt * c * ua, y + dt * conv_y * va), c)
                for (x, y, c), (ua, va) in zip(sets, winds)]
        # SETTLS fixed-point iterations, cumulative form (Q3)
        # (LagrangianCoherence LCS/trajectory.py:100-124)
        for _ in range(settls_order):
            deps, fl = group(t, sets, 4)
            flag = flag | fl
            sets = [(*clamp(x + 0.5 * dt * c * (ua + 2.0 * d[0] - d[2]),
                            y + 0.5 * dt * conv_y * (va + 2.0 * d[1] - d[3])),
                     c)
                    for (x, y, c), (ua, va), d in zip(sets, winds, deps)]
        px, py = sets[0][:2]
        if hoist:
            px, py = (P.set_pole_rows(a, P.pole_unsort_rows(
                b, inv_p, **pole_geom), order)
                for a, b in zip((px, py), sets[1][:2]))
        if return_traj:
            opx, opy = _unsort_bands((px, py), perm, bands)
            traj_x.append(opx)
            traj_y.append(opy)
    if return_traj:
        return torch.stack(traj_x), torch.stack(traj_y), flag
    return (*_unsort_bands((px, py), perm, bands), flag)


def _as_tensor(a, device, dtype=None) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def parcel_propagation_core(u, v, timestep, grid, *, settls_order: int = 0,
                            interp_order: int = 3, return_traj: bool = False,
                            kernel: str = "auto", engine: str = "auto",
                            rebin="sort", return_overflow: bool = False,
                            device=None,
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
    engine : ``"auto"``, ``"dma-all"`` or ``"blockspec"`` (see
        ``resolve_engine``); ``rebin``: see ``settls_scan``.
    device : where to compute; default: ``u``'s device (the CPU for arrays).
    state : ``grid_state`` tensors on that device and dtype, as
        ``FTLEPipeline`` holds them; built from ``grid`` when omitted.

    Returns
    -------
    (positions_x, positions_y), plus the int32 ``overflow`` bitmask
    (always 0 on the K1 route) when ``return_overflow``; (T, ny, nx)
    trajectories including the initial mesh when ``return_traj``.
    """
    resolve_engine(engine)
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
        return_traj=return_traj, kernel=kernel, engine=engine, rebin=rebin)
    if return_overflow:
        return tuple(pos) + (overflow,)
    return tuple(pos)
