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

* ``"auto"`` / ``"dma-all"``: the direct per-parcel gather, one fused
  step per launch (``ops/cuda_settls.py``: the whole step of a parcel in
  one thread, K1 redesigned), with no windows; the overflow flag stays 0;
* ``"blockspec"`` and ``"dma"``: the windowed gather (the routed spline
  tiers and the pole ladder, ``ops/window_interp.py``) with JAX's scan
  structure around it (models/settls.py:92-272, 463-729): the polar bands
  are sort-binned into spatial-tile storage order every ``SORT_K`` steps,
  the gathers take the sort ladder, and the pole-home rows are sorted once
  per step and evaluated by a second, pole-only gather.  The overflow word
  is ORed over every gather group.  ``"dma"`` differs from ``"blockspec"``
  only in the capacities of the ladder a gather takes when it is given
  none (``tiles.dma_ladder``): with sort-binning on, every gather is given
  the sort ladder, so the two engines give the same values and words.

On a latitude block (``home_rows``) the windowed route runs JAX's block
mode: one sort band of every complete 8-row group, whose groups with a
non-polar or pole-home row keep their layout, and, given ``pole_seed``,
the 2*order pole-home rows integrated on every block from the seed, each
block writing back the rows it holds.

JAX's trace-time ``LCS_*`` environment knobs are module constants at JAX's
defaults; the port reads no environment variable.
"""
from __future__ import annotations

import logging
from functools import lru_cache

import numpy as np
import torch

from ..devices import resolve_device
from ..ops import pole as P
from ..ops.cuda_settls import (CONV_Y, clamp_wrap, euler_guess, interleave,
                               settls_correction, settls_step,
                               settls_step_torch)
from ..ops.interp import _to_index, prefilter
from ..ops.tiles import SORT_LADDER, TILE_C, TILE_R
from ..ops.window_interp import windowed_interp_multi
from ..utils.logging import logger, timed_stage

__all__ = ["grid_state", "parcel_propagation_core", "resolve_engine",
           "resolve_kernel", "settls_scan"]

KERNELS = ("auto", "cuda", "torch")
ENGINES = ("auto", "dma-all", "blockspec", "dma")
WINDOWED = ("blockspec", "dma")     # the engines of the windowed route
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
    ops/pallas_interp.py:102): the direct gather, one fused step per
    launch.  ``"blockspec"`` and ``"dma"`` take the windowed route (see
    the module docstring)."""
    if engine not in ENGINES:
        raise ValueError(f"engine={engine!r}: expected one of {ENGINES}")
    return "dma-all" if engine == "auto" else engine


def grid_state(grid, *, dtype: torch.dtype,
               device) -> dict[str, torch.Tensor]:
    """The grid-derived tensors the integrator needs: the per-home-row
    ``conv_x`` (ny, 1) m/s → deg/s factor and the initial mesh
    ``px0``/``py0`` (ny, nx).  The prefilter builds its own operators
    (``ops/interp.prefilter``)."""
    kw = dict(dtype=dtype, device=device)
    conv_y = torch.full((), CONV_Y, **kw)
    lat = torch.tensor(grid.lats, **kw)
    px0, py0 = grid.mesh_xy
    return {
        "conv_x": (conv_y / torch.abs(torch.cos(lat * (np.pi / 180.0))))[:, None],
        "px0": torch.tensor(px0, **kw),
        "py0": torch.tensor(py0, **kw),
    }


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


@lru_cache(maxsize=32)
def _sortable_rows(grid, order: int, device: torch.device) -> torch.Tensor:
    """(ny,) bool on ``device``: global row h is polar (|lat| >= SORT_LAT)
    and not a pole-home row."""
    lat = np.asarray(grid.lats)
    h = np.arange(lat.size)
    ok = (np.abs(lat) >= SORT_LAT) & (h >= order) & (h < lat.size - order)
    return torch.as_tensor(ok, device=device)


def _shard_sortable_groups(home_rows, grid, order: int) -> torch.Tensor:
    """Per complete 8-row group of a block: every row's home row is polar
    and none is a pole-home row (models/settls.py:192-210).  ``home_rows``:
    (rows,) global home rows; reflected pad rows classify like the row
    they reflect."""
    ny = grid.shape[0]
    hr = home_rows.reshape(-1).long()
    ok = _sortable_rows(grid, order, hr.device)[hr.clamp(0, ny - 1)]
    n8 = (hr.shape[0] // TILE_R) * TILE_R
    return ok[:n8].reshape(-1, TILE_R).all(dim=1)


def _sort_bin_shard(arrs, px, sortable, grid):
    """A block's variant of ``_sort_bin_bands`` (models/settls.py:213-240):
    one band of every complete 8-row group, sorted by the same
    group-pinned, seam-anchored key; the groups that ``sortable`` leaves
    out then take their own layout back."""
    nx = grid.shape[1]
    sx = nx / (grid.x_max - grid.x_min)
    nr = (px.shape[0] // TILE_R) * TILE_R
    xi = _to_index(torch.remainder(torch.floor(sx * (px[:nr] - grid.x_min)),
                                   nx))
    group = (torch.arange(nr, device=px.device) // TILE_R)[:, None]
    key = (group * nx + _anchored_cells(xi, nx) // SORT_BX).reshape(-1)
    order = torch.argsort(key, stable=True)
    keep = sortable[group]
    out = [a.clone() for a in arrs]
    for a, src in zip(out, arrs):
        binned = _to_tile_storage(src[:nr].reshape(-1)[order], nr, nx)
        a[:nr] = torch.where(keep, binned, src[:nr])
    return tuple(out)


def _unsort_shard(arrs, perm, nr8: int):
    """Invert the cumulative block sort: order the first ``nr8`` rows by
    the carried original linear index (models/settls.py:243-257)."""
    if not nr8:
        return arrs
    order = torch.argsort(perm[:nr8].reshape(-1), stable=True)
    out = [a.clone() for a in arrs]
    for a, src in zip(out, arrs):
        a[:nr8] = src[:nr8].reshape(-1)[order].reshape(nr8, -1)
    return tuple(out)


def settls_scan(u, v, cu, cv, px0, py0, dt, conv_x, grid, *,
                settls_order: int, interp_order: int, return_traj: bool,
                row_offset=0, home_rows=None, kernel: str = "torch",
                engine: str = "auto", debug_per_step: bool = False,
                rebin="sort", pole_seed=None, progress: bool = False):
    """The SETTLS time loop over a block of parcels.

    ``u``/``v``: (T, ny, nx) winds; ``cu``/``cv``: their prefiltered
    coefficients.  ``px0``/``py0``: (rows, cols) initial positions: the
    whole grid, or a block of it whose home rows start at global row
    ``row_offset`` (a latitude block) or are given by ``home_rows`` (an
    integer tensor of ``rows`` values, as the latitude-block pipeline passes
    for its reflected pad rows).  An x-block (``cols < nx``) leaves the
    gather's geometry global: the winds are always the whole grid; the
    windowed route takes full-width blocks only, as JAX's.
    ``dt``: 0-dim tensor.  ``conv_x``: (rows, 1) per-home-latitude factor.
    ``kernel``: ``"cuda"`` (the hand-written kernels) or ``"torch"`` (their
    plain versions).  ``engine``: ``"auto"`` / ``"dma-all"`` (the direct
    gather: one fused step per launch, ``ops/cuda_settls.py``) or
    ``"blockspec"`` / ``"dma"`` (the windowed gather); see
    ``resolve_engine``.  ``pole_seed``: on a block of the windowed route,
    the initial positions and ``conv_x`` of the 2*order pole-home rows
    ((2*order, nx) tensors each, ``parallel/pipeline._pole_seed``): every
    block then integrates them, sorted once per step, and writes back the
    rows it holds (JAX's replicated pole block); without it a block's
    gathers evaluate the pole-home rows they hold themselves.  The direct
    route keys its pole test on the home row itself and ignores it.
    ``rebin`` applies to the windowed route: ``"sort"`` sort-bins the polar
    bands (on a block, the complete 8-row groups whose home rows are all
    polar), False keeps the grid layout.
    ``progress`` logs one ``Propagating time index`` line per step from the
    host loop (the reference's per-step print, LagrangianCoherence
    LCS/trajectory.py:81).  Nothing in the loop waits for the device.

    Returns ``(px, py, overflow)`` — (T, rows, cols) trajectories including
    the initial positions when ``return_traj`` — where ``overflow`` is the
    int32 0-dim overflow bitmask (always 0 on the direct route).  With
    ``debug_per_step`` and no trajectories, the third value is instead the
    (T-1,) int32 overflow word after each step, as JAX returns it
    (models/settls.py:671-673, 721); the windowed route then keeps the grid
    layout, as JAX's does.
    """
    if kernel not in ("cuda", "torch"):
        raise ValueError(f"settls_scan: kernel={kernel!r} (resolve 'auto' "
                         f"with resolve_kernel first)")
    if rebin not in ("sort", False):
        raise ValueError(f"rebin={rebin!r}: expected 'sort' or False")
    engine = resolve_engine(engine)
    T, ny, nx = u.shape
    rows, cols = px0.shape
    if engine in WINDOWED and cols != nx:
        raise ValueError(f"engine={engine!r} needs full-width latitude "
                         f"blocks: positions {rows}x{cols}, grid {ny}x{nx}")
    if home_rows is None and row_offset:
        home_rows = torch.arange(row_offset, row_offset + rows,
                                 device=px0.device)
    if home_rows is not None:
        home_rows = home_rows.reshape(-1).to(device=px0.device,
                                             dtype=torch.int32).contiguous()
    bounds = dict(y_min=grid.y_min, y_max=grid.y_max,
                  x_min=grid.x_min, x_max=grid.x_max)
    kw = dict(settls_order=settls_order, order=interp_order,
              cyclic_x=grid.cyclic_x, home_rows=home_rows, **bounds)
    if kernel == "cuda" and engine == "dma-all":
        # the fused step reads the raw winds as they are and the
        # coefficients interleaved
        u, v, CI = u.contiguous(), v.contiguous(), interleave(cu, cv)

        def step(px, py, t, out):
            return settls_step(u, v, CI, px, py, conv_x, dt, t, out=out, **kw)
    else:
        # planar (T*2, ny, nx) stacks: fields 2t, 2t+1 are (u, v) at level
        # t, so the group at (t, t+1) is the contiguous window [2t, 2t + 4)
        W = torch.stack([u, v], dim=1).reshape(T * 2, ny, nx)
        CW = torch.stack([cu, cv], dim=1).reshape(T * 2, ny, nx)
        if engine in WINDOWED:
            if pole_seed is not None:
                pole_seed = tuple(_as_tensor(a, u.device, u.dtype)
                                  for a in pole_seed)
            return _windowed_scan(W, CW, px0, py0, dt, conv_x, grid,
                                  settls_order=settls_order,
                                  order=interp_order,
                                  return_traj=return_traj, kernel=kernel,
                                  engine=engine,
                                  rebin=rebin and not debug_per_step,
                                  debug_per_step=debug_per_step,
                                  progress=progress, home_rows=home_rows,
                                  pole_seed=pole_seed)

        def step(px, py, t, out):
            return settls_step_torch(W, CW, px, py, conv_x, dt, t, out=out,
                                     **kw)

    # the direct route: one fused step per launch, or its plain version,
    # one gather group at a time; each step writes its end positions once,
    # into the next trajectory slot or a new pair (out of place)
    if return_traj:
        traj_x = torch.empty((T, rows, cols), dtype=u.dtype, device=u.device)
        traj_y = torch.empty_like(traj_x)
        traj_x[0], traj_y[0] = px0, py0
    px, py = px0, py0
    for t in range(T - 1):
        if progress:
            logger.info("Propagating time index %d/%d", t + 1, T - 1)
        out = (traj_x[t + 1], traj_y[t + 1]) if return_traj else None
        px, py = step(px, py, t, out)
    if return_traj:
        return traj_x, traj_y, torch.zeros((), dtype=torch.int32,
                                           device=u.device)
    shape = (T - 1,) if debug_per_step else ()
    return px, py, torch.zeros(shape, dtype=torch.int32, device=u.device)


def _windowed_scan(W, CW, px0, py0, dt, conv_x, grid, *, settls_order: int,
                   order: int, return_traj: bool, kernel: str, engine: str,
                   rebin, debug_per_step: bool, progress: bool, home_rows,
                   pole_seed):
    """``settls_scan``'s windowed route on the planar raw and coefficient
    stacks ``W``/``CW`` (2T, ny, nx), for the whole grid (``home_rows``
    None) or a full-width latitude block."""
    T, ny, nx = W.shape[0] // 2, *W.shape[1:]
    rows = px0.shape[0]
    dtype, device = W.dtype, W.device
    conv_y = torch.full((), CONV_Y, dtype=dtype, device=device)
    bounds = dict(y_min=grid.y_min, y_max=grid.y_max,
                  x_min=grid.x_min, x_max=grid.x_max)
    zero_flag = torch.zeros((), dtype=torch.int32, device=device)
    if order not in (1, 3):
        raise NotImplementedError(
            f"engine={engine!r} implements spline orders 1 and 3; got "
            f"interp_order={order}")
    block = home_rows is not None
    nr8 = (rows // TILE_R) * TILE_R
    if block:
        # JAX's block sort (models/settls.py:353-379) runs whenever the
        # block holds a complete 8-row group, sortable or not
        sort = bool(rebin) and nr8 > 0
        sortable = _shard_sortable_groups(home_rows, grid, order) \
            if sort else None
    else:
        bands = _sort_bands(grid, order) if rebin else []
        sort = bool(bands)
    ladder = SORT_LADDER if sort else None
    # the pole-home rows are sorted once per step and gathered by a
    # pole-only call (JAX's LCS_POLE_HOIST, on); a block hoists them when
    # it is given their seed
    hoist = ny > 2 * order and (not block or pole_seed is not None)

    def do_sort(arrs, px):
        if block:
            return _sort_bin_shard(arrs, px, sortable, grid)
        return _sort_bin_bands(arrs, px, bands, grid)

    def undo_sort(arrs, perm):
        if not sort:
            return arrs
        if block:
            return _unsort_shard(arrs, perm, nr8)
        return _unsort_bands(arrs, perm, bands)

    def gather(t, px, py, nf, **kw):
        # F=2 groups take 64-row base windows (128 // nf), as JAX's
        return windowed_interp_multi(
            W, CW, px, py, order=order, wy=max(WY, 128 // nf), f0=2 * t,
            nf=nf, ladder=ladder, engine=engine, kernel=kernel,
            **bounds, **kw)

    def group(t, sets, nf):
        """One gather group: the values at each parcel set, and the flag."""
        if not hoist:
            arr, fl = gather(t, sets[0][0], sets[0][1], nf,
                             home_rows=home_rows)
            return [arr], fl
        (px, py, _), (pxp, pyp, _) = sets
        arr, fl = gather(t, px, py, nf, skip_pole=True, home_rows=home_rows)
        valsp, flp = gather(t, pxp, pyp, nf, pole_block=True,
                            pole_presorted=True)
        return [arr, valsp], fl | flp

    def clamp(px, py):
        return clamp_wrap(px, py, cyclic_x=grid.cyclic_x, **bounds)

    px, py, flag = px0, py0, zero_flag
    cx = conv_x.expand(rows, nx).contiguous() if sort else conv_x
    perm = (torch.arange(rows * nx, dtype=torch.int32, device=device)
            .reshape(rows, nx))
    pole_geom = dict(order=order, nx=nx)
    if hoist and block:
        # the replicated pole block (models/settls.py:485-529): its rows in
        # home layout, and where each block row that holds one reads it
        pxp_h, pyp_h, cxp_h = pole_seed
        cxp_h = cxp_h.expand(2 * order, nx)
        hr = home_rows.long()
        pole_mask = ((hr < order) | (hr >= ny - order))[:, None]
        pole_slot = torch.where(hr < order, hr,
                                hr - (ny - 2 * order)).clamp(0, 2 * order - 1)
    traj_x, traj_y, step_flags = [px0], [py0], []
    for t in range(T - 1):
        if progress:
            logger.info("Propagating time index %d/%d", t + 1, T - 1)
        # JAX unrolls K steps per scan iteration when K divides the step
        # count and takes a lax.cond otherwise; both re-bin at t % K == 0
        if sort and t % SORT_K == 0:
            px, py, cx, perm = do_sort((px, py, cx, perm), px)
        # parcel sets (px, py, conv_x): the grid, then with the hoist the
        # pole-home rows as sorted point lists
        sets = [(px, py, cx)]
        if hoist:
            if block:
                rx, ry, rc = pxp_h, pyp_h, cxp_h
            else:
                rx, ry = P.pole_rows(px, order), P.pole_rows(py, order)
                rc = P.pole_rows(cx.expand(ny, nx), order)
            perm_p, inv_p = P.pole_sort_state(rx, ry, order=order, ny=ny,
                                              nx=nx, **bounds)
            sets.append(tuple(P.pole_apply_perm(a, perm_p, **pole_geom)
                              for a in (rx, ry, rc)))
        # Euler first guess (LagrangianCoherence LCS/trajectory.py:82-87)
        vals, fl = group(t, sets, 2)
        flag = flag | fl
        winds = [(a[0], a[1]) for a in vals]
        sets = [(*clamp(*euler_guess(x, y, c, ua, va, dt, conv_y)), c)
                for (x, y, c), (ua, va) in zip(sets, winds)]
        # SETTLS fixed-point iterations, cumulative form (Q3)
        # (LagrangianCoherence LCS/trajectory.py:100-124)
        for _ in range(settls_order):
            deps, fl = group(t, sets, 4)
            flag = flag | fl
            sets = [(*clamp(*settls_correction(x, y, c, ua, va, d, dt,
                                               conv_y)), c)
                    for (x, y, c), (ua, va), d in zip(sets, winds, deps)]
        px, py = sets[0][:2]
        if hoist:
            hx, hy = (P.pole_unsort_rows(b, inv_p, **pole_geom)
                      for b in sets[1][:2])
            if block:
                # the rows this block holds, in storage order: the block
                # sort never moves a group that holds a pole-home row
                pxp_h, pyp_h = hx, hy
                px = torch.where(pole_mask, hx.index_select(0, pole_slot), px)
                py = torch.where(pole_mask, hy.index_select(0, pole_slot), py)
            else:
                px = P.set_pole_rows(px, hx, order)
                py = P.set_pole_rows(py, hy, order)
        step_flags.append(flag)
        if return_traj:
            opx, opy = undo_sort((px, py), perm)
            traj_x.append(opx)
            traj_y.append(opy)
    if return_traj:
        return torch.stack(traj_x), torch.stack(traj_y), flag
    if debug_per_step:
        flag = torch.stack(step_flags) if step_flags else \
            zero_flag.new_zeros((0,))
    return (*undo_sort((px, py), perm), flag)


def _as_tensor(a, device, dtype=None) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def parcel_propagation_core(u, v, timestep, grid, *, settls_order: int = 0,
                            interp_order: int = 3, return_traj: bool = False,
                            kernel: str = "auto", engine: str = "auto",
                            rebin="sort", return_overflow: bool = False,
                            progress: bool = False, device=None,
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
    engine : ``"auto"``, ``"dma-all"``, ``"blockspec"`` or ``"dma"`` (see
        ``resolve_engine``); ``rebin``, ``progress``: see ``settls_scan``.
    device : where to compute; default: the device of ``u`` or ``v`` if a
        tensor, else the CUDA card (``devices.resolve_device``).
    state : ``grid_state`` tensors on that device and dtype, as
        ``FTLEPipeline`` holds them; built from ``grid`` when omitted.

    Returns
    -------
    (positions_x, positions_y), plus the int32 ``overflow`` bitmask
    (always 0 on the direct route) when ``return_overflow``; (T, ny, nx)
    trajectories including the initial mesh when ``return_traj``.
    """
    resolve_engine(engine)
    device = resolve_device(device, u, v)
    u = _as_tensor(u, device)
    v = _as_tensor(v, device, u.dtype)
    if u.shape[-2:] != tuple(grid.shape) or v.shape != u.shape:
        raise ValueError(f"winds {tuple(u.shape)}/{tuple(v.shape)} do not "
                         f"match grid {grid.shape}")
    kernel = resolve_kernel(kernel, u.device, interp_order)
    if state is None:
        state = grid_state(grid, dtype=u.dtype, device=u.device)

    # prefilter every time slice once; raw fields are still needed for the
    # pole rows' order-1/constant path
    with timed_stage("Prefilter", logging.DEBUG):
        cu = prefilter(u, order=interp_order)
        cv = prefilter(v, order=interp_order)
    dt = torch.full((), float(timestep), dtype=u.dtype, device=u.device)
    with timed_stage("SETTLS loop", logging.DEBUG):
        *pos, overflow = settls_scan(
            u, v, cu, cv, state["px0"], state["py0"], dt, state["conv_x"],
            grid, settls_order=settls_order, interp_order=interp_order,
            return_traj=return_traj, kernel=kernel, engine=engine,
            rebin=rebin, progress=progress)
    if return_overflow:
        return tuple(pos) + (overflow,)
    return tuple(pos)
