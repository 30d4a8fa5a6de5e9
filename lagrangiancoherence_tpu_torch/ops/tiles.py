"""Tile geometry and routing of the windowed gather — torch ops on the device.

The gather's main path takes from here its geometry (``tile_folds``,
``capped_ladder``, the ladders) and routes inside its kernel
(``ops/cuda_window.py`` ``tier_window_gather``).  ``route_tiles`` is the
routing restated as JAX runs it, ahead of the launches, in torch ops: the
tests pin it to JAX's ``debug_flags`` and hold the kernel's plain version
against it; nothing else calls it.

Counterpart of the routing half of ``lagrangiancoherence_tpu/ops/
pallas_interp.py`` ``pallas_interp_multi`` (non-``dma-all`` engines).  The
parcel grid is cut into (8, 128) home tiles; each tile's taps are proven to
fit a window of field cells, and the tile is routed to the cheapest window
tier that holds them:

* tier A — a (wy, wx) window per tile, dense over all tiles;
* tier A-sub — four (wy, 128) windows, one per 32-column quarter;
* an escalation ladder of wider windows, up to full-longitude slabs, over
  compacted tile lists (three-pass first fit with per-tier capacities).

Routing decisions and the overflow bits 1 (a tile left uncovered) are JAX's
exactly: window starts keep the 8-row and 32-lane alignment of JAX's padded
coefficient geometry (``coeff_pad_dims``), although the port never builds
the padded stack — a window cell maps back to the resident (fields, ny, nx)
stack by period-``n`` index arithmetic in the gather kernels.

Nothing here synchronises with the host: counts stay on the device, and
compaction is a cumsum and a scatter (never ``torch.nonzero``).
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch

from .interp import _fold_coord_wrap, _to_index, scale_positions

__all__ = ["DEFAULT_LADDER", "N_SUB", "POLE_PAD", "Routing", "SORT_LADDER",
           "SUB_W", "TILE_C", "TILE_R", "Tier", "WX", "X_GRAN",
           "capped_ladder", "coeff_pad_dims", "device_ints", "dma_ladder",
           "route_tiles", "substitute_pole_rows", "tile_folds", "unwrap_k"]

TILE_R = 8          # home rows per tile
TILE_C = 128        # home columns per tile
X_GRAN = 32         # x window starts are 32-granular (128 / 4 lane copies)
N_SUB = 4           # tier A-sub: four 32-column quarters, 128-wide windows
SUB_W = TILE_C // N_SUB
# raw-stack row padding of the pole windows (pallas_interp.py:79): window
# starts may reach ny_tf + POLE_PAD - wy
POLE_PAD = 48
WX = 256            # tier A's window width (JAX's wx default)

# escalation ladders: (wy, wx or None = full longitude, capacity).  The
# blockspec engine's (pallas_interp.py:1807-1817, with JAX's retry_wy 64
# and retry_wx 512), and that of sort-binned scans (models/settls.py:74-75)
DEFAULT_LADDER = ((64, WX, 384), (32, 384, 96), (64, 384, 96),
                  (32, 512, 64), (64, 512, 64), (128, 768, 96),
                  (32, None, 96), (64, None, 128), (192, None, 16))
SORT_LADDER = ((64, 256, 512), (32, 512, 256), (64, 512, 256),
               (32, None, 96), (64, None, 96), (192, None, 32))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def coeff_pad_dims(ny: int, nx: int) -> tuple[int, int]:
    """(ypad, xpad) of JAX's padded coefficient geometry
    (pallas_interp.py:129-134); the port keeps it so that window starts
    equal JAX's."""
    ypad = _cdiv(ny // 2 + 16, 8) * 8
    xpad = _cdiv(nx // 2 + 8, 128) * 128 + 2 * 128
    return ypad, xpad


@lru_cache(maxsize=256)
def device_ints(values: tuple, device: torch.device) -> torch.Tensor:
    """A constant int32 tensor of ``values`` on ``device``, built once by
    fill kernels: a host-to-device copy would synchronise."""
    return torch.stack([torch.full((), int(v), dtype=torch.int32,
                                   device=device) for v in values])


def _unwrap(fold_c: torch.Tensor, anchor: torch.Tensor,
            n: int) -> torch.Tensor:
    """Tile-anchored mod-n unwrap (pallas_interp.py:240-249)."""
    return anchor + torch.remainder(fold_c - anchor + 0.5 * n,
                                    float(n)) - 0.5 * n


def unwrap_k(fold_c: torch.Tensor, anchor: torch.Tensor,
             n: int) -> torch.Tensor:
    """Integer period count k with ``unwrap = fold + n*k``
    (pallas_interp.py:252-256); NaN gives 0, as XLA's cast does."""
    return _to_index(torch.round((_unwrap(fold_c, anchor, n) - fold_c) / n))


def _floor_int(a: torch.Tensor) -> torch.Tensor:
    return _to_index(torch.floor(a))


def _tile_minmax(fold_t: torch.Tensor, n: int):
    """Per-tile min/max of the unwrapped floors ``floor(fold) + n*k``,
    (gy, gx) each (pallas_interp.py:1060-1076)."""
    nyt, nxt = fold_t.shape
    tiles = fold_t.reshape(nyt // TILE_R, TILE_R, nxt // TILE_C, TILE_C)
    f = _floor_int(tiles) + n * unwrap_k(tiles, tiles[:, :1, :, :1], n)
    return f.amin(dim=(1, 3)), f.amax(dim=(1, 3))


def _fold_floor_mm(fold_t: torch.Tensor):
    nyt, nxt = fold_t.shape
    f = _floor_int(fold_t).reshape(nyt // TILE_R, TILE_R, nxt // TILE_C,
                                   TILE_C)
    return f.amin(dim=(1, 3)), f.amax(dim=(1, 3))


def substitute_pole_rows(p: torch.Tensor, order: int, ny: int | None = None,
                         home_rows: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """The spline path's positions: pole-home rows take the nearest
    non-pole row's positions (pallas_interp.py:1702-1723), so their
    unbounded positions never widen a tile's window.  ``p`` is the (ny, nx)
    grid, or with ``home_rows`` (the (rows,) global home row of each row of
    ``p``) a latitude block of a grid of ``ny`` rows, whose rows are taken
    through JAX's clipped home-row map: block row ``clip(clip(h, order,
    ny-1-order) - home_rows[0], 0, rows-1)`` for home row ``h``."""
    rows, nx = p.shape
    if order <= 0 or rows <= 2 * order:
        return p
    if home_rows is None:
        return torch.cat([p[order:order + 1].expand(order, nx),
                          p[order:rows - order],
                          p[rows - 1 - order:rows - order].expand(order, nx)])
    hr = home_rows.reshape(-1).long()
    idx = (hr.clamp(order, ny - 1 - order) - hr[0]).clamp(0, rows - 1)
    return p.index_select(0, idx)


def pad_tiles(p: torch.Tensor, ny_t: int, nx_t: int) -> torch.Tensor:
    """Edge-pad (rows, cols) positions to the (ny_t, nx_t) tile grid."""
    rows, cols = p.shape
    if ny_t > rows:
        p = torch.cat([p, p[-1:].expand(ny_t - rows, cols)])
    if nx_t > cols:
        p = torch.cat([p, p[:, -1:].expand(ny_t, nx_t - cols)], dim=1)
    return p


def capped_ladder(ny: int, nx: int, ladder=None):
    """``ladder`` (default ``DEFAULT_LADDER``) as (wy, wx or None,
    capacity) tiers with the windows cut to JAX's padded geometry."""
    ypad, xpad = coeff_pad_dims(ny, nx)
    wy_cap = ((ny + 2 * ypad) // 8) * 8
    wx_cap = ((nx + 2 * xpad - 128) // 128) * 128
    return [(min(wy_, wy_cap), None if wx_ is None else min(wx_, wx_cap), cap)
            for wy_, wx_, cap in (DEFAULT_LADDER if ladder is None
                                  else ladder)]


def dma_ladder(n_tiles: int, retry_wy: int = 64, retry_wx: int = 512
               ) -> tuple:
    """The ``dma`` / ``dma-all`` engines' escalation ladder for a parcel
    block of ``n_tiles`` (8, 128) tiles (pallas_interp.py:1793-1805): the
    windows of ``DEFAULT_LADDER``, with capacities that scale with the tile
    count, since the manual-DMA engine iterates live slots only."""
    n = n_tiles
    return ((64, WX, max(384, n // 2)), (32, 384, max(96, n // 4)),
            (64, 384, max(96, n // 4)), (32, retry_wx, max(64, n // 8)),
            (retry_wy, retry_wx, max(64, n // 8)),
            (128, 768, max(96, n // 4)), (32, None, max(96, n // 2)),
            (64, None, max(128, n // 2)), (192, None, max(16, n // 4)))


def tile_folds(px: torch.Tensor, py: torch.Tensor, *, ny: int, nx: int,
               x_min, x_max, y_min, y_max, order: int, wy: int,
               home_rows: torch.Tensor | None = None) -> torch.Tensor:
    """The folded (y, x) index coordinates (2, rows_t, nx_t) of (rows, nx)
    parcel positions, edge-padded to whole (8, 128) tiles
    (pallas_interp.py:1688-1689), the pole-home rows at their substituted
    positions (``substitute_pole_rows``): what the spline tiers gather at.
    The positions are the (ny, nx) grid, or with ``home_rows`` a latitude
    block of it.  Raises if tier A's (``wy``, ``WX``) window exceeds JAX's
    padded field."""
    rows = px.shape[0]
    if px.shape != (rows, nx) or py.shape != (rows, nx) or (
            home_rows is None and rows != ny):
        raise ValueError(f"tile_folds: positions {tuple(px.shape)} are "
                         f"neither the full ({ny}, {nx}) grid nor a "
                         f"full-width block with home_rows")
    ypad, xpad = coeff_pad_dims(ny, nx)
    ny_t, nx_t = _cdiv(rows, TILE_R) * TILE_R, _cdiv(nx, TILE_C) * TILE_C
    nxp_c = nx + 2 * xpad - 128
    if ny + 2 * ypad < wy or nxp_c < WX:
        raise ValueError(f"window ({wy},{WX}) exceeds padded field "
                         f"({ny + 2 * ypad},{nxp_c})")
    sub = dict(order=order, ny=ny, home_rows=home_rows)
    pxt = pad_tiles(substitute_pole_rows(px, **sub), ny_t, nx_t)
    pyt = pad_tiles(substitute_pole_rows(py, **sub), ny_t, nx_t)
    xi, yi = scale_positions(pxt, pyt, x_min=x_min, x_max=x_max,
                             y_min=y_min, y_max=y_max, nx=nx, ny=ny)
    return torch.stack([_fold_coord_wrap(yi, ny), _fold_coord_wrap(xi, nx)])


class Tier(NamedTuple):
    """One escalation tier's compacted slot list."""
    sel: torch.Tensor          # (cap,) int32 tile indices, live prefix
    count: torch.Tensor        # 0-dim int32 live slots
    ys: torch.Tensor           # (gy, gx) int32 unpadded y window starts
    xs: torch.Tensor | None    # (gy, gx) int32 x starts; None: full x
    wy: int
    wx: int | None
    cap: int


class Routing(NamedTuple):
    gy: int
    gx: int
    folds: torch.Tensor        # (2, ny_t, nx_t) folded y, x coordinates
    fitA: torch.Tensor         # (gy, gx) bool: taps fit tier A's window
    covered: torch.Tensor      # (gy, gx) bool: taken by a ladder tier
    liveA: torch.Tensor        # (gy, gx) int32: tiles tier A evaluates
    y0A: torch.Tensor          # (gy, gx) int32 unpadded tier-A starts
    x0A: torch.Tensor
    liveS: torch.Tensor | None  # (gy, gx) int32: tier A-sub tiles
    x0S: torch.Tensor | None   # (gy, gx, 4) int32 quarter starts
    tiers: list                # of Tier, one per ladder tier
    overflow: torch.Tensor     # (1,) int32: bit 1


def route_tiles(px: torch.Tensor, py: torch.Tensor, *, ny: int, nx: int,
                x_min, x_max, y_min, y_max, order: int, wy: int,
                retry_tiles: int = 256, ladder=None) -> Routing:
    """Route the (ny, nx) parcel grid's tiles to window tiers.

    ``px``/``py`` are the parcels' positions (home rows = grid rows).
    ``wy``: tier A's window height.  ``retry_tiles=0`` turns off tier
    A-sub and the ladder (``ladder``: default ``DEFAULT_LADDER``), so
    unfit tiles stay in tier A and clamp.  Window starts are returned in
    unpadded unwrapped index space (JAX's padded start minus its pad).
    """
    folds = tile_folds(px, py, ny=ny, nx=nx, x_min=x_min, x_max=x_max,
                       y_min=y_min, y_max=y_max, order=order, wy=wy)
    yfold, xfold = folds[0], folds[1]
    device = px.device
    ypad, xpad = coeff_pad_dims(ny, nx)
    _, ny_t, nx_t = folds.shape
    gy, gx = ny_t // TILE_R, nx_t // TILE_C
    n_tiles = gy * gx
    ymn, ymx = _tile_minmax(yfold, ny)
    xmn, xmx = _tile_minmax(xfold, nx)

    # tiles whose folded floors come within a cell of the mirror-remap
    # zones (pallas_interp.py:1740-1757) take one more cell of routing slack
    yfmn, yfmx = _fold_floor_mm(yfold)
    xfmn, xfmx = _fold_floor_mm(xfold)
    edge = (yfmn <= 1) | (yfmx >= ny - 3) | (xfmn <= 1) | (xfmx >= nx - 3)

    lad = capped_ladder(ny, nx, ladder)
    m = 2 if order == 3 else 1
    ulp = torch.where(edge, 2, 1).to(torch.int32)
    slop = m + ulp

    # every (wy, wx) spec at once, one (T, gy, gx) op chain
    # (fit_many, pallas_interp.py:1833-1854)
    specs = [(wy, WX)] + ([(w_, x_) for w_, x_, _ in lad]
                          if retry_tiles > 0 else [])

    def col(values):
        return device_ints(tuple(values), device).reshape(-1, 1, 1)

    wy_a = col(s[0] for s in specs)
    wx_a = col(WX if s[1] is None else s[1] for s in specs)
    ys = torch.minimum(torch.clamp(((ymn - slop + ypad) // 8) * 8, min=0),
                       col(((ny + 2 * ypad - s[0]) // 8) * 8 for s in specs))
    oky = (((ymn - m - ulp) >= ys - ypad)
           & ((ymx + 2 + ulp) <= ys - ypad + wy_a - 1))
    xs = torch.minimum(
        torch.clamp(((xmn - slop + xpad) // X_GRAN) * X_GRAN, min=0),
        col(((nx + 2 * xpad - 128 - (WX if s[1] is None else s[1]))
             // X_GRAN) * X_GRAN for s in specs))
    okx = (((xmn - m - ulp) >= xs - xpad)
           & ((xmx + 2 + ulp) <= xs - xpad + wx_a - 1))
    # window starts from here on are unpadded: JAX's padded start - pad
    ys = (ys - ypad).to(torch.int32)
    xs = (xs - xpad).to(torch.int32)
    fits = [(oky[i] if s[1] is None else oky[i] & okx[i], ys[i],
             None if s[1] is None else xs[i]) for i, s in enumerate(specs)]
    (fitA, y0A, x0A), lad_fits = fits[0], fits[1:]

    # tier A-sub (pallas_interp.py:1869-1894): per-quarter x windows of 128
    fitS = torch.zeros((gy, gx), dtype=torch.bool, device=device)
    x0S = None
    if retry_tiles > 0:
        xt = xfold.reshape(gy, TILE_R, gx, N_SUB, SUB_W)
        f2 = _floor_int(xt) + nx * unwrap_k(xt, xt[:, :1, :, :, :1], nx)
        xmn2, xmx2 = f2.amin(dim=(1, 4)), f2.amax(dim=(1, 4))
        slop2, ulp2 = slop[..., None], ulp[..., None]
        x0S = torch.clamp(((xmn2 - slop2 + xpad) // X_GRAN) * X_GRAN, 0,
                          ((nx + 2 * xpad - 256) // X_GRAN) * X_GRAN)
        okx2 = (((xmn2 - m - ulp2) >= x0S - xpad)
                & ((xmx2 + 2 + ulp2) <= x0S - xpad + 127)).all(dim=-1)
        oky = (((ymn - m - ulp) >= y0A) & ((ymx + 2 + ulp) <= y0A + wy - 1))
        fitS = oky & okx2

    overflow = torch.zeros((1,), dtype=torch.int32, device=device)
    covered = torch.zeros((gy, gx), dtype=torch.bool, device=device)
    fit_base = fitA | fitS
    tiers = []
    if lad_fits:
        tiers, covered = _assign_plan(lad, lad_fits, fit_base, n_tiles)
    if retry_tiles > 0:
        overflow |= (((~fit_base) & (~covered)).any()).to(torch.int32) << 1

    sub = retry_tiles > 0
    return Routing(
        gy=gy, gx=gx, folds=folds, fitA=fitA,
        covered=covered,
        liveA=((fitA | ~covered) & ~fitS).to(torch.int32), y0A=y0A, x0A=x0A,
        liveS=fitS.to(torch.int32) if sub else None,
        x0S=(x0S - xpad).to(torch.int32) if sub else None,
        tiers=tiers, overflow=overflow)


def _assign_plan(lad, lad_fits, fit_base, n_tiles):
    """Three-pass batched first fit (pallas_interp.py:1992-2036): every
    escalated tile goes to the first ladder tier that holds it with
    capacity left; every tier's slot list comes from one scatter."""
    device = fit_base.device
    T = len(lad)
    caps = [min(c, n_tiles) for _, _, c in lad]
    caps_j = device_ints(tuple(caps), device)[:, None]
    fits_T = torch.stack([f.reshape(-1) for f, _, _ in lad_fits])
    elig = fits_T & (~fit_base).reshape(1, -1)
    t_iota = torch.arange(T, dtype=torch.int32, device=device)[:, None]
    assigned = torch.zeros((n_tiles,), dtype=torch.bool, device=device)
    tried = torch.zeros_like(elig)
    taken = torch.zeros_like(elig)
    rank_T = torch.zeros(elig.shape, dtype=torch.int32, device=device)
    cnt = torch.zeros((T,), dtype=torch.int32, device=device)
    for _ in range(min(3, T)):
        avail = elig & ~tried & ~assigned[None]
        first = torch.argmax(avail.to(torch.int32), dim=0).to(torch.int32)
        oh = (t_iota == first[None]) & avail
        rank = (torch.cumsum(oh.to(torch.int32), dim=1) - 1
                + cnt[:, None]).to(torch.int32)
        take = oh & (rank < caps_j)
        taken |= take
        rank_T = torch.where(take, rank, rank_T)
        cnt = cnt + take.sum(dim=1, dtype=torch.int32)
        assigned |= take.any(dim=0)
        tried |= oh
    gy, gx = fit_base.shape
    covered = taken.any(dim=0).reshape(gy, gx)
    maxcap = max(caps)
    dst = torch.where(taken, t_iota * maxcap + rank_T, T * maxcap)
    tile_iota = torch.arange(n_tiles, dtype=torch.int32,
                             device=device).expand(T, n_tiles)
    sel_all = torch.zeros((T * maxcap + 1,), dtype=torch.int32,
                          device=device)
    sel_all.scatter_(0, dst.reshape(-1).long(), tile_iota.reshape(-1))
    sel_all = sel_all[:-1].reshape(T, maxcap)
    tiers = [Tier(sel=sel_all[t, :caps[t]].contiguous(), count=cnt[t], ys=ys,
                  xs=xs, wy=wy_, wx=wx_, cap=caps[t])
             for t, ((wy_, wx_, _), (_, ys, xs)) in enumerate(zip(lad,
                                                                  lad_fits))]
    return tiers, covered
