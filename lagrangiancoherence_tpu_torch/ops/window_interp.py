"""The windowed gather of the ``blockspec`` route — plain PyTorch versions of
K2, K3 and K4 and the routed evaluation that drives them.

Counterpart of ``lagrangiancoherence_tpu/ops/pallas_interp.py``
``pallas_interp_multi`` with a non-``dma-all`` engine: tier A, then tier
A-sub, then the escalation ladder, then the sorted-slot pole path, each
tile or slot evaluated against the window that routing (``ops/tiles.py``,
``ops/pole.py``) proved for it.  The functions here are the plain versions
that the CUDA kernels (``ops/cuda_window.py``) are held against, with the
kernels' signatures: they write their tiles into a shared output in place
and a flag per slot, and OR their overflow bit into a device word.

Values: an unflagged tile's taps are the same cells the direct gather
(``ops/interp.py``, K1) reads, accumulated in the same order, so they agree
bit for bit.  A flagged tile's taps are clipped into its window, so its
values are approximate, as in JAX.

JAX's 5-slab lane-shifted padded copy of the coefficients
(``pad_coeffs_for_pallas``, about 6.5 GB at the flagship) is not built: a
window cell maps to the resident (fields, ny, nx) stack by period-``n``
index arithmetic (spline tiers), by the mirrored column taps (full-longitude
tiers), or directly (the pole path's raw rows).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from . import pole as P
from .interp import _axis_taps, _cubic_weights, _to_index
from .tiles import N_SUB, SUB_W, TILE_C, TILE_R, WX, route_tiles, unwrap_k

__all__ = ["Launch", "kernel_functions", "pole_launches",
           "pole_window_gather_plain", "spline_launches",
           "sub_window_gather_plain", "tile_window_gather_plain",
           "windowed_interp_multi"]


# ---------------------------------------------------------------------------
# Plain versions of the kernels
# ---------------------------------------------------------------------------

def _window_taps(f, n, k, base, order):
    """Window-relative tap offsets with the exact mirror remaps of
    ``_tap_offsets`` (pallas_interp.py:268-299), and the tap weights."""
    fl = torch.floor(f)
    i0 = _to_index(fl)
    o0 = i0 + n * k - base
    t = f - fl
    if order == 1:
        return [o0, torch.where(i0 >= n - 1, o0 - 1, o0 + 1)], [1.0 - t, t]
    hi1 = i0 >= n - 1
    offs = [torch.where(f < 1.0, o0 + 1, o0 - 1), o0,
            torch.where(hi1, o0 - 1, o0 + 1),
            torch.where(hi1, o0 - 2, torch.where(i0 == n - 2, o0, o0 + 2))]
    return offs, _cubic_weights(t)


def _clip_taps(offs, w):
    """Offsets clipped into [0, w), and whether any was outside."""
    bad = None
    for o in offs:
        b = (o < 0) | (o >= w)
        bad = b if bad is None else bad | b
    return [o.clamp(0, w - 1) for o in offs], bad


def _window_values(coeffs, f0, nf, yf, xf, ya, xa, y0, x0, wy, wx, order):
    """Values (nf, ...) and per-parcel out-of-window mask of parcels at
    folds ``yf``/``xf`` against windows at (y0, x0) — x0 None: a
    full-longitude tier with mirrored column taps."""
    _, ny, nx = coeffs.shape
    oy, wyv = _window_taps(yf, ny, unwrap_k(yf, ya, ny), y0, order)
    oy, bad = _clip_taps(oy, wy)
    if x0 is None:
        cols, wxv = _axis_taps(xf, nx, order)
    else:
        ox, wxv = _window_taps(xf, nx, unwrap_k(xf, xa, nx), x0, order)
        ox, bad_x = _clip_taps(ox, wx)
        bad = bad | bad_x
        cols = [torch.remainder(x0 + o, nx) for o in ox]
    flat = coeffs[f0:f0 + nf].reshape(nf, ny * nx)
    acc = None
    for j, o in enumerate(oy):
        row = torch.remainder(y0 + o, ny) * nx
        for k, c in enumerate(cols):
            w = wyv[j] * wxv[k]
            lin = (row + c).reshape(-1)
            term = w[None] * flat[:, lin].reshape((nf,) + w.shape)
            acc = term if acc is None else acc + term
    return acc, bad


def _tile_major(a, gy, gx):
    """(nf, gy*8, gx*128) → (gy*gx, nf, 8, 128)."""
    nf = a.shape[0]
    return a.reshape(nf, gy, TILE_R, gx, TILE_C).permute(1, 3, 0, 2, 4) \
        .reshape(gy * gx, nf, TILE_R, TILE_C)


def _write_tiles(out, tile, vals, alive, gy, gx):
    """Write ``vals`` (S, nf, 8, 128) into the home blocks ``tile`` (S,) of
    ``out`` (nf, gy*8, gx*128) where ``alive``; the other slots write a
    spare block, so ``out`` keeps its values there."""
    n_tiles = gy * gx
    tm = torch.cat([_tile_major(out, gy, gx), vals[:1]])
    tm[torch.where(alive, tile, n_tiles)] = vals
    nf = out.shape[0]
    out.copy_(tm[:n_tiles].reshape(gy, gx, nf, TILE_R, TILE_C)
              .permute(2, 0, 3, 1, 4).reshape(out.shape))


def _or_bit(overflow, flags, bit):
    if overflow is not None:
        overflow |= (flags.amax() > 0).to(torch.int32) << bit


def tile_window_gather_plain(coeffs, folds, out, flags, overflow, y0map,
                             x0map, *, f0, nf, order, wy, wx, bit, live=None,
                             sel=None, count=None):
    """K2's plain version: one (8, 128) tile per slot.  Dense mode: every
    tile, gated by ``live``; list mode: slots below ``count`` run tiles
    ``sel``.  ``y0map``/``x0map`` (gy, gx) hold unpadded window starts
    (``x0map`` None: full longitude)."""
    _, ny_t, nx_t = folds.shape
    gy, gx = ny_t // TILE_R, nx_t // TILE_C
    dev = folds.device
    if sel is None:
        tile = torch.arange(gy * gx, device=dev)
        alive = live.reshape(-1) != 0
    else:
        tile = sel.long()
        alive = torch.arange(sel.shape[0], device=dev) < count
    ft = torch.stack([_tile_major(folds[i:i + 1], gy, gx)[:, 0]
                      for i in range(2)])[:, tile]            # (2, S, 8, 128)
    yf, xf = ft[0], ft[1]
    y0 = y0map.reshape(-1)[tile][:, None, None]
    x0 = None if x0map is None else x0map.reshape(-1)[tile][:, None, None]
    vals, bad = _window_values(coeffs, f0, nf, yf, xf, yf[:, :1, :1],
                               xf[:, :1, :1], y0, x0, wy, wx, order)
    slot_bad = bad.any(dim=2).any(dim=1) & alive
    flags.copy_(slot_bad.to(torch.int32))
    _or_bit(overflow, flags, bit)
    _write_tiles(out, tile, vals.permute(1, 0, 2, 3), alive, gy, gx)


def sub_window_gather_plain(coeffs, folds, out, flags, overflow, y0map, x0q,
                            live, *, f0, nf, order, wy, bit):
    """K3's plain version: every (tile, quarter), gated by ``live``; each
    32-column quarter against its own (wy, 128) window at ``x0q``
    (gy, gx, 4), anchored at the quarter's first fold."""
    _, ny_t, nx_t = folds.shape
    gy, gx = ny_t // TILE_R, nx_t // TILE_C
    n_tiles = gy * gx
    ft = torch.stack([_tile_major(folds[i:i + 1], gy, gx)[:, 0]
                      for i in range(2)])                     # (2, T, 8, 128)
    yq = ft[0].reshape(n_tiles, TILE_R, N_SUB, SUB_W).permute(0, 2, 1, 3)
    xq = ft[1].reshape(n_tiles, TILE_R, N_SUB, SUB_W).permute(0, 2, 1, 3)
    ya = ft[0][:, None, :1, :1]
    y0 = y0map.reshape(n_tiles, 1, 1, 1)
    x0 = x0q.reshape(n_tiles, N_SUB, 1, 1)
    vals, bad = _window_values(coeffs, f0, nf, yq, xq, ya, xq[..., :1, :1],
                               y0, x0, wy, TILE_C, order)  # (nf, T, 4, 8, 32)
    alive = live.reshape(-1) != 0
    flags.copy_((bad.any(dim=3).any(dim=2) & alive[:, None])
                .reshape(-1).to(torch.int32))
    _or_bit(overflow, flags, bit)
    vals = vals.permute(1, 0, 3, 2, 4).reshape(n_tiles, nf, TILE_R, TILE_C)
    _write_tiles(out, torch.arange(n_tiles, device=folds.device), vals, alive,
                 gy, gx)


def pole_window_gather_plain(raw, pack, ys, out, flags, overflow, *, f0, nf,
                             wy, bit, sel=None, count=None):
    """K4's plain version: order-1 ``mode='constant'`` bilinear on the raw
    stack for each (8, 128)-point slot of ``pack`` (4, S*8, 128), against
    the y window [ys, ys + wy).  Dense mode: every slot; list mode: slots
    below ``count`` run slots ``sel``.  A masked point whose rows leave the
    window flags its slot and clamps."""
    _, ny, nx = raw.shape
    s_n = pack.shape[1] // TILE_R
    dev = pack.device
    slot = TILE_R * TILE_C
    if sel is None:
        s = torch.arange(s_n, device=dev)
        alive = torch.ones((s_n,), dtype=torch.bool, device=dev)
    else:
        s = sel.long()
        alive = torch.arange(s_n, device=dev) < count
    yc, xc, vm, mk = pack.reshape(4, s_n, slot)[:, s]
    y0w = ys.long()[s][:, None]
    yi = _to_index(torch.floor(yc)).clamp(0, ny - 2)
    oy = yi - y0w
    bad = ((oy < 0) | (oy > wy - 2)) & (mk > 0)
    oy = oy.clamp(0, wy - 2)
    r0 = torch.remainder(y0w + oy, ny) * nx
    r1 = torch.remainder(y0w + oy + 1, ny) * nx
    xi = _to_index(torch.floor(xc)).clamp(0, nx - 2)
    ty = yc - yi.to(yc.dtype)
    tx = xc - xi.to(xc.dtype)
    flat = raw[f0:f0 + nf].reshape(nf, ny * nx)

    def at(lin):
        return flat[:, lin.reshape(-1)].reshape((nf,) + lin.shape)

    val = (at(r0 + xi) * ((1 - ty) * (1 - tx))[None]
           + at(r0 + xi + 1) * ((1 - ty) * tx)[None]
           + at(r1 + xi) * (ty * (1 - tx))[None]
           + at(r1 + xi + 1) * (ty * tx)[None])
    val = torch.where(vm[None] > 0, val, torch.zeros((), dtype=val.dtype,
                                                     device=dev))
    flags.copy_((bad.any(dim=1) & alive).to(torch.int32))
    _or_bit(overflow, flags, bit)
    om = torch.cat([out.reshape(nf, s_n, slot), val[:, :1]], dim=1)
    om[:, torch.where(alive, s, s_n)] = val
    out.copy_(om[:, :s_n].reshape(out.shape))


# ---------------------------------------------------------------------------
# The routed evaluation
# ---------------------------------------------------------------------------

class Launch(NamedTuple):
    """One kernel launch of a gather group.  ``run(fn, out, flags,
    overflow)`` launches ``fn`` — the kernel ``kernel`` or its plain
    version — on this launch's inputs."""
    kernel: str        # tile_window_gather, sub_window_gather, ...
    mode: str          # dense or list ("" for sub_window_gather)
    n_flags: int
    run: Callable


def kernel_functions(kernel: str) -> dict:
    """The functions of a kernel choice, by kernel name."""
    if kernel == "torch":
        return {"tile_window_gather": tile_window_gather_plain,
                "sub_window_gather": sub_window_gather_plain,
                "pole_window_gather": pole_window_gather_plain}
    if kernel == "cuda":
        from . import cuda_window as C
        return {"tile_window_gather": C.tile_window_gather,
                "sub_window_gather": C.sub_window_gather,
                "pole_window_gather": C.pole_window_gather}
    raise ValueError(f"kernel={kernel!r}: expected 'cuda' or 'torch'")


def spline_launches(rt, coeffs, *, f0, nf, order, wy) -> list[Launch]:
    """The spline tiers' launches for routing ``rt`` (``route_tiles``), in
    order: tier A (K2 dense, bit 2), tier A-sub (K3, bit 2), then one K2
    list launch per ladder tier t (bit 5+t).  Each writes its tiles into
    an (nf, gy*8, gx*128) output."""
    kw = dict(f0=f0, nf=nf, order=order)
    n_t = rt.gy * rt.gx
    out = [Launch("tile_window_gather", "dense", n_t,
                  lambda fn, o, f, v: fn(coeffs, rt.folds, o, f, v, rt.y0A,
                                         rt.x0A, wy=wy, wx=WX, bit=2,
                                         live=rt.liveA, **kw))]
    if rt.liveS is not None:
        out.append(Launch("sub_window_gather", "", N_SUB * n_t,
                          lambda fn, o, f, v: fn(coeffs, rt.folds, o, f, v,
                                                 rt.y0A, rt.x0S, rt.liveS,
                                                 wy=wy, bit=2, **kw)))
    for t, tier in enumerate(rt.tiers):
        out.append(Launch(
            "tile_window_gather", "list", tier.cap,
            lambda fn, o, f, v, t=t, tier=tier: fn(
                coeffs, rt.folds, o, f, v, tier.ys, tier.xs, wy=tier.wy,
                wx=tier.wx, bit=5 + t, sel=tier.sel, count=tier.count,
                **kw)))
    return out


def pole_launches(raw, pxf, pyf, mask, *, f0, nf, bounds, ladder):
    """The pole ladder's launches for (2, Mpad) sorted point lists
    (pallas_interp.py:1116-1324): K4 dense over every slot (level 1, flags
    only), then K4 list over the level-2 and level-3 slots (bit 4).  Each
    writes into an (nf, S*8, 128) output.  Also returns the routing
    (``pole.pole_levels``)."""
    _, ny, nx = raw.shape
    pack, key = P.pole_pack(pxf, pyf, mask, ny=ny, nx=nx, **bounds)
    pr = P.pole_levels(key, ny=ny, ladder=ladder)
    n_s = key.shape[0]
    out = [Launch("pole_window_gather", "dense", n_s,
                  lambda fn, o, f, v: fn(raw, pack, pr.ys[0], o, f, None,
                                         f0=f0, nf=nf, wy=pr.wy[0], bit=4))]
    for lvl in (1, 2):
        sel, count = P.compact(pr.want[lvl])
        out.append(Launch(
            "pole_window_gather", "list", n_s,
            lambda fn, o, f, v, lvl=lvl, sel=sel, count=count: fn(
                raw, pack, pr.ys[lvl], o, f, v, f0=f0, nf=nf, wy=pr.wy[lvl],
                bit=4, sel=sel, count=count)))
    return out, pr


def _pole_eval(fns, raw, pxf, pyf, mask, *, f0, nf, bounds, ladder):
    """Values (nf, 2, Mpad) of sorted pole lists, in the lists' order, and
    the overflow bits 3 and 4 (0-dim int32)."""
    launches, pr = pole_launches(raw, pxf, pyf, mask, f0=f0, nf=nf,
                                 bounds=bounds, ladder=ladder)
    dev = pxf.device
    vals = torch.empty((nf, pr.ys[0].shape[0] * TILE_R, TILE_C),
                       dtype=raw.dtype, device=dev)
    overflow = torch.zeros((1,), dtype=torch.int32, device=dev)
    flags = [torch.empty((ln.n_flags,), dtype=torch.int32, device=dev)
             for ln in launches]
    for ln, fl in zip(launches, flags):
        ln.run(fns[ln.kernel], vals, fl, overflow)
    # bit 3: a level-1 clamp no later level covered (level 3 takes every
    # slot left, so it stays 0, as in JAX)
    covered = pr.fit1 | pr.want[1] | pr.want[2]
    overflow |= (flags[0] * (~covered)).amax() << 3
    return vals.reshape(nf, 2, -1), overflow[0]


def windowed_interp_multi(raw, coeffs, px, py, *, x_min, x_max, y_min, y_max,
                          order: int = 3, wy: int = 32,
                          retry_tiles: int = 256, f0: int = 0, nf=None,
                          ladder=None, pole_ladder=P.POLE_LADDER,
                          skip_pole: bool = False, pole_block: bool = False,
                          pole_presorted: bool = False,
                          kernel: str = "torch"):
    """Fields ``[f0, f0 + nf)`` of the resident stacks at parcel positions,
    through the window tiers (``pallas_interp_multi`` with
    ``engine="blockspec"``).

    ``raw``/``coeffs``: (..., ny, nx) raw and prefiltered stacks whose
    leading axes flatten to the field index.  ``px``/``py``: (ny, nx)
    positions of the whole grid.  ``kernel``: ``"cuda"`` (K2-K4) or
    ``"torch"`` (their plain versions).  ``wy``: tier A's window height.
    ``retry_tiles=0`` turns off tier A-sub and the ladder (unfit tiles
    clamp and flag).  ``ladder``: (wy, wx or None, capacity) escalation
    tiers, default ``tiles.DEFAULT_LADDER``.  ``pole_ladder``: the pole
    path's three window heights.

    ``skip_pole``: the pole-home rows keep spline values computed at the
    substituted positions (the caller evaluates them separately).
    ``pole_block``: ``px``/``py`` are the (2*order, nx) pole-home rows
    (``pole_presorted``: (2, Mpad) point lists already in sorted order),
    evaluated by the pole ladder alone; returns the values (nf, 2*order,
    nx) (presorted: (nf, 2, Mpad) in the lists' order).

    Returns ``(out (nf, ny, nx), overflow)`` with JAX's overflow bitmask as
    an int32 0-dim tensor: bit 1 a tile left uncovered, bit 2 a clamped
    tier-A or A-sub tile, bit 3 an uncovered pole level-1 clamp, bit 4 the
    pole residue, bit 5+t a clamped tile of ladder tier t.
    """
    ny, nx = raw.shape[-2:]
    raw = raw.reshape(-1, ny, nx)
    coeffs = coeffs.reshape(-1, ny, nx)
    nf = raw.shape[0] - f0 if nf is None else nf
    fns = kernel_functions(kernel)
    bounds = dict(x_min=x_min, x_max=x_max, y_min=y_min, y_max=y_max)
    pole_kw = dict(f0=f0, nf=nf, bounds=bounds, ladder=pole_ladder)

    if pole_block:
        if order <= 0:
            raise ValueError("pole_block needs a spline order > 0")
        if pole_presorted:
            return _pole_eval(fns, raw, px, py, torch.ones_like(px),
                              **pole_kw)
        perm, inv = P.pole_sort_state(px, py, order=order, ny=ny, nx=nx,
                                      **bounds)
        geom = dict(order=order, nx=nx)
        pxf = P.pole_apply_perm(px, perm, **geom)
        vals, flag = _pole_eval(fns, raw, pxf,
                                P.pole_apply_perm(py, perm, **geom),
                                torch.ones_like(pxf), **pole_kw)
        return P.pole_unsort_rows(vals, inv, **geom), flag

    rt = route_tiles(px, py, ny=ny, nx=nx, order=order, wy=wy,
                     retry_tiles=retry_tiles, ladder=ladder, **bounds)
    out = torch.empty((nf, rt.gy * TILE_R, rt.gx * TILE_C), dtype=raw.dtype,
                      device=px.device)
    overflow = rt.overflow
    for ln in spline_launches(rt, coeffs, f0=f0, nf=nf, order=order, wy=wy):
        ln.run(fns[ln.kernel], out, torch.empty(
            (ln.n_flags,), dtype=torch.int32, device=px.device), overflow)

    if order > 0 and not skip_pole:
        vals, pflag = windowed_interp_multi(
            raw, coeffs, P.pole_rows(px, order), P.pole_rows(py, order),
            order=order, f0=f0, nf=nf, pole_ladder=pole_ladder,
            pole_block=True, kernel=kernel, **bounds)
        out[:, :order, :nx] = vals[:, :order]
        out[:, ny - order:ny, :nx] = vals[:, order:]
        overflow |= pflag
    return out[:, :ny, :nx], overflow[0]
