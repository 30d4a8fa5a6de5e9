"""The windowed gather of the ``blockspec`` route — plain PyTorch versions of
the spline tiers' routed gather and of the pole ladder, and the routed
evaluation that drives them.

Counterpart of ``lagrangiancoherence_tpu/ops/pallas_interp.py``
``pallas_interp_multi`` with a non-``dma-all`` engine: tier A, tier A-sub
and the escalation ladder, then the sorted-slot pole path, each tile or
slot evaluated against the window that holds its taps.  The functions here
are the plain versions that the CUDA kernels (``ops/cuda_window.py``) are
held against, with the kernels' signatures: they write their tiles into a
shared output in place and a flag per tile, and OR their overflow bits
into a device word.

The spline tiers come twice.  ``tier_window_gather_plain`` is the plain
version of the kernels: every tile derives its own window facts and routes
itself.  ``tiles.route_tiles`` with ``spline_launches`` and the per-tier
``tile_window_gather_plain`` and ``sub_window_gather_plain`` is the route
restated as JAX runs it (routing first, then one launch a tier), which the
tests pin to JAX's ``debug_flags`` and hold the former against; nothing
else calls it.

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
from .tiles import (N_SUB, SUB_W, TILE_C, TILE_R, WX, X_GRAN, _floor_int,
                    _fold_floor_mm, _tile_minmax, capped_ladder,
                    coeff_pad_dims, device_ints, dma_ladder, tile_folds,
                    unwrap_k)

__all__ = ["FIT_A", "FIT_S", "Launch", "PLAN_W", "block_pole_candidates",
           "kernel_functions",
           "plan_tiers", "pole_ladder_gather_plain", "pole_launch",
           "spline_launches", "sub_window_gather_plain", "tier_launch",
           "tier_window_gather_plain", "tile_window_gather_plain",
           "windowed_interp_multi"]

# tier_window_gather's per-tile outputs: ``plan`` rows are [tier, y0, x0 of
# quarters 0..3, wy, wx or 0 for full longitude] with tier -2 (A-sub), -1
# (tier A) or t >= 0 (ladder tier t; the x start in column 2); ``fits`` words
# hold bit t if ladder tier t's window holds the tile, bit FIT_A for tier
# A's, bit FIT_S for tier A-sub's
PLAN_W = 8
FIT_A, FIT_S = 16, 17
MAX_TIERS = 16


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
    """Offsets clipped into [0, w) (``w``: an int or a tensor), and whether
    any was outside."""
    bad = None
    for o in offs:
        b = (o < 0) | (o >= w)
        bad = b if bad is None else bad | b
    if isinstance(w, torch.Tensor):
        return [torch.minimum(o.clamp(min=0), w - 1) for o in offs], bad
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
    """One window tier as JAX launches it: one (8, 128) tile per slot.
    Dense mode: every tile, gated by ``live``; list mode: slots below
    ``count`` run tiles ``sel``.  ``y0map``/``x0map`` (gy, gx) hold unpadded
    window starts (``x0map`` None: full longitude)."""
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
    """Tier A-sub as JAX launches it: every (tile, quarter), gated by
    ``live``; each
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


def _window_fit(mn, mx, m, ulp, pad, gran, limit, w):
    """(start, fits): the unpadded start of the ``gran``-granular window of
    width ``w`` that routing gives floors [mn, mx] with tap reach ``m`` and
    slack ``ulp``, clamped to JAX's padded geometry (``limit`` cells), and
    whether the window holds them (ops/tiles.py route_tiles)."""
    start = ((mn - m - ulp + pad) // gran * gran).clamp(min=0).clamp(
        max=(limit - w) // gran * gran) - pad
    return start, (mn - m - ulp >= start) & (mx + 2 + ulp <= start + w - 1)


def plan_tiers(fits: torch.Tensor, caps) -> torch.Tensor:
    """The ladder tier of every tile, (n,) int64, -1: none.  ``fits`` (T, n)
    bool: tier t's window holds tile i and no base tier does.  Three ordered
    passes: in pass p a tile not yet taken tries the p-th tier that fits it,
    and is taken if its rank among the tiles trying that tier (in index
    order, after the tier's count so far) is under ``caps[t]``."""
    T, n = fits.shape
    nth = torch.cumsum(fits.to(torch.int64), dim=0)    # 1-based, per tile
    caps = torch.tensor(list(caps), dtype=torch.int64,
                        device=fits.device)[:, None]
    tier = torch.full((n,), -1, dtype=torch.int64, device=fits.device)
    cnt = torch.zeros((T, 1), dtype=torch.int64, device=fits.device)
    for p in range(min(3, T)):
        tries = fits & (nth == p + 1) & (tier < 0)[None]
        rank = cnt + torch.cumsum(tries.to(torch.int64), dim=1) - 1
        take = tries & (rank < caps)
        tier = torch.where(take.any(dim=0), take.to(torch.int64).argmax(dim=0),
                           tier)
        cnt = cnt + take.sum(dim=1, keepdim=True)
    return tier


def tier_window_gather_plain(coeffs, folds, out, plan, fits, flags, overflow,
                             *, f0, nf, order, wy, ladder, sub):
    """The spline tiers of a gather group, routed and gathered — the plain
    version of ``cuda_window.tier_window_gather``, in the kernels'
    formulation.

    Every (8, 128) home tile of ``folds`` (2, gy*8, gx*128) derives its
    window facts (the min/max of its parcels' unwrapped floors, per tile
    and per 32-column quarter, and of the plain floors), and from them
    whether tier A-sub's four (``wy``, 128) quarter windows, tier A's
    (``wy``, ``WX``) window and each ``ladder`` tier (wy, wx or None,
    capacity; windows already cut by ``tiles.capped_ladder``) hold it.  The
    tile takes A-sub if that fits (``sub``), else tier A if that fits, else
    the ladder tier that ``plan_tiers`` gives it, else tier A's window,
    clamped.  Its parcels are gathered against the window it took.

    Writes ``out`` (nf, gy*8, gx*128); ``plan`` (gy*gx, PLAN_W) and ``fits``
    (gy*gx,) int32 (see ``PLAN_W``); ``flags`` (gy*gx,) int32: 1 where a
    tile's taps left its window (A-sub: bit q for quarter q); and ORs into
    ``overflow``: bit 1 (with ``sub``) a tile that fits nothing, bit 2 a
    clamped tier-A or A-sub tile, bit 5+t a clamped tile of ladder tier t.
    """
    _, ny, nx = coeffs.shape
    _, ny_t, nx_t = folds.shape
    gy, gx = ny_t // TILE_R, nx_t // TILE_C
    n = gy * gx
    if len(ladder) > MAX_TIERS:
        raise ValueError(f"tier_window_gather: {len(ladder)} ladder tiers, "
                         f"at most {MAX_TIERS}")
    ypad, xpad = coeff_pad_dims(ny, nx)
    ylim, xlim = ny + 2 * ypad, nx + 2 * xpad - TILE_C
    m = 2 if order == 3 else 1
    yfold, xfold = folds[0], folds[1]

    # the tile's window facts
    ymn, ymx = (a.reshape(n) for a in _tile_minmax(yfold, ny))
    xmn, xmx = (a.reshape(n) for a in _tile_minmax(xfold, nx))
    yfmn, yfmx = (a.reshape(n) for a in _fold_floor_mm(yfold))
    xfmn, xfmx = (a.reshape(n) for a in _fold_floor_mm(xfold))
    ulp = 1 + ((yfmn <= 1) | (yfmx >= ny - 3) | (xfmn <= 1)
               | (xfmx >= nx - 3)).to(torch.int64)
    xq = xfold.reshape(gy, TILE_R, gx, N_SUB, SUB_W)
    f2 = _floor_int(xq) + nx * unwrap_k(xq, xq[:, :1, :, :, :1], nx)
    x2mn = f2.amin(dim=(1, 4)).reshape(n, N_SUB)
    x2mx = f2.amax(dim=(1, 4)).reshape(n, N_SUB)

    # what fits
    y0a, oky = _window_fit(ymn, ymx, m, ulp, ypad, 8, ylim, wy)
    x0a, okx = _window_fit(xmn, xmx, m, ulp, xpad, X_GRAN, xlim, WX)
    fit_a = oky & okx
    x0s, okq = _window_fit(x2mn, x2mx, m, ulp[:, None], xpad, X_GRAN, xlim,
                           TILE_C)
    fit_s = oky & okq.all(dim=1) if sub else torch.zeros_like(fit_a)
    lad = []
    for wy_, wx_, _ in ladder:
        y0, ok = _window_fit(ymn, ymx, m, ulp, ypad, 8, ylim, wy_)
        x0 = torch.zeros_like(y0)
        if wx_ is not None:
            x0, okx = _window_fit(xmn, xmx, m, ulp, xpad, X_GRAN, xlim, wx_)
            ok = ok & okx
        lad.append((ok, y0, x0))
    word = (fit_a.to(torch.int64) << FIT_A) | (fit_s.to(torch.int64) << FIT_S)
    for t, (ok, _, _) in enumerate(lad):
        word = word | (ok.to(torch.int64) << t)

    # the choice
    tier = torch.where(fit_s, -2, -1)
    rows = [y0a, *torch.where(fit_s[:, None], x0s, torch.stack(
        [x0a] + [torch.zeros_like(x0a)] * (N_SUB - 1), dim=1)).unbind(1),
        torch.full_like(y0a, wy), torch.where(fit_s, TILE_C, WX)]
    if lad:
        base = fit_a | fit_s
        took = plan_tiers(torch.stack([ok for ok, _, _ in lad]) & ~base[None],
                          [cap for _, _, cap in ladder])
        tier = torch.where(took >= 0, took, tier)
        for t, ((wy_, wx_, _), (_, y0, x0)) in enumerate(zip(ladder, lad)):
            mine = took == t
            for k, v in enumerate((y0, x0, 0, 0, 0, wy_, wx_ or 0)):
                rows[k] = torch.where(mine, v, rows[k])
    uncovered = (tier == -1) & ~fit_a
    plan.copy_(torch.stack([tier, *rows], dim=1).to(torch.int32))
    fits.copy_(word.to(torch.int32))

    # the gather: every tile as four quarters against its window (a tile
    # that is not in tier A-sub gives its quarters one window and anchor)
    is_sub = (tier == -2)[:, None, None, None]
    shape = (n, N_SUB, 1, 1)
    ft = torch.stack([_tile_major(folds[i:i + 1], gy, gx)[:, 0]
                      for i in range(2)])                     # (2, n, 8, 128)
    yq = ft[0].reshape(n, TILE_R, N_SUB, SUB_W).permute(0, 2, 1, 3)
    xq = ft[1].reshape(n, TILE_R, N_SUB, SUB_W).permute(0, 2, 1, 3)
    ya = ft[0][:, None, :1, :1]
    xa = torch.where(is_sub, xq[..., :1, :1], ft[1][:, None, :1, :1])
    y0 = rows[0].reshape(n, 1, 1, 1)
    x0 = torch.where(is_sub, torch.stack(rows[1:5], dim=1).reshape(shape),
                     rows[1].reshape(n, 1, 1, 1))
    wy_t, wx_t = rows[5].reshape(n, 1, 1, 1), rows[6].reshape(n, 1, 1, 1)
    full = wx_t == 0
    vals, bad = _window_values(coeffs, f0, nf, yq, xq, ya, xa, y0, x0, wy_t,
                               wx_t.clamp(min=1), order)  # (nf, n, 4, 8, 32)
    if any(wx_ is None for _, wx_, _ in ladder):
        vals_f, bad_f = _window_values(coeffs, f0, nf, yq, xq, ya, xa, y0,
                                       None, wy_t, None, order)
        vals = torch.where(full[None], vals_f, vals)
        bad = torch.where(full, bad_f, bad)
    vals = vals.permute(1, 0, 3, 2, 4).reshape(gy, gx, nf, TILE_R, TILE_C)
    out.copy_(vals.permute(2, 0, 3, 1, 4).reshape(out.shape))
    badq = bad.any(dim=3).any(dim=2)                          # (n, 4)
    bits = (badq.to(torch.int64)
            << torch.arange(N_SUB, device=badq.device)).sum(dim=1)
    flag = torch.where(tier == -2, bits, badq.any(dim=1).to(torch.int64))
    flags.copy_(flag.to(torch.int32))
    word = uncovered.any().to(torch.int32) << 1 if sub else 0
    for t in range(-1, len(lad)):
        mine = tier == t if t >= 0 else tier < 0
        word = word | (((flag > 0) & mine).any().to(torch.int32)
                       << (5 + t if t >= 0 else 2))
    overflow |= word


def pole_ladder_gather_plain(raw, pack, out, overflow, *, f0, nf, ladder,
                             bit, levels=None):
    """The pole ladder's plain version: order-1 ``mode='constant'``
    bilinear on the raw stack for every point of the sorted (8, 128)-point
    slots of ``pack`` (S*1024, 4) (``pole.pole_pack``), each slot against
    the y window of the level that serves it (``pole.pole_levels``: the
    first of the ``ladder`` windows that holds the slot's rows, the last if
    none does).  Writes ``out`` (nf, S*8, 128); a masked point of a level
    >= 2 slot whose rows leave the window clamps and ORs ``bit`` into
    ``overflow``.  ``levels`` (S,) int32, when given, receives each slot's
    level (0..2)."""
    _, ny, nx = raw.shape
    slot = TILE_R * TILE_C
    pr = P.pole_levels(P.pole_keys(pack, ny), ny=ny, ladder=ladder)
    lvl = pr.level[:, None]
    y0w, wy = pr.ys[2].long()[:, None], pr.wy[2]
    for k in (1, 0):
        y0w = torch.where(lvl == k, pr.ys[k].long()[:, None], y0w)
        wy = torch.where(lvl == k, pr.wy[k], wy)
    yc, xc, vm, mk = pack.reshape(-1, slot, 4).unbind(-1)
    yi = _to_index(torch.floor(yc)).clamp(0, ny - 2)
    oy = yi - y0w
    bad = ((oy < 0) | (oy > wy - 2)) & (mk > 0)
    oy = torch.minimum(oy.clamp(min=0), wy - 2)
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
    out.copy_(torch.where(vm[None] > 0, val, torch.zeros(
        (), dtype=val.dtype, device=val.device)).reshape(out.shape))
    overflow |= (bad & (lvl > 0)).any().to(torch.int32) << bit
    if levels is not None:
        levels.copy_(pr.level)


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
        return {"tier_window_gather": tier_window_gather_plain,
                "pole_ladder_gather": pole_ladder_gather_plain}
    if kernel == "cuda":
        from . import cuda_window as C
        return {"tier_window_gather": C.tier_window_gather,
                "pole_ladder_gather": C.pole_ladder_gather}
    raise ValueError(f"kernel={kernel!r}: expected 'cuda' or 'torch'")


def spline_launches(rt, coeffs, *, f0, nf, order, wy) -> list[Launch]:
    """The spline tiers as JAX launches them, for routing ``rt``
    (``route_tiles``), in order: tier A (``tile_window_gather_plain``,
    dense, bit 2), tier A-sub (``sub_window_gather_plain``, bit 2), then
    one list launch per ladder tier t (bit 5+t).  Each writes its tiles
    into an (nf, gy*8, gx*128) output.  The reference that
    ``tier_window_gather_plain`` is tested against."""
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


def tier_launch(coeffs, px, py, *, f0, nf, order, wy, retry_tiles=256,
                ladder=None, home_rows=None, **bounds):
    """The spline tiers' launch for the (ny, nx) parcel grid at
    ``px``/``py``, or a full-width latitude block of it whose rows have
    global home rows ``home_rows``, and the folds (2, rows_t, nx_t) it
    gathers at (``tiles.tile_folds``).  ``run(fn, out, plan, fits, flags,
    overflow)`` routes and gathers every tile into the (nf, rows_t, nx_t)
    output.  ``retry_tiles=0`` turns off tier A-sub and the ladder."""
    _, ny, nx = coeffs.shape
    folds = tile_folds(px, py, ny=ny, nx=nx, order=order, wy=wy,
                       home_rows=home_rows, **bounds)
    lad = tuple(capped_ladder(ny, nx, ladder)) if retry_tiles > 0 else ()
    n_tiles = folds.shape[1] // TILE_R * (folds.shape[2] // TILE_C)
    return Launch("tier_window_gather", "", n_tiles,
                  lambda fn, o, plan, fits, f, v: fn(
                      coeffs, folds, o, plan, fits, f, v, f0=f0, nf=nf,
                      order=order, wy=wy, ladder=lad,
                      sub=retry_tiles > 0)), folds


def pole_launch(raw, pack, *, f0, nf, ladder) -> Launch:
    """The pole ladder's one launch for the packed sorted slots ``pack``
    (``pole.pole_pack``): it writes an (nf, S*8, 128) output and ORs bit 4;
    its ``flags`` (S,), when given, receive the slots' levels."""
    return Launch("pole_ladder_gather", "", pack.shape[0] // (TILE_R * TILE_C),
                  lambda fn, o, f, v: fn(raw, pack, o, v, f0=f0, nf=nf,
                                         ladder=ladder, bit=4, levels=f))


def _pole_eval(fns, raw, pxf, pyf, mask, *, f0, nf, bounds, ladder):
    """Values (nf, 2, Mpad) of sorted pole lists, in the lists' order, and
    the overflow word (0-dim int32): bit 4, the clamped residue.  Bit 3, a
    level-1 clamp that no later level covered, cannot be raised: the last
    level takes every slot left, as in JAX."""
    _, ny, nx = raw.shape
    pack = P.pole_pack(pxf, pyf, mask, ny=ny, nx=nx, **bounds)
    ln = pole_launch(raw, pack, f0=f0, nf=nf, ladder=tuple(ladder))
    vals = torch.empty((nf, ln.n_flags * TILE_R, TILE_C), dtype=raw.dtype,
                       device=pxf.device)
    overflow = torch.zeros((1,), dtype=torch.int32, device=pxf.device)
    ln.run(fns[ln.kernel], vals, None, overflow)
    return vals.reshape(nf, 2, -1), overflow[0]


def block_pole_candidates(home_rows, *, order: int, ny: int):
    """The block rows that stand for the 2*order pole-home rows ``exp2``
    (rows 0..order-1, then ny-order..ny-1) in a latitude block with global
    home rows ``home_rows`` (pallas_interp.py:2389-2402):
    ``clip(exp2 - home_rows[0], 0, rows-1)``, (2*order,) int64, and whether
    each one's home row is the one it stands for, (2*order,) bool."""
    exp_s = list(range(max(ny - order, 0), ny))
    exp_s += exp_s[-1:] * (order - len(exp_s))
    hr = home_rows.reshape(-1).long()
    exp2 = device_ints(tuple(range(order)) + tuple(exp_s),
                       hr.device).long()
    idx = (exp2 - hr[0]).clamp(0, hr.shape[0] - 1)
    return idx, hr.index_select(0, idx) == exp2


def _block_pole_pass(fns, raw, out, px, py, home_rows, *, order, pole_kw):
    """The in-gather pole pass of a latitude block (pallas_interp.py:
    2379-2433): the candidate rows (``block_pole_candidates``) are
    evaluated as the pole-home rows, a candidate whose home row differs
    raising no flag, and their values are written, in candidate order, into
    the rows whose home row is a pole-home row.  Returns the pole pass's
    overflow word."""
    _, ny, nx = raw.shape
    rows = px.shape[0]
    idx, mask = block_pole_candidates(home_rows, order=order, ny=ny)
    rx, ry = px.index_select(0, idx), py.index_select(0, idx)
    geom = dict(order=order, nx=nx)
    perm, inv = P.pole_sort_state(rx, ry, order=order, ny=ny, nx=nx,
                                  **pole_kw["bounds"])
    mk = mask.to(rx.dtype)[:, None].expand(2 * order, nx)
    vals, flag = _pole_eval(fns, raw, P.pole_apply_perm(rx, perm, **geom),
                            P.pole_apply_perm(ry, perm, **geom),
                            P.pole_apply_perm(mk, perm, **geom), **pole_kw)
    vals = P.pole_unsort_rows(vals, inv, **geom)       # (nf, 2*order, nx)
    body = out[:, :rows, :nx]
    pole_vals = body.clone()
    for k in range(2 * order):
        pole_vals.index_copy_(1, idx[k:k + 1], vals[:, k:k + 1])
    hr = home_rows.reshape(-1)
    is_pole = ((hr < order) | (hr >= ny - order))[None, :, None]
    body.copy_(torch.where(is_pole, pole_vals, body))
    return flag


def windowed_interp_multi(raw, coeffs, px, py, *, x_min, x_max, y_min, y_max,
                          order: int = 3, wy: int = 32,
                          retry_tiles: int = 256, f0: int = 0, nf=None,
                          ladder=None, pole_ladder=P.POLE_LADDER,
                          skip_pole: bool = False, pole_block: bool = False,
                          pole_presorted: bool = False, home_rows=None,
                          engine: str = "blockspec", kernel: str = "torch"):
    """Fields ``[f0, f0 + nf)`` of the resident stacks at parcel positions,
    through the window tiers (``pallas_interp_multi`` with
    ``engine="blockspec"`` or ``"dma"``).

    ``raw``/``coeffs``: (..., ny, nx) raw and prefiltered stacks whose
    leading axes flatten to the field index.  ``px``/``py``: (ny, nx)
    positions of the whole grid, or (rows, nx) positions of a latitude
    block whose rows have the global home rows ``home_rows`` ((rows,)
    integer tensor; reflected pad rows carry the row they reflect).
    Routing is position-only; the home rows place the pole-home rows.
    ``kernel``: ``"cuda"`` (``tier_window_gather`` and the pole ladder) or
    ``"torch"`` (their plain versions).  ``wy``: tier A's window height.
    ``retry_tiles=0`` turns off tier A-sub and the ladder (unfit tiles
    clamp and flag).  ``ladder``: (wy, wx or None, capacity) escalation
    tiers; by default the engine's: ``tiles.DEFAULT_LADDER`` for
    ``"blockspec"``, ``tiles.dma_ladder`` of the block's tile count for
    ``"dma"``.  ``pole_ladder``: the pole path's three window heights.

    ``skip_pole``: the pole-home rows keep spline values computed at the
    substituted positions (the caller evaluates them separately).
    ``pole_block``: ``px``/``py`` are the (2*order, nx) pole-home rows
    (``pole_presorted``: (2, Mpad) point lists already in sorted order),
    evaluated by the pole ladder alone; returns the values (nf, 2*order,
    nx) (presorted: (nf, 2, Mpad) in the lists' order).

    Returns ``(out (nf, rows, nx), overflow)`` with JAX's overflow bitmask
    as an int32 0-dim tensor: bit 1 a tile left uncovered, bit 2 a clamped
    tier-A or A-sub tile, bit 3 an uncovered pole level-1 clamp (never
    raised: the ladder's last level takes every slot left), bit 4 the pole
    residue, bit 5+t a clamped tile of ladder tier t.
    """
    if engine not in ("blockspec", "dma"):
        raise ValueError(f"engine={engine!r}: the windowed gather serves "
                         f"'blockspec' and 'dma'")
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

    rows = px.shape[0]
    if ladder is None and engine == "dma":
        ladder = dma_ladder(-(-rows // TILE_R) * -(-nx // TILE_C))
    ln, folds = tier_launch(coeffs, px, py, f0=f0, nf=nf, order=order, wy=wy,
                            retry_tiles=retry_tiles, ladder=ladder,
                            home_rows=home_rows, **bounds)
    n_tiles = ln.n_flags
    ints = dict(dtype=torch.int32, device=px.device)
    out = torch.empty((nf,) + tuple(folds.shape[1:]), dtype=raw.dtype,
                      device=px.device)
    overflow = torch.zeros((1,), **ints)
    ln.run(fns[ln.kernel], out, torch.empty((n_tiles, PLAN_W), **ints),
           torch.empty((n_tiles,), **ints), torch.empty((n_tiles,), **ints),
           overflow)

    if order > 0 and not skip_pole and home_rows is not None:
        overflow |= _block_pole_pass(fns, raw, out, px, py, home_rows,
                                     order=order, pole_kw=pole_kw)
    elif order > 0 and not skip_pole:
        vals, pflag = windowed_interp_multi(
            raw, coeffs, P.pole_rows(px, order), P.pole_rows(py, order),
            order=order, f0=f0, nf=nf, pole_ladder=pole_ladder,
            pole_block=True, kernel=kernel, **bounds)
        out[:, :order, :nx] = vals[:, :order]
        out[:, ny - order:ny, :nx] = vals[:, order:]
        overflow |= pflag
    return out[:, :rows, :nx], overflow[0]
