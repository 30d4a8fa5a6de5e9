"""Sorted-slot routing of the pole-home rows — torch ops on the device.

Counterpart of ``lagrangiancoherence_tpu/ops/pallas_interp.py``
``pole_flat_dims`` .. ``pole_unsort_rows`` (``:1462-1513``) and of the
routing inside ``_pole_eval_block`` (``:1116-1341``).  The ``order`` home
rows nearest each pole take the order-1 ``mode='constant'`` bilinear on the
raw fields.  Their points are flattened per side, sorted by the floor of
their clipped y index and cut into (8, 128)-point slots, so that each slot
spans a few consecutive field rows.  A three-level ladder of full-longitude
y windows (``POLE_LADDER`` rows) serves them:

* level 1 runs every slot with the shortest window;
* level 2 runs the compacted list of slots that did not fit level 1 but
  fit level 2;
* level 3 runs every slot still uncovered with the tallest window; its
  clamped slots raise overflow bit 4.  Bit 3 is a level-1 clamp that no
  later level covered.

Slot lists are compacted with a cumsum and a scatter, so nothing
synchronises with the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .interp import _to_index, scale_positions
from .tiles import POLE_PAD, TILE_C, TILE_R

__all__ = ["POLE_LADDER", "PoleRouting", "pole_apply_perm", "pole_flat_dims",
           "pole_levels", "pole_pack", "pole_rows", "pole_side_flat",
           "pole_sort_state", "pole_unsort_rows", "set_pole_rows"]

_SLOT = TILE_R * TILE_C
POLE_LADDER = (16, 160, 288)     # pallas_interp.py:113-122, rows


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pole_flat_dims(order: int, nx: int) -> tuple[int, int]:
    """(Ms, Mpad): real points per side, and that rounded up to whole
    (8, 128) slots."""
    ms = order * nx
    return ms, _cdiv(ms, _SLOT) * _SLOT


def pole_rows(p: torch.Tensor, order: int) -> torch.Tensor:
    """The (2*order, nx) pole-home rows of a (ny, nx) array, in JAX's
    ``exp2`` order: rows 0..order-1, then ny-order..ny-1."""
    return torch.cat([p[:order], p[p.shape[0] - order:]])


def set_pole_rows(p: torch.Tensor, rows: torch.Tensor,
                  order: int) -> torch.Tensor:
    """``p`` with its pole-home rows replaced by ``rows`` (a new tensor)."""
    ny = p.shape[0]
    return torch.cat([rows[:order], p[order:ny - order], rows[order:]])


def pole_side_flat(a: torch.Tensor, order: int, nx: int) -> torch.Tensor:
    """(..., 2*order, nx) home layout → (..., 2, Mpad), edge-padded: pad
    points repeat the side's last point."""
    ms, mpad = pole_flat_dims(order, nx)
    a2 = a.reshape(*a.shape[:-2], 2, ms)
    if mpad > ms:
        a2 = torch.cat([a2, a2[..., -1:].expand(*a2.shape[:-1], mpad - ms)],
                       dim=-1)
    return a2


def _sort_key(yi: torch.Tensor, ny: int) -> torch.Tensor:
    """Slot key of a point: floor of its clipped y index, clipped to
    [0, ny-2]; NaN gives 0, as XLA's cast does."""
    return torch.clamp(_to_index(torch.floor(torch.clamp(yi, 0.0, ny - 1.0))),
                       0, ny - 2)


def pole_sort_state(px_rows, py_rows, *, order, ny, nx, x_min, x_max, y_min,
                    y_max):
    """Once-per-step sort of the (2*order, nx) pole-home rows by slot key:
    returns ``(perm, inv)`` int64 (2, Mpad) (pallas_interp.py:1477-1498;
    the sort is stable, as ``jnp.argsort``)."""
    pxf = pole_side_flat(px_rows, order, nx)
    pyf = pole_side_flat(py_rows, order, nx)
    _, yi = scale_positions(pxf, pyf, x_min=x_min, x_max=x_max, y_min=y_min,
                            y_max=y_max, nx=nx, ny=ny)
    perm = torch.argsort(_sort_key(yi, ny), dim=1, stable=True)
    inv = torch.empty_like(perm).scatter_(
        1, perm, torch.arange(perm.shape[1], device=perm.device)
        .expand_as(perm).contiguous())
    return perm, inv


def pole_apply_perm(a_rows, perm, *, order, nx):
    """(2*order, nx) home layout → (2, Mpad) sorted flat."""
    return torch.gather(pole_side_flat(a_rows, order, nx), 1, perm)


def pole_unsort_rows(flat, inv, *, order, nx):
    """(..., 2, Mpad) sorted flat → (..., 2*order, nx) home layout."""
    ms, _ = pole_flat_dims(order, nx)
    idx = inv.expand(*flat.shape[:-2], *inv.shape)
    u = torch.gather(flat, flat.ndim - 1, idx)[..., :ms]
    return u.reshape(*flat.shape[:-2], 2 * order, nx)


def pole_pack(pxf, pyf, mask, *, ny, nx, x_min, x_max, y_min, y_max):
    """The packed per-point operand ``[yc, xc, vmask, mask]`` (4, S*8, 128)
    of (2, Mpad) sorted point lists, and each point's slot key (S, 1024):
    clipped direct float indices and the in-range mask, computed once here
    and never again in the kernels (pallas_interp.py:1140-1169)."""
    xi, yi = scale_positions(pxf, pyf, x_min=x_min, x_max=x_max, y_min=y_min,
                             y_max=y_max, nx=nx, ny=ny)
    yc = torch.clamp(yi, 0.0, ny - 1.0)
    xc = torch.clamp(xi, 0.0, nx - 1.0)
    vm = ((yi >= 0) & (yi <= ny - 1) & (xi >= 0) & (xi <= nx - 1)).to(
        pxf.dtype)
    s = pxf.shape[0] * pxf.shape[1] // _SLOT
    pack = torch.stack([yc, xc, vm, mask.to(pxf.dtype)]).reshape(
        4, s * TILE_R, TILE_C)
    return pack, _sort_key(yi, ny).reshape(s, _SLOT)


class PoleRouting(NamedTuple):
    ys: list           # per level: (S,) int32 window start rows
    wy: list           # per level: window rows
    want: list         # per level >= 2: (S,) bool slots to run
    fit1: torch.Tensor  # (S,) bool


def pole_levels(key: torch.Tensor, *, ny: int, ladder=POLE_LADDER
                ) -> PoleRouting:
    """Per-level window starts and fits of the sorted slots
    (pallas_interp.py:1137-1138, 1187-1194).  ``key``: (S, 1024) slot keys.
    Level 2 wants the slots level 1 did not fit but level 2 does; level 3
    wants every slot left (its ``want`` is completed by the caller as
    ``~(fit1 | want2)``)."""
    ny_p = _cdiv(ny, TILE_R) * TILE_R + POLE_PAD
    wys = [min(max(8, (int(w) // 8) * 8), (ny_p // 8) * 8) for w in ladder]
    kymn = torch.clamp(key.amin(dim=1) - 1, 0, ny - 2)
    kymx = torch.clamp(key.amax(dim=1) + 1, 0, ny - 2)
    kymn = torch.minimum(kymn, kymx)
    ys, fits = [], []
    for w in wys:
        y = torch.clamp((kymn // 8) * 8, 0, max(ny_p - w, 0))
        fits.append((kymn >= y) & (kymx + 1 <= y + w - 1))
        ys.append(y.to(torch.int32))
    want2 = (~fits[0]) & fits[1]
    want3 = ~(fits[0] | want2)
    return PoleRouting(ys=ys, wy=wys, want=[None, want2, want3],
                       fit1=fits[0])


def compact(want: torch.Tensor):
    """(S,) bool → (sel (S,) int32 with the wanted slots first, in order;
    count 0-dim int32), by cumsum and scatter."""
    s = want.shape[0]
    w = want.to(torch.int32)
    rank = torch.cumsum(w, dim=0) - 1
    dst = torch.where(want, rank, s).long()
    sel = torch.zeros((s + 1,), dtype=torch.int32, device=want.device)
    sel.scatter_(0, dst, torch.arange(s, dtype=torch.int32,
                                      device=want.device))
    return sel[:s].contiguous(), w.sum(dtype=torch.int32)
