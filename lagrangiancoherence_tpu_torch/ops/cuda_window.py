"""``tier_window_gather`` (the spline window tiers) and the pole ladder
``pole_ladder_gather``: the hand-written CUDA kernels of the ``blockspec``
route (``csrc/window_gather.cu``).

Each wrapper takes the arguments of its plain version in
``ops/window_interp.py``.  Tensors on the CPU take the plain version; CUDA
tensors launch the kernel or raise — there is no fallback.  The kernels
choose on the device: every tile routes itself to its window tier and the
pole ladder picks each slot's level, so no launch needs a host
synchronisation and no torch op routes.  ``LAUNCHES`` counts kernel
launches by kernel.

The launch path is kept short, because most of these kernels run for a few
microseconds: the entry point and the stream come from ``ops/_launch.py``,
and device, dtype and contiguity are checked in one pass over the tensors,
which builds a message only when it fails.
"""
from __future__ import annotations

from functools import lru_cache

import torch

from . import pole as P
from . import window_interp as W
from ._launch import SUFFIX, entry, stream
from .tiles import TILE_C, TILE_R, WX, coeff_pad_dims, device_ints

__all__ = ["LAUNCHES", "MAX_TILES", "empty_launch", "pole_ladder_gather",
           "reset_launches", "tier_window_gather"]

LAUNCHES = {"tier_window_gather.route": 0, "tier_window_gather.gather": 0,
            "pole_ladder_gather": 0, "empty_launch": 0}
MAX_TILES = 12288     # the route kernel plans in 48 KB of shared memory


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _fits(tensors, dtype, index) -> bool:
    for t in tensors:
        if t is not None and (t.dtype is not dtype or t.get_device() != index
                              or not t.is_contiguous()):
            return False
    return True


def _check(name, floats, ints):
    """(dtype, device index) of a launch, raising unless every tensor is
    contiguous on the CUDA device of ``floats[0]``, ``floats`` share one
    float dtype of the kernels and ``ints`` are int32."""
    dtype, index = floats[0].dtype, floats[0].get_device()
    if (index >= 0 and dtype in SUFFIX and _fits(floats, dtype, index)
            and _fits(ints, torch.int32, index)):
        return dtype, index
    tensors = [t for t in (*floats, *ints) if t is not None]
    if index < 0 or any(t.get_device() != index for t in tensors):
        raise ValueError(f"{name}: tensors must all be on one CUDA device, "
                         f"got {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    if dtype not in SUFFIX or any(t.dtype != dtype for t in floats):
        raise TypeError(f"{name}: float tensors must share float32 or "
                        f"float64, got {[t.dtype for t in floats]}")
    raise TypeError(f"{name}: index tensors must be int32")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launched(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


@lru_cache(maxsize=64)
def _ladder_on(ladder: tuple, device: torch.device) -> torch.Tensor:
    """The ladder on the device: (wy, wx or 0, capacity) a tier."""
    return device_ints(tuple(v or 0 for spec in ladder for v in spec), device)


@lru_cache(maxsize=8)
def _ticket(index: int) -> torch.Tensor:
    """The route kernel's arrival counter on device ``index``: zero between
    launches (the last CTA to arrive resets it), so launches that share it
    must be ordered on one stream."""
    return torch.zeros((1,), dtype=torch.int32,
                       device=torch.device("cuda", index))


def tier_window_gather(coeffs, folds, out, plan, fits, flags, overflow, *,
                       f0, nf, order, wy, ladder, sub):
    """The spline tiers of a gather group in two launches (see
    ``window_interp.tier_window_gather_plain``): ``tier_route_kernel``
    routes every tile, ``tier_gather_kernel`` gathers it."""
    if not (coeffs.is_cuda or folds.is_cuda or out.is_cuda):
        return W.tier_window_gather_plain(
            coeffs, folds, out, plan, fits, flags, overflow, f0=f0, nf=nf,
            order=order, wy=wy, ladder=ladder, sub=sub)
    name = "tier_window_gather"
    dtype, index = _check(name, (coeffs, folds, out),
                          (plan, fits, flags, overflow))
    nfields, ny, nx = coeffs.shape
    _, ny_t, nx_t = folds.shape
    n_tiles = ny_t // TILE_R * (nx_t // TILE_C)
    ladder = tuple(tuple(spec) for spec in ladder)
    if (order not in (1, 3) or nf not in (2, 4) or f0 < 0
            or f0 + nf > nfields or len(ladder) > W.MAX_TIERS
            or n_tiles > MAX_TILES):
        raise ValueError(f"{name}: order {order}, fields [{f0}, {f0 + nf}) "
                         f"of {nfields}, {len(ladder)} ladder tiers (at most "
                         f"{W.MAX_TIERS}), {n_tiles} tiles (at most "
                         f"{MAX_TILES})")
    if (folds.shape[0] != 2 or ny_t % TILE_R or nx_t % TILE_C
            or out.shape != (nf, ny_t, nx_t)
            or plan.shape != (n_tiles, W.PLAN_W) or fits.numel() != n_tiles
            or flags.numel() != n_tiles or overflow.numel() != 1):
        raise ValueError(f"{name}: folds {tuple(folds.shape)}, out "
                         f"{tuple(out.shape)}, plan {tuple(plan.shape)}, "
                         f"fits, flags or overflow")
    ypad, xpad = coeff_pad_dims(ny, nx)
    scratch = torch.empty((n_tiles, 2), dtype=torch.int32, device=out.device)
    specs = _ladder_on(ladder, out.device) if ladder else None
    rc = entry(name, dtype)(
        coeffs.data_ptr(), folds.data_ptr(), out.data_ptr(), plan.data_ptr(),
        fits.data_ptr(), flags.data_ptr(), scratch.data_ptr(),
        overflow.data_ptr(), _ticket(index).data_ptr(), ny, nx, ny_t, nx_t,
        order, nf, f0, wy, WX, ypad, xpad, int(bool(sub)), len(ladder),
        _ptr(specs), stream(index))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES["tier_window_gather.route"] += 1
    LAUNCHES["tier_window_gather.gather"] += 1


def _ladder_launch(name, raw, pack, out, overflow, levels, f0, nf, ladder,
                   bit):
    """Check the pole ladder's arguments and launch entry point ``name``
    on them."""
    dtype, index = _check(name, (raw, pack, out), (overflow, levels))
    nfields, ny, nx = raw.shape
    n_slots = pack.shape[0] // 1024
    if (nf not in (2, 4) or f0 < 0 or f0 + nf > nfields or n_slots == 0
            or pack.shape != (n_slots * 1024, 4) or pack.data_ptr() % 16
            or ny < 2 or nx < 2 or not 0 <= bit < 31):
        raise ValueError(f"{name}: fields [{f0}, {f0 + nf}) of {nfields} "
                         f"({ny}, {nx}), pack {tuple(pack.shape)}, bit {bit}")
    if (out.numel() != nf * n_slots * 1024 or overflow.numel() != 1
            or (levels is not None and levels.numel() != n_slots)):
        raise ValueError(f"{name}: out {tuple(out.shape)} for {nf} fields "
                         f"of {n_slots} slots, or overflow or levels")
    ny_p, wys = P.ladder_windows(ny, tuple(ladder))
    if len(wys) != 3:
        raise ValueError(f"{name}: the ladder has three levels, got {ladder}")
    rc = entry(name, dtype)(
        raw.data_ptr(), pack.data_ptr(), out.data_ptr(), overflow.data_ptr(),
        _ptr(levels), n_slots, ny, nx, nf, f0, ny_p, wys[0], wys[1], wys[2],
        bit, stream(index))
    _launched(name, rc)


def pole_ladder_gather(raw, pack, out, overflow, *, f0, nf, ladder, bit,
                       levels=None):
    """The pole ladder in one launch (see
    ``window_interp.pole_ladder_gather_plain``)."""
    if not (raw.is_cuda or pack.is_cuda or out.is_cuda):
        return W.pole_ladder_gather_plain(raw, pack, out, overflow, f0=f0,
                                          nf=nf, ladder=ladder, bit=bit,
                                          levels=levels)
    _ladder_launch("pole_ladder_gather", raw, pack, out, overflow, levels,
                   f0, nf, ladder, bit)


def empty_launch(raw, pack, out, overflow, *, f0, nf, ladder, bit,
                 levels=None):
    """A kernel that returns at once, through ``pole_ladder_gather``'s
    checks and binding: what a launch on this path costs when the device
    has nothing to do."""
    _ladder_launch("empty_launch", raw, pack, out, overflow, levels, f0, nf,
                   ladder, bit)
