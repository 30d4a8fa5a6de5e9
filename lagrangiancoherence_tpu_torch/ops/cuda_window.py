"""K2 ``tile_window_gather``, K3 ``sub_window_gather`` and the pole ladder
``pole_ladder_gather``: the hand-written CUDA kernels of the ``blockspec``
route (``csrc/window_gather.cu``).

Each wrapper takes the arguments of its plain version in
``ops/window_interp.py``.  Tensors on the CPU take the plain version; CUDA
tensors launch the kernel or raise — there is no fallback.  The kernels
read their slot counts on the device, and the pole ladder picks each slot's
level there, so no launch needs a host synchronisation.  ``LAUNCHES``
counts kernel launches by kernel and mode.

The launch path is kept short, because most of these kernels run for a few
microseconds: the entry point and the stream come from ``ops/_launch.py``,
and device, dtype and contiguity are checked in one pass over the tensors,
which builds a message only when it fails.  The tensors that every spline
launch of a gather group shares (the stack, the folds, the output and the
overflow word) can be checked once for the group with ``shared_tensors``
and handed to the group's launches as ``shared=``; a launch trusts the
check only for the very tensors it was made on.

A window of at most ``STAGE_BYTES`` is staged into shared memory (tier A
and A-sub in float32; see ``staged``); wider windows, every
full-longitude tier and the pole windows read the stack through L2.
"""
from __future__ import annotations

import torch

from . import pole as P
from . import window_interp as W
from ._launch import SUFFIX, entry, stream

__all__ = ["LAUNCHES", "STAGE_BYTES", "empty_launch", "pole_ladder_gather",
           "reset_launches", "shared_tensors", "staged", "sub_window_gather",
           "tile_window_gather"]

LAUNCHES = {"tile_window_gather.dense": 0, "tile_window_gather.list": 0,
            "sub_window_gather": 0, "pole_ladder_gather": 0,
            "empty_launch": 0}
STAGE_BYTES = 128 * 1024      # the kernels opt in to this much shared memory


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def staged(nf: int, wy: int, wx: int | None, dtype: torch.dtype) -> bool:
    """Whether a (nf, wy, wx) window is staged in shared memory."""
    size = torch.finfo(dtype).bits // 8
    return wx is not None and nf * wy * wx * size <= STAGE_BYTES


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


def shared_tensors(coeffs, folds, out, overflow):
    """Check once the tensors that every spline launch of a gather group
    shares; the result goes to the group's launches as ``shared=``."""
    return (coeffs, folds, out, overflow,
            *_check("shared_tensors", (coeffs, folds, out), (overflow,)))


def _check_spline(name, coeffs, folds, out, overflow, ints, shared):
    """``_check`` of a spline launch; ``shared`` (``shared_tensors``)
    vouches for the four tensors it was made on."""
    if (shared is not None and shared[0] is coeffs and shared[1] is folds
            and shared[2] is out and shared[3] is overflow
            and _fits(ints, torch.int32, shared[5])):
        return shared[4], shared[5]
    return _check(name, (coeffs, folds, out), (overflow, *ints))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launched(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def tile_window_gather(coeffs, folds, out, flags, overflow, y0map, x0map, *,
                       f0, nf, order, wy, wx, bit, live=None, sel=None,
                       count=None, shared=None):
    """K2 (see ``window_interp.tile_window_gather_plain``)."""
    if not (coeffs.is_cuda or folds.is_cuda or out.is_cuda):
        return W.tile_window_gather_plain(
            coeffs, folds, out, flags, overflow, y0map, x0map, f0=f0, nf=nf,
            order=order, wy=wy, wx=wx, bit=bit, live=live, sel=sel,
            count=count)
    dense = sel is None
    name = "tile_window_gather.dense" if dense else "tile_window_gather.list"
    dtype, index = _check_spline(name, coeffs, folds, out, overflow,
                                 (flags, y0map, x0map, live, sel, count),
                                 shared)
    nfields, ny, nx = coeffs.shape
    _, ny_t, nx_t = folds.shape
    if order not in (1, 3) or nf not in (2, 4) or f0 + nf > nfields:
        raise ValueError(f"{name}: order {order}, fields [{f0}, {f0 + nf}) "
                         f"of {nfields}")
    if out.shape != (nf, ny_t, nx_t) or (dense and live is None):
        raise ValueError(f"{name}: out {tuple(out.shape)}, live {live}")
    n_slots = ny_t // 8 * (nx_t // 128) if dense else sel.shape[0]
    stage = (nf * wy * wx * out.element_size()
             if staged(nf, wy, wx, dtype) else 0)
    rc = entry("tile_window_gather", dtype)(
        coeffs.data_ptr(), folds.data_ptr(), out.data_ptr(), flags.data_ptr(),
        _ptr(overflow), y0map.data_ptr(), _ptr(x0map), _ptr(live), _ptr(sel),
        _ptr(count), n_slots, ny, nx, ny_t, nx_t, order, nf, f0, wy, wx or 0,
        bit, stage, stream(index))
    _launched(name, rc)


def sub_window_gather(coeffs, folds, out, flags, overflow, y0map, x0q, live,
                      *, f0, nf, order, wy, bit, shared=None):
    """K3 (see ``window_interp.sub_window_gather_plain``)."""
    if not (coeffs.is_cuda or folds.is_cuda or out.is_cuda):
        return W.sub_window_gather_plain(
            coeffs, folds, out, flags, overflow, y0map, x0q, live, f0=f0,
            nf=nf, order=order, wy=wy, bit=bit)
    name = "sub_window_gather"
    dtype, index = _check_spline(name, coeffs, folds, out, overflow,
                                 (flags, y0map, x0q, live), shared)
    nfields, ny, nx = coeffs.shape
    _, ny_t, nx_t = folds.shape
    if order not in (1, 3) or nf not in (2, 4) or f0 + nf > nfields:
        raise ValueError(f"{name}: order {order}, fields [{f0}, {f0 + nf}) "
                         f"of {nfields}")
    stage = nf * wy * 128 * out.element_size() \
        if staged(nf, wy, 128, dtype) else 0
    rc = entry(name, dtype)(
        coeffs.data_ptr(), folds.data_ptr(), out.data_ptr(), flags.data_ptr(),
        _ptr(overflow), y0map.data_ptr(), x0q.data_ptr(), live.data_ptr(),
        ny_t // 8 * (nx_t // 128), ny, nx, ny_t, nx_t, order, nf, f0, wy, bit,
        stage, stream(index))
    _launched(name, rc)


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
