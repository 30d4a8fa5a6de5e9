"""K2 ``tile_window_gather``, K3 ``sub_window_gather`` and K4
``pole_window_gather``: the hand-written CUDA kernels of the ``blockspec``
route (``csrc/window_gather.cu``).

Each wrapper takes the arguments of its plain version in
``ops/window_interp.py``.  Tensors on the CPU take the plain version; CUDA
tensors launch the kernel or raise — there is no fallback.  The kernels
read their slot counts on the device, so a list-mode launch needs no host
synchronisation.  ``LAUNCHES`` counts kernel launches by kernel and mode.

A window of at most ``STAGE_BYTES`` is staged into shared memory (tier A
and A-sub in float32; see ``staged``); wider windows, every
full-longitude tier and the pole windows read the stack through L2.
"""
from __future__ import annotations

import torch

from . import window_interp as W

__all__ = ["LAUNCHES", "STAGE_BYTES", "pole_window_gather",
           "reset_launches", "staged", "sub_window_gather",
           "tile_window_gather"]

LAUNCHES = {"tile_window_gather.dense": 0, "tile_window_gather.list": 0,
            "sub_window_gather": 0, "pole_window_gather.dense": 0,
            "pole_window_gather.list": 0}
STAGE_BYTES = 128 * 1024      # the kernels opt in to this much shared memory
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def staged(nf: int, wy: int, wx: int | None, dtype: torch.dtype) -> bool:
    """Whether a (nf, wy, wx) window is staged in shared memory."""
    size = torch.finfo(dtype).bits // 8
    return wx is not None and nf * wy * wx * size <= STAGE_BYTES


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors if t is not None)


def _check(name, floats, ints, device):
    """Raise unless every tensor is contiguous on ``device``, ``floats``
    share one float dtype of the kernels and ``ints`` are int32."""
    for t in floats + ints:
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name}: tensors must all be on {device}, got "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    dtype = floats[0].dtype
    if dtype not in _SUFFIX or any(t.dtype != dtype for t in floats):
        raise TypeError(f"{name}: float tensors must share float32 or "
                        f"float64, got {[t.dtype for t in floats]}")
    if any(t is not None and t.dtype != torch.int32 for t in ints):
        raise TypeError(f"{name}: index tensors must be int32")
    return dtype


def _ptr(t):
    return None if t is None else t.data_ptr()


def _entry(name, dtype):
    from ._build import load_library
    return getattr(load_library(), f"{name}_{_SUFFIX[dtype]}")


def _launched(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def tile_window_gather(coeffs, folds, out, flags, overflow, y0map, x0map, *,
                       f0, nf, order, wy, wx, bit, live=None, sel=None,
                       count=None):
    """K2 (see ``window_interp.tile_window_gather_plain``)."""
    if _on_cpu(coeffs, folds, out):
        return W.tile_window_gather_plain(
            coeffs, folds, out, flags, overflow, y0map, x0map, f0=f0, nf=nf,
            order=order, wy=wy, wx=wx, bit=bit, live=live, sel=sel,
            count=count)
    dense = sel is None
    name = f"tile_window_gather.{'dense' if dense else 'list'}"
    dtype = _check(name, [coeffs, folds, out],
                   [flags, overflow, y0map, x0map, live, sel, count],
                   folds.device)
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
    rc = _entry("tile_window_gather", dtype)(
        _ptr(coeffs), _ptr(folds), _ptr(out), _ptr(flags), _ptr(overflow),
        _ptr(y0map), _ptr(x0map), _ptr(live), _ptr(sel), _ptr(count),
        n_slots, ny, nx, ny_t, nx_t, order, nf, f0, wy, wx or 0, bit, stage,
        _stream(folds.device))
    _launched(name, rc)


def sub_window_gather(coeffs, folds, out, flags, overflow, y0map, x0q, live,
                      *, f0, nf, order, wy, bit):
    """K3 (see ``window_interp.sub_window_gather_plain``)."""
    if _on_cpu(coeffs, folds, out):
        return W.sub_window_gather_plain(
            coeffs, folds, out, flags, overflow, y0map, x0q, live, f0=f0,
            nf=nf, order=order, wy=wy, bit=bit)
    name = "sub_window_gather"
    dtype = _check(name, [coeffs, folds, out],
                   [flags, overflow, y0map, x0q, live], folds.device)
    nfields, ny, nx = coeffs.shape
    _, ny_t, nx_t = folds.shape
    if order not in (1, 3) or nf not in (2, 4) or f0 + nf > nfields:
        raise ValueError(f"{name}: order {order}, fields [{f0}, {f0 + nf}) "
                         f"of {nfields}")
    stage = nf * wy * 128 * out.element_size() \
        if staged(nf, wy, 128, dtype) else 0
    rc = _entry(name, dtype)(
        _ptr(coeffs), _ptr(folds), _ptr(out), _ptr(flags), _ptr(overflow),
        _ptr(y0map), _ptr(x0q), _ptr(live), ny_t // 8 * (nx_t // 128), ny,
        nx, ny_t, nx_t, order, nf, f0, wy, bit, stage, _stream(folds.device))
    _launched(name, rc)


def pole_window_gather(raw, pack, ys, out, flags, overflow, *, f0, nf, wy,
                       bit, sel=None, count=None):
    """K4 (see ``window_interp.pole_window_gather_plain``)."""
    if _on_cpu(raw, pack, out):
        return W.pole_window_gather_plain(
            raw, pack, ys, out, flags, overflow, f0=f0, nf=nf, wy=wy, bit=bit,
            sel=sel, count=count)
    name = f"pole_window_gather.{'dense' if sel is None else 'list'}"
    dtype = _check(name, [raw, pack, out], [ys, flags, overflow, sel, count],
                   pack.device)
    nfields, ny, nx = raw.shape
    n_slots = pack.shape[1] // 8
    if nf not in (2, 4) or f0 + nf > nfields or pack.shape[0] != 4:
        raise ValueError(f"{name}: fields [{f0}, {f0 + nf}) of {nfields}, "
                         f"pack {tuple(pack.shape)}")
    rc = _entry("pole_window_gather", dtype)(
        _ptr(raw), _ptr(pack), _ptr(ys), _ptr(out), _ptr(flags),
        _ptr(overflow), _ptr(sel), _ptr(count), n_slots, ny, nx, nf, f0, wy,
        bit, _stream(pack.device))
    _launched(name, rc)
