"""Device placement shared by the port's entry points, and the one place
where a host record crosses to the device and comes back.

Every entry point takes ``device=``.  ``None`` means the device of the
tensors the caller passed, and with no tensor the CUDA card: the port runs on
the card unless the caller asks for the CPU (``device="cpu"``, or CPU
tensors).  A machine without a card raises rather than falling back to the
CPU, and a tensor that lies on another kind of device than the one asked for
raises too: nothing moves between the host and the card unless the caller
asked for it.

``upload`` takes a host record to the device once, in the order it is
stored, and puts it in ascending coordinates there when asked;
``download`` copies a tensor back.  ``TRANSFERS`` counts both ways for
every caller.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "on_device", "upload", "download", "TRANSFERS",
           "reset_transfers"]

# Copies of a record's data between the host and the device, counted as
# ``cuda_prefilter.LAUNCHES`` counts launches: "uploads" are record-sized
# copies to the device (``upload``), "downloads" arrays copied back to the
# host (``download``), "host_reorders" copies that reorder data on the host
# (a record not stored in the order its caller reads it; the facade's debug
# log's first level).
TRANSFERS = {"uploads": 0, "downloads": 0, "host_reorders": 0}


def reset_transfers() -> None:
    for k in TRANSFERS:
        TRANSFERS[k] = 0


def resolve_device(device=None, *args) -> torch.device:
    """``device`` as a ``torch.device``.

    ``None`` → the device of the first tensor among ``args`` (the entry
    point's data arguments; anything else in them is ignored), else
    ``torch.device("cuda")``.  A CUDA device raises ``RuntimeError`` on a
    machine without one.
    """
    if device is None:
        device = next((a.device for a in args if isinstance(a, torch.Tensor)),
                      "cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device}: torch.cuda.is_available() is "
                           "False; pass device='cpu' (or CPU tensors) to "
                           "compute on the CPU")
    return device


def on_device(x, device: torch.device, dtype: torch.dtype | None = None
              ) -> torch.Tensor:
    """``x`` as a tensor on ``device``.

    A host array is copied there; a floating one takes ``dtype``, by default
    ``torch.get_default_dtype()`` (as ``jnp.asarray`` follows JAX's x64
    switch).  A tensor keeps its dtype unless ``dtype`` is given, and must
    already lie on ``device``'s kind of device.
    """
    if isinstance(x, torch.Tensor):
        if x.device.type != device.type:
            raise ValueError(f"tensor on {x.device} given with device="
                             f"{device}; move it there first")
        return x if dtype is None else x.to(dtype)
    a = np.ascontiguousarray(x)
    if dtype is None and np.issubdtype(a.dtype, np.floating):
        dtype = torch.get_default_dtype()
    return torch.as_tensor(a, dtype=dtype, device=device)


def upload(x, device: torch.device, ascending: bool = False):
    """A host record on ``device`` in ``torch.get_default_dtype()``, by one
    copy of the order it is stored in.

    ``x``: a host array, or a ``Field``.  On the card the cast lands in
    page-locked staging, which the host allocator hands back for the next
    record of the same size, and goes up from there; elsewhere it is
    ``on_device``'s copy (none on the CPU where the dtype matches).

    ``ascending``: put the Field in ascending latitude and longitude.  The
    host sorts only their coordinates (``np.argsort``, stable, as
    ``Field.sortby``), and the device gathers along each dim that does not
    ascend already.  The call then returns ``(tensor, lats, lons)``, the
    coordinates sorted; without, the tensor.
    """
    a = x.data if hasattr(x, "dims") else np.asarray(x)
    TRANSFERS["uploads"] += 1
    TRANSFERS["host_reorders"] += not a.flags.c_contiguous
    dtype = torch.get_default_dtype()
    if device.type != "cuda":
        t = on_device(a, device, dtype)
    else:
        staged = torch.empty(a.shape, dtype=dtype, pin_memory=True)
        staged.copy_(torch.from_numpy(np.ascontiguousarray(a)))
        t = staged.to(device)
    if not ascending:
        return t
    coords = []
    for dim in ("latitude", "longitude"):
        c = x.coords[dim]
        order = np.argsort(c, kind="stable")
        if not np.array_equal(order, np.arange(c.shape[0])):
            t = torch.index_select(t, x.axis(dim),
                                   torch.as_tensor(order, device=device))
            c = c[order]
        coords.append(c)
    return (t, *coords)


def download(t: torch.Tensor) -> np.ndarray:
    """``t`` copied to the host as a numpy array."""
    TRANSFERS["downloads"] += 1
    return t.cpu().numpy()
