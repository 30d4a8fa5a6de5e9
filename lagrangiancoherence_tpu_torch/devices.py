"""Device placement shared by the port's entry points.

Every entry point takes ``device=``; ``None`` means
``torch.get_default_device()``, the counterpart of JAX's default device.
A CUDA device on a machine without one raises, and a tensor that lies on
another kind of device than the one asked for raises too: nothing moves
between the host and the card unless the caller asked for it.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "on_device"]


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` → the default device."""
    device = torch.get_default_device() if device is None \
        else torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device}: torch.cuda.is_available() "
                           "is False")
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
