"""Device placement shared by the port's entry points.

Every entry point takes ``device=``.  ``None`` means the device of the
tensors the caller passed, and with no tensor the CUDA card: the port runs on
the card unless the caller asks for the CPU (``device="cpu"``, or CPU
tensors).  A machine without a card raises rather than falling back to the
CPU, and a tensor that lies on another kind of device than the one asked for
raises too: nothing moves between the host and the card unless the caller
asked for it.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "on_device"]


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
