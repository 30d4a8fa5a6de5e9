"""Device meshes for the latitude-block and batch pipelines — PyTorch.

Counterpart of ``lagrangiancoherence_tpu/parallel/mesh.py``.  JAX's
``shard_map`` runs one program over a ``jax.sharding.Mesh`` from a single
controller; the port writes that program out as a loop over blocks in one
process, so its ``Mesh`` is only what the pipelines read: an array of
``torch.device``\\ s, its axis names (``"y"``, ``"x"``, or ``"t"``) and
``shape``, a name → size mapping (JAX ``runners.py:66, 118``).

A device may appear more than once.  Its blocks then run in sequence on it:
the in-process counterpart of the JAX tests' 8 virtual CPU devices
(``tests/conftest.py:7-12``), and how one card runs N blocks.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..devices import resolve_device

__all__ = ["Mesh", "parcel_mesh", "batch_mesh"]


@dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: an object array of ``torch.device``, one axis per name
    in ``axis_names``."""
    devices: np.ndarray
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"devices of shape {self.devices.shape} for "
                             f"axes {self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size


def _devices(n_devices, devices) -> np.ndarray:
    """``devices`` as a flat object array; by default the visible CUDA
    cards (the first ``n_devices``), which must exist."""
    if devices is None:
        resolve_device("cuda")          # raises without a card
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            devices = devices[:n_devices]
    out = np.empty(len(devices), dtype=object)
    out[:] = [torch.device(d) for d in devices]
    return out


def parcel_mesh(n_devices: int | None = None, devices=None,
                x_parallel: int = 1) -> Mesh:
    """1-D (or 2-D) mesh over the parcel grid: ``("y",)`` or ``("y", "x")``.

    ``x_parallel > 1`` splits the devices between latitude and longitude
    blocks; the default splits latitude only (the stencil halo is in
    latitude and longitude is cyclic).
    """
    devices = _devices(n_devices, devices)
    n = devices.size
    if x_parallel > 1:
        if n % x_parallel:
            raise ValueError(f"{n} devices do not split into x_parallel="
                             f"{x_parallel}")
        return Mesh(devices.reshape(n // x_parallel, x_parallel), ("y", "x"))
    return Mesh(devices, ("y",))


def batch_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over a batch/time axis, ``("t",)``: the animation
    workload's layout (SURVEY.md §2, 'Batch/time DP')."""
    return Mesh(_devices(n_devices, devices), ("t",))
