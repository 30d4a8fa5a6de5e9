"""Carry state from the JAX package (or any numpy source) into the port.

This system has no learned weights: its state is the grid and the
grid-derived tensors (the prefilter matrices, ``conv_x``, the initial mesh),
plus the winds a run is given.  Everything crosses as numpy arrays, so this
module needs neither package's internals: ``grid_from_jax`` is duck-typed
on ``lats``, ``lons`` and ``cyclic_x``, ``field_from_jax`` on ``data``,
``dims``, ``coords``, ``name`` and ``attrs``, and
``FTLEPipeline.load_numpy_state`` takes the matrices by buffer name.
"""
from __future__ import annotations

from collections.abc import Mapping, Sequence

import numpy as np
import torch

from .field import Field
from .grid import Grid

__all__ = ["field_from_jax", "grid_from_jax", "tensors_from_numpy"]


def field_from_jax(field) -> Field:
    """This package's ``Field`` from a ``lagrangiancoherence_tpu.field.Field``
    (or anything with the same attributes), as numpy copies of its data and
    coordinates."""
    return Field(data=np.array(field.data), dims=tuple(field.dims),
                 coords={k: np.array(v) for k, v in field.coords.items()},
                 name=field.name, attrs=dict(getattr(field, "attrs", {})))


def grid_from_jax(grid) -> Grid:
    """This package's ``Grid`` from any object with ``lats``, ``lons`` and
    ``cyclic_x`` (e.g. ``lagrangiancoherence_tpu.grid.Grid``)."""
    return Grid(lats=np.asarray(grid.lats), lons=np.asarray(grid.lons),
                cyclic_x=bool(grid.cyclic_x))


def tensors_from_numpy(arrays: Mapping | Sequence, device,
                       dtype: torch.dtype | None = None):
    """Move arrays (numpy, or anything ``np.asarray`` accepts, such as JAX
    arrays) to ``device`` as tensors, cast to ``dtype`` when given.  A
    mapping comes back as a dict with the same keys, a sequence as a
    tuple."""
    def one(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    if isinstance(arrays, Mapping):
        return {k: one(a) for k, a in arrays.items()}
    return tuple(one(a) for a in arrays)
