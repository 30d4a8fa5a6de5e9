"""Lightweight labeled-array container — the port's API-boundary type.

A copy of ``lagrangiancoherence_tpu/field.py`` (numpy only), so that the port
never imports the JAX package; only ``Field.interp_to`` differs, calling the
port's regrid.  The reference threads ``xarray.DataArray`` through its
entire pipeline (LagrangianCoherence LCS/LCS.py:48-168).  Here labeled
coordinates exist **only at the API boundary**: ``Field`` carries a host
numpy array plus named 1-D coordinate vectors, and the torch code receives
tensors plus the ``Grid`` struct.  ``Field`` implements just the slice of the
xarray surface the reference's workflows use (``sortby``, ``sel``, ``isel``,
``mean``, arithmetic), so a user can port scripts without installing
xarray; when xarray *is* installed, ``Field.from_xarray`` /
``Field.to_xarray`` convert losslessly.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import numpy as np

__all__ = ["Field", "as_field"]


def _asarray(x) -> np.ndarray:
    # lists, numpy and CPU tensors normalise to host numpy; a CUDA tensor
    # raises (the caller copies it to the host)
    return np.asarray(x)


@dataclasses.dataclass
class Field:
    """N-D array with named dims and 1-D coordinate vectors.

    ``dims`` is a tuple of names, one per axis of ``data``; ``coords`` maps a
    dim name to its 1-D coordinate array.  Coordinate-free dims are allowed
    (no entry in ``coords``).
    """

    data: np.ndarray
    dims: tuple[str, ...]
    coords: dict[str, np.ndarray]
    name: str | None = None
    attrs: dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.data = _asarray(self.data)
        self.dims = tuple(self.dims)
        if len(self.dims) != self.data.ndim:
            raise ValueError(f"dims {self.dims} do not match data ndim {self.data.ndim}")
        coords = {}
        for k, v in self.coords.items():
            v = _asarray(v)
            if k in self.dims:
                ax = self.dims.index(k)
                if v.ndim != 1 or v.shape[0] != self.data.shape[ax]:
                    raise ValueError(
                        f"coord {k!r} has shape {v.shape}, dim size is "
                        f"{self.data.shape[ax]}")
            coords[k] = v
        self.coords = coords

    # ------------------------------------------------------------------
    # Introspection
    # ------------------------------------------------------------------
    @property
    def shape(self) -> tuple[int, ...]:
        return self.data.shape

    @property
    def ndim(self) -> int:
        return self.data.ndim

    @property
    def values(self) -> np.ndarray:
        return self.data

    @property
    def dtype(self):
        return self.data.dtype

    def axis(self, dim: str) -> int:
        return self.dims.index(dim)

    def get_coord(self, dim: str) -> np.ndarray:
        return self.coords[dim]

    def __repr__(self):
        dims = ", ".join(f"{d}: {s}" for d, s in zip(self.dims, self.shape))
        return f"<Field {self.name or ''}({dims}) dtype={self.data.dtype}>"

    # ------------------------------------------------------------------
    # xarray-flavoured ops (the subset reference workflows use)
    # ------------------------------------------------------------------
    def copy(self, data: np.ndarray | None = None) -> "Field":
        return Field(
            data=self.data.copy() if data is None else _asarray(data),
            dims=self.dims,
            coords={k: v.copy() for k, v in self.coords.items()},
            name=self.name,
            attrs=dict(self.attrs),
        )

    def rename(self, name: str) -> "Field":
        out = self.copy()
        out.name = name
        return out

    def sortby(self, dim: str) -> "Field":
        """Ascending sort along ``dim`` (reference requires ascending lat/lon,
        LagrangianCoherence LCS/LCS.py:101-104)."""
        c = self.coords[dim]
        order = np.argsort(c, kind="stable")
        if np.array_equal(order, np.arange(c.shape[0])):
            return self
        ax = self.axis(dim)
        out = self.copy(data=np.take(self.data, order, axis=ax))
        out.coords[dim] = c[order]
        return out

    def isel(self, indexers: Mapping[str, Any] | None = None, **kw) -> "Field":
        indexers = {**(indexers or {}), **kw}
        data = self.data
        coords = {k: v for k, v in self.coords.items()}
        dims = list(self.dims)
        drop = []
        for dim, idx in indexers.items():
            ax = dims.index(dim)
            data = np.take(data, np.arange(data.shape[ax])[idx], axis=ax) \
                if isinstance(idx, slice) else np.take(data, idx, axis=ax)
            if dim in coords:
                coords[dim] = coords[dim][idx]
            if np.isscalar(idx) or (isinstance(idx, (int, np.integer))):
                drop.append(dim)
        for dim in drop:
            ax = dims.index(dim)
            dims.pop(ax)
            if dim in coords:
                coords.pop(dim)
        return Field(data=data, dims=tuple(dims), coords=coords, name=self.name,
                     attrs=dict(self.attrs))

    def sel(self, indexers: Mapping[str, Any] | None = None, **kw) -> "Field":
        """Label-based selection: scalars snap to nearest; slices are
        inclusive coordinate windows."""
        indexers = {**(indexers or {}), **kw}
        iidx = {}
        for dim, val in indexers.items():
            c = self.coords[dim]
            if isinstance(val, slice):
                lo = -np.inf if val.start is None else val.start
                hi = np.inf if val.stop is None else val.stop
                if lo > hi:
                    lo, hi = hi, lo
                mask = (c >= lo) & (c <= hi)
                iidx[dim] = np.nonzero(mask)[0]
            elif np.ndim(val) == 0:
                iidx[dim] = int(np.argmin(np.abs(c - val)))
            else:
                val = _asarray(val)
                iidx[dim] = np.array([int(np.argmin(np.abs(c - x))) for x in val])
        return self.isel(iidx)

    def transpose(self, *dims: str) -> "Field":
        if not dims:
            dims = tuple(reversed(self.dims))
        perm = [self.dims.index(d) for d in dims]
        return Field(data=np.transpose(self.data, perm), dims=tuple(dims),
                     coords=dict(self.coords), name=self.name,
                     attrs=dict(self.attrs))

    def expand_dims(self, dim: str, coord=None) -> "Field":
        coords = dict(self.coords)
        if coord is not None:
            coords[dim] = _asarray(np.atleast_1d(coord))
        return Field(data=self.data[None], dims=(dim,) + self.dims,
                     coords=coords, name=self.name, attrs=dict(self.attrs))

    def assign_coords(self, **kw) -> "Field":
        out = self.copy()
        for k, v in kw.items():
            out.coords[k] = _asarray(np.atleast_1d(v)) if np.ndim(v) else _asarray([v])
            if k in out.dims:
                out.coords[k] = _asarray(v)
        return out

    # arithmetic delegates to the underlying array, preserving labels
    def _binop(self, other, op):
        other_data = other.data if isinstance(other, Field) else other
        return self.copy(data=op(self.data, other_data))

    def __add__(self, o):  return self._binop(o, np.add)
    def __radd__(self, o): return self._binop(o, lambda a, b: np.add(b, a))
    def __sub__(self, o):  return self._binop(o, np.subtract)
    def __rsub__(self, o): return self._binop(o, lambda a, b: np.subtract(b, a))
    def __mul__(self, o):  return self._binop(o, np.multiply)
    def __rmul__(self, o): return self._binop(o, lambda a, b: np.multiply(b, a))
    def __truediv__(self, o):  return self._binop(o, np.divide)
    def __rtruediv__(self, o): return self._binop(o, lambda a, b: np.divide(b, a))
    def __neg__(self): return self.copy(data=-self.data)

    def mean(self, dim: str | None = None):
        if dim is None:
            return float(np.nanmean(self.data))
        ax = self.axis(dim)
        out = self.isel({dim: 0}).copy(data=np.nanmean(self.data, axis=ax))
        return out

    def std(self):
        return float(np.nanstd(self.data))

    def coarsen(self, boundary: str = "trim", **factors) -> "Field":
        """Block-mean coarsening (xarray ``coarsen(...).mean()`` semantics
        with ``boundary='trim'``), e.g. ``f.coarsen(latitude=2, longitude=2)``
        — the research script's resolution reduction
        (LagrangianCoherence LCS/area_of_influence.py:174-178)."""
        if boundary != "trim":
            raise NotImplementedError("only boundary='trim'")
        data = self.data
        coords = dict(self.coords)
        for dim, k in factors.items():
            if k == 1:
                continue
            ax = self.dims.index(dim)
            n = (data.shape[ax] // k) * k
            sl = [slice(None)] * data.ndim
            sl[ax] = slice(0, n)
            data = data[tuple(sl)]
            shape = list(data.shape)
            shape[ax:ax + 1] = [n // k, k]
            data = data.reshape(shape).mean(axis=ax + 1)
            if dim in coords:
                c = coords[dim][:n]
                coords[dim] = c.reshape(n // k, k).mean(axis=1)
        return Field(data=data, dims=self.dims, coords=coords,
                     name=self.name, attrs=dict(self.attrs))

    def differentiate(self, dim: str) -> "Field":
        """Derivative with respect to the coordinate of ``dim`` (xarray
        ``differentiate`` = second-order central differences via
        ``np.gradient``)."""
        ax = self.axis(dim)
        out = np.gradient(self.data, self.coords[dim], axis=ax)
        return self.copy(data=out)

    def interp_to(self, latitude: np.ndarray, longitude: np.ndarray,
                  device=None) -> "Field":
        """Bilinear regrid of the trailing (latitude, longitude) axes onto new
        coordinate vectors (nearest outside the hull), xarray
        ``interp(method='linear')`` with reindex-nearest fallback; computed
        on ``device`` (see ``ops/regrid.py``) and copied back to the host."""
        from .ops.regrid import regrid_linear_nearest
        if self.dims[-2:] != ("latitude", "longitude"):
            raise ValueError("trailing dims must be (latitude, longitude)")
        data = regrid_linear_nearest(
            self.data, self.coords["latitude"], self.coords["longitude"],
            np.asarray(latitude), np.asarray(longitude),
            device=device).cpu().numpy()
        coords = {k: v for k, v in self.coords.items()
                  if k not in ("latitude", "longitude")}
        coords["latitude"] = np.asarray(latitude)
        coords["longitude"] = np.asarray(longitude)
        return Field(data=data, dims=self.dims, coords=coords,
                     name=self.name, attrs=dict(self.attrs))

    # ------------------------------------------------------------------
    # Conversions
    # ------------------------------------------------------------------
    @classmethod
    def from_xarray(cls, da) -> "Field":
        coords = {str(k): np.asarray(da.coords[k].values)
                  for k in da.coords if da.coords[k].ndim == 1}
        return cls(data=np.asarray(da.values), dims=tuple(str(d) for d in da.dims),
                   coords={k: v for k, v in coords.items() if k in da.dims
                           or v.ndim == 1},
                   name=getattr(da, "name", None))

    def to_xarray(self):
        import xarray as xr  # optional dependency
        return xr.DataArray(self.data,
                            dims=self.dims,
                            coords={k: v for k, v in self.coords.items()
                                    if k in self.dims},
                            name=self.name, attrs=self.attrs)


def as_field(obj, dims: Sequence[str] | None = None,
             coords: Mapping[str, np.ndarray] | None = None) -> Field:
    """Normalise user input to ``Field``: accepts Field, xarray DataArray
    (duck-typed — no xarray import needed), or a plain array plus explicit
    ``dims``/``coords``."""
    if isinstance(obj, Field):
        return obj
    if hasattr(obj, "dims") and hasattr(obj, "coords") and hasattr(obj, "values"):
        return Field.from_xarray(obj)
    if dims is None:
        raise TypeError(
            "plain arrays need explicit dims=/coords= to become a Field")
    return Field(data=_asarray(obj), dims=tuple(dims), coords=dict(coords or {}))
