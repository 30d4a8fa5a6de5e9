"""Dataset IO: read/write netCDF4-flavoured HDF5 files via h5py.

Counterpart of ``lagrangiancoherence_tpu/utils/io.py``; the files each
package writes open in the other.  The reference loads ERA5 netCDF with
``xr.open_dataset`` (LagrangianCoherence LCS/LCS.py:84-85) and writes results
with ``to_netcdf`` (LagrangianCoherence LCS/LCS.py:254-262).  netCDF4 files
*are* HDF5, so this module reads them directly with h5py (dimension names
recovered from netCDF dimension scales) and writes files that
netCDF4/xarray can open (dimension scales attached, ``_FillValue``
honoured).  h5py is imported inside the functions, and CF time units are
decoded and encoded with numpy ``datetime64`` (``utils/times.py``), so this
module needs no pandas and imports no h5py until a file is read or written.
Time labels keep their resolution, as the JAX package's pandas keeps it, so
a record outside 1678-2262 decodes and encodes to its own instants.

Writes are idempotent per timestamp — ``save_field(..., skip_if_exists=True)``
is the failure-recovery contract SURVEY.md §5 calls for (retry the file),
replacing the reference CLI's destructive rm-input behaviour (quirk Q8).
"""
from __future__ import annotations

import os

import numpy as np

from ..field import Field
from .times import as_labels, isoformat
from .times import decode_cf as _decode_times

__all__ = ["open_dataset", "open_dataarray", "save_field", "save_dataset"]


def _require_h5py():
    try:
        import h5py
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "h5py is required for netCDF/HDF5 IO; install it or pass "
            "in-memory Fields instead of paths") from e
    return h5py


def _var_dims(h5var, fallback_ndim: int) -> tuple[str, ...]:
    """Dimension names from netCDF4 dimension scales, else generic names."""
    dims = []
    dimlist = h5var.attrs.get("DIMENSION_LIST")
    if dimlist is not None:
        for refs in dimlist:
            ref = refs[0]
            name = h5var.file[ref].name.rsplit("/", 1)[-1]
            dims.append(name)
        return tuple(dims)
    return tuple(f"dim_{i}" for i in range(fallback_ndim))


def open_dataset(path: str) -> dict[str, Field]:
    """Read every non-coordinate variable of a netCDF4/HDF5 file into Fields."""
    h5py = _require_h5py()
    out: dict[str, Field] = {}
    with h5py.File(path, "r") as f:
        names = list(f.keys())
        coord_names = [n for n in names
                       if f[n].ndim == 1 and (
                           "CLASS" in f[n].attrs and
                           f[n].attrs["CLASS"] in (b"DIMENSION_SCALE",
                                                   "DIMENSION_SCALE"))]
        coords: dict[str, np.ndarray] = {}
        for n in coord_names:
            vals = f[n][...]
            units = f[n].attrs.get("units")
            if isinstance(units, bytes):
                units = units.decode()
            vals = _decode_times(vals, units)
            coords[n] = vals
        for n in names:
            if n in coord_names:
                continue
            var = f[n]
            if not hasattr(var, "ndim"):
                continue
            data = var[...]
            fill = var.attrs.get("_FillValue")
            scale = var.attrs.get("scale_factor")
            offset = var.attrs.get("add_offset")
            if fill is not None or scale is not None or offset is not None:
                data = data.astype(np.float64)
                if fill is not None:
                    data = np.where(data == np.asarray(fill, dtype=np.float64),
                                    np.nan, data)
                if scale is not None:
                    data = data * float(np.asarray(scale))
                if offset is not None:
                    data = data + float(np.asarray(offset))
            dims = _var_dims(var, data.ndim)
            out[n] = Field(data=data, dims=dims,
                           coords={d: coords[d] for d in dims if d in coords},
                           name=n)
    return out


def open_dataarray(path: str, name: str | None = None) -> Field:
    ds = open_dataset(path)
    if name is not None:
        return ds[name]
    if len(ds) != 1:
        raise ValueError(f"{path} holds {sorted(ds)}; pass name=")
    return next(iter(ds.values()))


def _encode_times(vals: np.ndarray):
    """Encode datetime64 coords as CF 'seconds since' floats."""
    if np.issubdtype(np.asarray(vals).dtype, np.datetime64):
        t = as_labels(vals)
        origin = t[0]
        sec = ((t - origin) / np.timedelta64(1, "s")).astype(np.float64)
        return sec, f"seconds since {isoformat(origin)}"
    return np.asarray(vals), None


def save_dataset(fields: dict[str, Field], path: str,
                 skip_if_exists: bool = False) -> bool:
    """Write Fields into a netCDF4-compatible HDF5 file.  Returns False when
    skipped because the output already exists (idempotent batch contract)."""
    if skip_if_exists and os.path.exists(path):
        return False
    h5py = _require_h5py()
    tmp = path + ".tmp"
    with h5py.File(tmp, "w") as f:
        written_coords: dict[str, object] = {}
        for name, fld in fields.items():
            for d in fld.dims:
                if d in written_coords or d not in fld.coords:
                    continue
                vals, units = _encode_times(fld.coords[d])
                cset = f.create_dataset(d, data=vals)
                cset.make_scale(d)
                if units:
                    cset.attrs["units"] = units
                written_coords[d] = cset
        for name, fld in fields.items():
            dset = f.create_dataset(name, data=np.asarray(fld.data))
            for ax, d in enumerate(fld.dims):
                if d in written_coords:
                    dset.dims[ax].attach_scale(written_coords[d])
    os.replace(tmp, path)
    return True


def save_field(field: Field, path: str, skip_if_exists: bool = False) -> bool:
    return save_dataset({field.name or "data": field}, path,
                        skip_if_exists=skip_if_exists)
