"""Batch runners: FTLE time series (the animation workload) — PyTorch.

Counterpart of ``lagrangiancoherence_tpu/runners.py``.  The reference's
production pattern is one batch job per timestamp over netCDF files
(LagrangianCoherence LCS/LCS.py:236-268, area_of_influence.py:168-184: a
Python loop sliding an 8-step window).  Here it is a library call:

* ``ftle_series`` slides an integration window over a long wind record and
  computes one FTLE field per window.  The record crosses to the device
  once, in the order it is stored, and is put in ascending coordinates
  there (``devices.upload``); the windows are slices of it on the device.
  One ``FTLEPipeline`` serves every window, so the grid state (``conv_x``,
  the initial mesh) is built once per series.  With a ``"t"`` mesh
  (``parallel/mesh.batch_mesh``) each chunk of windows goes through
  ``parallel/pipeline.ftle_batch``.
* ``ftle_series_to_files`` **streams**: each chunk of windows is computed
  and then written, one netCDF/HDF5 file per window timestamp, before the
  next chunk starts; windows whose file already exists are dropped
  *before* compute — the idempotent retry-the-call recovery contract
  (SURVEY.md §5): a crashed run is resumed by calling it again and pays
  only for the windows it had not finished.

JAX evaluates a chunk as one ``vmap``-ed program; PyTorch runs eagerly, so
a chunk is a loop over its windows and ``batch`` keeps only its streaming
meaning (how many windows are computed before they are written).  JAX's
fallback for a ``vmap`` that fails to compile (runners.py:148-168) and its
TPU compile limits in ``_auto_batch`` (runners.py:50-68) have no
counterpart: ``batch="auto"`` is ``AUTO_BATCH`` windows, a multiple of the
device count with a mesh.
"""
from __future__ import annotations

import logging
import os

import numpy as np
import torch

from .devices import download, resolve_device, upload
from .field import Field, as_field
from .grid import Grid
from .utils.logging import logger, timed_stage

__all__ = ["ftle_series", "ftle_series_to_files"]

AUTO_BATCH = 8          # windows a chunk for batch="auto", as JAX's off-TPU
SERIES_SPAN = "Series call"     # the root span of one series call


def _windows(nt: int, window: int, stride: int) -> list[int]:
    return list(range(0, nt - window + 1, stride))


def _prep_record(u, v, propdim):
    """The wind record as (time, latitude, longitude) Fields, in the order
    it is stored."""
    if not (hasattr(u, "dims") or not isinstance(u, np.ndarray)):
        raise TypeError("pass Fields (or xarray DataArrays) with "
                        "time/latitude/longitude dims")
    order = (propdim, "latitude", "longitude")
    return as_field(u).transpose(*order), as_field(v).transpose(*order)


def _auto_batch(mesh) -> int:
    """``AUTO_BATCH`` windows, or with a mesh a multiple of its device
    count, so that every device takes a share of each chunk."""
    if mesh is None:
        return AUTO_BATCH
    return mesh.size * max(1, AUTO_BATCH // mesh.size)


def _warn_overflow(overflow, chunk):
    bad = np.nonzero(np.atleast_1d(overflow))[0]
    if bad.size:
        logger.warning(
            "windowed gathers clamped some taps in windows starting at %s; "
            "affected tiles are approximate — re-run with the default "
            "engine for exact values", [chunk[i] for i in bad])


def _iter_series_chunks(ud, vd, starts, window, timestep, grid, *, batch,
                        mesh, pipeline_kw):
    """Yield ``(chunk_starts, fields_np)`` per chunk of ``batch`` windows.

    ``ud``/``vd``: the whole wind record on the device, uploaded once by
    the caller; every window is a slice of it (no copy on that device).
    """
    from .models.pipeline import FTLEPipeline

    if mesh is None:
        model = FTLEPipeline(grid, **pipeline_kw, dtype=ud.dtype,
                             device=ud.device)
    else:
        from .parallel.pipeline import ftle_batch
    for chunk_start in range(0, len(starts), batch):
        chunk = starts[chunk_start:chunk_start + batch]
        if mesh is not None:
            # pad the tail chunk to a multiple of the device count so that
            # every device takes a share; the replicas are cut off below
            padded = chunk + [chunk[-1]] * ((-len(chunk)) % mesh.size)
            out, overflow = ftle_batch(
                torch.stack([ud[s:s + window] for s in padded]),
                torch.stack([vd[s:s + window] for s in padded]), timestep,
                grid, mesh, **pipeline_kw, return_overflow=True)
            out, overflow = out[:len(chunk)], overflow[:len(chunk)]
        else:
            outs, flags = [], []
            for s in chunk:
                o, f = model(ud[s:s + window], vd[s:s + window], timestep,
                             return_overflow=True)
                outs.append(o)
                flags.append(f)
            out, overflow = torch.stack(outs), torch.stack(flags)
        with timed_stage("Series chunk copy back", logging.DEBUG):
            overflow, out = download(overflow), download(out)
        _warn_overflow(overflow, chunk)
        yield chunk, out


def _stamp_indices(starts, window, timestep):
    """Per-window timestamp rule: last time of the window forward, first
    backward (LagrangianCoherence LCS/LCS.py:158)."""
    return [(s + window - 1 if timestep > 0 else s) for s in starts]


def _setup(u, v, window, stride, propdim):
    with timed_stage("Series record prep"):
        U, V = _prep_record(u, v, propdim)
    starts = _windows(U.shape[0], window, stride)
    if not starts:
        raise ValueError(f"record of {U.shape[0]} steps is shorter than "
                         f"window={window}")
    return U, V, U.coords[propdim], starts


def _record_on_device(U, V, mesh, device):
    """The record on the series' device (the mesh's first device with a
    mesh) in ascending coordinates, and those coordinates."""
    device = mesh.devices.flat[0] if mesh is not None \
        else resolve_device(device)
    with timed_stage("Series record upload"):
        ud, lats, lons = upload(U, device, ascending=True)
        vd = upload(V, device, ascending=True)[0]
    return ud, vd, lats, lons


def ftle_series(u, v, timestep: float, *, window: int, stride: int = 1,
                settls_order: int = 4, interp_order: int = 3, sigma=None,
                compat: bool = True, batch="auto", mesh=None,
                kernel: str = "auto", engine: str = "auto",
                propdim: str = "time", cyclic_x: bool = True, device=None):
    """FTLE fields over sliding windows of a long wind record.

    ``u``/``v``: Fields (time, latitude, longitude) (or xarray DataArrays);
    ``window``: time levels per integration (e.g. 33 for 8 days of
    6-hourly data); ``stride``: window start spacing.  Returns a Field
    (time, latitude, longitude) stamped per the reference's rule (last time
    of the window forward, first backward — LagrangianCoherence
    LCS/LCS.py:158).

    ``batch``: windows a chunk (``"auto"``: see ``_auto_batch``).
    ``mesh``: an optional ``batch_mesh``, over whose devices each chunk is
    split.  ``kernel``/``engine``: as ``ftle_pipeline``.  The fields are
    computed in ``torch.get_default_dtype()`` on ``device`` (default: the
    CUDA card; ``"cpu"`` for the CPU), or on the mesh's devices.

    ``cyclic_x``: longitude wrap semantics.  ``True`` (global records)
    wraps parcels across the dateline; pass ``False`` for regional records
    (the reference's research workload, LagrangianCoherence
    LCS/area_of_influence.py:168-184), which clamp at the domain edge.
    """
    with timed_stage(SERIES_SPAN):
        U, V, times, starts = _setup(u, v, window, stride, propdim)
        batch = _auto_batch(mesh) if batch == "auto" else max(1, int(batch))
        ud, vd, lats, lons = _record_on_device(U, V, mesh, device)
        grid = Grid(lats=lats, lons=lons, cyclic_x=cyclic_x)
        kw = dict(settls_order=settls_order, interp_order=interp_order,
                  sigma=sigma, compat=compat, kernel=kernel, engine=engine)
        fields = []
        with timed_stage(f"FTLE series: {len(starts)} windows"):
            for _chunk, out in _iter_series_chunks(
                    ud, vd, starts, window, timestep, grid, batch=batch,
                    mesh=mesh, pipeline_kw=kw):
                fields.append(out)
        with timed_stage("Series assembly"):
            stamps = np.asarray(times)[_stamp_indices(starts, window,
                                                      timestep)]
            return Field(np.concatenate(fields, axis=0),
                         (propdim, "latitude", "longitude"),
                         {propdim: stamps, "latitude": lats,
                          "longitude": lons},
                         name="ftle")


def _stamp_tag(stamp) -> str:
    return np.datetime_as_string(np.datetime64(stamp), unit="h") \
        if np.issubdtype(np.asarray(stamp).dtype, np.datetime64) \
        else str(stamp)


def ftle_series_to_files(u, v, timestep: float, outdir: str, *,
                         window: int, stride: int = 1,
                         overwrite: bool = False, batch="auto", mesh=None,
                         settls_order: int = 4, interp_order: int = 3,
                         sigma=None, compat: bool = True,
                         kernel: str = "auto", engine: str = "auto",
                         propdim: str = "time", cyclic_x: bool = True,
                         device=None) -> list[str]:
    """Streaming variant: one netCDF/HDF5 file per window timestamp.

    Each chunk of windows is written as soon as it is computed, so a crash
    at window N loses at most one chunk of compute and host memory stays
    O(batch) fields.  On a second call, windows whose output file already
    exists are dropped *before* compute (unless ``overwrite``).  Returns the
    paths written.  Arguments as ``ftle_series``.
    """
    from .utils.io import save_dataset

    with timed_stage(SERIES_SPAN):
        os.makedirs(outdir, exist_ok=True)
        U, V, times, starts = _setup(u, v, window, stride, propdim)
        stamps = np.asarray(times)[_stamp_indices(starts, window, timestep)]
        paths = {s: os.path.join(outdir, f"ftle_{_stamp_tag(st)}.nc")
                 for s, st in zip(starts, stamps)}
        stamp_of = dict(zip(starts, stamps))
        if overwrite:
            todo = starts
        else:
            todo = [s for s in starts if not os.path.exists(paths[s])]
            for s in starts:
                if s not in todo:
                    logger.info("skip existing %s", paths[s])
        if not todo:
            return []

        batch = _auto_batch(mesh) if batch == "auto" else max(1, int(batch))
        ud, vd, lats, lons = _record_on_device(U, V, mesh, device)
        grid = Grid(lats=lats, lons=lons, cyclic_x=cyclic_x)
        kw = dict(settls_order=settls_order, interp_order=interp_order,
                  sigma=sigma, compat=compat, kernel=kernel, engine=engine)
        written = []
        with timed_stage(f"FTLE series → files: {len(todo)} windows"):
            for chunk, out in _iter_series_chunks(
                    ud, vd, todo, window, timestep, grid, batch=batch,
                    mesh=mesh, pipeline_kw=kw):
                for s, field2d in zip(chunk, out):
                    fld = Field(field2d[None],
                                (propdim, "latitude", "longitude"),
                                {propdim: np.asarray([stamp_of[s]]),
                                 "latitude": lats, "longitude": lons},
                                name="ftle")
                    if save_dataset({"ftle": fld}, paths[s],
                                    skip_if_exists=not overwrite):
                        written.append(paths[s])
        return written
