"""The latitude-block FTLE pipeline and the batch runner — PyTorch.

Counterpart of ``lagrangiancoherence_tpu/parallel/pipeline.py``.  JAX runs
one ``shard_map`` program from a single controller over a device mesh; the
port writes that program out as a loop over the mesh's blocks in one
process:

* the winds are copied once to each device of the mesh and prefiltered
  there once; every block on that device reads them (the replicated winds
  of the JAX design, so the integration needs no exchange);
* each block is a latitude band of parcels (and, on a ``("y", "x")`` mesh,
  a longitude band of it) integrated by one ``settls_scan`` on its device,
  with ``home_rows`` giving the global home row of each block row;
* grids whose row count the ``"y"`` axis does not divide are padded at the
  south end with symmetric-reflected rows (global row k >= ny is row
  2*ny-1-k), which start and integrate exactly as the rows they reflect
  and are cut off at the end;
* ``ftle_sharded`` assembles the departure points on the mesh's first
  device and takes the whole-grid ``ftle_from_departures``: one process
  holds every block, so JAX's blocked gradient and Gaussian (with their
  halo exchanges, ``parallel/halo.py``) would buy no locality here.

Every block runs the same operations on the same values as the whole-grid
``models/settls.parcel_propagation_core``, so on one kind of device the
departure points, and with them the FTLE field, are identical to
``models/pipeline``'s.  On the windowed route (``engine="blockspec"`` or
``"dma"``) a block's tiles and sort groups differ from the whole grid's,
but a tile whose taps fit its window gathers the direct gather's values,
so while the overflow word stays 0 the same holds there.

``ftle_batch`` is the animation workload's batch parallelism: one
``FTLEPipeline`` per device of a ``("t",)`` mesh over its share of the
batch.
"""
from __future__ import annotations

import numpy as np
import torch

from ..grid import EARTH_RADIUS
from ..models.ftle import ftle_from_departures
from ..models.pipeline import FTLEPipeline
from ..models.settls import (WINDOWED, _as_tensor, grid_state,
                             resolve_engine, resolve_kernel, settls_scan)
from ..ops import pole as P
from ..ops.interp import prefilter

__all__ = ["block_layout", "ftle_batch", "ftle_sharded",
           "parcel_propagation_sharded"]

EARTH_DEG = np.pi / 180.0


def block_layout(grid, n_blocks: int) -> dict[str, np.ndarray]:
    """The host-side layout of ``n_blocks`` latitude blocks (JAX
    parallel/pipeline.py:95-113): ``home_idx``, the global home row of each
    of the ``n_blocks * ceil(ny / n_blocks)`` padded rows (symmetric
    reflection past the south end); ``lats``, their latitudes; and
    ``conv_x``, JAX's float64 (rows, 1) m/s → deg/s factor on them.  The
    blocks integrate with the grid state's ``conv_x`` rows at ``home_idx``
    instead, so that their bits are the whole-grid run's."""
    ny = grid.shape[0]
    rows = -(-ny // n_blocks)
    if rows < 2:
        raise ValueError(f"{rows} rows a block < the stencil halo width 2; "
                         f"use fewer blocks")
    home_idx = np.arange(rows * n_blocks)
    home_idx = np.where(home_idx < ny, home_idx, 2 * ny - 1 - home_idx)
    lats = np.asarray(grid.lats)[home_idx]
    conv_y = 180.0 / (EARTH_RADIUS * np.pi)
    return {"home_idx": home_idx, "lats": lats,
            "conv_x": (conv_y / np.abs(np.cos(lats * EARTH_DEG)))[:, None]}


def _mesh_split(grid, mesh, engine: str):
    """(y blocks, x blocks, the (nyd, nxd) device array), with JAX's
    rejections of the x-split cases (parallel/pipeline.py:84-94)."""
    nyd, nxd = mesh.shape["y"], mesh.shape.get("x", 1)
    if nxd > 1:
        if resolve_engine(engine) in WINDOWED:
            raise NotImplementedError(
                f"engine={engine!r} needs full-width latitude blocks; use a "
                f"1-D ('y',) mesh")
        if grid.shape[1] % nxd:
            raise ValueError(f"nx={grid.shape[1]} must divide the x mesh "
                             f"axis ({nxd})")
    return nyd, nxd, mesh.devices.reshape(nyd, nxd)


def _pole_seed(state, order: int):
    """The replicated pole block's seed (JAX parallel/pipeline.py:52-66):
    the initial positions and ``conv_x`` of the 2*order pole-home rows,
    taken from the grid state's rows, as the whole-grid scan takes them,
    so that every block integrates them bit for bit as the whole grid
    does; None where the grid has no such rows."""
    ny = state["px0"].shape[0]
    if order <= 0 or ny <= 2 * order:
        return None
    return tuple(P.pole_rows(state[k], order)
                 for k in ("px0", "py0", "conv_x"))


def _integrate(u, v, timestep, grid, mesh, *, settls_order, interp_order,
               return_traj, kernel, engine):
    """Every block's ``settls_scan``: (nyd x nxd nested lists of (px, py)
    blocks, the overflow word max-reduced over the blocks on the mesh's
    first device)."""
    nyd, nxd, devs = _mesh_split(grid, mesh, engine)
    ny, nx = grid.shape
    lay = block_layout(grid, nyd)
    rows, cols = lay["home_idx"].size // nyd, nx // nxd
    windowed = resolve_engine(engine) in WINDOWED
    per_device = {}
    for dev in dict.fromkeys(devs.flat):
        # the winds once per device, prefiltered once there
        ud = _as_tensor(u, dev)
        vd = _as_tensor(v, dev, ud.dtype)
        if ud.shape[-2:] != (ny, nx) or vd.shape != ud.shape:
            raise ValueError(f"winds {tuple(ud.shape)}/{tuple(vd.shape)} do "
                             f"not match grid {grid.shape}")
        state = grid_state(grid, interp_order, dtype=ud.dtype, device=dev)
        mats = (state["prefilter_y"], state["prefilter_x"])
        home = torch.tensor(lay["home_idx"], dtype=torch.int64, device=dev)
        per_device[dev] = dict(
            u=ud, v=vd, cu=prefilter(ud, order=interp_order, matrices=mats),
            cv=prefilter(vd, order=interp_order, matrices=mats),
            dt=torch.full((), float(timestep), dtype=ud.dtype, device=dev),
            kernel=resolve_kernel(kernel, dev, interp_order), home=home,
            px0=state["px0"][home], py0=state["py0"][home],
            conv_x=state["conv_x"][home],
            pole_seed=_pole_seed(state, interp_order) if windowed else None)
    blocks, flags = [], []
    for i in range(nyd):
        blocks.append([])
        for j in range(nxd):
            d = per_device[devs[i, j]]
            r, c = slice(i * rows, (i + 1) * rows), slice(j * cols,
                                                          (j + 1) * cols)
            *pos, ovf = settls_scan(
                d["u"], d["v"], d["cu"], d["cv"],
                d["px0"][r, c].contiguous(), d["py0"][r, c].contiguous(),
                d["dt"], d["conv_x"][r], grid, settls_order=settls_order,
                interp_order=interp_order, return_traj=return_traj,
                home_rows=d["home"][r], kernel=d["kernel"], engine=engine,
                pole_seed=d["pole_seed"])
            blocks[-1].append(pos)
            flags.append(ovf)
    dev0 = devs[0, 0]
    overflow = torch.stack([f.to(dev0) for f in flags]).amax()
    return blocks, overflow


def _assemble(blocks, ny: int, dev0) -> torch.Tensor:
    """The (..., rows, cols) blocks of an nyd x nxd nested list as one
    (..., ny, nx) tensor on ``dev0``, the pad rows cut off."""
    full = torch.cat([torch.cat([b.to(dev0) for b in row], dim=-1)
                      for row in blocks], dim=-2)
    return full[..., :ny, :]


def parcel_propagation_sharded(u, v, timestep, grid, mesh, *,
                               settls_order: int = 0, interp_order: int = 3,
                               return_traj: bool = False,
                               kernel: str = "auto", engine: str = "auto",
                               return_overflow: bool = False):
    """Latitude-block SETTLS integration over ``mesh`` (``parcel_mesh``):
    (T, ny, nx) winds → departure points (ny, nx), or trajectories
    (T, ny, nx) with ``return_traj``, on the mesh's first device.  Blocks
    never exchange anything: the integration never couples parcels.  A
    ``("y", "x")`` mesh also splits the longitudes (``nx`` must divide).
    ``kernel``/``engine``: as ``parcel_propagation_core``; on the
    windowed route (``engine="blockspec"`` or ``"dma"``) every block also
    integrates the 2*order pole-home rows from their seed (``_pole_seed``)
    and writes back those it holds, as JAX's blocks do.

    ``return_overflow=True`` appends the overflow word max-reduced over the
    blocks (int32, 0-dim; 0 on the direct route).
    """
    blocks, overflow = _integrate(
        u, v, timestep, grid, mesh, settls_order=settls_order,
        interp_order=interp_order, return_traj=return_traj, kernel=kernel,
        engine=engine)
    dev0 = mesh.devices.flat[0]
    ny = grid.shape[0]
    px = _assemble([[b[0] for b in row] for row in blocks], ny, dev0)
    py = _assemble([[b[1] for b in row] for row in blocks], ny, dev0)
    if return_overflow:
        return px, py, overflow
    return px, py


def ftle_sharded(u, v, timestep, grid, mesh, *, settls_order: int = 0,
                 interp_order: int = 3, sigma=None, compat: bool = True,
                 kernel: str = "auto", engine: str = "auto",
                 return_overflow: bool = False):
    """(T, ny, nx) winds → (ny, nx) FTLE norm over the latitude blocks of
    ``mesh``, on the mesh's first device; the same field as
    ``models.pipeline.ftle_pipeline``.

    The blocks integrate (``parcel_propagation_sharded``); their departure
    points, assembled on the mesh's first device, go through the whole-grid
    ``ftle_from_departures`` (``sigma`` smoothing, flow-map gradient,
    norm).  A ``("y", "x")`` mesh takes no ``sigma``, as JAX's, and needs
    ``nx`` to divide its ``"x"`` axis.  ``return_overflow=True`` also
    returns the overflow word max-reduced over the blocks.
    """
    _, nxd, _ = _mesh_split(grid, mesh, engine)
    if nxd > 1 and sigma is not None:
        raise NotImplementedError(
            "gauss_sigma with an x-sharded mesh is not supported yet; use a "
            "1-D ('y',) mesh")
    px, py, overflow = parcel_propagation_sharded(
        u, v, timestep, grid, mesh, settls_order=settls_order,
        interp_order=interp_order, kernel=kernel, engine=engine,
        return_overflow=True)
    out = ftle_from_departures(px, py, grid, sigma=sigma, compat=compat)
    if return_overflow:
        return out, overflow
    return out


def ftle_batch(u_batch, v_batch, timestep, grid, mesh, *,
               settls_order: int = 0, interp_order: int = 3, sigma=None,
               compat: bool = True, kernel: str = "auto",
               engine: str = "auto", return_overflow: bool = False):
    """Batched FTLE over independent wind records (B, T, ny, nx), split over
    the ``"t"`` axis of ``mesh`` (``batch_mesh``): device k takes the k-th
    contiguous share of the batch (B must divide the device count) through
    one ``FTLEPipeline`` per device.  Returns (B, ny, nx) fields on the
    mesh's first device and, with ``return_overflow=True``, the (B,) int32
    overflow words (0 on the direct route)."""
    devs = list(mesh.devices.flat)
    n, B = len(devs), len(u_batch)
    if B % n:
        raise ValueError(f"a batch of {B} does not split over {n} devices")
    per = B // n
    models, outs, flags = {}, [], []
    for k, dev in enumerate(devs):
        ub = _as_tensor(u_batch[k * per:(k + 1) * per], dev)
        vb = _as_tensor(v_batch[k * per:(k + 1) * per], dev, ub.dtype)
        if dev not in models:
            models[dev] = FTLEPipeline(
                grid, settls_order=settls_order, interp_order=interp_order,
                sigma=sigma, compat=compat, kernel=kernel, engine=engine,
                dtype=ub.dtype, device=dev)
        for b in range(per):
            out, flag = models[dev](ub[b], vb[b], timestep,
                                    return_overflow=True)
            outs.append(out.to(devs[0]))
            flags.append(flag.to(devs[0]))
    out = torch.stack(outs)
    if return_overflow:
        return out, torch.stack(flags)
    return out
