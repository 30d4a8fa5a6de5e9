"""Entry points of the port: the flagship forward step, and a
multi-block dry run.

Counterpart of the JAX package's ``__graft_entry__.py``.  ``entry()``
returns the flagship forward step — the FTLE pipeline (prefilter, SETTLS
loop, flow-map gradient, closed-form norm) at the 1-degree, nine-level
compile-check size — with its example arguments on the device.
``dryrun_multichip(n)`` runs the latitude-block pipeline over a mesh of n
blocks (a device may repeat: one card runs the n blocks in sequence) on a
small grid whose row count n does not divide, and holds it against the
whole-grid pipeline: with ``sigma``, on the 2-D ``("y", "x")`` mesh when n
is even, and on the windowed route (``engine="blockspec"``, the port's
counterpart of JAX's ``kernel="pallas"``).

Run both on the card::

    python -m lagrangiancoherence_tpu_torch.entry [--blocks N] [--device D]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .devices import resolve_device
from .grid import Grid
from .models.pipeline import ftle_pipeline
from .parallel.mesh import parcel_mesh
from .parallel.pipeline import ftle_sharded

__all__ = ["dryrun_multichip", "entry"]

DT = -6.0 * 3600.0
# max |blocks - whole grid| of the FTLE in float32: JAX's dry-run bound
# (__graft_entry__.py:146-150)
DRYRUN_ATOL = 1e-4


def _vortex_winds(ny, nx, nt, dtype):
    """Small analytic wind field (__graft_entry__.py:16-32)."""
    lats = np.linspace(-80.0, 80.0, ny)
    lons = np.linspace(-180.0, 180.0 - 360.0 / nx, nx)
    LON, LAT = np.meshgrid(lons, lats)
    u = np.zeros((nt, ny, nx), dtype=dtype)
    v = np.zeros((nt, ny, nx), dtype=dtype)
    for t in range(nt):
        dx = LON + 55.0
        dy = LAT + 20.0
        r = np.sqrt(dx * dx + dy * dy) + 1e-8
        mag = np.where(r > 5.0, 40.0 * 25.0 / (2.0 * r), 40.0 * 0.5 * r)
        u[t] = mag * (dy / r) + 2.0
        v[t] = -mag * (dx / r)
    return u, v, lats, lons


def entry(device=None):
    """``(fn, (u, v))``: the flagship forward step on one device and its
    float32 winds there (181x360, 9 levels: a 1-degree global 2-day window),
    SETTLS-4, order 3.  ``device``: default the CUDA card."""
    dev = resolve_device(device)
    ny, nx, nt = 181, 360, 9
    u, v, lats, lons = _vortex_winds(ny, nx, nt, np.float32)
    grid = Grid(lats=lats, lons=lons, cyclic_x=True)

    def fn(u_arr, v_arr):
        return ftle_pipeline(u_arr, v_arr, DT, grid, settls_order=4,
                             interp_order=3)

    return fn, (torch.from_numpy(u).to(dev), torch.from_numpy(v).to(dev))


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One SETTLS-2 field through ``n_devices`` latitude blocks of
    ``device`` (default: the CUDA card) on a (max(4n, 24) + 1) x 64 grid,
    each leg held within ``DRYRUN_ATOL`` of the whole-grid pipeline: the
    1-D mesh with ``sigma=1.0``; the 2-D mesh (when n is even) without; the
    windowed route on the 1-D mesh without (on the 2-D mesh it raises, as
    JAX's does, and the leg records why).  Returns each leg's max |error|
    (None for a leg not run) and prints one line."""
    dev = resolve_device(device)
    ny = max(4 * n_devices, 24) + 1   # deliberately non-divisible: exercises
    nx = 64                           # the reflected pad rows
    u, v, lats, lons = _vortex_winds(ny, nx, 3, np.float32)
    grid = Grid(lats=lats, lons=lons, cyclic_x=True)
    u, v = torch.from_numpy(u).to(dev), torch.from_numpy(v).to(dev)
    mesh = parcel_mesh(devices=[dev] * n_devices)
    kw = dict(settls_order=2)

    def err(out, ref, what):
        if out.shape != (ny, nx):
            raise AssertionError(f"{what}: shape {tuple(out.shape)}")
        e = float(torch.nan_to_num(out - ref, nan=0.0).abs().max())
        if not e < DRYRUN_ATOL:
            raise AssertionError(f"{what} mismatch: {e}")
        return e

    legs = {}
    ref = ftle_pipeline(u, v, DT, grid, sigma=1.0, **kw)
    legs["sigma"] = err(ftle_sharded(u, v, DT, grid, mesh, sigma=1.0, **kw),
                        ref, "sharded/single")
    refp = ftle_pipeline(u, v, DT, grid, **kw)
    legs["mesh_2d"] = legs["windowed_2d"] = None
    if n_devices % 2 == 0 and nx % 2 == 0:
        mesh2 = parcel_mesh(devices=[dev] * n_devices, x_parallel=2)
        legs["mesh_2d"] = err(ftle_sharded(u, v, DT, grid, mesh2, **kw),
                              refp, "2-D-mesh/single")
        try:
            ftle_sharded(u, v, DT, grid, mesh2, engine="blockspec", **kw)
        except NotImplementedError as e:
            legs["windowed_2d"] = f"SKIPPED ({str(e).splitlines()[0][:80]})"
    legs["windowed"] = err(ftle_sharded(u, v, DT, grid, mesh,
                                        engine="blockspec", **kw),
                           refp, "sharded-blockspec/single")
    line = (f"max|sharded-single|={legs['sigma']:.2e}, blockspec "
            f"{legs['windowed']:.2e}")
    if legs["mesh_2d"] is not None:
        line += f", 2-D mesh {legs['mesh_2d']:.2e}"
    if legs["windowed_2d"] is not None:
        line += f", 2-D blockspec {legs['windowed_2d']}"
    print(f"dryrun_multichip({n_devices}): ok, shape={(ny, nx)}, {line}")
    return legs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="entry() and a multi-block "
                                "dry run of the port")
    p.add_argument("--blocks", type=int, default=4)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    fn, (u, v) = entry(args.device)
    out = fn(u, v)
    print(f"entry(): FTLE {tuple(out.shape)} on {out.device}, finite rows "
          f"[2:-2]: {bool(torch.isfinite(out[2:-2]).all())}")
    dryrun_multichip(args.blocks, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
