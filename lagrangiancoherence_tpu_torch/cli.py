"""Batch CLI: one FTLE field per input file — PyTorch.

Counterpart of ``lagrangiancoherence_tpu/cli.py`` with the same argparse
surface (timestep, timedim, SETTLS order, subdomain string
``lon1/lon2/lat1/lat2``, input, output, return_traj), plus ``--device``
(default ``cuda``; a machine without a CUDA device needs ``--device cpu``).
Inputs are **never deleted** (quirk Q8 fixed), and outputs are idempotent —
an existing output file short-circuits the run (``--overwrite`` to force),
the retry-the-file failure-recovery contract (SURVEY.md §5).

Usage::

    python -m lagrangiancoherence_tpu_torch.cli --device cuda \\
        --timestep -21600 --settls-order 4 --isglobal \\
        input.nc output.nc
"""
from __future__ import annotations

import argparse
import os
import sys

from .api import LCS
from .utils.io import open_dataset, save_dataset
from .utils.logging import configure_verbosity, logger


def parse_subdomain(spec: str | None):
    if not spec:
        return None
    lon1, lon2, lat1, lat2 = (float(x) for x in spec.split("/"))
    return {"longitude": slice(lon1, lon2), "latitude": slice(lat1, lat2)}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="lagrangiancoherence_tpu_torch",
        description="Compute an FTLE field from a u/v wind file (netCDF4/HDF5)")
    p.add_argument("input", help="input file with variables u and v")
    p.add_argument("output", help="output file for the FTLE field")
    p.add_argument("--timestep", type=float, default=-6 * 3600,
                   help="integration step in seconds; negative = backward")
    p.add_argument("--timedim", default="time")
    p.add_argument("--settls-order", type=int, default=4)
    p.add_argument("--subdomain", default=None,
                   help="crop 'lon1/lon2/lat1/lat2' (strict bounds)")
    p.add_argument("--isglobal", action="store_true",
                   help="regrid to the common global grid, truncate, cyclic x")
    p.add_argument("--truncation", type=int, default=20)
    p.add_argument("--interp-order", type=int, default=3,
                   choices=(0, 1, 2, 3, 4, 5),
                   help="spline order (scipy map_coordinates parity; the "
                        "CUDA gather implements 1/3 and the API takes the "
                        "plain gather for the rest)")
    p.add_argument("--resample", default=None,
                   help="time-resample frequency, e.g. 3h")
    p.add_argument("--gauss-sigma", type=float, default=None)
    p.add_argument("--return-traj", action="store_true",
                   help="also write departure-point files")
    p.add_argument("--device", default="cuda",
                   help="torch device to compute on (default cuda)")
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--quiet", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    configure_verbosity(not args.quiet)

    if os.path.exists(args.output) and not args.overwrite:
        logger.info("output %s exists; skipping (idempotent batch contract)",
                    args.output)
        return 0

    ds = open_dataset(args.input)
    lcs = LCS(timestep=args.timestep, timedim=args.timedim,
              SETTLS_order=args.settls_order,
              subdomain=parse_subdomain(args.subdomain),
              gauss_sigma=args.gauss_sigma,
              return_dpts=args.return_traj, device=args.device)
    out = lcs(ds=ds, verbose=not args.quiet, isglobal=args.isglobal,
              resample=args.resample, truncation=args.truncation,
              traj_interp_order=args.interp_order,
              return_traj=args.return_traj)

    if args.return_traj:
        ftle, x_dep, y_dep, x_traj, y_traj = out
        save_dataset({"ftle": ftle}, args.output)
        stem, ext = os.path.splitext(args.output)
        save_dataset({"x_departure": x_dep}, f"{stem}_x_departure{ext}")
        save_dataset({"y_departure": y_dep}, f"{stem}_y_departure{ext}")
        logger.info("wrote %s (+ departure files)", args.output)
    else:
        save_dataset({"ftle": out}, args.output)
        logger.info("wrote %s", args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
