"""Ideal-vortex validation workload — the de-facto acceptance test, on the port.

Counterpart of ``examples/ideal_vortex.py`` (the JAX package's script),
itself a re-creation of the reference's example script
(LagrangianCoherence examples/ideal_vortex.py:211-403):

* build the Rankine-like moving vortex flow (``testing/flows.py``);
* advect a dye tracer forward and backward through the flow (the reference's
  trajectory-based mixing visualisation, ideal_vortex.py:262-279);
* compute attracting (backward) and repelling (forward) FTLE through the
  ``LCS`` facade with ``isglobal=True``, applying the caller-side
  ``log(ftle)/2`` convention (ideal_vortex.py:280-288, SURVEY.md Q9);
* print summary statistics; write PNG figures only with ``--plot`` and
  when matplotlib is importable.

Run::

    python -m lagrangiancoherence_tpu_torch.examples.ideal_vortex [--quick]
        [--plot] [--device cpu]

The default device is the CUDA card; ``--device cpu`` computes on the CPU.
The facade computes in ``torch.get_default_dtype()`` (float32 unless the
caller sets float64).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..api import LCS, parcel_propagation
from ..field import Field
from ..testing import flows


def make_fields(cfg):
    u, v, lats, lons, times = flows.ideal_vortex(**cfg)
    dims = ("time", "latitude", "longitude")
    coords = dict(time=times, latitude=lats, longitude=lons)
    return (Field(u, dims, coords, name="u"),
            Field(v, dims, coords, name="v"), lats, lons)


def dye_advection(U, V, timestep, device):
    """Departure-point dye maps: each parcel carries its origin longitude /
    latitude — the mixing picture of ideal_vortex.py:262-279."""
    return parcel_propagation(U, V, timestep, verbose=False, SETTLS_order=2,
                              cyclic_xboundary=True, device=device)


def lcs_ftle(U, V, timestep, device):
    """The FTLE Field of ``LCS`` with the example's settings: SETTLS-4,
    ``isglobal=True``, the common grid, T20 (attracting for a negative
    ``timestep``, repelling for a positive one)."""
    lcs = LCS(timestep=timestep, timedim="time", SETTLS_order=4,
              device=device)
    return lcs(u=U, v=V, verbose=False, isglobal=True,
               interp_to_common_grid=True, truncation=20)


def main(argv=None) -> dict:
    """Run the workload; returns the summary it prints (times in s, the
    dye spreads, the attracting and repelling statistics, the vortex-ring
    check) with the two FTLE Fields under ``"ftle"``."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--quick", action="store_true",
                   help="fewer time steps for smoke testing")
    p.add_argument("--plot", action="store_true",
                   help="write PNGs (requires matplotlib)")
    p.add_argument("--device", default=None,
                   help="torch device to compute on (default: the CUDA card)")
    args = p.parse_args(argv)

    cfg = dict(flows.VORTEX_CONFIG_SUBTROPICAL)
    if args.quick:
        cfg["nt"] = 5

    U, V, lats, lons = make_fields(cfg)
    timestep = 6 * 3600
    summary = {}

    t0 = time.perf_counter()
    x_fwd, _ = dye_advection(U, V, +timestep, args.device)
    x_bwd, _ = dye_advection(U, V, -timestep, args.device)
    summary["dye_s"] = time.perf_counter() - t0
    summary["forward_lon_std"] = float(np.nanstd(x_fwd.data))
    summary["backward_lon_std"] = float(np.nanstd(x_bwd.data))
    print(f"dye advection: {summary['dye_s']:.2f}s")
    print(f"  forward dye lon spread (std): "
          f"{summary['forward_lon_std']:8.3f} deg")
    print(f"  backward dye lon spread (std): "
          f"{summary['backward_lon_std']:8.3f} deg")

    t0 = time.perf_counter()
    ftle = {name: lcs_ftle(U, V, sign * timestep, args.device)
            for name, sign in (("attracting", -1), ("repelling", +1))}
    summary["ftle_s"] = time.perf_counter() - t0
    print(f"FTLE (attracting + repelling): {summary['ftle_s']:.2f}s")

    # caller-side Lyapunov convention (Q9): lambda = log(sigma_max) / 2
    lam = {name: np.log(f.data[0]) / 2 for name, f in ftle.items()}
    for name, lam_ in lam.items():
        stats = {"max": float(np.nanmax(lam_)),
                 "p99": float(np.nanpercentile(lam_, 99)),
                 "median": float(np.nanmedian(lam_))}
        summary[name] = stats
        print(f"  {name:10s}: max={stats['max']:6.3f} "
              f"p99={stats['p99']:6.3f} median={stats['median']:6.3f}")

    # structural sanity: strong attracting ridge near the vortex
    glats = ftle["attracting"].coords["latitude"]
    glons = ftle["attracting"].coords["longitude"]
    iy = np.argmin(np.abs(glats - cfg["center"][1]))
    ix = np.argmin(np.abs(glons - cfg["center"][0]))
    lam_a = lam["attracting"]
    near = float(np.nanmax(lam_a[max(0, iy - 20):iy + 20,
                                 max(0, ix - 20):ix + 20]))
    far = float(np.nanmedian(lam_a))
    summary.update(vortex_ring_max=near, global_median=far)
    print(f"  vortex-ring max vs global median: {near:.3f} vs {far:.3f}")
    if not near > far:
        raise RuntimeError("no coherent structure found near the vortex")
    summary["ftle"] = ftle

    if args.plot:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            print("matplotlib unavailable; skipping plots")
            return summary
        fig, axs = plt.subplots(2, 2, figsize=(14, 7))
        for ax, (title, data) in zip(axs.flat, [
                ("forward dye (origin lon)", x_fwd.data),
                ("backward dye (origin lon)", x_bwd.data),
                ("attracting log-FTLE/2", lam["attracting"]),
                ("repelling log-FTLE/2", lam["repelling"])]):
            im = ax.imshow(data, origin="lower", aspect="auto")
            ax.set_title(title)
            fig.colorbar(im, ax=ax, shrink=0.8)
        fig.tight_layout()
        fig.savefig("ideal_vortex_summary.png", dpi=150)
        print("wrote ideal_vortex_summary.png")
    return summary


if __name__ == "__main__":
    main()
