"""Moisture-flux FTLE pipeline — the reference's research workload, on the port.

Counterpart of ``examples/area_of_influence.py`` (the JAX package's
script), which mirrors the production pipeline of
LagrangianCoherence LCS/area_of_influence.py:90-295 end to end, with
synthetic ERA5-like inputs in place of the author's private netCDF files.

Stages (reference line citations in parentheses):

1. moisture-flux winds ``u = viwve / tcwv`` (:163-164);
2. coarsen + 8-step window, backward SETTLS-4 FTLE with 3-hourly resampling
   (:174-184), plus single-interval "local" FTLE (:183-188);
3. caller-side ``log`` scaling (:186-187, SURVEY.md Q9);
4. local thresholding of the local-FTLE field (:194-199);
5. Hessian ridge extraction → skeletonize → component filtering
   (:202-211);
6. ridge classification by the along-ridge pressure gradient (:215-229);
7. rainfall attribution: rain on coherent zones (ridges) vs local-strain
   areas vs remainder (:277-285).

``case`` runs stages 1-7 on five host Fields; ``main`` synthesises them,
runs one case and prints its summary.  Run::

    python -m lagrangiancoherence_tpu_torch.examples.area_of_influence
        [--quick] [--coarse-factor N] [--device cpu]

The default device is the CUDA card; ``--device cpu`` computes on the CPU.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
from scipy import ndimage as ndi

from ..api import LCS
from ..field import Field
from ..models.ridge_filter import filter_ridges
from ..models.ridges import find_ridges_spherical_hessian
from ..ops.morphology import skeletonize, threshold_local
from ..utils.logging import timed_stage


def synthetic_era5(nt=16, ny=96, nx=120, seed=0):
    """ERA5-like regional fields: a moisture conveyor (jet + embedded vortex),
    column water vapour, surface pressure with a trough, and rainfall
    concentrated along the moisture front (the JAX example's closed forms;
    six-hourly ``datetime64[ns]`` labels from 2020-01-20)."""
    rng = np.random.RandomState(seed)
    lats = np.linspace(-40.0, 15.0, ny)
    lons = np.linspace(-90.0, -32.0, nx)
    times = np.datetime64("2020-01-20", "ns") \
        + np.arange(nt) * np.timedelta64(6, "h")
    LON, LAT = np.meshgrid(lons, lats)
    t = np.arange(nt)[:, None, None]
    jet = 250.0 * np.exp(-((LAT + 15.0 - 3 * np.sin(2 * np.pi * t / nt))
                           / 6.0) ** 2)
    viwve = jet * (1 + 0.2 * np.sin(2 * np.pi * (LON + 60) / 30.0)) \
        + 20.0 * rng.randn(nt, ny, nx) * 0.05
    viwvn = 100.0 * np.exp(-((LON + 60.0) / 10.0) ** 2) \
        * np.sin(np.pi * (LAT + 40) / 55.0) + 0.2 * t
    tcwv = 30.0 + 20.0 * np.cos(np.deg2rad(LAT)) + 0.0 * t
    mslpres = 101325.0 - 600.0 * np.exp(-(((LON + 60.0) / 8.0) ** 2
                                          + ((LAT + 15.0) / 8.0) ** 2)) \
        + 0.0 * t
    pr = 5.0 * np.exp(-((LAT + 15.0) / 4.0) ** 2) \
        * (1 + 0.3 * np.sin(2 * np.pi * LON / 20.0)) + 0.0 * t
    dims = ("time", "latitude", "longitude")
    coords = dict(time=times, latitude=lats, longitude=lons)

    def f(name, arr):
        return Field(arr, dims, coords, name=name)

    return dict(viwve=f("viwve", viwve), viwvn=f("viwvn", viwvn),
                tcwv=f("tcwv", tcwv), mslpres=f("mslpres", mslpres),
                pr=f("pr", pr))


# the case's root span; the facade's, the diagnostics' and the case's own
# stages nest under it
CASE_SPAN = "AOI case"


def case(viwve, viwvn, tcwv, mslpres, pr, *, coarse_factor: int = 1,
         device=None, kernel: str = "auto") -> dict:
    """One area-of-influence case: stages 1-7 on five host Fields
    (``time``, ``latitude``, ``longitude``; six-hourly, at least 8 levels),
    computed on ``device`` (default: the CUDA card); ``kernel`` is the
    ``LCS`` facade's (``"torch"``: the plain SETTLS step).

    Returns a dict: ``log_ftle`` and ``log_ftle_local`` (2-D Fields),
    ``stamps`` (their time labels), ``threshold_mask`` (the local-FTLE
    field above its local threshold, 0/1), ``ridges_raw`` and ``skeleton``
    (the Hessian ridge mask before and after thinning), ``eigvectors`` (the
    ridges' quirk-Q7 eigenvector Field), ``ridges`` (the filtered
    skeleton, 0 where filtered out), ``ridges_high_gradient`` (the ridges
    kept by the pressure-gradient filter, NaN elsewhere), ``cz_mask`` (the
    convergence zones), ``local_strain`` (0/1), and the four rain sums
    ``total_rain``, ``rain_on_czs``, ``rain_on_local_strain`` and
    ``rain_remainder``."""
    dev = device
    cf = coarse_factor
    with timed_stage(CASE_SPAN):
        # 1. moisture-flux winds (area_of_influence.py:163-164)
        u = (viwve / tcwv).rename("u")
        v = (viwvn / tcwv).rename("v")
        if cf > 1:
            u = u.coarsen(latitude=cf, longitude=cf)
            v = v.coarsen(latitude=cf, longitude=cf)

        # 2. window + FTLE (:180-188)
        u_w = u.isel(time=slice(-8, None))
        v_w = v.isel(time=slice(-8, None))
        lcs = LCS(timestep=-6 * 3600, timedim="time", SETTLS_order=4,
                  kernel=kernel, device=dev)
        ftle = lcs(u=u_w, v=v_w, verbose=False, resample="3h")
        lcs_local = LCS(timestep=-6 * 3600, timedim="time", SETTLS_order=4,
                        kernel=kernel, device=dev)
        ftle_local = lcs_local(u=u.isel(time=slice(-2, None)),
                               v=v.isel(time=slice(-2, None)), verbose=False)
        stamps = (ftle.coords["time"][0], ftle_local.coords["time"][0])

        # 3. log scaling (:186-187)
        ftle = ftle.isel(time=0).copy(data=np.log(ftle.data[0]) / 2)
        ftle_local = ftle_local.isel(time=0).copy(
            data=np.log(ftle_local.data[0]) * 4)

        # 4. local threshold of local FTLE (:194-199)
        block = min(301, (min(ftle_local.shape) // 2) * 2 + 1)
        thresh = threshold_local(ftle_local.data, block, offset=-0.8,
                                 device=dev).cpu().numpy()
        ftle_local_high = (ftle_local.data > thresh).astype(float)

        # 5. ridges: Hessian → skeleton → filter (:202-211)
        ridges, eigmin, dt_prod, eigvectors, gradient, angle = \
            find_ridges_spherical_hessian(ftle, sigma=1.2,
                                          tolerance_threshold=1e-3,
                                          return_eigvectors=True,
                                          isglobal=False, device=dev)
        ridges_raw = ridges.data
        ridges = ridges.copy(data=skeletonize(ridges.data, device=dev)
                             .cpu().numpy())
        skeleton = ridges.data
        ridges = filter_ridges(ridges, ftle,
                               criteria=["mean_intensity",
                                         "major_axis_length"],
                               thresholds=[1.2, 30 / cf])
        ridges = ridges.copy(data=np.where(np.isnan(ridges.data), 0,
                                           ridges.data))

        # 6. pressure-gradient classification (:215-229)
        with timed_stage("Pressure-gradient classification"):
            mslp = mslpres.isel(time=-1).interp_to(
                ridges.coords["latitude"], ridges.coords["longitude"],
                device=dev)
            dpdx = mslp.differentiate("longitude")
            dpdy = mslp.differentiate("latitude")
            u_vec = eigvectors.isel(eigvectors=1)
            v_vec = eigvectors.isel(eigvectors=0)
            pres_grad_parallel = np.sqrt((dpdx.data * v_vec.data) ** 2
                                         + (dpdy.data * u_vec.data) ** 2)
            ridges_pres_grad = ridges.copy(data=ridges.data
                                           * pres_grad_parallel)
            ridges_pres_grad = filter_ridges(ridges, ridges_pres_grad.data,
                                             criteria=["mean_intensity"],
                                             thresholds=[50])

        # 7. rainfall attribution (:277-285)
        with timed_stage("Rain attribution"):
            rain = pr.isel(time=-1).interp_to(
                ridges.coords["latitude"], ridges.coords["longitude"],
                device=dev)
            ridges_bool = ridges.data == 1
            dist = ndi.distance_transform_edt(~ridges_bool)
            cz_mask = (ridges.data > 0) | ((ftle_local_high > 0)
                                           & (dist < 12))
            local_strain = np.clip(ftle_local_high - cz_mask.astype(float),
                                   0, None)
            total_rain = float(np.nansum(rain.data))
            czs_rain = float(np.nansum(cz_mask * rain.data))
            lstr_rain = float(np.nansum(local_strain * rain.data))
            rest = total_rain - czs_rain - lstr_rain

    return {"log_ftle": ftle, "log_ftle_local": ftle_local,
            "stamps": stamps, "threshold_mask": ftle_local_high,
            "ridges_raw": ridges_raw, "skeleton": skeleton,
            "eigvectors": eigvectors, "ridges": ridges,
            "ridges_high_gradient": ridges_pres_grad, "cz_mask": cz_mask,
            "local_strain": local_strain, "total_rain": total_rain,
            "rain_on_czs": czs_rain, "rain_on_local_strain": lstr_rain,
            "rain_remainder": rest}


def main(argv=None) -> dict:
    """Run the workload; returns the summary it prints (elapsed s, ridge
    pixel counts, the rain attribution)."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--quick", action="store_true")
    p.add_argument("--coarse-factor", type=int, default=1)
    p.add_argument("--device", default=None,
                   help="torch device to compute on (default: the CUDA card)")
    args = p.parse_args(argv)

    data = synthetic_era5(nt=10 if args.quick else 16)
    t0 = time.time()
    out = case(**data, coarse_factor=args.coarse_factor, device=args.device)
    total_rain, czs_rain = out["total_rain"], out["rain_on_czs"]
    lstr_rain, rest = out["rain_on_local_strain"], out["rain_remainder"]

    summary = {"elapsed_s": time.time() - t0,
               "ridge_pixels": int((out["ridges"].data > 0).sum()),
               "high_pressure_gradient_ridge_pixels":
                   int(np.nansum(out["ridges_high_gradient"].data > 0)),
               "total_rain": total_rain, "rain_on_czs": czs_rain,
               "rain_on_local_strain": lstr_rain, "rain_remainder": rest}
    print(f"elapsed: {summary['elapsed_s']:.1f}s")
    print(f"ridge pixels (filtered): {summary['ridge_pixels']}")
    print(f"high-pressure-gradient ridge pixels: "
          f"{summary['high_pressure_gradient_ridge_pixels']}")
    print(f"rain attribution: total={total_rain:.0f}  "
          f"on CZs={czs_rain:.0f}  on local strain={lstr_rain:.0f}  "
          f"remainder={rest:.0f}")
    if not (czs_rain >= 0 and total_rain > 0):
        raise RuntimeError("rain attribution failed")
    print("AREA-OF-INFLUENCE PIPELINE OK")
    return summary


if __name__ == "__main__":
    main()
