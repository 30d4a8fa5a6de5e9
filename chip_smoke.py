"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Usage, from the root of a checkout, on a machine with one CUDA card::

    python3 chip_smoke.py

It builds the port's CUDA kernel from the sources in the checkout, holds it
against its plain PyTorch version on the card, drives the flagship FTLE
pipeline (1440x721 parcels, 33 time levels, SETTLS order 4, float32) through
it, checks the float32 pipeline against a scipy oracle, and times the kernel
and the pipeline against the plain version.  Each phase prints its results;
the line before the last is the kernel record
``{"kernels": [{"name", "route", "source", "replaces", "launches",
"max_abs_err", "ms", "plain_ms"}]}`` and the last line is
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero, as does
a machine without a CUDA device or a directory without the package.

This script imports neither JAX nor the JAX package: the oracle below is a
plain numpy/scipy statement of the reference semantics
(LagrangianCoherence LCS/trajectory.py:8-144, LCS.py:142-225, tools.py:11-267).
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

NT = 33                  # 8 days at 6 h (bench.py:56)
DT = -6.0 * 3600.0       # backward integration
SETTLS_ORDER = 4
ORDER = 3
# max |K1 - plain| over one gather group: the committed float32 per-value
# bound (BASELINE.md:27); float64 differs only where float32 would round
GATHER_F32_ATOL = 5e-5
GATHER_F64_ATOL = 1e-12
FOLD_TOL = 2e-6          # rtol = atol, tests_tpu/test_device_parity.py:138
LOG_FTLE_P99_BOUND = 1.5e-3
POSITION_F64_ATOL = 1e-9
REPS = 3
KERNEL_SOURCE = "lagrangiancoherence_tpu_torch/ops/csrc/spline_gather.cu"
KERNEL_REPLACES = "lagrangiancoherence_tpu/ops/pallas_interp.py:793"


# ---------------------------------------------------------------------------
# Inputs, made from closed forms (no random state)
# ---------------------------------------------------------------------------

def bench_winds(lats, lons, nt):
    """bench.py:62-67: a 25 m/s jet with planetary waves, (nt, ny, nx) f64."""
    LON, LAT = np.meshgrid(np.deg2rad(lons), np.deg2rad(lats))
    base_u = 25.0 * np.cos(LAT) + 3.0 * np.cos(3 * LON) * np.sin(2 * LAT)
    base_v = 3.0 * np.sin(3 * LON) * np.cos(2 * LAT)
    t = np.arange(nt)[:, None, None]
    u = base_u[None] * (1.0 + 0.05 * np.sin(2 * np.pi * t / nt))
    v = base_v[None] * (1.0 + 0.05 * np.cos(2 * np.pi * t / nt))
    return u, v


def flagship_positions(grid):
    """tests_tpu/test_device_parity.py:41-55 in float32 numpy: midlatitude
    drift, violent shear and a polar full-circle whirl, Q5-wrapped."""
    px0, py0 = (a.astype(np.float32) for a in grid.mesh_xy)
    coslat = np.cos(np.deg2rad(py0))
    whirl = 500.0 * np.sin(py0 / 7.0) * (1.0 - coslat) ** 2
    shear = 40.0 * np.sin(py0 / 10.0) * np.cos(px0 / 15.0)
    px = px0 + 12.0 * np.sin(py0 / 30.0) + shear + whirl
    py = np.clip(py0 + 8.0 * np.cos(px0 / 40.0), -90.0, 90.0)
    px = np.where(px > 180.0, -180.0 + (px % 180.0), px)
    px = np.where(px < -180.0, px % 180.0, px)
    return px.astype(np.float32), py.astype(np.float32)


# ---------------------------------------------------------------------------
# scipy oracle of the reference semantics (quirks Q1-Q6)
# ---------------------------------------------------------------------------

EARTH_RADIUS = 6371000.0


def _oracle_interp(values, lats, lons, px, py, order):
    """xr_map_coordinates(isglobal=True) (LagrangianCoherence LCS/tools.py:11-48)."""
    from scipy.ndimage import map_coordinates
    ny, nx = values.shape
    new_x = nx * (px - lons.min()) / (lons.max() - lons.min())
    new_y = ny * (py - lats.min()) / (lats.max() - lats.min())
    out = np.empty((ny, nx))
    inner = slice(order, ny - order)
    out[inner] = map_coordinates(
        values, [new_y[inner].ravel(), new_x[inner].ravel()], order=order,
        mode="wrap").reshape(-1, nx)
    pole = np.r_[0:order, ny - order:ny]
    out[pole] = map_coordinates(
        values, [new_y[pole].ravel(), new_x[pole].ravel()], order=1,
        mode="constant").reshape(-1, nx)
    return out


def _oracle_positions(u, v, lats, lons, dt, settls_order, order):
    """Cyclic SETTLS (LagrangianCoherence LCS/trajectory.py:80-124)."""
    conv_y = 180.0 / (EARTH_RADIUS * np.pi)
    conv_x = (conv_y / np.abs(np.cos(lats * np.pi / 180.0)))[:, None]

    def clamp_wrap(px, py):
        py = np.where(py > lats.min(), py, lats.min())
        py = np.where(py < lats.max(), py, lats.max())
        px = np.where(px > -180.0, px, px % 180.0)
        return np.where(px < 180.0, px, -180.0 + px % 180.0), py

    px, py = np.meshgrid(lons, lats)
    for t in range(u.shape[0] - 1):
        ua = _oracle_interp(u[t], lats, lons, px, py, order)
        va = _oracle_interp(v[t], lats, lons, px, py, order)
        py, px = py + dt * conv_y * va, px + dt * conv_x * ua
        px, py = clamp_wrap(px, py)
        for _ in range(settls_order):
            ut, vt, un, vn = (_oracle_interp(f, lats, lons, px, py, order)
                              for f in (u[t], v[t], u[t + 1], v[t + 1]))
            py = py + 0.5 * dt * conv_y * (va + 2 * vt - vn)
            px = px + 0.5 * dt * conv_x * (ua + 2 * ut - un)
            px, py = clamp_wrap(px, py)
    return px, py


def _oracle_derivative(values, lats, lons, dim):
    """4th-order stencil in float32 (Q6) with one-sided edge rows and cyclic
    longitude, then the spherical metric (tools.py:190-267)."""
    a = values.astype(np.float32)
    ax = 0 if dim == 0 else 1
    p1, m1 = np.roll(a, -1, ax), np.roll(a, 1, ax)
    p2, m2 = np.roll(a, -2, ax), np.roll(a, 2, ax)
    d = (4 / 3) * (p1 - m1) / 2 - (1 / 3) * (p2 - m2) / 4
    if dim == 0:
        d[:2] = (a[1:3] - a[:2]) / 2
        d[-2:] = (a[-2:] - a[-3:-1]) / 2
        return d.astype(np.float64) / ((np.pi / 180) * (lats[1] - lats[0])
                                       * EARTH_RADIUS)
    dx = (np.pi / 180) * (lons[1] - lons[0]) * EARTH_RADIUS \
        * np.cos(lats * np.pi / 180)
    return d.astype(np.float64) / dx[:, None]


def oracle_ftle(u, v, lats, lons, dt, settls_order, order=ORDER):
    """Q1-compatible FTLE norm of the scrambled [3,3] deformation matrix
    (LagrangianCoherence LCS/LCS.py:142-157)."""
    px, py = _oracle_positions(u, v, lats, lons, dt, settls_order, order)
    lon = px * np.pi / 180
    colat = (py - 90.0) * np.pi / 180
    X = EARTH_RADIUS * np.sin(colat) * np.cos(lon)
    Y = EARTH_RADIUS * np.sin(colat) * np.sin(lon)
    Z = EARTH_RADIUS * np.cos(colat)
    comps = [_oracle_derivative(f, lats, lons, dim)
             for f in (X, Y, Z) for dim in (1, 0)]
    tensor = np.stack(comps + [np.zeros_like(X)] * 3)        # (9, ny, nx)
    return np.linalg.norm(tensor.reshape(3, 3, -1), ord=2,
                          axis=(0, 1)).reshape(X.shape)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def log(msg=""):
    print(msg, flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA device", file=sys.stderr)
        return 2

    from lagrangiancoherence_tpu_torch import Grid, ftle_pipeline
    from lagrangiancoherence_tpu_torch.grid import global_quarter_degree_grid
    from lagrangiancoherence_tpu_torch.models.settls import \
        parcel_propagation_core
    from lagrangiancoherence_tpu_torch.ops import _build, cuda_interp
    from lagrangiancoherence_tpu_torch.ops.interp import (
        interp_at_parcels_multi, prefilter)

    failures = []

    def check(ok, what):
        log(f"  {'ok  ' if ok else 'FAIL'} {what}")
        if not ok:
            failures.append(what)

    # -- 1. device ----------------------------------------------------------
    log("== phase 1: device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    card = smi.splitlines()[0].strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log(f"tf32 before: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32} "
        f"float32_matmul_precision={torch.get_float32_matmul_precision()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("tf32 now: matmul=False cudnn=False")
    dev = torch.device("cuda", 0)

    # -- 2. build ------------------------------------------------------------
    log("== phase 2: build K1")
    lib_path, build_s, build_log = _build.build()
    _build.load_library()
    log(f"built {lib_path.name} in {build_s:.2f} s")
    for line in build_log.splitlines():
        if "Used" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # -- 3. K1 against the plain version --------------------------------------
    log("== phase 3: K1 vs plain on the card")
    grid = global_quarter_degree_grid()
    ny, nx = grid.shape
    bounds = dict(x_min=grid.x_min, x_max=grid.x_max, y_min=grid.y_min,
                  y_max=grid.y_max)
    u64, v64 = bench_winds(grid.lats, grid.lons, NT)
    u32 = torch.tensor(u64.astype(np.float32), device=dev)
    v32 = torch.tensor(v64.astype(np.float32), device=dev)
    pxn, pyn = flagship_positions(grid)

    def group_err(W, CW, px, py, f0, nf, order, row_offset=0):
        got, flag = cuda_interp.cuda_interp_multi(
            W, CW, px, py, f0=f0, nf=nf, order=order, row_offset=row_offset,
            **bounds)
        flat = (W.reshape(-1, ny, nx), CW.reshape(-1, ny, nx))
        want = interp_at_parcels_multi(flat[0][f0:f0 + nf],
                                       flat[1][f0:f0 + nf], px, py,
                                       order=order, row_offset=row_offset,
                                       **bounds)
        same_nan = bool(torch.equal(torch.isnan(got), torch.isnan(want)))
        fin = torch.isfinite(want)
        err = float((got - want).abs()[fin].max()) if fin.any() else 0.0
        return err, int(flag), same_nan, got

    gather_err = {}
    for dtype, tol in ((torch.float32, GATHER_F32_ATOL),
                       (torch.float64, GATHER_F64_ATOL)):
        W = torch.stack([u32.to(dtype), v32.to(dtype)], dim=1)
        CW = prefilter(W, order=ORDER)
        px = torch.tensor(pxn, dtype=dtype, device=dev)
        py = torch.tensor(pyn, dtype=dtype, device=dev)
        name = str(dtype).replace("torch.", "")
        worst = 0.0
        for f0, nf, order in ((0, 4, 3), (2 * (NT - 2), 4, 3), (6, 2, 3),
                              (0, 4, 1)):
            coeffs = CW if order == 3 else W
            err, flag, same_nan, _ = group_err(W, coeffs, px, py, f0, nf,
                                               order)
            check(err <= tol and flag == 0 and same_nan,
                  f"{name} flagship group f0={f0} F={nf} order={order}: "
                  f"max|K1-plain|={err:.3e} (<= {tol:g}) flag={flag}")
            worst = max(worst, err) if order == 3 and nf == 4 else worst
        # a block of home rows 1..8: two pole-home rows, then spline rows
        err, flag, same_nan, _ = group_err(W, CW, px[1:9].contiguous(),
                                           py[1:9].contiguous(), 0, 4, 3,
                                           row_offset=1)
        check(err <= tol and same_nan,
              f"{name} row block 1..8 (row_offset=1): max|K1-plain|="
              f"{err:.3e} (<= {tol:g})")
        gather_err[name] = worst
        del W, CW

    # fold boundary: the grid's own last column scales to exactly n
    fl_lats = np.linspace(-90.0, 90.0, 16)
    fl_lons = np.linspace(-180.0, 180.0 - 360.0 / 128, 128)
    LON, LAT = np.meshgrid(np.deg2rad(fl_lons), np.deg2rad(fl_lats))
    fu = 20.0 * np.cos(LAT) + 2.0 * np.cos(3 * LON) * np.sin(2 * LAT)
    raw = torch.tensor(np.stack([fu, 0.5 * fu]), dtype=torch.float32,
                       device=dev)
    fpx = torch.tensor(np.broadcast_to(fl_lons, (16, 128)).copy(),
                       dtype=torch.float32, device=dev)
    fpy = torch.tensor(np.broadcast_to(fl_lats[:, None], (16, 128)).copy(),
                       dtype=torch.float32, device=dev)
    fb = dict(x_min=fl_lons[0], x_max=fl_lons[-1], y_min=fl_lats[0],
              y_max=fl_lats[-1])
    craw = prefilter(raw, order=ORDER)
    got, _ = cuda_interp.cuda_interp_multi(raw, craw, fpx, fpy, order=ORDER,
                                           **fb)
    want = interp_at_parcels_multi(raw, craw, fpx, fpy, order=ORDER, **fb)
    rel = float(((got - want).abs() / (FOLD_TOL + FOLD_TOL * want.abs()))
                .max())
    check(rel <= 1.0, f"fold-boundary last column: max|K1-plain|="
          f"{float((got - want).abs().max()):.3e} (rtol=atol={FOLD_TOL:g})")

    # pole rows flung to O(2**27) degrees, and NaN positions
    pxe, pye = pxn.copy(), pyn.copy()
    pxe[:ORDER] = 2.0 ** 27
    pxe[-ORDER:] = -2.0 ** 27
    r_far, r_nan, r_nany = ny // 7, ny // 3, ny // 2     # spline rows
    pxe[r_far, :7] = 2.0 ** 27
    pxe[0, 50] = pye[-1, 51] = pxe[r_nan, :5] = pye[r_nany, 9] = np.nan
    W = torch.stack([u32, v32], dim=1)
    CW = prefilter(W, order=ORDER)
    err, flag, same_nan, got = group_err(
        W, CW, torch.tensor(pxe, device=dev), torch.tensor(pye, device=dev),
        0, 4, ORDER)
    poles_zero = bool((got[:, :ORDER] == 0).all() and (got[:, -ORDER:] == 0)
                      .all())
    nan_rows = bool(torch.isnan(got[:, r_nan, :5]).all()
                    and torch.isnan(got[:, r_nany, 9]).all())
    check(err <= GATHER_F32_ATOL and same_nan and poles_zero and nan_rows,
          f"pole rows at 2**27 deg and NaN positions: max|K1-plain|="
          f"{err:.3e}, NaN pattern equal={same_nan}, pole rows 0="
          f"{poles_zero}, spline-row NaN={nan_rows}")

    # -- 4. main path ---------------------------------------------------------
    log("== phase 4: flagship ftle_pipeline through K1 "
        f"({nx}x{ny}, T={NT}, settls_order={SETTLS_ORDER}, f32)")
    expected = (NT - 1) * (1 + SETTLS_ORDER)
    torch.cuda.synchronize()
    cuda_interp.LAUNCHES = 0
    t0 = time.perf_counter()
    norm, overflow = ftle_pipeline(u32, v32, DT, grid,
                                   settls_order=SETTLS_ORDER,
                                   interp_order=ORDER, kernel="cuda",
                                   return_overflow=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = cuda_interp.LAUNCHES
    finite = bool(torch.isfinite(norm[2:-2]).all())
    log(f"first call {first_s:.3f} s; FTLE norm range "
        f"[{float(norm[2:-2].min()):.4g}, {float(norm[2:-2].max()):.4g}]")
    check(launches == expected, f"K1 launches {launches} == {expected}")
    check(int(overflow) == 0, f"overflow {int(overflow)} == 0")
    check(norm.shape == (ny, nx) and finite,
          f"shape {tuple(norm.shape)}, rows [2:-2] finite={finite}")

    # -- 5. end-to-end accuracy ------------------------------------------------
    log("== phase 5: 1-degree global config vs the scipy oracle")
    lats1 = np.linspace(-90.0, 90.0, 181)
    lons1 = np.linspace(-180.0, 179.0, 360)
    grid1 = Grid(lats=lats1, lons=lons1, cyclic_x=True)
    u1, v1 = bench_winds(lats1, lons1, 9)
    got1 = ftle_pipeline(torch.tensor(u1, dtype=torch.float32, device=dev),
                         torch.tensor(v1, dtype=torch.float32, device=dev),
                         DT, grid1, settls_order=2, interp_order=ORDER,
                         kernel="cuda").cpu().numpy()
    want1 = oracle_ftle(u1, v1, lats1, lons1, DT, settls_order=2)
    mask = np.isfinite(want1) & np.isfinite(got1) & (want1 > 0) & (got1 > 0)
    mask[:4] = mask[-4:] = False     # the order-1/'constant' pole band
    p99 = float(np.percentile(np.abs(np.log(got1[mask])
                                     - np.log(want1[mask])), 99))
    check(p99 <= LOG_FTLE_P99_BOUND,
          f"f32 K1 pipeline p99 |dlog-FTLE| vs oracle = {p99:.3e} "
          f"(<= {LOG_FTLE_P99_BOUND:g})")
    u1d = torch.tensor(u1, device=dev)
    v1d = torch.tensor(v1, device=dev)
    pos = {k: parcel_propagation_core(u1d, v1d, DT, grid1, settls_order=2,
                                      interp_order=ORDER, kernel=k)
           for k in ("cuda", "torch")}
    dpos = max(float((a - b).abs().max())
               for a, b in zip(pos["cuda"], pos["torch"]))
    check(dpos <= POSITION_F64_ATOL,
          f"f64 K1 vs plain departure points: max diff {dpos:.3e} deg "
          f"(<= {POSITION_F64_ATOL:g})")

    # -- 6. times --------------------------------------------------------------
    log(f"== phase 6: times on {card}")

    def pipeline_s(kernel):
        ftle_pipeline(u32, v32, DT, grid, settls_order=SETTLS_ORDER,
                      interp_order=ORDER, kernel=kernel)      # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPS):
            ftle_pipeline(u32, v32, DT, grid, settls_order=SETTLS_ORDER,
                          interp_order=ORDER, kernel=kernel)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / REPS

    torch.cuda.reset_peak_memory_stats()
    k1_s = pipeline_s("cuda")
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    plain_s = pipeline_s("torch")
    log(f"flagship fields/s: K1 {1.0 / k1_s:.4f} ({k1_s * 1e3:.1f} ms/field, "
        f"peak {peak_gb:.2f} GiB), plain {1.0 / plain_s:.4f} "
        f"({plain_s * 1e3:.1f} ms/field) [{card}]")

    px = torch.tensor(pxn, device=dev)
    py = torch.tensor(pyn, device=dev)

    def group_ms(fn, n):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    k1_ms = group_ms(lambda: cuda_interp.cuda_interp_multi(
        W, CW, px, py, f0=0, nf=4, order=ORDER, **bounds), 50)
    plain_ms = group_ms(lambda: interp_at_parcels_multi(
        W.reshape(-1, ny, nx)[:4], CW.reshape(-1, ny, nx)[:4], px, py,
        order=ORDER, **bounds), 10)
    log(f"F=4 gather group at the flagship: K1 {k1_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms [{card}]")

    # stage breakdown of one K1 field (host clock around synchronised stages)
    from lagrangiancoherence_tpu_torch.models.ftle import (flowmap_gradient,
                                                           ftle_norm)
    from lagrangiancoherence_tpu_torch.models.settls import (grid_state,
                                                             settls_scan)
    state = grid_state(grid, ORDER, dtype=torch.float32, device=dev)
    mats = (state["prefilter_y"], state["prefilter_x"])
    stages = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cu = prefilter(u32, order=ORDER, matrices=mats)
    cv = prefilter(v32, order=ORDER, matrices=mats)
    torch.cuda.synchronize()
    stages["prefilter_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    dt = torch.full((), DT, dtype=torch.float32, device=dev)
    spx, spy, _ = settls_scan(u32, v32, cu, cv, state["px0"], state["py0"],
                              dt, state["conv_x"], grid,
                              settls_order=SETTLS_ORDER, interp_order=ORDER,
                              return_traj=False, kernel="cuda")
    torch.cuda.synchronize()
    stages["settls_scan_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ftle_norm(flowmap_gradient(spx, spy, grid))
    torch.cuda.synchronize()
    stages["gradient_norm_ms"] = (time.perf_counter() - t0) * 1e3
    log("stages (K1 field): " + json.dumps(
        {k: round(v, 3) for k, v in stages.items()}) + f" [{card}]")

    if failures:
        log(f"chip_smoke: {len(failures)} check(s) failed:")
        for f in failures:
            log(f"  {f}")
        return 1

    log(json.dumps({"kernels": [{
        "name": "spline_gather", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": gather_err["float32"], "ms": k1_ms,
        "plain_ms": plain_ms}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
