"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Usage, from the root of a checkout, on a machine with one CUDA card::

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout (K1
``spline_gather``; K2 ``tile_window_gather``, K3 ``sub_window_gather`` and K4
``pole_window_gather``), holds each against its plain PyTorch version on the
card, drives the flagship FTLE pipeline (1440x721 parcels, 33 time levels,
SETTLS order 4, float32) through both gather routes — ``engine="auto"``
(K1) and ``engine="blockspec"`` (K2-K4) — checks the float32 pipelines
against a scipy oracle, times the kernels and the pipelines against the
plain versions, and profiles one field of each route (device busy time,
kernels per field, idle share).  Each phase prints its results; the line
before the last is the kernel record ``{"kernels": [{"name", "route",
"source", "replaces", "launches", "max_abs_err", "ms", "plain_ms"}]}``
(times: medians of CUDA-event trials) and the last line is
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
TRIALS = 7               # CUDA-event trials per timed launch group
KERNEL_SOURCE = "lagrangiancoherence_tpu_torch/ops/csrc/spline_gather.cu"
KERNEL_REPLACES = "lagrangiancoherence_tpu/ops/pallas_interp.py:793"
WINDOW_SOURCE = "lagrangiancoherence_tpu_torch/ops/csrc/window_gather.cu"
_PALLAS = "lagrangiancoherence_tpu/ops/pallas_interp.py"
# the window kernels by name and mode, and the Pallas kernel each replaces
WINDOW_KERNELS = {
    "tile_window_gather.dense": f"{_PALLAS}:715",    # _grid_kernel
    "tile_window_gather.list": f"{_PALLAS}:772",     # _list_kernel
    "sub_window_gather": f"{_PALLAS}:648",           # _sub_grid_kernel
    "pole_window_gather.dense": f"{_PALLAS}:738",    # _pole_grid_kernel
    "pole_window_gather.list": f"{_PALLAS}:755",     # _pole_list_kernel
}
FORCED_POLE_LADDER = (8, 16, 288)   # slots escalate to levels 2 and 3


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


def whirl_positions(grid):
    """tests/test_pallas_interp.py:27-32 in float32 numpy: a full-circle
    zonal whirl, whose tiles need the full-longitude tiers."""
    px0, py0 = (a.astype(np.float32) for a in grid.mesh_xy)
    px = px0 + 700.0 * np.sin(py0 / 7.0) * np.cos(px0 / 11.0)
    py = np.clip(py0 + 4.0 * np.sin(px0 / 20.0), -90.0, 90.0)
    px = np.where(px > 180.0, -180.0 + (px % 180.0), px)
    px = np.where(px < -180.0, px % 180.0, px)
    return px.astype(np.float32), py.astype(np.float32)


def shear_positions(grid):
    """tests/test_pallas_interp.py:34-35: a violent shear, which clamps
    tier-A windows of 16 rows."""
    px0, py0 = (a.astype(np.float32) for a in grid.mesh_xy)
    px = px0 + 120.0 * np.sin(py0 / 10.0) * np.cos(px0 / 15.0)
    py = np.clip(py0 + 60.0 * np.sin(px0 / 20.0), -90.0, 90.0)
    px = np.where(px > 180.0, -180.0 + (px % 180.0), px)
    px = np.where(px < -180.0, px % 180.0, px)
    return px.astype(np.float32), py.astype(np.float32)


# ---------------------------------------------------------------------------
# The window kernels of one gather group, on the card and plain
# ---------------------------------------------------------------------------

def window_launches(W, CW, px, py, *, f0, nf, wy, bounds, ladder,
                    order=ORDER, retry_tiles=256, pole_ladder=None):
    """Every window-kernel launch of one ``engine="blockspec"`` gather group
    at positions ``px``/``py`` with escalation ladder ``ladder``
    (``window_interp.spline_launches``), plus the pole launches of the
    group's pole-home rows, sorted as the hoisted pole loop sorts them.
    Returns ([(name, out shape, n flags, run)], counts),
    where ``run(kind, out, flags, overflow)`` launches the kernel (kind
    "cuda") or its plain version (kind "plain") on the same inputs."""
    import torch
    from lagrangiancoherence_tpu_torch.ops import pole as PL
    from lagrangiancoherence_tpu_torch.ops import window_interp as WI
    from lagrangiancoherence_tpu_torch.ops.tiles import route_tiles
    ny, nx = px.shape
    fns = {kind: WI.kernel_functions(k) for kind, k in (("cuda", "cuda"),
                                                 ("plain", "torch"))}
    rt = route_tiles(px, py, ny=ny, nx=nx, order=order, wy=wy,
                     retry_tiles=retry_tiles, ladder=ladder, **bounds)
    rx, ry = PL.pole_rows(px, order), PL.pole_rows(py, order)
    perm, _ = PL.pole_sort_state(rx, ry, order=order, ny=ny, nx=nx, **bounds)
    geom = dict(order=order, nx=nx)
    pxf = PL.pole_apply_perm(rx, perm, **geom)
    poles, pr = WI.pole_launches(
        W.reshape(-1, ny, nx), pxf, PL.pole_apply_perm(ry, perm, **geom),
        torch.ones_like(pxf), f0=f0, nf=nf, bounds=bounds,
        ladder=pole_ladder or PL.POLE_LADDER)
    shapes = {"spline": (nf, rt.gy * 8, rt.gx * 128),
              "pole": (nf, pr.ys[0].shape[0] * 8, 128)}
    runs = []
    for part, launches in (("spline", WI.spline_launches(
            rt, CW.reshape(-1, ny, nx), f0=f0, nf=nf, order=order, wy=wy)),
            ("pole", poles)):
        for ln in launches:
            runs.append((f"{ln.kernel}.{ln.mode}".rstrip("."), shapes[part],
                         ln.n_flags,
                         lambda kind, o, f, v, ln=ln: ln.run(
                             fns[kind][ln.kernel], o, f, v)))
    counts = {"tiers": [int(t.count) for t in rt.tiers],
              "tierA": int(rt.liveA.sum()),
              "sub": int(rt.liveS.sum()) if rt.liveS is not None else 0,
              "pole_levels": [int(pr.fit1.sum())]
              + [int(pr.want[lvl].sum()) for lvl in (1, 2)]}
    return runs, counts


def compare_launches(runs, dtype, device):
    """Run each launch through the kernel and its plain version on zeroed
    outputs; per kernel name: (max |kernel - plain|, flags and overflow
    bits equal, overflow word of the kernel, slots flagged)."""
    import torch
    res = {}
    for name, shape, n_flags, run in runs:
        outs, flags, ovf = {}, {}, {}
        for kind in ("cuda", "plain"):
            outs[kind] = torch.zeros(shape, dtype=dtype, device=device)
            flags[kind] = torch.full((n_flags,), -1, dtype=torch.int32,
                                     device=device)
            ovf[kind] = torch.zeros((1,), dtype=torch.int32, device=device)
            run(kind, outs[kind], flags[kind], ovf[kind])
        torch.cuda.synchronize()
        a, b = outs["cuda"], outs["plain"]
        same_nan = bool(torch.equal(torch.isnan(a), torch.isnan(b)))
        fin = torch.isfinite(b)
        err = float((a - b).abs()[fin].max()) if fin.any() else 0.0
        if not same_nan:
            err = float("inf")
        eq = (torch.equal(flags["cuda"], flags["plain"])
              and torch.equal(ovf["cuda"], ovf["plain"]))
        e0, eq0, o0, n0 = res.get(name, (0.0, True, 0, 0))
        res[name] = (max(e0, err), eq0 and eq, o0 | int(ovf["cuda"]),
                     n0 + int((flags["cuda"] > 0).sum()))
    return res


def event_ms(fn, n):
    """CUDA-event milliseconds per call of ``fn``, after a warm-up call:
    one value per trial of ``n`` calls, TRIALS trials."""
    import torch
    fn()
    out = []
    for _ in range(TRIALS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / n)
    return out


def spread(ms):
    """(median, min, max) of a list of trial times."""
    return float(np.median(ms)), min(ms), max(ms)


def time_launches(runs, dtype, device, reps, plain_reps):
    """Trial times (``event_ms``) of one gather group's launches of each
    kernel name, for the kernels and for the plain versions."""
    import torch
    bufs = [(name, torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros((n,), dtype=torch.int32, device=device),
             torch.zeros((1,), dtype=torch.int32, device=device), run)
            for name, shape, n, run in runs]
    times = {}
    for kind, n in (("cuda", reps), ("plain", plain_reps)):
        for name in WINDOW_KERNELS:
            mine = [b for b in bufs if b[0] == name]

            def group(mine=mine, kind=kind):
                for _, o, f, v, run in mine:
                    run(kind, o, f, v)
            times[name, kind] = event_ms(group, n)
    return times


def profile_field(run):
    """``torch.profiler`` over one call of ``run`` (after a warm-up):
    the device's busy milliseconds (the union of its op intervals), the
    span from its first op to its last, the number of device ops and of
    kernels among them, and the five kernels with the most device time
    as (name, ms, launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    ops = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end, by_name = 0.0, float("-inf"), {}
    for t0, t1, name in ops:
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (t1 - t0) / 1e3, n + 1)
    kernels = sum(n for name, (_, n) in by_name.items()
                  if not name.startswith(("Memcpy", "Memset")))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    return {"busy_ms": busy / 1e3,
            "span_ms": (end - ops[0][0]) / 1e3 if ops else 0.0,
            "device_ops": len(ops), "kernels": kernels,
            "top": [(name[:60], round(ms, 3), n) for name, (ms, n) in top]}


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
    from lagrangiancoherence_tpu_torch.models.settls import (
        _sort_bands, _sort_bin_bands, parcel_propagation_core)
    from lagrangiancoherence_tpu_torch.ops import (_build, cuda_interp,
                                                   cuda_window)
    from lagrangiancoherence_tpu_torch.ops.interp import (
        interp_at_parcels_multi, prefilter)
    from lagrangiancoherence_tpu_torch.ops.tiles import (DEFAULT_LADDER,
                                                         SORT_LADDER)

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
    log(f"== phase 2: build K1-K4 (one nvcc per source, in parallel) "
        f"[{card}]")
    lib_path, build_s, build_log = _build.build()
    _build.load_library()
    log(f"built {lib_path.name} in {build_s:.2f} s")
    for line in build_log.splitlines():
        if "Used" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # -- 3. K1 against the plain version --------------------------------------
    log(f"== phase 3: K1 vs plain on the card [{card}]")
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

    # -- 3b. K2, K3, K4 against their plain versions --------------------------
    log(f"== phase 3b: K2/K3/K4 vs plain on the card (flagship grid) "
        f"[{card}]")
    # the flagship cases are laid out as the main path lays them out:
    # polar bands sort-binned, gathered with the sort ladder
    bands = _sort_bands(grid, ORDER)

    def sort_binned(px, py):
        return _sort_bin_bands((px, py), px, bands, grid)
    pxw, pyw = whirl_positions(grid)
    pxs, pys = shear_positions(grid)
    window_err = {}
    for dtype, tol in ((torch.float32, GATHER_F32_ATOL),
                       (torch.float64, GATHER_F64_ATOL)):
        name = str(dtype).replace("torch.", "")
        Wd = torch.stack([u32.to(dtype), v32.to(dtype)], dim=1)
        CWd = prefilter(Wd, order=ORDER)
        srt = dict(ladder=SORT_LADDER, sort=True)
        dfl = dict(ladder=DEFAULT_LADDER, sort=False)
        cases = [("flagship F=4 sort ladder", pxn, pyn,
                  dict(f0=0, nf=4, wy=32, **srt)),
                 ("flagship F=2 sort ladder", pxn, pyn,
                  dict(f0=2, nf=2, wy=64, **srt)),
                 ("whirl F=4 sort ladder", pxw, pyw,
                  dict(f0=0, nf=4, wy=32, **srt)),
                 ("whirl F=4 default ladder", pxw, pyw,
                  dict(f0=0, nf=4, wy=32, **dfl)),
                 ("shear retry=0 wy=16", pxs, pys,
                  dict(f0=0, nf=2, wy=16, retry_tiles=0, **dfl)),
                 (f"pole_ladder={FORCED_POLE_LADDER}", pxs, pys,
                  dict(f0=0, nf=4, wy=32, pole_ladder=FORCED_POLE_LADDER,
                       **dfl))]
        for label, cx, cy, kw in cases:
            px = torch.tensor(cx, dtype=dtype, device=dev)
            py = torch.tensor(cy, dtype=dtype, device=dev)
            if kw.pop("sort"):
                px, py = sort_binned(px, py)
            runs, counts = window_launches(Wd, CWd, px, py, bounds=bounds,
                                           **kw)
            res = compare_launches(runs, dtype, dev)
            log(f"  {name} {label}: tierA {counts['tierA']} sub "
                f"{counts['sub']} ladder {counts['tiers']} pole levels "
                f"{counts['pole_levels']}")
            for kname, (err, eq, ovf, nflag) in res.items():
                check(err <= tol and eq,
                      f"{name} {label} {kname}: max|kernel-plain|={err:.3e} "
                      f"(<= {tol:g}) flags equal={eq} overflow=0x{ovf:x} "
                      f"slots flagged={nflag} bit-identical={err == 0.0}")
                window_err[kname] = max(window_err.get(kname, 0.0), err) \
                    if name == "float32" else window_err.get(kname, 0.0)
            if label.startswith("whirl"):
                full = [n for n, (_, wx, _) in zip(counts["tiers"],
                                                   kw["ladder"]) if wx is None]
                check(any(full), f"{name} {label} fills the full-longitude "
                      f"tiers {full}")
            if label.startswith("shear"):
                ovf = res["tile_window_gather.dense"][2]
                check(ovf & (1 << 2) != 0,
                      f"{name} shear retry=0 wy=16 raises bit 2: 0x{ovf:x}")
            if label.startswith("pole_ladder"):
                check(all(c > 0 for c in counts["pole_levels"][1:]),
                      f"{name} forced pole ladder reaches levels 2 and 3: "
                      f"{counts['pole_levels']}")
        del Wd, CWd

    # -- 4. main path ---------------------------------------------------------
    log("== phase 4: flagship ftle_pipeline through K1 "
        f"({nx}x{ny}, T={NT}, settls_order={SETTLS_ORDER}, f32) [{card}]")
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

    # -- 4b. the blockspec route ----------------------------------------------
    log("== phase 4b: flagship ftle_pipeline(engine='blockspec') through "
        f"K2/K3/K4 [{card}]")
    torch.cuda.synchronize()
    cuda_interp.LAUNCHES = 0
    cuda_window.reset_launches()
    t0 = time.perf_counter()
    norm_b, overflow_b = ftle_pipeline(u32, v32, DT, grid,
                                       settls_order=SETTLS_ORDER,
                                       interp_order=ORDER, kernel="cuda",
                                       engine="blockspec",
                                       return_overflow=True)
    torch.cuda.synchronize()
    first_b = time.perf_counter() - t0
    window_launch = dict(cuda_window.LAUNCHES)
    k1_on_b = cuda_interp.LAUNCHES
    log(f"first call {first_b:.3f} s; launches {json.dumps(window_launch)}, "
        f"K1 {k1_on_b}")
    check(int(overflow_b) == 0, f"blockspec overflow 0x{int(overflow_b):x} "
          f"== 0")
    check(all(n > 0 for n in window_launch.values()) and k1_on_b == 0,
          f"K2/K3/K4 launched on the blockspec route, K1 {k1_on_b} == 0")
    dnorm = float((norm_b - norm).abs().nan_to_num(0.0).max())
    same = bool(torch.equal(torch.isnan(norm_b), torch.isnan(norm)))
    check(same and dnorm == 0.0,
          f"blockspec FTLE vs K1 FTLE: max|d|={dnorm:.3e} (identical "
          f"expected), NaN pattern equal={same}")
    # the SETTLS loop of the blockspec route never waits for the card
    from lagrangiancoherence_tpu_torch.models.settls import (grid_state,
                                                             settls_scan)
    state = grid_state(grid, ORDER, dtype=torch.float32, device=dev)
    mats = (state["prefilter_y"], state["prefilter_x"])
    cu = prefilter(u32, order=ORDER, matrices=mats)
    cv = prefilter(v32, order=ORDER, matrices=mats)
    dt = torch.full((), DT, dtype=torch.float32, device=dev)
    scan_args = (u32, v32, cu, cv, state["px0"], state["py0"], dt,
                 state["conv_x"], grid)
    scan_kw = dict(settls_order=SETTLS_ORDER, interp_order=ORDER,
                   return_traj=False, kernel="cuda", engine="blockspec")
    torch.cuda.synchronize()
    sync_error = None
    torch.cuda.set_sync_debug_mode("error")
    try:
        settls_scan(*scan_args, **scan_kw)
    except RuntimeError as e:
        sync_error = str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    check(sync_error is None, f"blockspec SETTLS loop under "
          f"set_sync_debug_mode('error'): no host sync ({sync_error})")

    # -- 5. end-to-end accuracy ------------------------------------------------
    log(f"== phase 5: 1-degree global config vs the scipy oracle [{card}]")
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
    got1b = ftle_pipeline(torch.tensor(u1, dtype=torch.float32, device=dev),
                          torch.tensor(v1, dtype=torch.float32, device=dev),
                          DT, grid1, settls_order=2, interp_order=ORDER,
                          kernel="cuda", engine="blockspec").cpu().numpy()
    p99b = float(np.percentile(np.abs(np.log(got1b[mask])
                                      - np.log(want1[mask])), 99))
    check(p99b <= LOG_FTLE_P99_BOUND,
          f"f32 blockspec pipeline p99 |dlog-FTLE| vs oracle = {p99b:.3e} "
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

    def pipeline_s(kernel, engine="auto"):
        ftle_pipeline(u32, v32, DT, grid, settls_order=SETTLS_ORDER,
                      interp_order=ORDER, kernel=kernel,
                      engine=engine)                          # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPS):
            ftle_pipeline(u32, v32, DT, grid, settls_order=SETTLS_ORDER,
                          interp_order=ORDER, kernel=kernel, engine=engine)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / REPS

    torch.cuda.reset_peak_memory_stats()
    k1_s = pipeline_s("cuda")
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    plain_s = pipeline_s("torch")
    torch.cuda.reset_peak_memory_stats()
    bs_s = pipeline_s("cuda", "blockspec")
    peak_b = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"flagship fields/s: K1 {1.0 / k1_s:.4f} ({k1_s * 1e3:.1f} ms/field, "
        f"peak {peak_gb:.2f} GiB), plain {1.0 / plain_s:.4f} "
        f"({plain_s * 1e3:.1f} ms/field), blockspec {1.0 / bs_s:.4f} "
        f"({bs_s * 1e3:.1f} ms/field, peak {peak_b:.2f} GiB) [{card}]")

    # F=4 gather groups at the flagship positions, as each route lays them
    # out: K1 on the grid layout, K2-K4 sort-binned with the sort ladder
    px = torch.tensor(pxn, device=dev)
    py = torch.tensor(pyn, device=dev)
    group_times = {"spline_gather": (
        event_ms(lambda: cuda_interp.cuda_interp_multi(
            W, CW, px, py, f0=0, nf=4, order=ORDER, **bounds), 50),
        event_ms(lambda: interp_at_parcels_multi(
            W.reshape(-1, ny, nx)[:4], CW.reshape(-1, ny, nx)[:4], px, py,
            order=ORDER, **bounds), 5))}
    runs, _ = window_launches(W, CW, *sort_binned(px, py), f0=0, nf=4, wy=32,
                              bounds=bounds, ladder=SORT_LADDER)
    window_ms = time_launches(runs, torch.float32, dev, reps=50,
                              plain_reps=5)
    for kname in WINDOW_KERNELS:
        group_times[kname] = (window_ms[kname, "cuda"],
                              window_ms[kname, "plain"])
    ms, plain_ms, ratio = {}, {}, {}
    for kname, (kt, pt) in group_times.items():
        (ms[kname], klo, khi), (plain_ms[kname], plo, phi) = \
            spread(kt), spread(pt)
        ratio[kname] = (ms[kname] / plain_ms[kname], klo / phi, khi / plo)
        log(f"F=4 gather group at the flagship: {kname} {ms[kname]:.4f} ms "
            f"[{klo:.4f}, {khi:.4f}], plain {plain_ms[kname]:.4f} ms "
            f"[{plo:.4f}, {phi:.4f}] (median [min, max] of {TRIALS} "
            f"trials) [{card}]")
    rank = sorted(ratio, key=lambda k: -ratio[k][0])
    log("kernel/plain, slowest first: " + ", ".join(
        f"{k} {ratio[k][0]:.4f} [{ratio[k][1]:.4f}, {ratio[k][2]:.4f}]"
        for k in rank) + f"; first apart from second: "
        f"{ratio[rank[0]][1] > ratio[rank[1]][2]} [{card}]")

    # stage breakdown of one K1 field (host clock around synchronised stages)
    from lagrangiancoherence_tpu_torch.models.ftle import (flowmap_gradient,
                                                           ftle_norm)
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
    torch.cuda.synchronize()
    cuda_window.reset_launches()
    t0 = time.perf_counter()
    settls_scan(*scan_args, **scan_kw)
    torch.cuda.synchronize()
    log(f"stages (blockspec field): settls_scan_ms "
        f"{(time.perf_counter() - t0) * 1e3:.3f}, window launches "
        f"{sum(cuda_window.LAUNCHES.values())} [{card}]")

    # -- 7. device profile ------------------------------------------------------
    log(f"== phase 7: torch.profiler over one flagship field per route "
        f"[{card}]")
    for engine, wall_s in (("auto", k1_s), ("blockspec", bs_s)):
        prof = profile_field(lambda engine=engine: ftle_pipeline(
            u32, v32, DT, grid, settls_order=SETTLS_ORDER,
            interp_order=ORDER, kernel="cuda", engine=engine))
        prof["wall_ms"] = wall_s * 1e3
        prof["idle_share"] = 1.0 - prof["busy_ms"] / prof["wall_ms"]
        log(f"profile engine={engine}: {json.dumps(prof)} [{card}]")
        check(prof["kernels"] > 0, f"profile engine={engine} sees device "
              f"kernels: {prof['kernels']}")

    if failures:
        log(f"chip_smoke: {len(failures)} check(s) failed:")
        for f in failures:
            log(f"  {f}")
        return 1

    log(json.dumps({"kernels": [{
        "name": "spline_gather", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": gather_err["float32"], "ms": ms["spline_gather"],
        "plain_ms": plain_ms["spline_gather"]}] + [{
            "name": kname, "route": "cuda", "source": WINDOW_SOURCE,
            "replaces": replaces, "launches": window_launch[kname],
            "max_abs_err": window_err[kname], "ms": ms[kname],
            "plain_ms": plain_ms[kname]}
            for kname, replaces in WINDOW_KERNELS.items()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
