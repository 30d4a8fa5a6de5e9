"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Usage, from the root of a checkout, on a machine with one CUDA card::

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout (the
fused SETTLS step ``settls_step``; K1 ``spline_gather``; the spline window
tiers' routed gather ``tier_window_gather`` and the one-launch pole ladder
``pole_ladder_gather``), holds each against its plain PyTorch version on the
card (the fused step, the routed gather and the ladder bit for bit, the
routed gather's choices included, with a ladder whose capacities bind),
drives the flagship
FTLE pipeline (1440x721 parcels, 33 time levels, SETTLS order 4, float32)
through both gather routes — ``engine="auto"`` (one ``settls_step`` launch
per step) and ``engine="blockspec"`` (the routed gather and the ladder) —
and through
the per-group K1 loop that the fused step replaced, checks the float32
pipelines against a scipy oracle, times the kernels beside their bounds (the
least time the card could take for the same work), their plain versions and,
where one exists, one PyTorch call computing the same function — each kernel
with its device time per launch under ``torch.profiler`` and the cost of an
empty launch through the same wrapper path beside its CUDA-event time —
times the pipelines, and profiles one field of each route (device busy time,
kernels per field, idle share).  Then
it drives the user-facing paths through the fused step: phase 8 runs
``LCS(isglobal=True, truncation=20)`` (the CLI's defaults) on the flagship
winds — regrid to the common 0.5-degree grid, T20 truncation, SETTLS-4, the
float64 FTLE; a first and a second call timed by stage, the second on the
winds stored in ERA5's latitude order, 90 -> -90, with an identical FTLE and
one crossing to the card a wind component (``devices.TRANSFERS``) — phase 8c
the same facade with ``resample="12h"`` and
``parcel_propagation(return_traj=True)`` on those winds labelled from 2300
by the port's CF decoder (NCEP's
``"hours since 1800-1-1 00:00:0.0"``), outside datetime64[ns]'s range, with a
resample alias pandas 3 removed refused before any launch — and phase 8b one
area-of-influence case (LagrangianCoherence LCS/area_of_influence.py, as
``examples/area_of_influence.case`` runs its stages 1-7) at ERA5's 0.25
degrees: timed by its spans, its ``skeletonize`` sweeps counted, its
outputs identical to the same case through the plain step, and its
``threshold_local``, Hessian ridges, ``skeletonize``, ``filter_ridges`` and
then ``find_area`` each held against the same call in float64 on the CPU.
Phase 9 runs ``ftle_series`` over a
36-level record on the flagship grid (4 windows, each identical to
``ftle_pipeline`` on its slice, and again through a ``batch_mesh`` of the
card twice, and on the record stored in ERA5's order, identical, with
``devices.TRANSFERS`` counting one crossing a wind component); phase 10
the latitude-block pipeline's
``parcel_propagation_sharded`` (1 and 4 blocks, and 2x2 with longitude
blocks) and ``ftle_sharded`` (4 blocks, with and without ``sigma``) on a
mesh of the card repeated, each identical to the whole-grid run, and both
on the windowed route (``engine="blockspec"``, 2 and 4 blocks); phase 11
the port's examples (``--quick``), ``entry()`` and ``dryrun_multichip(4)``;
phase 12 the port's benchmark entry point (``bench.main``, ``--engine
auto`` and ``--engine blockspec``: fields/s by CUDA events and its
numerics record, each record printed on a line of its own).
Phase 3c also holds ``settls_step`` on blocks with their home rows against
its plain version and the whole-grid launch's rows, and phase 6 times the
step as 4 blocks; phase 3b holds a block of the windowed route and the
ladder with a home-row mask against their plain versions, and phase 4b
also runs ``engine="dma"``.  Each phase prints its results; the line
before the last is the kernel record ``{"kernels": [{"name", "route",
"source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
"bound_ms", "bound_by", "library_ms", "device_us_per_launch",
"empty_launch_us", "launches_new_paths"}]}`` (one entry per TPU kernel
replaced; ``launches_new_paths``: its launches on each path added by the
windowed blocks, phase 4b's two routes, the facade (phase 8), the series
(phase 9), the examples and the bench's timed calls, each counted from 0;
times:
medians of CUDA-event trials; ``device_us_per_launch``: from
``torch.profiler``, null where the profiler saw none of the kernel's
launches; ``empty_launch_us``: an empty launch through
the pole ladder's wrapper path in the same run; ``settls_step``'s launches
summed over phases 4, 8, 8c, 8b, 9, 10, 11 and 12 (the bench's timed
calls), K1's from the per-group loop of
phase 4, the routed gather's (its two kernels) and the ladder's from phase
4b, each counted from 0)
and the last line is ``{"ok": true, "device": {...}}``.  Any failed check
exits non-zero, as does a machine without a CUDA device or a directory
without the package.  Phase 3d holds the banded prefilter
``spline_prefilter`` against the dense float64 prefilter (max |kernel -
dense64| / max |x| <= 1e-6 in float32, and at the flagship shape no more
than twice the dense float32 GEMMs' own, <= 1e-13 in float64) and against
its plain sweep, runs it on a second card where there is one, times it
beside its bound and the dense GEMMs, and counts its launches in one
resident field (2); it prints ``prefilter record:`` with its numbers.  The
kernel record's last entry is ``spline_prefilter``'s, its ``launches``
those of phase 4's main-path call (2).  ``--quick`` stops after phase 3d
(build, and the kernels against their plain versions) and prints no result
line; ``--prefilter`` runs phase 3d alone after the build.  ``--area``
runs phase 8b alone, twice in one process, and prints no result line: its
second pass shows the workflow's times without the first-use costs (kernel
build, CUDA module loading, FFT plans) that the first pass of a process pays.
``--facade`` runs phases 8, 8c and 9 alone, every path on which a host
record crosses to the card, and prints no result line.

This script imports neither JAX nor the JAX package: phase 5's oracle is
the port's ``testing/oracle.py``, a plain numpy/scipy statement of the
reference semantics (LagrangianCoherence LCS/trajectory.py:8-144,
LCS.py:142-225, tools.py:11-267).
"""
from __future__ import annotations

import hashlib
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
PREFILTER_SOURCE = ("lagrangiancoherence_tpu_torch/ops/csrc/"
                    "spline_prefilter.cu")
# max |kernel - dense float64| / max |x| of the banded prefilter: a few
# roundings of the solve in the working type, no truncation
PREFILTER_F32_RTOL = 1e-6
PREFILTER_F64_RTOL = 1e-13
KERNEL_REPLACES = "lagrangiancoherence_tpu/ops/pallas_interp.py:793"
STEP_SOURCE = "lagrangiancoherence_tpu_torch/ops/csrc/settls_step.cu"
WINDOW_SOURCE = "lagrangiancoherence_tpu_torch/ops/csrc/window_gather.cu"
_PALLAS = "lagrangiancoherence_tpu/ops/pallas_interp.py"
# the window kernels by name and mode, and the Pallas kernel each replaces
WINDOW_KERNELS = {
    # _grid_kernel (tier A), _list_kernel (the ladder) and _sub_grid_kernel
    # (tier A-sub): the spline tiers as one routed gather
    "tier_window_gather": [f"{_PALLAS}:715", f"{_PALLAS}:772",
                           f"{_PALLAS}:648"],
    # _pole_grid_kernel and _pole_list_kernel: the ladder in one launch
    "pole_ladder_gather": [f"{_PALLAS}:738", f"{_PALLAS}:755"],
}
# launches per flagship field on the blockspec route: 32 steps of 5 gather
# groups, the spline tiers' two kernels and the pole ladder's one in each
BLOCKSPEC_LAUNCHES = {"tier_window_gather.route": 160,
                      "tier_window_gather.gather": 160,
                      "pole_ladder_gather": 160}
# the default ladder with capacities of 1 to 4: every tier fills, tiles
# spill to later tiers and some are left to tier A
CAPPED_LADDER = ((64, 256, 1), (32, 384, 2), (64, 384, 3), (32, 512, 4),
                 (64, 512, 1), (128, 768, 2), (32, None, 3), (64, None, 4),
                 (192, None, 1))
FORCED_POLE_LADDER = (8, 16, 288)   # slots escalate to levels 2 and 3
CLAMPED_POLE_LADDER = (8, 8, 8)     # the last level clamps: bit 4
# one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet): HBM3 bytes/s
# and float32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TILE = 8 * 128           # parcels per window tile and per pole slot
SERIES_LEVELS = 36       # phase 9's record: 4 windows of NT at stride 1


# ---------------------------------------------------------------------------
# Bounds: the least time the card could take for a kernel's work
# ---------------------------------------------------------------------------

def gather_ops(nf, order=ORDER):
    """Operations of one wrap-mode spline gather of ``nf`` fields at one
    parcel: the Q4 scaling (6), the two folds (10), the B-spline weights
    (38 at order 3, 4 at order 1), then per tap the weight product and
    ``nf`` multiply-adds."""
    return 16 + {3: 38, 1: 4}[order] + (order + 1) ** 2 * (1 + 2 * nf)


def tier_ops(nf, order=ORDER):
    """Operations of the routed window gather at one parcel: routing's two
    floors, three unwraps (8 each) and ten min/max; then the gather's two
    unwraps, its B-spline weights and per tap the weight product and ``nf``
    multiply-adds (the folds are given, so no scaling and no fold)."""
    return 2 + 3 * 8 + 10 + gather_ops(nf, order) - 16 + 2 * 8


def bilinear_ops(nf):
    """Operations of the order-1 'constant' bilinear at one parcel: the Q4
    scaling (6), fractions and weights (8), four products and three sums
    per field."""
    return 14 + 7 * nf


def step_ops(settls_order, order=ORDER):
    """Operations of one fused SETTLS step at one parcel: the F=2 gather,
    its update (6) and clamp (4), then per iteration an F=4 gather, its
    update (10) and clamp (4)."""
    return gather_ops(2, order) + 10 + settls_order * (gather_ops(4, order)
                                                      + 14)


def bound(nbytes, ops):
    """(bound ms, what sets it, the arithmetic): the larger of the bytes
    over HBM_BYTES_PER_S and the operations over F32_OPS_PER_S."""
    t_mem, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    by = "bytes" if t_mem >= t_ops else "operations"
    return max(t_mem, t_ops), by, (f"{nbytes / 1e6:.2f} MB / 3.35 TB/s = "
                                   f"{t_mem * 1e3:.2f} us; {ops / 1e9:.4f} "
                                   f"Gop / 67 TFLOP/s = {t_ops * 1e3:.2f} us")


# ---------------------------------------------------------------------------
# Inputs, made from closed forms (no random state)
# ---------------------------------------------------------------------------

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

def pole_launches(W, px, py, *, f0, nf, bounds, order=ORDER,
                  pole_ladder=None, home_rows=None):
    """The pole ladder's launch of one ``engine="blockspec"`` gather group at
    positions ``px``/``py``, on the group's pole-home rows, sorted as the
    hoisted pole loop sorts them (its flags are the slots' levels).  With
    ``home_rows`` (``px``/``py`` a latitude block), the block's candidate
    rows for the pole-home rows and their home-row mask, as a block's
    in-gather pole pass takes them (``window_interp._block_pole_pass``).
    Returns ([(name, out shape, n flags, run)], slots per level), where
    ``run(kind, out, flags, overflow)`` launches the kernel (kind "cuda"),
    its plain version (kind "plain") or the empty launch (kind "empty") on
    the same inputs."""
    import torch
    from lagrangiancoherence_tpu_torch.ops import cuda_window
    from lagrangiancoherence_tpu_torch.ops import pole as PL
    from lagrangiancoherence_tpu_torch.ops import window_interp as WI
    ny, nx = W.shape[-2:]
    fns = {"cuda": cuda_window.pole_ladder_gather,
           "plain": WI.pole_ladder_gather_plain,
           "empty": cuda_window.empty_launch}
    if home_rows is None:
        rx, ry = PL.pole_rows(px, order), PL.pole_rows(py, order)
        mask = torch.ones_like(rx)
    else:
        idx, mask = WI.block_pole_candidates(home_rows, order=order, ny=ny)
        rx, ry = px[idx], py[idx]
        mask = mask.to(px.dtype)[:, None].expand_as(rx)
    perm, _ = PL.pole_sort_state(rx, ry, order=order, ny=ny, nx=nx, **bounds)
    geom = dict(order=order, nx=nx)
    pxf = PL.pole_apply_perm(rx, perm, **geom)
    pole_ladder = tuple(pole_ladder or PL.POLE_LADDER)
    pack = PL.pole_pack(pxf, PL.pole_apply_perm(ry, perm, **geom),
                        PL.pole_apply_perm(mask, perm, **geom), ny=ny, nx=nx,
                        **bounds)
    ln = WI.pole_launch(W.reshape(-1, ny, nx), pack, f0=f0, nf=nf,
                        ladder=pole_ladder)
    pr = PL.pole_levels(PL.pole_keys(pack, ny), ny=ny, ladder=pole_ladder)
    runs = [(ln.kernel, (nf, ln.n_flags * 8, 128), ln.n_flags,
             lambda kind, o, f, v: ln.run(fns[kind], o, f, v))]
    return runs, [int((pr.level == k).sum()) for k in range(3)]


def tier_run(CW, px, py, kind, *, f0, nf, wy, bounds, ladder, order=ORDER,
             retry_tiles=256, home_rows=None):
    """One gather group's spline tiers through ``tier_window_gather`` (kind
    "cuda") or its plain version (kind "plain") on zeroed outputs: {"out",
    "plan", "fits", "flags", "overflow"} and a closure that launches again
    on the same buffers.  ``px``/``py``: the grid, or a full-width latitude
    block whose rows have the global home rows ``home_rows``."""
    import torch
    from lagrangiancoherence_tpu_torch.ops import cuda_window
    from lagrangiancoherence_tpu_torch.ops import window_interp as WI
    ny, nx = CW.shape[-2:]
    ln, folds = WI.tier_launch(CW.reshape(-1, ny, nx), px, py, f0=f0, nf=nf,
                               order=order, wy=wy, retry_tiles=retry_tiles,
                               ladder=ladder, home_rows=home_rows, **bounds)
    fn = (cuda_window.tier_window_gather if kind == "cuda"
          else WI.tier_window_gather_plain)
    ints = dict(dtype=torch.int32, device=px.device)
    n = ln.n_flags
    res = {"out": torch.zeros((nf,) + tuple(folds.shape[1:]), dtype=CW.dtype,
                              device=px.device),
           "plan": torch.full((n, WI.PLAN_W), -9, **ints),
           "fits": torch.full((n,), -9, **ints),
           "flags": torch.full((n,), -9, **ints),
           "overflow": torch.zeros((1,), **ints)}

    def again():
        ln.run(fn, res["out"], res["plan"], res["fits"], res["flags"],
               res["overflow"])
    again()
    return res, again


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


def device_us(fn, n, match, tries=3):
    """``torch.profiler`` over ``n`` calls of ``fn`` (after a warm-up): the
    mean device microseconds of one launch of the kernels whose name
    contains ``match``, and how many of them one call launched. The
    profiler can drop device events; a profile that saw none, or a count
    that is not a multiple of ``n``, is taken again, up to ``tries``
    profiles, and the last one that saw any is kept. With none at all:
    ``(None, 0)``, logged as not measured (a device time is reported, not
    checked)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    kept = None
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        cuda = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        us = [e.time_range.end - e.time_range.start for e in cuda
              if match in e.name]
        if us:
            kept = us
        if us and not len(us) % n:
            break
        names = {}
        for e in cuda:
            names[e.name[:50]] = names.get(e.name[:50], 0) + 1
        log(f"  device_us: {len(us)} events named *{match}* in {n} calls; "
            f"device events seen: {json.dumps(names)}")
    if not kept:
        log(f"  device_us: torch.profiler saw no kernel named *{match}* in "
            f"{tries} profiles: not measured")
        return None, 0
    return float(np.mean(kept)), len(kept) / n


def us_text(us):
    """A device time from ``device_us`` as text."""
    return "not measured" if us is None else f"{us:.2f} us"


def spread(ms):
    """(median, min, max) of a list of trial times."""
    return float(np.median(ms)), min(ms), max(ms)


def time_launches(runs, dtype, device, reps, plain_reps):
    """Trial times (``event_ms``) of one gather group's launches of each
    kernel name, for the kernels and for the plain versions, and under
    ``name, "device"`` the kernels' ``device_us``."""
    import torch
    from lagrangiancoherence_tpu_torch.bench import event_ms
    bufs = [(name, torch.zeros(shape, dtype=dtype, device=device),
             # the main path asks the ladder for no levels
             None if name == "pole_ladder_gather" else torch.zeros(
                 (n,), dtype=torch.int32, device=device),
             torch.zeros((1,), dtype=torch.int32, device=device), run)
            for name, shape, n, run in runs]
    times = {}
    for kind, n in (("cuda", reps), ("plain", plain_reps)):
        for name in dict.fromkeys(b[0] for b in bufs):
            mine = [b for b in bufs if b[0] == name]

            def group(mine=mine, kind=kind):
                for _, o, f, v, run in mine:
                    run(kind, o, f, v)
            times[name, kind] = event_ms(group, n)
            if kind == "cuda":
                times[name, "device"] = device_us(
                    group, n, name.replace("_gather", "_kernel"))
    return times


def host_us(fn, n=1000):
    """Host microseconds per call of ``fn`` over ``n`` calls that nothing
    synchronises: what issuing the call costs the host."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def profile_field(run, tries=3):
    """``torch.profiler`` over one call of ``run`` (after a warm-up):
    the device's busy milliseconds (the union of its op intervals), the
    span from its first op to its last, the number of device ops and of
    kernels among them, and the five kernels with the most device time
    as (name, ms, launches). A profile that saw no device op (the profiler
    can drop events) is taken again, up to ``tries`` profiles."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        ops = sorted((e.time_range.start, e.time_range.end, e.name)
                     for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
        if ops:
            break
        log("  profile_field: torch.profiler saw no device op; again")
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


def profile_call(run, top=6, sites=3):
    """``torch.profiler`` over one call of ``run``, with no warm-up, and
    the input shapes recorded: (its result, the wall milliseconds under the
    profiler, the device's busy milliseconds, the ``top`` host ops with the
    most self time as (name, ms, count), and the ``sites`` single host
    events with the most self time as (name, ms, input shapes))."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy, end = 0.0, float("-inf")
    for t0_, t1 in sorted((e.time_range.start, e.time_range.end)
                          for e in prof.events() if e.device_type == cuda):
        busy += max(0.0, t1 - max(t0_, end))
        end = max(end, t1)

    ops = sorted((e for e in prof.key_averages() if e.device_type != cuda),
                 key=lambda e: -e.self_cpu_time_total)[:top]
    ops = [(e.key[:60], round(e.self_cpu_time_total / 1e3, 3), e.count)
           for e in ops]
    # the heaviest single host events, with their input shapes
    host = sorted((e for e in prof.events() if e.device_type != cuda),
                  key=lambda e: -e.self_cpu_time_total)[:sites]
    where = [(e.name[:40], round(e.self_cpu_time_total / 1e3, 3),
              [list(x) for x in (e.input_shapes or [])][:2]) for e in host]
    return out, wall, busy / 1e3, ops, where


def same_values(got, want):
    """(``torch.equal`` with equal NaN patterns, max |got - want| over the
    pairs finite in both, index of the first differing element or None)."""
    import torch
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    a, b = torch.where(nan_g, 0.0, got), torch.where(nan_w, 0.0, want)
    if bool(torch.equal(nan_g, nan_w)) and bool(torch.equal(a, b)):
        return True, 0.0, None
    where = tuple(((a != b) | (nan_g != nan_w)).nonzero()[0].tolist())
    fin = torch.isfinite(got) & torch.isfinite(want)
    err = float((got - want).abs()[fin].max()) if fin.any() else float("inf")
    return False, err, where


# ---------------------------------------------------------------------------
# The fused SETTLS step, and the per-group K1 loop it replaced
# ---------------------------------------------------------------------------

def step_kw(grid, settls_order=SETTLS_ORDER, order=ORDER):
    return dict(settls_order=settls_order, order=order, x_min=grid.x_min,
                x_max=grid.x_max, y_min=grid.y_min, y_max=grid.y_max,
                cyclic_x=grid.cyclic_x)


def k1_gather(fields, coeffs, px, py, **kw):
    """K1 as ``settls_step_torch``'s gather: one launch per gather group."""
    from lagrangiancoherence_tpu_torch.ops import cuda_interp
    return cuda_interp.cuda_interp_multi(fields, coeffs, px, py, **kw)[0]


def k1_loop_field(u, v, grid, state, dt, stages=None):
    """One field as the direct route ran it before the fused step:
    prefilter, then per step ``settls_step_torch`` with K1 as its gather
    (five launches and the torch updates), then gradient and norm.  With
    ``stages``, the synchronised stage times go there (ms)."""
    import torch
    from lagrangiancoherence_tpu_torch.models.ftle import (flowmap_gradient,
                                                           ftle_norm)
    from lagrangiancoherence_tpu_torch.ops.cuda_settls import \
        settls_step_torch
    from lagrangiancoherence_tpu_torch.ops.interp import prefilter
    T, ny, nx = u.shape
    clock = [time.perf_counter()]

    def lap(name):
        if stages is not None:
            torch.cuda.synchronize()
            clock.append(time.perf_counter())
            stages[name] = (clock[-1] - clock[-2]) * 1e3

    cu, cv = (prefilter(a, order=ORDER) for a in (u, v))
    lap("prefilter_ms")
    W = torch.stack([u, v], dim=1).reshape(2 * T, ny, nx)
    CW = torch.stack([cu, cv], dim=1).reshape(2 * T, ny, nx)
    px, py = state["px0"], state["py0"]
    for t in range(T - 1):
        px, py = settls_step_torch(W, CW, px, py, state["conv_x"], dt, t,
                                   gather=k1_gather, **step_kw(grid))
    lap("settls_loop_ms")
    norm = ftle_norm(flowmap_gradient(px, py, grid))
    lap("gradient_norm_ms")
    return norm


def phase_step_parity(dev, card, check, grid, u32, v32, cases, fold,
                      block_cases):
    """Phase 3c: ``settls_step`` against ``settls_step_torch`` on the card,
    one flagship step per case, float32 and float64; then blocks of the
    flagship grid with their home rows (``block_cases``: (label, px, py
    numpy) at t = 0), each also against the same rows of the whole-grid
    launch; then the fold-boundary grid, cyclic and not.  ``cases``:
    (label, px, py numpy, step, order); ``fold``: (lats, lons, field).
    Returns the largest max |kernel - plain| in float32 (0.0:
    identical)."""
    import torch
    from lagrangiancoherence_tpu_torch import Grid
    from lagrangiancoherence_tpu_torch.models.settls import grid_state
    from lagrangiancoherence_tpu_torch.ops.cuda_settls import (
        interleave, settls_step, settls_step_torch)
    from lagrangiancoherence_tpu_torch.ops.interp import prefilter
    from lagrangiancoherence_tpu_torch.parallel.pipeline import block_layout
    ny, nx = grid.shape
    log(f"== phase 3c: settls_step vs settls_step_torch on the card, bit "
        f"for bit, whole grid and blocks with home rows [{card}]")
    probe = np.array([-540.5, 2.0 ** 27, -2.0 ** 27, -180.0, 179.999,
                      -1e-30, 359.5, -359.5, 540.0, np.nan])
    for dtype, npt in ((torch.float32, np.float32),
                       (torch.float64, np.float64)):
        a = probe.astype(npt)
        got = torch.remainder(torch.tensor(a, device=dev), 180.0).cpu()
        with np.errstate(invalid="ignore"):
            m = np.fmod(a, npt(180.0))
            want = np.where((m != 0) & (m < 0), m + npt(180.0), m)
        check(np.array_equal(got.numpy(), want, equal_nan=True),
              f"torch.remainder({dtype}) on the card is fmod with the sign "
              f"fix-up: {got.tolist()}")

    worst = {}

    def compare(label, name, want, got):
        """One check per case; a case that differs is named with its max |d|
        and where (x, y) first differ."""
        torch.cuda.synchronize()
        res = [same_values(g, w) for g, w in zip(got, want)]
        err = max(r[1] for r in res)
        worst[name] = max(worst.get(name, 0.0), err)
        same = all(r[0] for r in res)
        check(same, f"{name} {label}: end positions identical"
              + ("" if same else f"; max|d|={err:.3e} at (x, y) "
                 f"{[r[2] for r in res]}"))

    def stacks(u, v, order):
        T, ny, nx = u.shape
        cu, cv = (prefilter(a, order=order) for a in (u, v))
        return (torch.stack([u, v], dim=1).reshape(2 * T, ny, nx),
                torch.stack([cu, cv], dim=1).reshape(2 * T, ny, nx),
                interleave(cu, cv))

    for dtype in (torch.float32, torch.float64):
        name = str(dtype).replace("torch.", "")
        u, v = u32.to(dtype), v32.to(dtype)
        dt = torch.full((), DT, dtype=dtype, device=dev)
        state = grid_state(grid, dtype=dtype, device=dev)
        for order in sorted({c[4] for c in cases}, reverse=True):
            W, CW, CI = stacks(u, v, order)
            for label, cx, cy, t, o in cases:
                if o != order:
                    continue
                px = torch.tensor(cx, dtype=dtype, device=dev)
                py = torch.tensor(cy, dtype=dtype, device=dev)
                kw = step_kw(grid, order=order)
                want = settls_step_torch(W, CW, px, py, state["conv_x"], dt,
                                         t, **kw)
                compare(label, name, want, settls_step(
                    u, v, CI, px, py, state["conv_x"], dt, t, **kw))
            del W, CW, CI
        # blocks of a 4-block latitude mesh (181 rows each, the last with 3
        # reflected pad rows), an interior band and an x-block
        W, CW, CI = stacks(u, v, ORDER)
        kw = step_kw(grid)
        home = torch.tensor(block_layout(grid, 4)["home_idx"],
                            dtype=torch.int32, device=dev)
        rows = home.numel() // 4
        blocks = [(f"south pole-home rows 0-{rows - 1}", 0, rows, 0, nx),
                  (f"interior rows {ny // 3}-{2 * ny // 3 - 1}", ny // 3,
                   2 * ny // 3, 0, nx),
                  (f"last of 4, rows {3 * rows}-{ny - 1} and "
                   f"{4 * rows - ny} reflected", 3 * rows, 4 * rows, 0, nx),
                  (f"x-block rows 0-{rows - 1}, columns {nx // 2}-{nx - 1}",
                   0, rows, nx // 2, nx)]
        for label, cx, cy in block_cases:
            px = torch.tensor(cx, dtype=dtype, device=dev)
            py = torch.tensor(cy, dtype=dtype, device=dev)
            whole = settls_step(u, v, CI, px, py, state["conv_x"], dt, 0,
                                **kw)
            for bl, r0, r1, c0, c1 in blocks:
                hr = home[r0:r1]
                idx = hr.long()
                bx = px[idx][:, c0:c1].contiguous()
                by = py[idx][:, c0:c1].contiguous()
                cxb = state["conv_x"][idx]
                got = settls_step(u, v, CI, bx, by, cxb, dt, 0, home_rows=hr,
                                  **kw)
                compare(f"{label}, block {bl}", name, settls_step_torch(
                    W, CW, bx, by, cxb, dt, 0, home_rows=hr, **kw), got)
                compare(f"{label}, block {bl} vs the whole-grid launch's "
                        f"rows", name, tuple(w[idx][:, c0:c1] for w in whole),
                        got)
        del W, CW, CI
        lats, lons, f = fold
        fu = torch.tensor(f, dtype=dtype, device=dev)
        uf = torch.stack([fu, 0.8 * fu])
        vf = torch.stack([0.5 * fu, 0.3 * fu + 1.0])
        for cyclic in (True, False):
            g = Grid(lats=lats, lons=lons, cyclic_x=cyclic)
            state = grid_state(g, dtype=dtype, device=dev)
            W, CW, CI = stacks(uf, vf, ORDER)
            kw = step_kw(g)
            px, py = state["px0"], state["py0"]
            want = settls_step_torch(W, CW, px, py, state["conv_x"], dt, 0,
                                     **kw)
            compare(f"fold-boundary grid {len(lats)}x{len(lons)} from its "
                    f"nodes, cyclic={cyclic}", name, want,
                    settls_step(uf, vf, CI, px, py, state["conv_x"], dt, 0,
                                **kw))
    return worst["float32"]


# ---------------------------------------------------------------------------
# Phases 8 and 8b: the facade and the area-of-influence workflow
# ---------------------------------------------------------------------------

DIMS3 = ("time", "latitude", "longitude")
# a facade call's crossings: a wind component up each, the FTLE back
ONE_CROSSING = {"uploads": 2, "downloads": 1, "host_reorders": 0}
TRUNCATION = 20          # the CLI's default
# max |card - CPU| / max |CPU| of the float32 regrid and truncation on the
# card against the float64 versions on the CPU
FACADE_F32_REL = 1e-5
# float32 diagnostics on the card against float64 on the CPU: eigen-
# quantities within DIAG_REL of their largest value; a mask may differ only
# where its test lies within DIAG_REL (of the tested quantity's largest
# value) of its threshold; the walk of find_area within AREA_REL of a mark or
# snap threshold (relative to the walked distance and the coordinates)
DIAG_REL = 1e-3
AREA_REL = 1e-5
AREA_NT = 16             # six-hourly levels, as the example's main runs
AREA_WINDOW = 8          # the case's last 8 levels, resampled to 3 h
AREA_BOX = (221, 233)    # the example's box at ERA5's 0.25 degrees
RIDGE_SIGMA, RIDGE_TOL = 1.2, 1e-3          # the case's ridge parameters
FILTER = (["mean_intensity", "major_axis_length"], [1.2, 30.0])


class StageClock:
    """Collects the facade's own stage times: the milliseconds between each
    ``timed_stage`` banner record and its "took" record."""

    def __init__(self):
        import logging
        from lagrangiancoherence_tpu_torch.utils.logging import logger

        class Handler(logging.Handler):
            def emit(_, record):
                msg = record.getMessage()
                if msg.startswith("*---- "):
                    self._start[msg[6:-6]] = record.created
                elif " took " in msg:
                    name = msg.rsplit(" took ", 1)[0]
                    self.ms[name] = (record.created
                                     - self._start.pop(name)) * 1e3

        self.logger, self.handler = logger, Handler(logging.INFO)
        self.ms, self._start = {}, {}

    def __enter__(self):
        import logging
        self.level = self.logger.level
        self.logger.setLevel(logging.INFO)
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)
        self.logger.setLevel(self.level)


def rel_err(got, want):
    """max |got - want| / max |want| over the points finite in both; inf
    when the NaN patterns differ."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if not np.array_equal(np.isnan(got), np.isnan(want)):
        return float("inf")
    fin = np.isfinite(got) & np.isfinite(want)
    if not fin.any():
        return 0.0
    return float(np.abs(got[fin] - want[fin]).max()
                 / max(np.abs(want[fin]).max(), 1e-300))


def hessian_eigenvalues(field, lats, lons):
    """(lam0, lam1) of the ridges' smoothed spherical Hessian in float64 on
    the CPU (models/ridges.py: the same steps, isglobal=False)."""
    import torch
    from lagrangiancoherence_tpu_torch.models.ridges import symmetric_eig_2x2
    from lagrangiancoherence_tpu_torch.ops.filters import gaussian_filter
    from lagrangiancoherence_tpu_torch.ops.stencil import \
        derivative_spherical_coords as deriv
    f = gaussian_filter(torch.from_numpy(np.asarray(field, np.float64)),
                        RIDGE_SIGMA)

    def d(x, dim):
        return deriv(x, lats, lons, dim=dim, isglobal=False)

    gx, gy = d(f, 1), d(f, 0)
    a, b, c = (torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)
               for x in (d(gx, 1), d(gx, 0), d(gy, 0)))
    lam0, lam1, _, _ = symmetric_eig_2x2(a, b, c)
    return lam0.numpy(), lam1.numpy()


def area_uncertain(ftle, ev, ridges, lats, lons, max_steps=128):
    """Cells whose ``find_area`` mark may differ between float32 and float64
    (models/area.py's walk, in numpy): every cell of the bracketing box of a
    walk candidate whose mark test ``(k-1) step <= 2r`` lies within AREA_REL
    of its threshold, or whose position lies within AREA_REL of the
    midpoint between two grid coordinates, where the nearest-index snap
    changes."""
    res = lats[1] - lats[0]
    sigma = np.exp(ftle) * ridges
    ev_y, ev_x = ev[..., 0], ev[..., 1]
    valid = ~np.isnan(sigma) & ~np.isnan(ev_x) & ~np.isnan(ev_y)
    r = np.where(valid, sigma * 0.5, 0.0)
    LAT, LON = np.meshgrid(lats, lons, indexing="ij")
    k = np.arange(1, max_steps + 1, dtype=np.float64)[:, None, None]
    step = np.sqrt(ev_x * ev_x + ev_y * ev_y) * res
    d_prev = (k - 1.0) * step
    near_mark = valid & (np.abs(d_prev - 2.0 * r)
                         <= AREA_REL * np.maximum(2.0 * r, step))
    live = valid & ((d_prev <= 2.0 * r) | near_mark)
    out = np.zeros(ftle.shape, bool)
    axes = []
    for lower, comp, coords in ((LON - np.abs(ev_x) * r, ev_x, lons),
                                (LAT - np.abs(ev_y) * r, ev_y, lats)):
        pos = lower + k * np.abs(comp) * res
        mids = 0.5 * (coords[1:] + coords[:-1])
        j = np.clip(np.searchsorted(mids, pos), 1, mids.size - 1)
        gap = np.minimum(np.abs(pos - mids[j - 1]), np.abs(pos - mids[j]))
        near = gap <= AREA_REL * np.abs(coords).max()
        lo = np.clip(np.searchsorted(coords, pos) - 1, 0, coords.size - 1)
        axes.append((near, lo, np.minimum(lo + 1, coords.size - 1)))
    (nx_, xlo, xhi), (ny_, ylo, yhi) = axes
    pick = live & (near_mark | nx_ | ny_)
    for yi in (ylo[pick], yhi[pick]):
        for xi in (xlo[pick], xhi[pick]):
            out[yi, xi] = True
    return out


def phase_facade(dev, card, check, sync, u64, v64, grid, by_path):
    """Phase 8: ``LCS(isglobal=True)`` at the CLI's defaults on the flagship
    winds, through the fused step, then on the same winds stored as ERA5
    stores them (latitude 90 -> -90): the record crosses to the card once
    a wind component and only the FTLE comes back (``devices.TRANSFERS``), and
    the FTLE is identical to the ascending record's.  Returns its launches
    in the facade's run, and the winds regridded and truncated on the
    card."""
    import torch
    from lagrangiancoherence_tpu_torch import LCS, Field, parcel_propagation
    from lagrangiancoherence_tpu_torch.api import (COMMON_GRID_LATS,
                                                   COMMON_GRID_LONS)
    from lagrangiancoherence_tpu_torch.bench import launch_counts
    from lagrangiancoherence_tpu_torch.devices import TRANSFERS
    from lagrangiancoherence_tpu_torch.ops.regrid import \
        regrid_linear_nearest
    from lagrangiancoherence_tpu_torch.ops.sht import truncate
    ny, nx = grid.shape
    log(f"== phase 8: LCS(isglobal=True, truncation={TRUNCATION}) on the "
        f"flagship winds ({nx}x{ny}, T={NT}, SETTLS-{SETTLS_ORDER}) -> the "
        f"common grid, through settls_step [{card}]")
    times = np.datetime64("2020-01-01", "ns") \
        + np.arange(NT) * np.timedelta64(6, "h")
    coords = {"time": times, "latitude": grid.lats, "longitude": grid.lons}
    U = Field(u64, DIMS3, coords, name="u")
    V = Field(v64, DIMS3, coords, name="v")
    expected = NT - 1
    sync()
    reset_counts()
    t0 = time.perf_counter()
    with StageClock() as clock:
        out = LCS(timestep=DT, SETTLS_order=SETTLS_ORDER, device=dev)(
            u=U, v=V, verbose=False, isglobal=True, truncation=TRUNCATION)
    wall = (time.perf_counter() - t0) * 1e3
    by_path["phase 8 facade"] = c = launch_counts()
    check(TRANSFERS == ONE_CROSSING,
          f"facade transfers {json.dumps(TRANSFERS)} == "
          f"{json.dumps(ONE_CROSSING)}")
    launches, k1 = c["settls_step"], c["spline_gather"]
    log("facade stages, first call (ms): " + json.dumps(
        {k: round(v, 3) for k, v in clock.ms.items()})
        + f", wall {wall:.3f} ms [{card}]")
    check(launches == expected and k1 == 0 and c["spline_prefilter"] == 2,
          f"settls_step launches in the facade {launches} == {expected}, K1 "
          f"launches {k1} == 0, spline_prefilter {c['spline_prefilter']} "
          f"== 2")
    inner = out.data[0, 5:-5]
    check(out.shape == (1, COMMON_GRID_LATS.size, COMMON_GRID_LONS.size)
          and bool(np.isfinite(inner).all()),
          f"FTLE shape {out.shape}, rows [5:-5] finite; range "
          f"[{inner.min():.4g}, {inner.max():.4g}]")

    # the card's float32 regrid and truncation against float64 on the CPU
    truncated = []
    for name, a in (("u", u64), ("v", v64)):
        args = (grid.lats, grid.lons, COMMON_GRID_LATS, COMMON_GRID_LONS)
        reg = regrid_linear_nearest(a, *args, device=dev)
        reg64 = regrid_linear_nearest(torch.from_numpy(a), *args,
                                      device="cpu")
        trc = truncate(reg.cpu().numpy(), COMMON_GRID_LATS, TRUNCATION,
                       device=dev).cpu().numpy()
        trc64 = truncate(reg64, COMMON_GRID_LATS, TRUNCATION,
                         device="cpu").numpy()
        e_reg, e_trc = rel_err(reg.cpu().numpy(), reg64), rel_err(trc, trc64)
        check(reg.dtype == torch.float32 and e_reg <= FACADE_F32_REL
              and e_trc <= FACADE_F32_REL,
              f"{name}: f32 card vs f64 CPU: regrid {e_reg:.3e}, "
              f"T{TRUNCATION} truncation {e_trc:.3e} (<= {FACADE_F32_REL:g} "
              f"of max)")
        truncated.append(trc)

    # the same truncated winds: the fused step and the plain step give
    # identical departure points (the kernel is bit-identical to its plain
    # version)
    ccoords = {"time": times, "latitude": COMMON_GRID_LATS,
               "longitude": COMMON_GRID_LONS}
    Ut, Vt = (Field(a, DIMS3, ccoords) for a in truncated)
    pos = {k: parcel_propagation(Ut, Vt, DT, SETTLS_order=SETTLS_ORDER,
                                 cyclic_xboundary=True, verbose=False,
                                 kernel=k, device=dev)
           for k in ("cuda", "torch")}
    same = all(np.array_equal(a.data, b.data)
               for a, b in zip(pos["cuda"], pos["torch"]))
    check(same, f"departure points on the common grid: kernel='cuda' and "
          f"kernel='torch' identical={same}")

    # a CLI run is one process per file, so it pays the first call's
    # set-up (SHT operators, cuFFT plans); a second call shows the rest.
    # It takes the record in ERA5's order, latitude 90 -> -90, as a file
    # stores it: ordered on the card, the same FTLE bit for bit
    era5 = {"time": times, "latitude": grid.lats[::-1],
            "longitude": grid.lons}
    Ue, Ve = (Field(np.ascontiguousarray(a[:, ::-1]), DIMS3, era5, name=n)
              for a, n in ((u64, "u"), (v64, "v")))
    sync()
    reset_counts()
    t0 = time.perf_counter()
    with StageClock() as clock:
        era5_out = LCS(timestep=DT, SETTLS_order=SETTLS_ORDER, device=dev)(
            u=Ue, v=Ve, verbose=False, isglobal=True, truncation=TRUNCATION)
    wall = (time.perf_counter() - t0) * 1e3
    log("facade stages, second call, ERA5's order (ms): " + json.dumps(
        {k: round(v, 3) for k, v in clock.ms.items()})
        + f", wall {wall:.3f} ms [{card}]")
    digest = hashlib.sha256(out.data.tobytes()).hexdigest()
    check(TRANSFERS == ONE_CROSSING
          and np.array_equal(era5_out.data, out.data, equal_nan=True),
          f"ERA5's order: transfers {json.dumps(TRANSFERS)}, FTLE "
          f"identical to the ascending record's (sha256 {digest})")
    return launches, truncated


# NCEP reanalysis' CF time unit, which numpy's own parser refuses; days
# from its origin to the two records' starts and from 1970 to 2300, counted
# by leap years (every 4th, less the centuries not divisible by 400)
NCEP_UNITS = "hours since 1800-1-1 00:00:0.0"
DAYS_1800_TO = {2300: 500 * 365 + 121, 2020: 220 * 365 + 53}
DAYS_1970_2300 = 330 * 365 + 80


def phase_labels(dev, card, check, sync, u64, v64, grid, truncated):
    """Phase 8c: the facade on the flagship winds labelled in 2300, outside
    datetime64[ns]'s 1678-2262, by the port's CF decoder from NCEP's unit
    string: (a) ``LCS(resample="12h")`` runs through ``settls_step`` and
    gives the FTLE of the same winds labelled from 2020, bit for bit; (b)
    ``parcel_propagation(return_traj=True)`` on phase 8's truncated winds
    carries the 2300 instants, computed here from integers; (c) a resample
    alias pandas 3 removed ("3H") raises ``ValueError`` before any launch.
    Returns its ``settls_step`` launches."""
    from lagrangiancoherence_tpu_torch import LCS, Field, parcel_propagation
    from lagrangiancoherence_tpu_torch.api import (COMMON_GRID_LATS,
                                                   COMMON_GRID_LONS)
    from lagrangiancoherence_tpu_torch.bench import launch_counts
    from lagrangiancoherence_tpu_torch.devices import TRANSFERS
    from lagrangiancoherence_tpu_torch.utils.io import _decode_times
    ny, nx = grid.shape
    log(f"== phase 8c: LCS(resample='12h', isglobal=True) and "
        f"parcel_propagation(return_traj=True) on the flagship winds "
        f"({nx}x{ny}, T={NT}, SETTLS-{SETTLS_ORDER}) labelled from "
        f"2300-01-01 by {NCEP_UNITS!r}, through settls_step [{card}]")
    t_phase = time.perf_counter()

    def seconds(labels):
        """Whole seconds since 1970 of datetime64 labels, or None where a
        label is not a whole second."""
        s = labels.astype("datetime64[s]")
        whole = bool((s.astype(labels.dtype) == labels).all())
        return s.astype(np.int64).tolist() if whole else None

    want = [DAYS_1970_2300 * 86400 + k * 6 * 3600 for k in range(NT)]
    times = {yr: _decode_times(24.0 * days + 6.0 * np.arange(NT), NCEP_UNITS)
             for yr, days in DAYS_1800_TO.items()}
    check(seconds(times[2300]) == want, f"decoded labels: "
          f"{times[2300][0]} .. {times[2300][-1]} ({times[2300].dtype}), "
          f"the 2300 instants from integers")

    def winds(yr):
        coords = {"time": times[yr], "latitude": grid.lats,
                  "longitude": grid.lons}
        return Field(u64, DIMS3, coords, name="u"), \
            Field(v64, DIMS3, coords, name="v")

    def counted(fn):
        sync()
        reset_counts()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, launch_counts(), (time.perf_counter() - t0) * 1e3

    def others(c):
        return sum(v for k, v in c.items()
                   if k not in ("settls_step", "spline_prefilter"))

    # (a) 33 six-hourly levels resample to 17 twelve-hourly ones: 16 steps
    steps = (NT - 1) // 2
    ftle, launches = {}, 0
    for yr in (2300, 2020):
        U, V = winds(yr)
        ftle[yr], c, wall = counted(lambda: LCS(
            timestep=DT, SETTLS_order=SETTLS_ORDER, device=dev)(
            u=U, v=V, verbose=False, resample="12h", isglobal=True,
            truncation=TRUNCATION))
        launches += c["settls_step"]
        log(f"LCS(resample='12h') labelled from {yr}: {wall:.3f} ms wall, "
            f"launches {json.dumps(c)} [{card}]")
        check(c["settls_step"] == steps and c["spline_prefilter"] == 2
              and others(c) == 0 and TRANSFERS == ONE_CROSSING,
              f"{yr}: settls_step launches {c['settls_step']} == {steps}, "
              f"spline_prefilter {c['spline_prefilter']} == 2, other "
              f"kernels {others(c)} == 0; transfers "
              f"{json.dumps(TRANSFERS)}")
    a, b = ftle[2300], ftle[2020]
    inner = a.data[0, 5:-5]
    check(a.shape == (1, COMMON_GRID_LATS.size, COMMON_GRID_LONS.size)
          and bool(np.isfinite(inner).all())
          and np.array_equal(a.data, b.data, equal_nan=True),
          f"FTLE labelled 2300: shape {a.shape}, rows [5:-5] finite, "
          f"identical to the 2020 record's (sha256 "
          f"{hashlib.sha256(a.data.tobytes()).hexdigest()})")
    # backward: the field is stamped with the window's first label
    check(seconds(np.asarray(a.coords["time"])) == want[:1],
          f"FTLE label {a.coords['time'][0]} == 2300-01-01T00")

    # (b) the trajectories on the truncated winds carry the 2300 labels,
    # reversed by the backward step (quirk Q2)
    ccoords = {"time": times[2300], "latitude": COMMON_GRID_LATS,
               "longitude": COMMON_GRID_LONS}
    Ut, Vt = (Field(x, DIMS3, ccoords) for x in truncated)
    (tx, ty), c, wall = counted(lambda: parcel_propagation(
        Ut, Vt, DT, SETTLS_order=SETTLS_ORDER, cyclic_xboundary=True,
        verbose=False, return_traj=True, device=dev))
    launches += c["settls_step"]
    log(f"parcel_propagation(return_traj=True): {wall:.3f} ms wall, "
        f"launches {json.dumps(c)} [{card}]")
    two_back = {**ONE_CROSSING, "downloads": 2}
    check(c["settls_step"] == NT - 1 and c["spline_prefilter"] == 2
          and others(c) == 0 and TRANSFERS == two_back,
          f"trajectories: settls_step launches {c['settls_step']} == "
          f"{NT - 1}, spline_prefilter {c['spline_prefilter']} == 2, other "
          f"kernels {others(c)} == 0; transfers {json.dumps(TRANSFERS)} == "
          f"{json.dumps(two_back)}")
    labels = np.asarray(tx.coords["time"])
    digest = hashlib.sha256(tx.data.tobytes() + ty.data.tobytes()).hexdigest()
    check(seconds(labels) == want[::-1]
          and np.array_equal(labels, ty.coords["time"])
          and bool(np.isfinite(tx.data).all() and np.isfinite(ty.data).all()),
          f"trajectories {tx.shape}: labels {labels[0]} .. {labels[-1]} == "
          f"the 2300 instants reversed; positions finite (sha256 {digest})")

    # (c) an alias pandas 3 removed raises before any launch
    U, V = winds(2300)
    sync()
    reset_counts()
    try:
        LCS(timestep=DT, SETTLS_order=SETTLS_ORDER, device=dev)(
            u=U, v=V, verbose=False, resample="3H", isglobal=True,
            truncation=TRUNCATION)
        raised = "nothing"
    except ValueError as e:
        raised = f"ValueError: {e}"
    c = launch_counts()
    check(raised.startswith("ValueError") and sum(c.values()) == 0,
          f"resample='3H' raised {raised!r}; launches {json.dumps(c)}")
    log(f"phase 8c: {(time.perf_counter() - t_phase) * 1e3:.3f} ms wall "
        f"[{card}]")
    return launches


def phase_area(dev, card, check, sync):
    """Phase 8b: one area-of-influence case (``examples/area_of_influence
    .case``, stages 1-7) on the example's own fields at ERA5's 0.25 degrees
    over its box, through the fused step, then ``find_area``.  The case is
    timed by its spans, its ``skeletonize`` sweeps counted, a warm case
    profiled, and its outputs held equal to the same case through the
    plain step.  Its diagnostics (float32 on the card) are held against the
    same calls in float64 on the CPU, each fed the card's output of the
    stage before.  Returns the fused step's launches in the first case."""
    import torch
    from lagrangiancoherence_tpu_torch import (filter_ridges, find_area,
                                              find_ridges_spherical_hessian)
    from lagrangiancoherence_tpu_torch.examples import area_of_influence
    from lagrangiancoherence_tpu_torch.ops import (cuda_interp, cuda_settls,
                                                  morphology)
    from lagrangiancoherence_tpu_torch.ops.morphology import (skeletonize,
                                                              threshold_local)
    data = area_of_influence.synthetic_era5(nt=AREA_NT, ny=AREA_BOX[0],
                                            nx=AREA_BOX[1])
    lats = np.sort(data["pr"].coords["latitude"])
    lons = np.sort(data["pr"].coords["longitude"])
    log(f"== phase 8b: area-of-influence case, {lons.size}x{lats.size} at "
        f"0.25 deg, {AREA_NT} levels, SETTLS-{SETTLS_ORDER} with "
        f"resample='3h' [{card}]")
    ms = {}

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        ms[name] = (time.perf_counter() - t0) * 1e3
        return out

    def case(name, **kw):
        sweeps = morphology.SWEEPS
        with StageClock() as clock:
            out = timed(name, lambda: area_of_influence.case(
                **data, device=dev, **kw))
        log(f"{name}: {ms[name]:.3f} ms, skeletonize sweeps "
            f"{morphology.SWEEPS - sweeps}, spans (ms, the last of each "
            f"name) " + json.dumps({k: round(v, 3) for k, v in
                                    clock.ms.items()}) + f" [{card}]")
        return out, morphology.SWEEPS - sweeps

    sync()
    cuda_settls.LAUNCHES = cuda_interp.LAUNCHES = 0
    out, sweeps = case("case, first")
    launches, k1 = cuda_settls.LAUNCHES, cuda_interp.LAUNCHES
    # 3-hourly steps over the window, then the one local step
    expected = 2 * (AREA_WINDOW - 1) + 1
    check(launches == expected and k1 == 0, f"settls_step launches in the "
          f"case {launches} == {expected}, K1 launches {k1} == 0")
    check(0 < sweeps <= 256, f"skeletonize sweeps in the case: {sweeps}")
    case("case, second")
    _, wall, busy, top, where = profile_call(
        lambda: area_of_influence.case(**data, device=dev))
    log(f"case under torch.profiler: wall {wall:.3f} ms, device busy "
        f"{busy:.3f} ms, most host self time (ms, calls) {json.dumps(top)}; "
        f"heaviest events (ms, shapes) {json.dumps(where)} [{card}]")
    plain, _ = case("case, plain step", kernel="torch")
    for k, got in out.items():
        want = plain[k]
        a, b = (np.asarray(x.data if hasattr(x, "dims") else x)
                for x in (got, want))
        same = np.array_equal(a, b, equal_nan=True) if a.dtype != object \
            else a.tolist() == b.tolist()
        check(same, f"case {k}: through the fused step identical to the "
              f"plain step's on the card: {same}")
    log(f"case: {int((out['ridges'].data > 0).sum())} filtered ridge "
        f"pixels, {int(np.nansum(out['ridges_high_gradient'].data > 0))} of "
        f"high pressure gradient; rain total {out['total_rain']:.1f}, on "
        f"CZs {out['rain_on_czs']:.1f}, on local strain "
        f"{out['rain_on_local_strain']:.1f} [{card}]")
    fl, fll = out["log_ftle"], out["log_ftle_local"]
    block = min(301, (min(fll.shape) // 2) * 2 + 1)

    def diagnostics(device):
        """The case's threshold and ridges on ``device`` in the default
        dtype, on the card's log-FTLE fields."""
        return {"threshold": timed(f"threshold_local[{device}]", lambda:
                                   threshold_local(fll.data, block,
                                                   offset=-0.8,
                                                   device=device)
                                   .cpu().numpy()),
                "ridges": timed(f"ridges[{device}]", lambda:
                                find_ridges_spherical_hessian(
                                    fl, sigma=RIDGE_SIGMA,
                                    tolerance_threshold=RIDGE_TOL,
                                    return_eigvectors=True, isglobal=False,
                                    device=device))}

    def downstream(device, ridges, eigvectors):
        skel = timed(f"skeletonize[{device}]", lambda: skeletonize(
            ridges.data, device=device))
        kept = timed(f"filter_ridges[{device}]", lambda: filter_ridges(
            skel, fl.data, *FILTER))
        area = timed(f"find_area[{device}]", lambda: find_area(
            fl, eigvectors, ridges.copy(data=kept), device=device))
        return skel.cpu().numpy(), kept, area.data

    card_out = diagnostics(dev)
    check(np.array_equal(card_out["ridges"][0].data, out["ridges_raw"]),
          "the ridges of the case's log-FTLE on the card again: the case's "
          "ridge mask")
    card_down = downstream(dev, card_out["ridges"][0], card_out["ridges"][3])
    check(np.array_equal(card_down[0], out["skeleton"])
          and np.array_equal(np.nan_to_num(card_down[1]), out["ridges"].data),
          "skeletonize and filter_ridges on the card again: the case's")
    torch.set_default_dtype(torch.float64)
    try:
        cpu_out = diagnostics("cpu")
        cpu_down = downstream("cpu", card_out["ridges"][0],
                              card_out["ridges"][3])
    finally:
        torch.set_default_dtype(torch.float32)
    log("stages (ms): " + json.dumps({k: round(v, 3) for k, v in ms.items()})
        + f" [{card}]")

    # threshold_local: values, and the mask away from its threshold
    thr, thr64 = card_out["threshold"], cpu_out["threshold"]
    near = np.abs(fll.data - thr64) <= DIAG_REL * np.abs(thr64).max()
    diff = (fll.data > thr) != (fll.data > thr64)
    e = rel_err(thr, thr64)
    check(e <= DIAG_REL and not (diff & ~near).any(),
          f"threshold_local f32 vs f64: {e:.3e} (<= {DIAG_REL:g}); mask "
          f"differs at {int(diff.sum())} of {int(near.sum())} points near "
          f"the threshold, none elsewhere")
    # ridges: eigen-quantities away from the tests' thresholds
    ridges, eigmin, dt_prod, eigvectors, gradient, angle = card_out["ridges"]
    r64, em64, dt64, ev64, g64, an64 = cpu_out["ridges"]
    lam0, lam1 = hessian_eigenvalues(fl.data, lats, lons)
    lam_scale = max(np.abs(lam0).max(), np.abs(lam1).max())
    near = {
        # eigmin's sign (the ridge test and the eigvector zeroing)
        "sign": np.abs(em64.data) <= DIAG_REL * lam_scale,
        # quirk Q7: eigmin picks the larger-|lambda| eigenvalue
        "pick": np.abs(np.abs(lam0) - np.abs(lam1)) <= DIAG_REL * lam_scale,
        # |dt_prod| <= tolerance
        "tol": np.abs(np.abs(dt64.data) - RIDGE_TOL)
        <= DIAG_REL * np.abs(dt64.data).max(),
        # nearly equal eigenvalues: the eigvector direction is unstable
        "degenerate": lam1 - lam0 <= DIAG_REL * lam_scale,
        # ev[..., 1] near 0 on a kept eigvector: the angle's +-90 seam
        "seam": (np.abs(ev64.data[1]) <= DIAG_REL) & (em64.data < 0),
    }
    for k, m in near.items():
        log(f"  points within {DIAG_REL:g} of the {k} threshold: "
            f"{int(m.sum())} of {m.size}")
    steady = ~(near["sign"] | near["pick"] | near["degenerate"])
    for name, got, want, keep in (
            ("gradient", gradient.data, g64.data, None),
            ("dt_prod", dt_prod.data, dt64.data, None),
            ("eigmin", eigmin.data, em64.data, ~near["pick"]),
            ("eigvectors", eigvectors.data, ev64.data, steady),
            ("angle", angle.data, an64.data, steady & ~near["seam"])):
        if keep is not None:
            got, want = got[..., keep], want[..., keep]
        e = rel_err(got, want)
        check(e <= DIAG_REL, f"{name} f32 vs f64: {e:.3e} of max "
              f"(<= {DIAG_REL:g})")
    diff = ridges.data != r64.data
    near_r = near["sign"] | near["pick"] | near["tol"]
    check(not (diff & ~near_r).any(),
          f"ridges mask: {int(ridges.data.sum())} ridge points; differs at "
          f"{int(diff.sum())} of {int(near_r.sum())} points near a "
          f"threshold, none elsewhere")
    # skeletonize and filter_ridges on equal inputs: identical
    (skel, kept, area), (skel64, kept64, area64) = card_down, cpu_down
    check(np.array_equal(skel, skel64),
          f"skeletonize card vs CPU: identical ({int(skel.sum())} points)")
    check(np.array_equal(kept, kept64, equal_nan=True),
          f"filter_ridges of the card's and the CPU's skeleton tensors: "
          f"identical ({int(np.nansum(kept))} points kept)")
    # find_area: float32 walk vs float64, away from its thresholds
    ev = np.moveaxis(eigvectors.data, 0, -1).astype(np.float64)
    unsure = area_uncertain(fl.data, ev, kept, lats, lons)
    diff = area != area64
    check(area.sum() > 0 and not (diff & ~unsure).any(),
          f"find_area: {int(area.sum())} cells; f32 vs f64 differs at "
          f"{int(diff.sum())} of {int(unsure.sum())} cells near a walk "
          f"threshold, none elsewhere")
    return launches


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def series_winds(grid, nt=SERIES_LEVELS):
    """Phase 9's record: ``bench_winds`` over ``nt`` six-hourly levels as
    host ``Field``s, and the same winds in float32 numpy."""
    from lagrangiancoherence_tpu_torch import Field
    from lagrangiancoherence_tpu_torch.bench import bench_winds
    u, v = bench_winds(grid, nt, np.float64)
    times = np.datetime64("2020-01-01", "ns") \
        + np.arange(nt) * np.timedelta64(6, "h")
    coords = {"time": times, "latitude": grid.lats, "longitude": grid.lons}
    return (Field(u, DIMS3, coords, name="u"),
            Field(v, DIMS3, coords, name="v"), u.astype(np.float32),
            v.astype(np.float32), times)


def phase_series(dev, card, check, grid, by_path):
    """Phase 9: ``ftle_series`` on the flagship grid (a ``SERIES_LEVELS``
    level record, window ``NT``, stride 1), each window against
    ``ftle_pipeline`` on the same slice, and through a ``batch_mesh`` of the
    card twice.  The record crosses to the card once a wind component and
    only the fields come back (``devices.TRANSFERS``); stored as ERA5
    stores it (latitude 90 -> -90) it is put in order on the card and gives
    the same fields bit for bit.  Returns its ``settls_step`` launches."""
    import torch
    from lagrangiancoherence_tpu_torch import Field, ftle_pipeline, ftle_series
    from lagrangiancoherence_tpu_torch.bench import event_ms, launch_counts
    from lagrangiancoherence_tpu_torch.devices import TRANSFERS, upload
    from lagrangiancoherence_tpu_torch.ops import cuda_settls
    from lagrangiancoherence_tpu_torch.parallel.mesh import batch_mesh
    from lagrangiancoherence_tpu_torch.runners import AUTO_BATCH, _prep_record
    ny, nx = grid.shape
    U, V, u32, v32, times = series_winds(grid)
    starts = list(range(SERIES_LEVELS - NT + 1))
    log(f"== phase 9: ftle_series, {nx}x{ny}, {SERIES_LEVELS} levels, "
        f"window {NT}, stride 1 ({len(starts)} windows), SETTLS-"
        f"{SETTLS_ORDER}, f32, engine='auto' [{card}]; ftle_series_to_files "
        f"is not driven here: this machine has no h5py (the CPU tests hold "
        f"its files and its skip-before-compute contract)")
    kw = dict(window=NT, stride=1, settls_order=SETTLS_ORDER,
              interp_order=ORDER)
    torch.cuda.synchronize()
    reset_counts()
    series = ftle_series(U, V, DT, device=dev, **kw)
    torch.cuda.synchronize()
    by_path["phase 9 series"] = c = launch_counts()
    # each chunk of windows: its fields and its overflow words come back
    series_crossing = dict(TRANSFERS)
    chunks = -(-len(starts) // AUTO_BATCH)
    check(series_crossing == {**ONE_CROSSING, "downloads": 2 * chunks},
          f"series transfers {json.dumps(series_crossing)}: 2 uploads, each "
          f"of the {chunks} chunks' fields and words back, no host reorder")
    launches, k1 = c["settls_step"], c["spline_gather"]
    expected = (NT - 1) * len(starts)
    check(launches == expected and k1 == 0
          and c["spline_prefilter"] == 2 * len(starts),
          f"series: settls_step launches {launches} == {expected}, K1 "
          f"launches {k1} == 0, spline_prefilter {c['spline_prefilter']} == "
          f"{2 * len(starts)} (one a wind component a window)")
    ud = torch.tensor(u32, device=dev)
    vd = torch.tensor(v32, device=dev)
    for i, s in enumerate(starts):
        want = ftle_pipeline(ud[s:s + NT], vd[s:s + NT], DT, grid,
                             settls_order=SETTLS_ORDER,
                             interp_order=ORDER).cpu()
        same, err, where = same_values(torch.from_numpy(series.data[i]),
                                       want)
        finite = bool(np.isfinite(series.data[i][2:-2]).all())
        check(same and finite and series.coords["time"][i] == times[s],
              f"series window {i} (levels {s}-{s + NT - 1}): identical to "
              f"ftle_pipeline on the slice={same}"
              + ("" if same else f" (max|d|={err:.3e} at {where})")
              + f", rows [2:-2] finite={finite}, stamped with its first "
              f"time")
    mesh = batch_mesh(devices=[dev] * 2)
    cuda_settls.LAUNCHES = 0
    meshed = ftle_series(U, V, DT, mesh=mesh, **kw)
    torch.cuda.synchronize()
    launches += cuda_settls.LAUNCHES
    same = np.array_equal(meshed.data, series.data, equal_nan=True)
    check(same and cuda_settls.LAUNCHES == expected,
          f"series through batch_mesh(devices=[card] * 2): identical="
          f"{same}, settls_step launches {cuda_settls.LAUNCHES} == "
          f"{expected}")

    # the record as ERA5 stores it, latitude 90 -> -90: put in order on
    # the card, the same fields bit for bit
    era5 = {**U.coords, "latitude": grid.lats[::-1]}
    Ue, Ve = (Field(np.ascontiguousarray(f.data[:, ::-1]), DIMS3, era5,
                    name=f.name) for f in (U, V))
    reset_counts()
    era5_series = ftle_series(Ue, Ve, DT, device=dev, **kw)
    same = np.array_equal(era5_series.data, series.data, equal_nan=True) \
        and np.array_equal(era5_series.coords["latitude"], grid.lats)
    check(same and TRANSFERS == series_crossing,
          f"series on ERA5's order: identical to the ascending record's="
          f"{same}, latitudes ascending; transfers {json.dumps(TRANSFERS)} "
          f"(sha256 {hashlib.sha256(series.data.tobytes()).hexdigest()})")

    series_ms = event_ms(lambda: ftle_series(Ue, Ve, DT, device=dev, **kw),
                         1, REPS)
    one_ms = event_ms(lambda: ftle_pipeline(
        ud[:NT], vd[:NT], DT, grid, settls_order=SETTLS_ORDER,
        interp_order=ORDER).cpu(), 1, REPS)

    def prep_upload():
        Ur, Vr = _prep_record(Ue, Ve, "time")
        return sum(upload(f, dev, ascending=True)[0].sum().item()
                   for f in (Ur, Vr))
    prep_ms = event_ms(prep_upload, 1, REPS)
    med, lo, hi = spread(series_ms)
    per = [t / len(starts) for t in (med, lo, hi)]
    log(f"series: {med:.3f} ms [{lo:.3f}, {hi:.3f}] a series of "
        f"{len(starts)} windows, {per[0]:.3f} ms [{per[1]:.3f}, "
        f"{per[2]:.3f}] a window, on ERA5's order; of a series, host prep, "
        f"upload and order on the card of the record "
        f"{spread(prep_ms)[0]:.3f} ms; one-call ftle_pipeline "
        f"(winds on the card, field to the host) "
        f"{spread(one_ms)[0]:.3f} ms [{min(one_ms):.3f}, {max(one_ms):.3f}] "
        f"(CUDA events, median [min, max] of {REPS} after a warm-up) "
        f"[{card}]")
    return launches


def reset_counts():
    from lagrangiancoherence_tpu_torch.devices import reset_transfers
    from lagrangiancoherence_tpu_torch.ops import (cuda_interp,
                                                   cuda_prefilter,
                                                   cuda_settls, cuda_window)
    cuda_settls.LAUNCHES = cuda_interp.LAUNCHES = 0
    cuda_prefilter.LAUNCHES = 0
    cuda_window.reset_launches()
    reset_transfers()


def phase_blocks(dev, card, check, grid, u32, v32, by_path):
    """Phase 10: the latitude-block pipeline on the card: ``parcel_mesh`` of
    the card repeated n times runs n blocks in sequence.  Departure points
    against the whole-grid ``parcel_propagation_core``, FTLE against
    ``ftle_pipeline``, on the direct route and on the windowed route
    (``engine="blockspec"``, 2 and 4 blocks: 160 launches a block of each
    window kernel).  Returns its ``settls_step`` launches."""
    import torch
    from lagrangiancoherence_tpu_torch import (ftle_pipeline, ftle_sharded,
                                              parcel_propagation_sharded)
    from lagrangiancoherence_tpu_torch.bench import event_ms, launch_counts
    from lagrangiancoherence_tpu_torch.models.settls import \
        parcel_propagation_core
    from lagrangiancoherence_tpu_torch.parallel.mesh import parcel_mesh
    ny, nx = grid.shape
    log(f"== phase 10: parcel_propagation_sharded and ftle_sharded, "
        f"{nx}x{ny}, T={NT}, SETTLS-{SETTLS_ORDER}, f32, blocks of the card "
        f"[{card}]")
    kw = dict(settls_order=SETTLS_ORDER, interp_order=ORDER)
    wx, wy = parcel_propagation_core(u32, v32, DT, grid, **kw)
    total = 0

    def counted(fn):
        nonlocal total
        torch.cuda.synchronize()
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = launch_counts()
        total += counts["settls_step"]
        return out, counts

    meshes = {"n=1": (parcel_mesh(devices=[dev]), 1),
              "n=4": (parcel_mesh(devices=[dev] * 4), 4),
              "2x2 (y, x)": (parcel_mesh(devices=[dev] * 4, x_parallel=2),
                             4)}
    for label, (mesh, n) in meshes.items():
        (px, py, ovf), c = counted(
            lambda: parcel_propagation_sharded(u32, v32, DT, grid, mesh,
                                               return_overflow=True, **kw))
        same = same_values(px, wx)[0] and same_values(py, wy)[0]
        launches, k1 = c["settls_step"], c["spline_gather"]
        check(same and launches == (NT - 1) * n and k1 == 0
              and int(ovf) == 0,
              f"parcel_propagation_sharded {label}: departure points "
              f"identical to the whole grid's={same}; settls_step launches "
              f"{launches} == {(NT - 1) * n}, K1 {k1} == 0, overflow "
              f"{int(ovf)} == 0")
    mesh4 = meshes["n=4"][0]
    want_f = {}
    for sigma in (None, 1.5):
        want_f[sigma] = want = ftle_pipeline(u32, v32, DT, grid, sigma=sigma,
                                             **kw)
        (out, ovf), c = counted(
            lambda: ftle_sharded(u32, v32, DT, grid, mesh4, sigma=sigma,
                                 return_overflow=True, **kw))
        same, err, where = same_values(out, want)
        launches, k1 = c["settls_step"], c["spline_gather"]
        check(same and launches == (NT - 1) * 4 and k1 == 0
              and int(ovf) == 0,
              f"ftle_sharded n=4 sigma={sigma}: identical to ftle_pipeline="
              f"{same}" + ("" if same else f" (max|d|={err:.3e} at {where})")
              + f"; settls_step launches {launches} == {(NT - 1) * 4}, K1 "
              f"{k1}, overflow {int(ovf)}")
    # the windowed route on blocks: each block routes its own tiles, sorts
    # its complete polar 8-row groups and integrates the pole-home rows from
    # their seed; identical to the whole grid's direct route, as phase 4b
    # holds the routes identical
    per_block = (NT - 1) * (1 + SETTLS_ORDER)
    for n in (2, 4):
        mesh = parcel_mesh(devices=[dev] * n)
        want_c = {k: per_block * n for k in BLOCKSPEC_LAUNCHES}
        for what, fn, want in (
                ("departure points", lambda: parcel_propagation_sharded(
                    u32, v32, DT, grid, mesh, engine="blockspec",
                    return_overflow=True, **kw), (wx, wy)),
                ("FTLE", lambda: ftle_sharded(
                    u32, v32, DT, grid, mesh, engine="blockspec",
                    return_overflow=True, **kw), (want_f[None],))):
            (*got, ovf), c = counted(fn)
            by_path[f"phase 10 blockspec n={n} {what}"] = c
            same = all(same_values(g, w)[0] for g, w in zip(got, want))
            on = {k: c[k] for k in want_c}
            check(same and int(ovf) == 0 and on == want_c
                  and c["settls_step"] == c["spline_gather"] == 0,
                  f"blockspec on {n} blocks: {what} identical to the whole "
                  f"grid's auto route={same}; overflow 0x{int(ovf):x}; "
                  f"launches {json.dumps(on)} == {per_block} x {n} each, "
                  f"settls_step {c['settls_step']}, K1 {c['spline_gather']}")
    times = {label: event_ms(lambda: ftle_sharded(
        u32, v32, DT, grid, meshes[label][0], **kw).cpu(), 1, REPS)
        for label in ("n=1", "n=4")}
    times["ftle_pipeline"] = event_ms(lambda: ftle_pipeline(
        u32, v32, DT, grid, **kw).cpu(), 1, REPS)
    log("ms a field (CUDA events, median [min, max] of "
        f"{REPS} after a warm-up, field to the host): " + "; ".join(
            f"{k} {spread(t)[0]:.3f} [{min(t):.3f}, {max(t):.3f}]"
            for k, t in times.items()) + f" [{card}]")
    times = {f"blockspec n={n}": event_ms(lambda: ftle_sharded(
        u32, v32, DT, grid, parcel_mesh(devices=[dev] * n),
        engine="blockspec", **kw).cpu(), 1, REPS) for n in (1, 2, 4)}
    times["blockspec whole grid"] = event_ms(lambda: ftle_pipeline(
        u32, v32, DT, grid, engine="blockspec", **kw).cpu(), 1, REPS)
    times["direct whole grid"] = event_ms(lambda: ftle_pipeline(
        u32, v32, DT, grid, **kw).cpu(), 1, REPS)
    log("windowed route on blocks, ms a field (CUDA events, median [min, "
        f"max] of {REPS} after a warm-up, field to the host): " + "; ".join(
            f"{k} {spread(t)[0]:.3f} [{min(t):.3f}, {max(t):.3f}]"
            for k, t in times.items()) + f" [{card}]")
    prof = profile_field(lambda: ftle_sharded(
        u32, v32, DT, grid, parcel_mesh(devices=[dev] * 2),
        engine="blockspec", **kw))
    prof["idle_share"] = 1.0 - prof["busy_ms"] / spread(
        times["blockspec n=2"])[0]
    log(f"profile blockspec n=2: {json.dumps(prof)} [{card}]")
    return total


def phase_examples(dev, card, check, by_path):
    """Phase 11: the port's examples with ``--quick`` on the card, its
    ``entry()`` and ``dryrun_multichip(4)`` over the card repeated.
    Returns their ``settls_step`` launches."""
    import torch
    from lagrangiancoherence_tpu_torch.bench import launch_counts
    from lagrangiancoherence_tpu_torch.entry import dryrun_multichip, entry
    from lagrangiancoherence_tpu_torch.examples import (area_of_influence,
                                                       ideal_vortex)
    log(f"== phase 11: the examples (--quick), entry() and "
        f"dryrun_multichip(4) on the card [{card}]")
    total = 0

    def counted(label, fn):
        nonlocal total
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        by_path[f"phase 11 {label}"] = c = launch_counts()
        total += c["settls_step"]
        others = sum(v for k, v in c.items()
                     if k not in ("settls_step", "spline_prefilter"))
        log(f"{label}: {wall:.3f} ms wall (its first call; the facade's "
            f"set-up was paid in phases 8-9); launches {json.dumps(c)} "
            f"[{card}]")
        return out, c["settls_step"], others

    def prefilters(label):
        return by_path[f"phase 11 {label}"]["spline_prefilter"]

    # 4 steps each: two dye advections and two LCS runs, each prefiltering
    # both wind components once
    summary, steps, others = counted(
        "ideal_vortex --quick", lambda: ideal_vortex.main(["--quick"]))
    lam = summary["ftle"]["attracting"].data
    pf = prefilters("ideal_vortex --quick")
    check(steps == 16 and others == 0 and pf == 8
          and np.isfinite(lam[0, 5:-5]).all()
          and summary["vortex_ring_max"] > summary["global_median"],
          f"ideal_vortex --quick: settls_step launches {steps} == 16, "
          f"spline_prefilter {pf} == 8, others {others}; attracting FTLE "
          f"rows [5:-5] finite; ring max "
          f"{summary['vortex_ring_max']:.3f} > median "
          f"{summary['global_median']:.3f}")
    # 14 three-hourly steps over the window, then the one local step: two
    # runs
    summary, steps, others = counted(
        "area_of_influence --quick",
        lambda: area_of_influence.main(["--quick"]))
    pf = prefilters("area_of_influence --quick")
    check(steps == 15 and others == 0 and pf == 4
          and summary["total_rain"] > 0 and summary["ridge_pixels"] > 0,
          f"area_of_influence --quick: settls_step launches {steps} == 15, "
          f"spline_prefilter {pf} == 4, others {others}; "
          f"{summary['ridge_pixels']} ridge pixels, rain "
          f"{summary['total_rain']:.0f}")

    def run_entry():
        fn, args = entry()
        return fn(*args), args[0].device
    (out, where), steps, others = counted("entry()", run_entry)
    finite = bool(torch.isfinite(out[2:-2]).all())
    pf = prefilters("entry()")
    check(steps == 8 and others == 0 and pf == 2 and finite and out.is_cuda
          and where.type == "cuda" and out.shape == (181, 360),
          f"entry(): settls_step launches {steps} == 8, spline_prefilter "
          f"{pf} == 2, others {others}; FTLE {tuple(out.shape)} on "
          f"{out.device}, rows [2:-2] finite={finite}")
    legs, steps, _ = counted("dryrun_multichip(4)",
                             lambda: dryrun_multichip(4))
    c = by_path["phase 11 dryrun_multichip(4)"]
    windowed = [c[k] for k in BLOCKSPEC_LAUNCHES]
    check(all(legs[k] < 1e-4 for k in ("sigma", "mesh_2d", "windowed"))
          and str(legs["windowed_2d"]).startswith("SKIPPED")
          and windowed == [24] * 3 and steps == 20
          and c["spline_prefilter"] == 10,
          f"dryrun_multichip(4) over the card: legs {json.dumps(legs)}; "
          f"window kernel launches {windowed} == 4 blocks x 2 steps x 3 "
          f"groups each; settls_step {steps} == 20; spline_prefilter "
          f"{c['spline_prefilter']} == 10 (both components in each of five "
          f"calls)")
    return total


def phase_bench(card, check, want_sha, by_path):
    """Phase 12: the port's benchmark entry point ``bench.main`` (``python
    -m lagrangiancoherence_tpu_torch.bench``) on the card, ``--engine
    auto`` and ``--engine blockspec`` (2 calls a trial: a windowed field
    costs ~15 direct ones).  The bench raises on its own checks; here each
    record must show overflow 0, every kernel within GATHER_F32_ATOL of its
    plain version, fields/s > 0, a field identical to phase 4's
    ``ftle_pipeline`` on the same winds (``want_sha``: the SHA-256 of its
    bytes), the route's launches a field, the timed calls' launches as that
    times the fields, and besides them the numerics record's: the 32 steps
    to its departure points and one comparison launch a kernel.  Prints
    each record on a line of its own; returns the ``settls_step`` launches
    of the timed calls."""
    import contextlib
    import io

    import torch
    from lagrangiancoherence_tpu_torch import bench
    log(f"== phase 12: the benchmark entry point (bench.main) on the card "
        f"[{card}]")
    # the numerics record: one parcel_propagation_core (two prefilters)
    # and one prefiltered group of four fields
    record_launches = {"settls_step": NT, "spline_gather": 1,
                       "tier_window_gather.route": 1,
                       "tier_window_gather.gather": 1,
                       "pole_ladder_gather": 1, "empty_launch": 0,
                       "spline_prefilter": 3}
    routes = {"auto": ("20", {"settls_step": NT - 1, "spline_prefilter": 2}),
              "blockspec": ("2", {**BLOCKSPEC_LAUNCHES,
                                  "spline_prefilter": 2})}
    total = 0
    for engine, (reps, per_field) in routes.items():
        torch.cuda.synchronize()
        reset_counts()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = bench.main(["--engine", engine, "--reps", reps])
        torch.cuda.synchronize()
        counts = bench.launch_counts()
        lines = out.getvalue().splitlines()
        for line in lines[:-1]:
            log(f"  bench --engine {engine}: {line}")
        log(lines[-1])
        rec = json.loads(lines[-1])
        errs = rec["kernel_vs_plain_maxabs"]
        check(rc == 0 and rec["overflow"] == 0 and rec["value"] > 0
              and set(errs) == {"settls_step", "spline_gather",
                                "tier_window_gather", "pole_ladder_gather"}
              and all(e <= GATHER_F32_ATOL for e in errs.values()),
              f"bench --engine {engine}: rc {rc}, overflow {rec['overflow']}"
              f", {rec['value']:.4f} fields/s, kernel vs plain "
              f"{json.dumps(errs)} (<= {GATHER_F32_ATOL:g})")
        check(rec["ftle_sha256"] == want_sha,
              f"bench --engine {engine}: its field identical to phase 4's "
              f"ftle_pipeline on the same winds (SHA-256 "
              f"{rec['ftle_sha256'][:16]}.. == {want_sha[:16]}..)")
        launched = {k: n for k, n in rec["launches_per_field"].items() if n}
        timed = all(rec["launches"][k] == n * rec["fields"]
                    for k, n in rec["launches_per_field"].items())
        extra = {k: counts[k] - rec["launches"][k] for k in counts}
        check(launched == per_field and timed and extra == record_launches,
              f"bench --engine {engine}: launches a field "
              f"{json.dumps(launched)} == {json.dumps(per_field)}; over "
              f"{rec['fields']} fields {json.dumps(rec['launches'])}; the "
              f"numerics record's {json.dumps(extra)} == "
              f"{json.dumps(record_launches)}")
        by_path[f"phase 12 bench --engine {engine}"] = rec["launches"]
        total += rec["launches"]["settls_step"]
    return total


def phase_prefilter(dev, card, check, grid, u64, v64):
    """Phase 3d: the banded prefilter ``spline_prefilter`` against the dense
    float64 path and its plain sweep on the card, at the flagship shape
    and at small and ragged ones, in float32 and float64; on a second card,
    where there is one, the same call on each; its time beside its bound,
    the plain sweep's and the dense float32 GEMMs' (``library_ms``); and its
    launches in one resident field.  Returns its kernel record."""
    import torch
    from lagrangiancoherence_tpu_torch import FTLEPipeline
    from lagrangiancoherence_tpu_torch.bench import event_ms
    from lagrangiancoherence_tpu_torch.ops import cuda_prefilter as CP
    from lagrangiancoherence_tpu_torch.ops.interp import (
        prefilter_dense, spline_band_factors)
    log(f"== phase 3d: spline_prefilter vs the dense float64 path and the "
        f"plain sweep on the card [{card}]")
    ny, nx = grid.shape
    rng = np.random.RandomState(17)
    noise = rng.standard_normal((NT, ny, nx))
    cases = [("flagship u", u64), ("flagship v", v64),
             ("flagship white noise", noise),
             ("1-degree grid 181x360", noise[:3, :181, :360]),
             ("2x3, batch 5", noise[:5, :2, :3]),
             ("33x40, batch 2", noise[:2, :33, :40])]

    def bands(n_y, n_x, dtype, device=dev):
        return tuple(torch.tensor(spline_band_factors(n), dtype=dtype,
                                  device=device) for n in (n_y, n_x))

    errs, abs_errs = {}, {}
    for dtype, tol in ((torch.float32, PREFILTER_F32_RTOL),
                       (torch.float64, PREFILTER_F64_RTOL)):
        name = str(dtype).replace("torch.", "")
        worst = worst_abs = 0.0
        for label, a in cases:
            x = torch.tensor(np.ascontiguousarray(a), dtype=dtype,
                             device=dev)
            by, bx = bands(*x.shape[-2:], dtype)
            scale = float(x.abs().max())
            got = CP.spline_prefilter(x, by, bx)
            want = prefilter_dense(x.double(), ORDER)
            plain = CP.spline_prefilter_torch(x, by, bx)
            torch.cuda.synchronize()
            err_abs = float((got.double() - want).abs().max())
            err = err_abs / scale
            err_plain = float((got - plain).abs().max()) / scale
            # each within tol of the exact coefficients, so within 2 tol
            # of each other
            what = (f"{name} {label}: max|kernel - dense64| / max|x| = "
                    f"{err:.3e} (<= {tol:g}), vs the plain sweep "
                    f"{err_plain:.3e} (<= {2 * tol:g})")
            ok = err <= tol and err_plain <= 2 * tol
            if dtype == torch.float32:
                # at the flagship shape no worse than twice the dense
                # float32 GEMMs' own error
                dense = prefilter_dense(x, ORDER)
                err_dense = float((dense.double() - want).abs().max()) / scale
                what += f"; the dense float32 GEMMs' own {err_dense:.3e}"
                if label.startswith("flagship"):
                    what += f" (kernel <= 2x: {err <= 2 * err_dense})"
                    ok = ok and err <= 2 * err_dense
                del dense
            check(ok, what)
            worst, worst_abs = max(worst, err), max(worst_abs, err_abs)
            del x, got, want, plain
        errs[name], abs_errs[name] = worst, worst_abs
    del noise

    u32 = torch.tensor(u64, dtype=torch.float32, device=dev)
    v32 = torch.tensor(v64, dtype=torch.float32, device=dev)
    by, bx = bands(ny, nx, torch.float32)
    # a second card: the kernels' shared-memory limit is per device, and the
    # launch goes to the field's card whichever is current
    if torch.cuda.device_count() > 1:
        other = torch.device("cuda", 1)
        with torch.cuda.device(0):
            here = CP.spline_prefilter(u32, by, bx)
            there = CP.spline_prefilter(u32.to(other),
                                        *bands(ny, nx, torch.float32, other))
            torch.cuda.synchronize(other)
        same = torch.equal(here, there.to(dev))
        check(same, f"spline_prefilter on {other} (current device 0): "
                    f"identical to {dev}'s={same}")
        del here, there
    else:
        log("spline_prefilter on a second card: not run (one card)")

    # times at the flagship shape, one wind component a call (the dense
    # path's operators are built at the warm-up call)
    nbytes = 2 * u32.numel() * u32.element_size()
    bound_ms, bound_by, arith = bound(nbytes, 4 * 2 * u32.numel())
    kernel_ms = spread(event_ms(lambda: CP.spline_prefilter(u32, by, bx), 20,
                                device=dev))
    dense_ms = spread(event_ms(lambda: prefilter_dense(u32, ORDER), 5,
                               device=dev))
    plain_ms = spread(event_ms(
        lambda: CP.spline_prefilter_torch(u32, by, bx), 1, trials=3,
        device=dev))
    both_us, per_call = device_us(lambda: CP.spline_prefilter(u32, by, bx),
                                  20, "_sweep_kernel")
    lat_us, _ = device_us(lambda: CP.spline_prefilter(u32, by, bx), 20,
                          "lat_sweep_kernel")
    lon_us, _ = device_us(lambda: CP.spline_prefilter(u32, by, bx), 20,
                          "lon_sweep_kernel")
    log(f"spline_prefilter (33x721x1440 float32, one component): "
        f"{kernel_ms[0]:.4f} ms [{kernel_ms[1]:.4f}, {kernel_ms[2]:.4f}]; "
        f"device {us_text(lat_us)} latitude + {us_text(lon_us)} longitude "
        f"({per_call:g} kernels a call); bound {bound_ms:.4f} ms by "
        f"{bound_by} ({arith}), kernel/bound {kernel_ms[0] / bound_ms:.2f}; "
        f"dense float32 GEMMs {dense_ms[0]:.4f} ms [{dense_ms[1]:.4f}, "
        f"{dense_ms[2]:.4f}]; plain sweep {plain_ms[0]:.2f} ms [{card}]")

    # launches in one resident field: one a wind component
    model = FTLEPipeline(grid, settls_order=SETTLS_ORDER, interp_order=ORDER,
                         dtype=torch.float32, device=dev)
    model(u32, v32, DT)
    torch.cuda.synchronize()
    CP.LAUNCHES = 0
    model(u32, v32, DT)
    torch.cuda.synchronize()
    per_field = CP.LAUNCHES
    check(per_field == 2, f"spline_prefilter launches in one resident field: "
                          f"{per_field} == 2")
    record = {"name": "spline_prefilter", "route": "cuda",
              "source": PREFILTER_SOURCE, "replaces": None,
              "launches_per_field": per_field,
              "max_abs_err": abs_errs["float32"],
              "max_rel_err": errs, "ms": kernel_ms[0],
              "ms_min_max": kernel_ms[1:], "plain_ms": plain_ms[0],
              "bound_ms": bound_ms, "bound_by": bound_by,
              "library_ms": dense_ms[0],
              "device_us_per_launch": (None if both_us is None
                                       else both_us * per_call),
              "device_us_latitude": lat_us, "device_us_longitude": lon_us}
    log("prefilter record: " + json.dumps(record))
    return record


def log(msg=""):
    print(msg, flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA device", file=sys.stderr)
        return 2

    from lagrangiancoherence_tpu_torch import Grid, ftle_pipeline
    from lagrangiancoherence_tpu_torch.bench import (bench_winds, event_ms,
                                                     launch_counts)
    from lagrangiancoherence_tpu_torch.grid import global_quarter_degree_grid
    from lagrangiancoherence_tpu_torch.models.settls import (
        _shard_sortable_groups, _sort_bands, _sort_bin_bands,
        _sort_bin_shard, parcel_propagation_core)
    from lagrangiancoherence_tpu_torch.parallel.pipeline import block_layout
    from lagrangiancoherence_tpu_torch.ops import (_build, cuda_interp,
                                                   cuda_prefilter,
                                                   cuda_settls, cuda_window)
    from lagrangiancoherence_tpu_torch.ops.interp import (
        interp_at_parcels_multi, prefilter)
    from lagrangiancoherence_tpu_torch.ops.tiles import (DEFAULT_LADDER,
                                                         SORT_LADDER,
                                                         dma_ladder)

    failures = []
    # launches of each kernel on the paths this slice added, each path
    # counted from 0 (the kernel record carries them)
    by_path = {}

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
    if "--area" in sys.argv[1:]:
        for _ in range(2):
            phase_area(dev, card, check, torch.cuda.synchronize)
        log(f"chip_smoke --area: {len(failures)} check(s) failed")
        return 1 if failures else 0
    if "--facade" in sys.argv[1:]:
        grid = global_quarter_degree_grid()
        u64, v64 = bench_winds(grid, NT, np.float64)
        _, truncated = phase_facade(dev, card, check, torch.cuda.synchronize,
                                    u64, v64, grid, {})
        phase_labels(dev, card, check, torch.cuda.synchronize, u64, v64,
                     grid, truncated)
        phase_series(dev, card, check, grid, {})
        log(f"chip_smoke --facade: {len(failures)} check(s) failed")
        return 1 if failures else 0

    # -- 2. build ------------------------------------------------------------
    log(f"== phase 2: build settls_step, K1, tier_window_gather and the pole "
        f"ladder (one nvcc per source, in parallel) [{card}]")
    lib_path, build_s, build_log = _build.build()
    _build.load_library()
    log(f"built {lib_path.name} in {build_s:.2f} s")
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            # the kernel's name and template arguments, still mangled
            name = line.split("'")[1]
            log(f"  ptxas: {name[name.find('_cu_') + 4:]}")
        elif "Used" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # -- 3. K1 against the plain version --------------------------------------
    log(f"== phase 3: K1 vs plain on the card [{card}]")
    grid = global_quarter_degree_grid()
    ny, nx = grid.shape
    bounds = dict(x_min=grid.x_min, x_max=grid.x_max, y_min=grid.y_min,
                  y_max=grid.y_max)
    u64, v64 = bench_winds(grid, NT, np.float64)
    u32 = torch.tensor(u64.astype(np.float32), device=dev)
    v32 = torch.tensor(v64.astype(np.float32), device=dev)
    pxn, pyn = flagship_positions(grid)
    if "--prefilter" in sys.argv[1:]:
        phase_prefilter(dev, card, check, grid, u64, v64)
        log(f"chip_smoke --prefilter: {len(failures)} check(s) failed")
        return 1 if failures else 0

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

    # -- 3c. the fused step against its plain version, bit for bit -----------
    rng = np.random.RandomState(11)
    pxc = rng.uniform(-540.0, 540.0, (ny, nx)).astype(np.float32)
    pyc = rng.uniform(-100.0, 100.0, (ny, nx)).astype(np.float32)
    pxc[:, :4] = [-540.0, 540.0, -180.0, 180.0]
    step_err = phase_step_parity(
        dev, card, check, grid, u32, v32,
        [("flagship t=0", pxn, pyn, 0, ORDER),
         (f"flagship t={NT - 2}", pxn, pyn, NT - 2, ORDER),
         ("pole rows at +-2**27 deg, NaN positions", pxe, pye, 0, ORDER),
         ("longitudes across +-540 deg, latitudes past the poles", pxc, pyc,
          0, ORDER),
         ("flagship order 1", pxn, pyn, 0, 1)],
        (fl_lats, fl_lons, fu),
        [("flagship", pxn, pyn),
         ("pole rows at +-2**27 deg, NaN positions", pxe, pye)])
    prefilter_rec = phase_prefilter(dev, card, check, grid, u64, v64)
    if "--quick" in sys.argv[1:]:
        log(f"chip_smoke --quick: {len(failures)} check(s) failed")
        return 1 if failures else 0

    # -- 3b. the window tiers and the pole ladder against their plain versions
    log(f"== phase 3b: tier_window_gather and the pole ladder vs plain on the "
        f"card (flagship grid) [{card}]")
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
                 ("shear, ladder capacities 1-4", pxs, pys,
                  dict(f0=0, nf=4, wy=32, ladder=CAPPED_LADDER, sort=False)),
                 (f"pole_ladder={FORCED_POLE_LADDER}", pxs, pys,
                  dict(f0=0, nf=4, wy=32, pole_ladder=FORCED_POLE_LADDER,
                       **dfl)),
                 (f"pole_ladder={CLAMPED_POLE_LADDER}", pxs, pys,
                  dict(f0=0, nf=2, wy=32, pole_ladder=CLAMPED_POLE_LADDER,
                       **dfl))]
        for label, cx, cy, kw in cases:
            px = torch.tensor(cx, dtype=dtype, device=dev)
            py = torch.tensor(cy, dtype=dtype, device=dev)
            if kw.pop("sort"):
                px, py = sort_binned(px, py)
            runs, levels = pole_launches(
                Wd, px, py, f0=kw["f0"], nf=kw["nf"], bounds=bounds,
                pole_ladder=kw.pop("pole_ladder", None))
            res = compare_launches(runs, dtype, dev)
            for kname, (err, eq, ovf, nflag) in res.items():
                # the ladder is held to bit identity; its flags are levels
                check(err == 0.0 and eq,
                      f"{name} {label} {kname}: max|kernel-plain|={err:.3e} "
                      f"(== 0) levels equal={eq} overflow=0x{ovf:x} pole "
                      f"levels {levels}")
                window_err[kname] = max(window_err.get(kname, 0.0), err) \
                    if name == "float32" else window_err.get(kname, 0.0)
            # the spline tiers as one routed gather: against its plain
            # version (values, plan, fits, flags and overflow word), and
            # its unflagged tiles against K1 on the spline rows
            plain, _ = tier_run(CWd, px, py, "plain", bounds=bounds, **kw)
            new, _ = tier_run(CWd, px, py, "cuda", bounds=bounds, **kw)
            k1 = cuda_interp.cuda_interp_multi(
                Wd, CWd, px, py, f0=kw["f0"], nf=kw["nf"], order=ORDER,
                **bounds)[0]
            torch.cuda.synchronize()
            tier = new["plan"][:, 0]
            gy_, gx_ = new["out"].shape[1] // 8, new["out"].shape[2] // 128
            same_p, err, where = same_values(new["out"], plain["out"])
            eq_p = all(torch.equal(new[k], plain[k])
                       for k in ("plan", "fits", "flags", "overflow"))
            clean = (new["flags"] == 0).reshape(gy_, 1, gx_, 1).expand(
                gy_, 8, gx_, 128).reshape(gy_ * 8, gx_ * 128)[
                    ORDER:ny - ORDER, :nx]
            same_k = same_values(
                torch.where(clean, new["out"][:, ORDER:ny - ORDER, :nx], 0.0),
                torch.where(clean, k1[:, ORDER:ny - ORDER], 0.0))[0]
            tcounts = [int((tier == t).sum())
                       for t in range(-2, len(kw["ladder"]))]
            ovf = int(new["overflow"])
            check(same_p and eq_p and same_k,
                  f"{name} {label} tier_window_gather: identical to plain="
                  f"{same_p} (max|d|={err:.3e} at {where}), plan, fits, "
                  f"flags, overflow equal={eq_p}; unflagged tiles identical "
                  f"to K1={same_k}; overflow=0x{ovf:x} tiles flagged="
                  f"{int((new['flags'] > 0).sum())}; tiles in A-sub, A, "
                  f"ladder tiers={tcounts}")
            if name == "float32":
                window_err["tier_window_gather"] = max(
                    window_err.get("tier_window_gather", 0.0), err)
            if label.startswith("shear, ladder capacities"):
                caps = [c for _, _, c in CAPPED_LADDER]
                unfit = (new["fits"] >> 16) == 0
                want = [int((unfit & ((new["fits"] >> t) & 1 > 0)).sum())
                        for t in range(len(caps))]
                full = [t for t, c in enumerate(caps)
                        if tcounts[2 + t] == c < want[t]]
                left = int((unfit & (tier == -1)).sum())
                check(len(full) >= 3 and left > 0 and ovf & 2 != 0,
                      f"{name} capacities bind: ladder counts {tcounts[2:]} "
                      f"of capacities {caps}, tiles each tier holds {want}; "
                      f"tiers full with tiles turned away {full}; {left} "
                      f"unfit tiles left to tier A, bit 1 raised: 0x{ovf:x}")
            if label.startswith("whirl"):
                full = [n for n, (_, wx, _) in zip(tcounts[2:], kw["ladder"])
                        if wx is None]
                check(any(full), f"{name} {label} fills the full-longitude "
                      f"tiers {full}")
            if label.startswith("shear retry=0"):
                check(ovf == 1 << 2,
                      f"{name} shear retry=0 wy=16 raises bit 2 only: "
                      f"0x{ovf:x}")
            if label.startswith(f"pole_ladder={FORCED_POLE_LADDER}"):
                check(all(c > 0 for c in levels[1:]),
                      f"{name} forced pole ladder reaches levels 2 and 3: "
                      f"{levels}")
            if label.startswith(f"pole_ladder={CLAMPED_POLE_LADDER}"):
                ovf = res["pole_ladder_gather"][2]
                check(ovf == 1 << 4, f"{name} clamped pole ladder raises "
                      f"bit 4 only: 0x{ovf:x}")
        # a latitude block, as the block pipeline's windowed route lays it
        # out: the last of 4 (rows 543-720 and 3 reflected pad rows, the
        # north pole-home rows among both), block-sorted, the sort ladder;
        # the ladder on the block's candidate rows with their home-row mask
        rows = -(-ny // 4)
        home = torch.tensor(block_layout(grid, 4)["home_idx"],
                            device=dev)[3 * rows:]
        px = torch.tensor(pxn, dtype=dtype, device=dev)[home]
        py = torch.tensor(pyn, dtype=dtype, device=dev)[home]
        px, py = _sort_bin_shard((px, py), px, _shard_sortable_groups(
            home, grid, ORDER), grid)
        label = f"flagship block 4 of 4 ({home.numel()} rows, 3 reflected)"
        runs, levels = pole_launches(Wd, px, py, f0=0, nf=4, bounds=bounds,
                                     home_rows=home)
        for kname, (err, eq, ovf, _) in compare_launches(
                runs, dtype, dev).items():
            check(err == 0.0 and eq,
                  f"{name} {label} {kname} with the home-row mask: "
                  f"max|kernel-plain|={err:.3e} (== 0) levels equal={eq} "
                  f"overflow=0x{ovf:x} pole levels {levels}")
        kw = dict(f0=0, nf=4, wy=32, bounds=bounds, ladder=SORT_LADDER,
                  home_rows=home)
        plain, _ = tier_run(CWd, px, py, "plain", **kw)
        new, _ = tier_run(CWd, px, py, "cuda", **kw)
        torch.cuda.synchronize()
        same_p, err, where = same_values(new["out"], plain["out"])
        eq_p = all(torch.equal(new[k], plain[k])
                   for k in ("plan", "fits", "flags", "overflow"))
        check(same_p and eq_p and new["out"].shape[1] == -(-rows // 8) * 8,
              f"{name} {label} tier_window_gather: identical to plain="
              f"{same_p} (max|d|={err:.3e} at {where}), plan, fits, flags, "
              f"overflow equal={eq_p}; overflow=0x{int(new['overflow']):x}, "
              f"{new['plan'].shape[0]} tiles")
        del Wd, CWd

    # -- 4. main path ---------------------------------------------------------
    log("== phase 4: flagship ftle_pipeline through settls_step "
        f"({nx}x{ny}, T={NT}, settls_order={SETTLS_ORDER}, f32) [{card}]")
    from lagrangiancoherence_tpu_torch.models.settls import (grid_state,
                                                             settls_scan)
    state = grid_state(grid, dtype=torch.float32, device=dev)
    dt = torch.full((), DT, dtype=torch.float32, device=dev)
    expected = NT - 1
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    norm, overflow = ftle_pipeline(u32, v32, DT, grid,
                                   settls_order=SETTLS_ORDER,
                                   interp_order=ORDER, kernel="cuda",
                                   return_overflow=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches, k1_on_main = cuda_settls.LAUNCHES, cuda_interp.LAUNCHES
    window_on_main = sum(cuda_window.LAUNCHES.values())
    prefilter_on_main = cuda_prefilter.LAUNCHES
    finite = bool(torch.isfinite(norm[2:-2]).all())
    log(f"first call {first_s:.3f} s; FTLE norm range "
        f"[{float(norm[2:-2].min()):.4g}, {float(norm[2:-2].max()):.4g}]")
    check(launches == expected and k1_on_main == 0 and window_on_main == 0
          and prefilter_on_main == 2,
          f"settls_step launches {launches} == {expected}, K1 launches "
          f"{k1_on_main} == 0, window and pole ladder launches "
          f"{window_on_main} == 0, spline_prefilter launches "
          f"{prefilter_on_main} == 2 (one a wind component)")
    check(int(overflow) == 0, f"overflow {int(overflow)} == 0")
    check(norm.shape == (ny, nx) and finite,
          f"shape {tuple(norm.shape)}, rows [2:-2] finite={finite}")
    norm_sha = hashlib.sha256(norm.cpu().numpy().tobytes()).hexdigest()
    # the per-group K1 loop that the fused step replaced, in the same call
    torch.cuda.synchronize()
    cuda_interp.LAUNCHES = 0
    norm_k1 = k1_loop_field(u32, v32, grid, state, dt)
    torch.cuda.synchronize()
    k1_launches = cuda_interp.LAUNCHES
    k1_expected = (NT - 1) * (1 + SETTLS_ORDER)
    same, dnorm, where = same_values(norm, norm_k1)
    check(k1_launches == k1_expected and same,
          f"per-group K1 loop: {k1_launches} K1 launches (== "
          f"{k1_expected}); its FTLE identical to the fused step's={same}"
          + ("" if same else f", max|d|={dnorm:.3e} at {where}"))

    # -- 4b. the blockspec route ----------------------------------------------
    log("== phase 4b: flagship ftle_pipeline(engine='blockspec') through "
        f"tier_window_gather and the pole ladder [{card}]")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    norm_b, overflow_b = ftle_pipeline(u32, v32, DT, grid,
                                       settls_order=SETTLS_ORDER,
                                       interp_order=ORDER, kernel="cuda",
                                       engine="blockspec",
                                       return_overflow=True)
    torch.cuda.synchronize()
    first_b = time.perf_counter() - t0
    window_launch = dict(cuda_window.LAUNCHES)
    other_on_b = cuda_interp.LAUNCHES + cuda_settls.LAUNCHES
    by_path["phase 4b blockspec"] = launch_counts()
    prefilter_on_b = cuda_prefilter.LAUNCHES
    log(f"first call {first_b:.3f} s; launches {json.dumps(window_launch)}, "
        f"K1 and settls_step {other_on_b}, spline_prefilter "
        f"{prefilter_on_b}")
    check(int(overflow_b) == 0, f"blockspec overflow 0x{int(overflow_b):x} "
          f"== 0")
    on_route = {k: window_launch[k] for k in BLOCKSPEC_LAUNCHES}
    off_route = sum(window_launch.values()) - sum(on_route.values())
    check(on_route == BLOCKSPEC_LAUNCHES and off_route + other_on_b == 0
          and prefilter_on_b == 2,
          f"blockspec launches {json.dumps(on_route)} == "
          f"{json.dumps(BLOCKSPEC_LAUNCHES)}; other window kernels "
          f"{off_route}, K1 and settls_step {other_on_b} == 0, "
          f"spline_prefilter {prefilter_on_b} == 2")
    same, dnorm, _ = same_values(norm_b, norm)
    check(same, f"blockspec FTLE vs the fused step's FTLE: identical={same}, "
          f"max|d|={dnorm:.3e}")
    # engine="dma": the same route; its capacity table applies only where a
    # gather is given no ladder, and the sort-binned main path gives each
    # the sort ladder, so the launches and the field are blockspec's
    torch.cuda.synchronize()
    reset_counts()
    norm_d, overflow_d = ftle_pipeline(u32, v32, DT, grid,
                                       settls_order=SETTLS_ORDER,
                                       interp_order=ORDER, kernel="cuda",
                                       engine="dma", return_overflow=True)
    torch.cuda.synchronize()
    by_path["phase 4b dma"] = launch_counts()
    on_route = {k: cuda_window.LAUNCHES[k] for k in BLOCKSPEC_LAUNCHES}
    off_route = sum(cuda_window.LAUNCHES.values()) - sum(on_route.values()) \
        + cuda_interp.LAUNCHES + cuda_settls.LAUNCHES
    same_b = same_values(norm_d, norm_b)[0]
    same_a = same_values(norm_d, norm)[0]
    check(int(overflow_d) == 0 and on_route == BLOCKSPEC_LAUNCHES
          and off_route == 0 and cuda_prefilter.LAUNCHES == 2 and same_b
          and same_a,
          f"engine='dma': overflow 0x{int(overflow_d):x}, launches "
          f"{json.dumps(on_route)}, others {off_route}, spline_prefilter "
          f"{cuda_prefilter.LAUNCHES} == 2; FTLE identical to "
          f"blockspec={same_b}, to auto={same_a}")
    # one gather group on the dma ladder, in the grid layout (rebin=False):
    # the routed gather against its plain version, overflow word included
    n_tiles = -(-ny // 8) * -(-nx // 128)
    kw = dict(f0=0, nf=4, wy=32, bounds=bounds, ladder=dma_ladder(n_tiles))
    px, py = (torch.tensor(a, device=dev) for a in (pxn, pyn))
    plain, _ = tier_run(CW, px, py, "plain", **kw)
    new, _ = tier_run(CW, px, py, "cuda", **kw)
    torch.cuda.synchronize()
    same_p, err, where = same_values(new["out"], plain["out"])
    eq_p = all(torch.equal(new[k], plain[k])
               for k in ("plan", "fits", "flags", "overflow"))
    tier = new["plan"][:, 0]
    check(same_p and eq_p,
          f"dma ladder ({n_tiles} tiles, capacities "
          f"{[c for _, _, c in kw['ladder']]}), flagship F=4 in the grid "
          f"layout: tier_window_gather identical to plain={same_p} "
          f"(max|d|={err:.3e} at {where}), plan, fits, flags, overflow "
          f"equal={eq_p}; overflow=0x{int(new['overflow']):x}; tiles in "
          f"A-sub, A, ladder tiers="
          f"{[int((tier == t).sum()) for t in range(-2, 9)]}")
    # neither SETTLS loop waits for the card
    cu = prefilter(u32, order=ORDER)
    cv = prefilter(v32, order=ORDER)
    scan_args = (u32, v32, cu, cv, state["px0"], state["py0"], dt,
                 state["conv_x"], grid)
    scan_kw = dict(settls_order=SETTLS_ORDER, interp_order=ORDER,
                   return_traj=False, kernel="cuda")
    for engine in ("auto", "blockspec", "dma"):
        torch.cuda.synchronize()
        sync_error = None
        torch.cuda.set_sync_debug_mode("error")
        try:
            settls_scan(*scan_args, engine=engine, **scan_kw)
        except RuntimeError as e:
            sync_error = str(e).splitlines()[0]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        check(sync_error is None, f"engine={engine!r} SETTLS loop under "
              f"set_sync_debug_mode('error'): no host sync ({sync_error})")

    # -- 5. end-to-end accuracy ------------------------------------------------
    log(f"== phase 5: 1-degree global config vs the port's scipy oracle "
        f"(testing/oracle.py) [{card}]")
    from lagrangiancoherence_tpu_torch.testing.oracle import oracle_ftle
    lats1 = np.linspace(-90.0, 90.0, 181)
    lons1 = np.linspace(-180.0, 179.0, 360)
    grid1 = Grid(lats=lats1, lons=lons1, cyclic_x=True)
    u1, v1 = bench_winds(grid1, 9, np.float64)
    want1 = oracle_ftle(u1, v1, lats1, lons1, DT, settls_order=2,
                        interp_order=ORDER, cyclic_x=True)
    for engine in ("auto", "blockspec"):
        got1 = ftle_pipeline(
            torch.tensor(u1, dtype=torch.float32, device=dev),
            torch.tensor(v1, dtype=torch.float32, device=dev), DT, grid1,
            settls_order=2, interp_order=ORDER, kernel="cuda",
            engine=engine).cpu().numpy()
        if engine == "auto":
            mask = (np.isfinite(want1) & np.isfinite(got1) & (want1 > 0)
                    & (got1 > 0))
            mask[:4] = mask[-4:] = False   # the order-1/'constant' pole band
        p99 = float(np.percentile(np.abs(np.log(got1[mask])
                                         - np.log(want1[mask])), 99))
        check(p99 <= LOG_FTLE_P99_BOUND,
              f"f32 engine={engine!r} pipeline p99 |dlog-FTLE| vs oracle = "
              f"{p99:.3e} (<= {LOG_FTLE_P99_BOUND:g})")
    u1d = torch.tensor(u1, device=dev)
    v1d = torch.tensor(v1, device=dev)
    pos = {k: parcel_propagation_core(u1d, v1d, DT, grid1, settls_order=2,
                                      interp_order=ORDER, kernel=k)
           for k in ("cuda", "torch")}
    same = all(same_values(a, b)[0] for a, b in zip(pos["cuda"], pos["torch"]))
    dpos = max(float((a - b).abs().max())
               for a, b in zip(pos["cuda"], pos["torch"]))
    check(dpos <= POSITION_F64_ATOL,
          f"f64 fused step vs plain departure points: max diff {dpos:.3e} "
          f"deg (<= {POSITION_F64_ATOL:g}), identical={same}")

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

    def k1_loop_s():
        k1_loop_field(u32, v32, grid, state, dt)              # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPS):
            k1_loop_field(u32, v32, grid, state, dt)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / REPS

    # the fused route and the K1 loop in turns: fused, K1, K1, fused
    torch.cuda.reset_peak_memory_stats()
    fused_s = [pipeline_s("cuda")]
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    k1_s = [k1_loop_s(), k1_loop_s()]
    fused_s.append(pipeline_s("cuda"))
    plain_s = pipeline_s("torch")
    torch.cuda.reset_peak_memory_stats()
    bs_s = pipeline_s("cuda", "blockspec")
    peak_b = torch.cuda.max_memory_allocated() / 2 ** 30
    log("flagship ms/field (fields/s): fused step "
        + ", ".join(f"{t * 1e3:.3f} ({1.0 / t:.4f})" for t in fused_s)
        + f" (peak {peak_gb:.2f} GiB); per-group K1 loop "
        + ", ".join(f"{t * 1e3:.3f} ({1.0 / t:.4f})" for t in k1_s)
        + f"; plain {plain_s * 1e3:.3f} ({1.0 / plain_s:.4f}); blockspec "
        f"{bs_s * 1e3:.3f} ({1.0 / bs_s:.4f}, peak {peak_b:.2f} GiB) "
        f"[{card}]")
    fused_s, k1_s = float(np.mean(fused_s)), float(np.mean(k1_s))

    # one SETTLS step at the flagship positions (t = 0): the fused step, its
    # plain version, and the per-group K1 loop's step
    from lagrangiancoherence_tpu_torch.ops.cuda_settls import (
        interleave, settls_step_torch)
    px = torch.tensor(pxn, device=dev)
    py = torch.tensor(pyn, device=dev)
    CI = interleave(CW[:, 0], CW[:, 1])
    ox, oy = torch.empty_like(px), torch.empty_like(py)
    skw = step_kw(grid)
    times = {"settls_step": event_ms(
        lambda: cuda_settls.settls_step(u32, v32, CI, px, py, state["conv_x"],
                                        dt, 0, out=(ox, oy), **skw), 50)}
    dev_us = {"settls_step": device_us(
        lambda: cuda_settls.settls_step(u32, v32, CI, px, py, state["conv_x"],
                                        dt, 0, out=(ox, oy), **skw), 50,
        "settls_step_kernel")}
    # the same step as 4 latitude blocks of 181 rows (the last with 3
    # reflected pad rows), one launch each: the step of phase 10's n = 4
    home4 = torch.tensor(block_layout(grid, 4)["home_idx"],
                         dtype=torch.int32, device=dev).split(
                             -(-ny // 4))
    blocks4 = [(hr, px[hr.long()], py[hr.long()], state["conv_x"][hr.long()],
                torch.empty((hr.numel(), nx), device=dev),
                torch.empty((hr.numel(), nx), device=dev)) for hr in home4]

    def four_blocks():
        for hr, bx, by, cxb, bo, bp in blocks4:
            cuda_settls.settls_step(u32, v32, CI, bx, by, cxb, dt, 0,
                                    home_rows=hr, out=(bo, bp), **skw)
    # and the whole grid in one launch that reads its rows' home rows:
    # the home-row load without the split
    home_all = torch.arange(ny, dtype=torch.int32, device=dev)

    def whole_homes():
        cuda_settls.settls_step(u32, v32, CI, px, py, state["conv_x"], dt, 0,
                                home_rows=home_all, out=(ox, oy), **skw)
    for label, fn in ((f"as 4 blocks of {-(-ny // 4)} rows", four_blocks),
                      ("on the whole grid with home_rows", whole_homes)):
        t_ms = event_ms(fn, 50)
        us, n = device_us(fn, 50, "settls_step_kernel")
        med, lo, hi = spread(t_ms)
        log(f"  settls_step {label}: {med:.4f} ms [{lo:.4f}, {hi:.4f}] a "
            f"step (median [min, max] of {len(t_ms)} trials of 50); device "
            f"{us_text(us)} a launch x {n:g}"
            + ("" if us is None else f" = {us * n:.2f} us") + f" [{card}]")
    del blocks4
    plain_times = {"settls_step": event_ms(lambda: settls_step_torch(
        W, CW, px, py, state["conv_x"], dt, 0, **skw), 3)}
    times["K1 loop step"] = event_ms(lambda: settls_step_torch(
        W, CW, px, py, state["conv_x"], dt, 0, gather=k1_gather, **skw), 20)
    del CI
    # F=4 gather groups at the flagship positions, as each route lays them
    # out: K1 on the grid layout, the routed gather and the pole ladder
    # sort-binned with the sort ladder
    times["spline_gather"] = event_ms(lambda: cuda_interp.cuda_interp_multi(
        W, CW, px, py, f0=0, nf=4, order=ORDER, **bounds), 50)
    dev_us["spline_gather"] = device_us(
        lambda: cuda_interp.cuda_interp_multi(
            W, CW, px, py, f0=0, nf=4, order=ORDER, **bounds), 50,
        "spline_gather_kernel")
    plain_times["spline_gather"] = event_ms(lambda: interp_at_parcels_multi(
        W.reshape(-1, ny, nx)[:4], CW.reshape(-1, ny, nx)[:4], px, py,
        order=ORDER, **bounds), 5)
    spx, spy = sort_binned(px, py)
    runs, pole_levels = pole_launches(W, spx, spy, f0=0, nf=4, bounds=bounds)
    window_ms = time_launches(runs, torch.float32, dev, reps=50,
                              plain_reps=5)
    kname = "pole_ladder_gather"
    times[kname] = window_ms[kname, "cuda"]
    plain_times[kname] = window_ms[kname, "plain"]
    dev_us[kname] = window_ms[kname, "device"]
    # the spline tiers as one routed gather: the group's two launches, F=4
    # (wy 32) and F=2 (wy 64), and the device time of each kernel
    for nf_, wy_ in ((4, 32), (2, 64)):
        _, again = tier_run(CW, spx, spy, "cuda", f0=0, nf=nf_, wy=wy_,
                            bounds=bounds, ladder=SORT_LADDER)
        t_ms = event_ms(again, 50)
        r_us = device_us(again, 50, "tier_route_kernel")
        g_us = device_us(again, 50, "tier_gather_kernel")
        med, lo, hi = spread(t_ms)
        log(f"  F={nf_} wy={wy_} tier_window_gather: {med:.4f} ms [{lo:.4f}, "
            f"{hi:.4f}] a group; device: tier_route_kernel "
            f"{us_text(r_us[0])}, tier_gather_kernel {us_text(g_us[0])} "
            f"[{card}]")
        if nf_ == 4:
            times["tier_window_gather"] = t_ms
            dev_us["tier_window_gather"] = (
                None if None in (r_us[0], g_us[0])
                else (r_us[0] + g_us[0]) / 2, 2)
    _, again = tier_run(CW, spx, spy, "cuda", f0=0, nf=4, wy=32,
                        bounds=bounds, ladder=())
    log(f"  F=4 wy=32 with an empty ladder (the last CTA plans no pass): "
        f"tier_route_kernel "
        f"{us_text(device_us(again, 50, 'tier_route_kernel')[0])} [{card}]")
    _, again = tier_run(CW, spx, spy, "plain", f0=0, nf=4, wy=32,
                        bounds=bounds, ladder=SORT_LADDER)
    plain_times["tier_window_gather"] = event_ms(again, 5)
    # the kernels one F=4 gather group's spline call launches, routing and
    # torch ops included
    from lagrangiancoherence_tpu_torch.ops.window_interp import \
        windowed_interp_multi
    n_group = profile_field(lambda: windowed_interp_multi(
        W, CW, spx, spy, order=ORDER, wy=32, f0=0, nf=4, ladder=SORT_LADDER,
        skip_pole=True, kernel="cuda", **bounds))["kernels"]
    log(f"  kernels of one F=4 gather group's spline call "
        f"(windowed_interp_multi, skip_pole): {n_group} [{card}]")

    # bounds: each input byte read once and each output byte written once,
    # and the operations, for one step (settls_step) or one F=4 group at
    # the layout each route gives it
    n_all, plane = ny * nx, 4 * ny * nx
    pole_p = 2 * ORDER * nx
    work = {"settls_step": (16 * n_all + 4 * plane + 16 * pole_p + 4 * ny,
                            n_all * step_ops(SETTLS_ORDER)),
            "spline_gather": (8 * n_all + 4 * plane + 16 * n_all,
                              n_all * gather_ops(4)),
            # the packed operand in and the four values out of every point
            # of the padded slots, the raw rows in proportion to the real
            # points, and the overflow word
            "pole_ladder_gather": (
                32 * sum(pole_levels) * TILE + 4 * plane * pole_p / n_all + 4,
                pole_p * bilinear_ops(4))}
    # the routed gather: every tile's folds read once, its values written
    # once, the four coefficient planes once, and the per-tile plan, fits
    # and flag words and the overflow word
    n_tiles = -(-ny // 8) * -(-nx // 128)
    work["tier_window_gather"] = (
        (8 + 16) * n_tiles * TILE + 4 * plane + 40 * n_tiles + 4,
        n_tiles * TILE * tier_ops(4))
    bnd = {k: bound(*w) for k, w in work.items()}
    log("  K1 F=2 group (not timed): " + bound(
        16 * n_all + 2 * plane, n_all * gather_ops(2))[2])

    # one PyTorch call computing the pole ladder's function: grid_sample's
    # bilinear with zero padding on the raw fields, at the same pole-home
    # parcels (it differs from the order-1 'constant' mode only within one
    # cell outside the field)
    pole_x = torch.cat([px[:ORDER], px[-ORDER:]]).reshape(-1)
    pole_y = torch.cat([py[:ORDER], py[-ORDER:]]).reshape(-1)
    raw4 = W.reshape(-1, ny, nx)[:4][None]
    xs = nx * (pole_x - grid.x_min) / (grid.x_max - grid.x_min)
    ys = ny * (pole_y - grid.y_min) / (grid.y_max - grid.y_min)
    g = torch.stack([2.0 * xs / (nx - 1) - 1.0, 2.0 * ys / (ny - 1) - 1.0],
                    dim=-1).reshape(1, 1, pole_p, 2)

    def library_call():
        return torch.nn.functional.grid_sample(
            raw4, g, mode="bilinear", padding_mode="zeros",
            align_corners=True)

    # the ladder, an empty launch through its wrapper path and the library
    # call in turns (A, B, C, C, B, A: the host's speed drifts within a
    # call): CUDA-event trials pooled, and the host's cost of issuing each
    _, lshape, _, lrun = next(r for r in runs if r[0] == "pole_ladder_gather")
    l_out = torch.zeros(lshape, device=dev)
    l_ovf = torch.zeros((1,), dtype=torch.int32, device=dev)
    turns = {"pole_ladder_gather": lambda: lrun("cuda", l_out, None, l_ovf),
             "empty launch": lambda: lrun("empty", l_out, None, l_ovf),
             "grid_sample": library_call}
    turn_ms = {k: [] for k in turns}
    turn_host = {k: [] for k in turns}
    for k in [*turns, *reversed(turns)]:
        turn_ms[k] += event_ms(turns[k], 50)
        turn_host[k].append(host_us(turns[k]))
    turn_dev = {"pole_ladder_gather": dev_us["pole_ladder_gather"],
                "empty launch": device_us(turns["empty launch"], 50,
                                          "empty_kernel"),
                "grid_sample": device_us(library_call, 50, "")}
    for k in turns:
        med, lo, hi = spread(turn_ms[k])
        log(f"  in turns, {k}: {med * 1e3:.2f} us [{lo * 1e3:.2f}, "
            f"{hi * 1e3:.2f}] a call (CUDA events, median [min, max] of "
            f"{len(turn_ms[k])} trials of 50); {us_text(turn_dev[k][0])} on "
            f"the device x {turn_dev[k][1]:g} kernels; host alone "
            + " / ".join(f"{u:.2f}" for u in turn_host[k])
            + f" us a call (1000 unsynchronised calls, twice) [{card}]")
    times["pole_ladder_gather"] = turn_ms["pole_ladder_gather"]
    library = {"pole_ladder_gather": spread(turn_ms["grid_sample"])[0]}
    empty_us = spread(turn_ms["empty launch"])[0] * 1e3

    per_field = {"settls_step": NT - 1, "spline_gather": k1_launches,
                 **window_launch,
                 "tier_window_gather":
                 window_launch["tier_window_gather.route"]
                 + window_launch["tier_window_gather.gather"]}
    ms, plain_ms = {}, {}
    for kname in ["settls_step", "K1 loop step", "spline_gather",
                  *WINDOW_KERNELS]:
        ms[kname], lo, hi = spread(times[kname])
        line = (f"{kname}: {ms[kname]:.4f} ms [{lo:.4f}, {hi:.4f}] (median "
                f"[min, max] of {len(times[kname])} trials)")
        if kname in plain_times:
            plain_ms[kname], plo, phi = spread(plain_times[kname])
            line += f", plain {plain_ms[kname]:.4f} ms [{plo:.4f}, {phi:.4f}]"
        if dev_us.get(kname, (None,))[0] is not None:
            us, per_call = dev_us[kname]
            line += (f"; device {us:.2f} us a launch x {per_call:g} launches "
                     f"= {us * per_call:.2f} us, host issue and gaps "
                     f"{ms[kname] * 1e3 - us * per_call:.2f} us")
        if kname in bnd:
            b, by, arith = bnd[kname]
            line += (f"; bound {b:.5f} ms by {by} ({arith}); kernel/bound "
                     f"{ms[kname] / b:.2f}; launches per field "
                     f"{per_field[kname]}; library "
                     + (f"{library[kname]:.4f} ms" if kname in library
                        else "none"))
        log(f"  {line} [{card}]")
    log("kernel/bound, farthest first: " + ", ".join(
        f"{k} {ms[k] / bnd[k][0]:.2f}"
        for k in sorted(bnd, key=lambda k: -ms[k] / bnd[k][0])) + f" [{card}]")

    # stage breakdown of one field per route (host clock around
    # synchronised stages)
    from lagrangiancoherence_tpu_torch.models.ftle import (flowmap_gradient,
                                                           ftle_norm)
    stages = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cu = prefilter(u32, order=ORDER)
    cv = prefilter(v32, order=ORDER)
    torch.cuda.synchronize()
    stages["prefilter_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    spx, spy, _ = settls_scan(u32, v32, cu, cv, state["px0"], state["py0"],
                              dt, state["conv_x"], grid, engine="auto",
                              **scan_kw)
    torch.cuda.synchronize()
    stages["settls_scan_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ftle_norm(flowmap_gradient(spx, spy, grid))
    torch.cuda.synchronize()
    stages["gradient_norm_ms"] = (time.perf_counter() - t0) * 1e3
    log("stages (fused-step field; the scan includes the interleave): "
        + json.dumps({k: round(v, 3) for k, v in stages.items()})
        + f" [{card}]")
    stages = {}
    torch.cuda.synchronize()
    k1_loop_field(u32, v32, grid, state, dt, stages=stages)
    log("stages (per-group K1 loop field): " + json.dumps(
        {k: round(v, 3) for k, v in stages.items()}) + f" [{card}]")
    torch.cuda.synchronize()
    cuda_window.reset_launches()
    t0 = time.perf_counter()
    settls_scan(*scan_args, engine="blockspec", **scan_kw)
    torch.cuda.synchronize()
    log(f"stages (blockspec field): settls_scan_ms "
        f"{(time.perf_counter() - t0) * 1e3:.3f}, window launches "
        f"{sum(cuda_window.LAUNCHES.values())} [{card}]")

    # -- 7. device profile ------------------------------------------------------
    log(f"== phase 7: torch.profiler over one flagship field per route "
        f"[{card}]")
    routes = {"fused step": (fused_s, lambda: ftle_pipeline(
        u32, v32, DT, grid, settls_order=SETTLS_ORDER, interp_order=ORDER,
        kernel="cuda")),
        "per-group K1 loop": (k1_s, lambda: k1_loop_field(u32, v32, grid,
                                                          state, dt)),
        "blockspec": (bs_s, lambda: ftle_pipeline(
            u32, v32, DT, grid, settls_order=SETTLS_ORDER,
            interp_order=ORDER, kernel="cuda", engine="blockspec"))}
    for route, (wall_s, run) in routes.items():
        prof = profile_field(run)
        prof["wall_ms"] = wall_s * 1e3
        prof["idle_share"] = 1.0 - prof["busy_ms"] / prof["wall_ms"]
        log(f"profile {route}: {json.dumps(prof)} [{card}]")
        check(prof["kernels"] > 0, f"profile {route} sees device kernels: "
              f"{prof['kernels']}")

    # -- 8. the LCS facade; 8c. labels from 2300; 8b. area of influence ------
    n, truncated = phase_facade(dev, card, check, torch.cuda.synchronize,
                                u64, v64, grid, by_path)
    launches += n
    launches += phase_labels(dev, card, check, torch.cuda.synchronize, u64,
                             v64, grid, truncated)
    del truncated
    launches += phase_area(dev, card, check, torch.cuda.synchronize)

    # -- 9. the series runner; 10. the latitude-block pipeline ----------------
    launches += phase_series(dev, card, check, grid, by_path)
    launches += phase_blocks(dev, card, check, grid, u32, v32, by_path)

    # -- 11. the examples, entry() and the multi-block dry run ----------------
    launches += phase_examples(dev, card, check, by_path)

    # -- 12. the benchmark entry point ----------------------------------------
    launches += phase_bench(card, check, norm_sha, by_path)

    if failures:
        log(f"chip_smoke: {len(failures)} check(s) failed:")
        for f in failures:
            log(f"  {f}")
        return 1

    def record(name, source, replaces, n, err):
        # launches on each path this slice added; tier_window_gather's
        # count, as its "launches", is its two kernels' sum
        counters = {"tier_window_gather": ("tier_window_gather.route",
                                           "tier_window_gather.gather")}
        keys = counters.get(name, (name,))
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n, "max_abs_err": err,
                "ms": ms[name], "plain_ms": plain_ms[name],
                "bound_ms": bnd[name][0], "bound_by": bnd[name][1],
                "library_ms": library.get(name),
                "device_us_per_launch": dev_us[name][0],
                "empty_launch_us": empty_us,
                "launches_new_paths": {path: sum(c[k] for k in keys)
                                       for path, c in by_path.items()}}

    log(json.dumps({"kernels": [
        record("settls_step", STEP_SOURCE, KERNEL_REPLACES, launches,
               step_err),
        record("spline_gather", KERNEL_SOURCE, KERNEL_REPLACES, k1_launches,
               gather_err["float32"])] + [
        record(kname, WINDOW_SOURCE, replaces, per_field[kname],
               window_err[kname])
        for kname, replaced in WINDOW_KERNELS.items()
        for replaces in replaced] + [
        dict(prefilter_rec, launches=prefilter_on_main,
             empty_launch_us=empty_us,
             launches_new_paths={path: c["spline_prefilter"]
                                 for path, c in by_path.items()})]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
