"""Flagship benchmark of the port: global 0.25-degree FTLE fields/s.

Counterpart of the JAX package's ``bench.py``: the flagship config
(1440x721 parcels, 33 six-hourly levels, SETTLS-4, order 3, float32) on
the winds of ``bench.py:54-67``.  One ``FTLEPipeline`` is built once and
called ``reps`` times a trial, timed by CUDA events after a warm-up (the
warm-up builds the kernels, ``nvcc`` at first use): the counterpart of
JAX's jitted call, whose grid state lives in the executable.  The one-call
``ftle_pipeline``, which builds its grid state on every call, is timed the
same way beside it.  Then the numerics record holds each kernel of the
port against its plain version at the flagship departure points, within
the ``BASELINE.md`` float32 bound of 5e-5 (``bench.py:151-216``).

The last line of standard output is one JSON record with ``bench.py``'s
keys (``metric``, ``value`` in fields/s — the mean over the timed calls,
``unit``, ``vs_baseline``, ``vs_north_star``, ``overflow``) and the
port's: ``device``, ``config``, ``ms_per_field`` and
``ftle_pipeline_ms_per_call`` (median, min, max and mean of the trials),
``kernel_vs_plain_maxabs`` (one value a kernel), the kernels' launches per
field and over the timed calls.  There is no fallback and no setting
outside the flags: no environment variable, no config file.  A failed
check raises; without a card the default device raises::

    python -m lagrangiancoherence_tpu_torch.bench \
        [--engine auto|dma-all|blockspec|dma] [--rebin sort|false] \
        [--reps N] [--device D]
"""
from __future__ import annotations

import argparse
import hashlib
import json
import shutil
import subprocess
import time

import numpy as np
import torch

from .devices import resolve_device
from .grid import global_quarter_degree_grid
from .models.pipeline import FTLEPipeline, ftle_pipeline
from .models.settls import ENGINES, grid_state, parcel_propagation_core
from .ops import cuda_interp, cuda_prefilter, cuda_settls, cuda_window
from .ops.interp import interp_at_parcels_multi, prefilter
from .ops.window_interp import windowed_interp_multi
from .testing.oracle import REFERENCE_SECONDS_PER_FIELD

__all__ = ["bench_winds", "event_ms", "main", "numerics_record", "run"]

NT = 33                  # 8 days at 6 h (bench.py:56)
DT = -6.0 * 3600.0       # backward integration (bench.py:104)
SETTLS_ORDER = 4
ORDER = 3
REPS = 20                # calls a trial
TRIALS = 7
# max |kernel - plain| of one value in float32: BASELINE.md's contract,
# the bound of bench.py:215-216
MAXABS_BOUND = 5e-5


def bench_winds(grid, nt: int, dtype=np.float32):
    """(nt, ny, nx) u and v of ``bench.py:54-67``: a 25 m/s midlatitude jet
    with planetary waves, computed in float64 and cast to ``dtype``."""
    LON, LAT = np.meshgrid(np.deg2rad(grid.lons), np.deg2rad(grid.lats))
    base_u = 25.0 * np.cos(LAT) + 3.0 * np.cos(3 * LON) * np.sin(2 * LAT)
    base_v = 3.0 * np.sin(3 * LON) * np.cos(2 * LAT)
    t = np.arange(nt)[:, None, None]
    u = base_u[None] * (1.0 + 0.05 * np.sin(2 * np.pi * t / nt))
    v = base_v[None] * (1.0 + 0.05 * np.cos(2 * np.pi * t / nt))
    return u.astype(dtype), v.astype(dtype)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def event_ms(fn, reps: int, trials: int = TRIALS, device="cuda"):
    """Milliseconds per call of ``fn``, one value per trial of ``reps``
    calls, after a warm-up call.  On a CUDA device: CUDA events recorded
    before and after the trial's calls.  On the CPU (the tests): the host
    clock."""
    device = torch.device(device)
    fn()
    out = []
    for _ in range(trials):
        if device.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            out.append((time.perf_counter() - t0) * 1e3 / reps)
            continue
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        out.append(start.elapsed_time(end) / reps)
    return out


def launch_counts() -> dict:
    """Every launch counter of the port's kernels, by kernel."""
    return dict(cuda_window.LAUNCHES, settls_step=cuda_settls.LAUNCHES,
                spline_gather=cuda_interp.LAUNCHES,
                spline_prefilter=cuda_prefilter.LAUNCHES)


def _since(before: dict) -> dict:
    return {k: n - before[k] for k, n in launch_counts().items()}


def _maxabs(got, want) -> float:
    """max |got - want| over the finite values of ``want``; inf where the
    NaN patterns differ."""
    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        return float("inf")
    fin = torch.isfinite(want)
    return float((got - want).abs()[fin].max()) if fin.any() else 0.0


def numerics_record(u, v, grid, device=None) -> dict:
    """max |kernel - plain| of each kernel of the port at the flagship
    departure points: one ``parcel_propagation_core`` (SETTLS-4, order 3)
    gives them, and one F=4 group (``u[0], v[0], u[1], v[1]``, prefiltered)
    goes through ``windowed_interp_multi`` (``tier_window_gather`` on the
    rows between the pole-home rows, ``pole_ladder_gather`` on those) and
    K1 ``spline_gather``, each against ``interp_at_parcels_multi``; one
    ``settls_step`` from the departure points at level 0 goes against
    ``settls_step_torch``.  Raises ``AssertionError`` where a value exceeds
    ``MAXABS_BOUND``.  On CPU tensors every wrapper takes its plain
    version, so every value is 0."""
    dev = resolve_device(device, u, v)
    u, v = torch.as_tensor(u, device=dev), torch.as_tensor(v, device=dev)
    bounds = dict(x_min=grid.x_min, x_max=grid.x_max, y_min=grid.y_min,
                  y_max=grid.y_max)
    px, py = parcel_propagation_core(u, v, DT, grid,
                                     settls_order=SETTLS_ORDER,
                                     interp_order=ORDER, device=dev)
    state = grid_state(grid, dtype=u.dtype, device=dev)
    raw = torch.stack([u[0], v[0], u[1], v[1]])
    cw = prefilter(raw, order=ORDER)
    want = interp_at_parcels_multi(raw, cw, px, py, order=ORDER, **bounds)
    k1, _ = cuda_interp.cuda_interp_multi(raw, cw, px, py, order=ORDER,
                                          **bounds)
    win, _ = windowed_interp_multi(raw, cw, px, py, order=ORDER,
                                   kernel="cuda", **bounds)
    inner = slice(ORDER, px.shape[0] - ORDER)
    poles = torch.cat([torch.arange(ORDER, device=dev),
                       torch.arange(px.shape[0] - ORDER, px.shape[0],
                                    device=dev)])
    step_kw = dict(settls_order=SETTLS_ORDER, order=ORDER,
                   cyclic_x=grid.cyclic_x, **bounds)
    dt = torch.full((), DT, dtype=u.dtype, device=dev)
    step = cuda_settls.settls_step(
        raw[0::2].contiguous(), raw[1::2].contiguous(),
        cuda_settls.interleave(cw[0::2], cw[1::2]), px, py, state["conv_x"],
        dt, 0, **step_kw)
    step_want = cuda_settls.settls_step_torch(raw, cw, px, py,
                                              state["conv_x"], dt, 0,
                                              **step_kw)
    rec = {"settls_step": max(_maxabs(a, b)
                              for a, b in zip(step, step_want)),
           "spline_gather": _maxabs(k1, want),
           "tier_window_gather": _maxabs(win[:, inner], want[:, inner]),
           "pole_ladder_gather": _maxabs(win[:, poles], want[:, poles])}
    bad = {k: e for k, e in rec.items() if not e <= MAXABS_BOUND}
    if bad:
        raise AssertionError(f"kernel numerics beyond {MAXABS_BOUND:g}: "
                             f"{bad}")
    return rec


def _spread(ms) -> dict:
    return {"median": float(np.median(ms)), "min": float(min(ms)),
            "max": float(max(ms)), "mean": float(np.mean(ms)),
            "trials": [float(t) for t in ms]}


def device_info(device: torch.device) -> dict:
    """The device's name and power limit (``nvidia-smi``'s, or the name
    from torch and the limit "not read" without it) and the clock the
    times come from."""
    if device.type != "cuda":
        return {"name": str(device), "power_limit": "not read",
                "clock": "host clock"}
    name, limit = torch.cuda.get_device_name(device), "not read"
    smi = shutil.which("nvidia-smi")
    if smi:
        lines = subprocess.run(
            [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.splitlines()
        name, limit = (s.strip() for s in
                       lines[device.index or 0].split(",", 1))
    return {"name": name, "power_limit": limit, "clock": "CUDA events"}


def _same(a, b) -> bool:
    return (torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))


def run(grid, nt: int, *, device=None, engine: str = "auto", rebin="sort",
        reps: int = REPS, trials: int = TRIALS):
    """Time the FTLE pipeline on ``grid`` over ``nt`` levels of
    ``bench_winds`` in float32: one ``FTLEPipeline`` built once, warmed up
    (rows [2:-2] of its field must be finite), then ``trials`` trials of
    ``reps`` calls (``event_ms``); then ``ftle_pipeline``, one call at a
    time, the same way; its last field must equal the pipeline's.  On a
    CUDA device the numerics record follows (``numerics_record``).
    ``device``: default the CUDA card.  Returns ``(record, field)``: the
    record that ``main`` prints, and the last field."""
    dev = resolve_device(device)
    ny, nx = grid.shape
    u, v = (torch.from_numpy(a).to(dev) for a in bench_winds(grid, nt))
    kw = dict(settls_order=SETTLS_ORDER, interp_order=ORDER, engine=engine,
              rebin=rebin)
    model = FTLEPipeline(grid, dtype=torch.float32, device=dev, **kw)
    last = {}

    def pipeline_call():
        last["pipeline"] = model(u, v, DT, return_overflow=True)

    def one_call():
        last["ftle_pipeline"] = ftle_pipeline(u, v, DT, grid, **kw)

    before = launch_counts()
    _sync(dev)
    t0 = time.perf_counter()
    pipeline_call()
    _sync(dev)
    first_s = time.perf_counter() - t0
    per_field = _since(before)
    field, overflow = last["pipeline"]
    if not bool(torch.isfinite(field[2:-2]).all()):
        raise AssertionError("non-finite FTLE in rows [2:-2]")
    ms = event_ms(pipeline_call, reps, trials, dev)
    one_ms = event_ms(one_call, reps, trials, dev)
    launches = _since(before)
    field, overflow = last["pipeline"]
    if not _same(field, last["ftle_pipeline"]):
        raise AssertionError("FTLEPipeline's field differs from "
                             "ftle_pipeline's on the same winds")
    fps = 1e3 / float(np.mean(ms))
    record = {
        "metric": (f"global {360.0 / nx:g}deg FTLE fields/sec ({nx}x{ny}, "
                   f"{(nt - 1) * -DT / 86400.0:g}-day, "
                   f"SETTLS-{SETTLS_ORDER})"),
        "value": fps,
        "unit": "fields/sec",
        "vs_baseline": fps * REFERENCE_SECONDS_PER_FIELD,
        "vs_north_star": fps / 1.0,
        "overflow": int(overflow),
        "device": device_info(dev),
        "config": {"engine": engine, "rebin": rebin, "reps": reps,
                   "trials": trials, "dtype": "float32", "levels": nt,
                   "settls_order": SETTLS_ORDER, "interp_order": ORDER},
        "ms_per_field": _spread(ms),
        "ftle_pipeline_ms_per_call": _spread(one_ms),
        "kernel_vs_plain_maxabs": (numerics_record(u, v, grid, dev)
                                   if dev.type == "cuda" else None),
        "launches_per_field": per_field,
        "launches": launches,
        # the warm-up, then per timing event_ms's warm-up and its trials
        "fields": 3 + 2 * reps * trials,
        "first_call_s": first_s,
        "ftle_sha256": hashlib.sha256(
            field.cpu().numpy().tobytes()).hexdigest(),
    }
    return record, field


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="flagship FTLE fields/s of the "
                                "port, timed by CUDA events")
    p.add_argument("--engine", default="auto", choices=ENGINES)
    p.add_argument("--rebin", default="sort", choices=("sort", "false"))
    p.add_argument("--reps", type=int, default=REPS,
                   help=f"calls a trial ({TRIALS} trials)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    rec, _ = run(global_quarter_degree_grid(), NT, device=dev,
                 engine=args.engine,
                 rebin="sort" if args.rebin == "sort" else False,
                 reps=args.reps)
    d = rec["device"]
    tag = f"[{d['name']}, {d['power_limit']}; {d['clock']}]"
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {tag}")
    print(f"first call {rec['first_call_s']:.3f} s (kernels built at first "
          f"use); launches a field {json.dumps(rec['launches_per_field'])}")
    for label, key in (("FTLEPipeline built once", "ms_per_field"),
                       ("ftle_pipeline per call",
                        "ftle_pipeline_ms_per_call")):
        s = rec[key]
        print(f"{label}: {s['median']:.3f} ms a field [{s['min']:.3f}, "
              f"{s['max']:.3f}] (median [min, max] of {len(s['trials'])} "
              f"trials of {args.reps}), mean {s['mean']:.3f} ms = "
              f"{1e3 / s['mean']:.4f} fields/s {tag}")
    print("kernel vs plain max|d|: "
          f"{json.dumps(rec['kernel_vs_plain_maxabs'])} (<= {MAXABS_BOUND:g})")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
