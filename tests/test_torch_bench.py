"""The port's benchmark entry point (``lagrangiancoherence_tpu_torch/
bench.py``) on the CPU, at a 1-degree global grid over 5 levels: the winds
are ``bench.py``'s formula, ``run`` returns ``bench.py``'s keys and the
port's, and its float32 field agrees with JAX's ``ftle_pipeline`` on the
same float32 winds (``kernel="xla"``, one jit, float32 as ``bench.py`` runs
it) within the committed float32 bound, p99 |dlog-FTLE| <= 1.5e-3
(BASELINE.md), with equal NaN patterns.  The rows whose FTLE reads an
exact-pole home row (0-2 and the last 3) are left out, as in
tests/test_torch_pipeline.py.  A bound of 1e-5 of the field's largest
value holds only in float64: at the equator the float32 norm of either
package differs from its own float64 one by up to 7e-3 of 51.5.  On the CPU
every kernel wrapper takes its plain version, so the numerics record reads
0; the card's record is ``chip_smoke.py``'s phase 12."""
import json

import jax
import numpy as np
import pytest
import torch

from lagrangiancoherence_tpu.grid import Grid as JaxGrid
from lagrangiancoherence_tpu.models.pipeline import \
    ftle_pipeline as jax_ftle_pipeline
from lagrangiancoherence_tpu_torch import Grid, bench

torch.set_num_threads(1)

LOG_FTLE_P99_BOUND = 1.5e-3
NT = 5
LATS = np.linspace(-90.0, 90.0, 181)
LONS = np.linspace(-180.0, 179.0, 360)
GRID = Grid(lats=LATS, lons=LONS, cyclic_x=True)
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "vs_north_star",
              "overflow"}
PORT_KEYS = {"device", "config", "ms_per_field", "ftle_pipeline_ms_per_call",
             "kernel_vs_plain_maxabs", "launches_per_field", "launches",
             "fields", "first_call_s", "ftle_sha256"}
KERNELS = {"settls_step", "spline_gather", "tier_window_gather",
           "pole_ladder_gather"}


def bench_py_winds(lats, lons, nt):
    """bench.py:54-67 as written there."""
    LON, LAT = np.meshgrid(np.deg2rad(lons), np.deg2rad(lats))
    base_u = 25.0 * np.cos(LAT) + 3.0 * np.cos(3 * LON) * np.sin(2 * LAT)
    base_v = 3.0 * np.sin(3 * LON) * np.cos(2 * LAT)
    t = np.arange(nt)[:, None, None]
    u = base_u[None] * (1.0 + 0.05 * np.sin(2 * np.pi * t / nt))
    v = base_v[None] * (1.0 + 0.05 * np.cos(2 * np.pi * t / nt))
    return u, v


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bench_winds_is_bench_py_formula(dtype):
    u, v = bench.bench_winds(GRID, NT, dtype)
    want_u, want_v = bench_py_winds(LATS, LONS, NT)
    assert u.dtype == v.dtype == dtype and u.shape == (NT, 181, 360)
    np.testing.assert_array_equal(u, want_u.astype(dtype))
    np.testing.assert_array_equal(v, want_v.astype(dtype))


def test_bench_winds_default_is_float32():
    assert bench.bench_winds(GRID, 2)[0].dtype == np.float32


def test_event_ms_host_clock_counts_calls():
    calls = []
    ms = bench.event_ms(lambda: calls.append(1), 3, trials=4, device="cpu")
    assert len(ms) == 4 and all(t >= 0.0 for t in ms)
    assert len(calls) == 1 + 3 * 4      # the warm-up, then the trials


def test_run_matches_jax_ftle_pipeline():
    rec, field = bench.run(GRID, NT, device="cpu", reps=1, trials=2)
    assert BENCH_KEYS | PORT_KEYS <= set(rec)
    json.dumps(rec)
    assert rec["metric"] == ("global 1deg FTLE fields/sec (360x181, 1-day, "
                             "SETTLS-4)")
    assert rec["unit"] == "fields/sec" and rec["overflow"] == 0
    assert rec["value"] == pytest.approx(1e3 / rec["ms_per_field"]["mean"])
    assert rec["vs_baseline"] == pytest.approx(rec["value"] * 131.9)
    assert rec["vs_north_star"] == rec["value"]
    assert rec["device"] == {"name": "cpu", "power_limit": "not read",
                             "clock": "host clock"}
    assert rec["config"]["engine"] == "auto" and rec["config"]["reps"] == 1
    for key in ("ms_per_field", "ftle_pipeline_ms_per_call"):
        s = rec[key]
        assert len(s["trials"]) == 2 and s["min"] <= s["median"] <= s["max"]
    # the numerics record runs on the card only; no kernel launches here
    assert rec["kernel_vs_plain_maxabs"] is None
    assert rec["fields"] == 3 + 2 * 1 * 2
    assert not any(rec["launches"].values())

    u, v = bench.bench_winds(GRID, NT)
    jgrid = JaxGrid(lats=LATS, lons=LONS, cyclic_x=True)
    with jax.enable_x64(False):
        want = np.asarray(jax.jit(lambda a, b: jax_ftle_pipeline(
            a, b, bench.DT, jgrid, settls_order=4, interp_order=3,
            kernel="xla"))(u, v))
    got = field.numpy()
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (181, 360)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.isfinite(got[2:-2]).all()
    g, w = got[3:-3], want[3:-3]
    both = (g > 0) & (w > 0)
    assert both.mean() > 0.99
    dlog = np.abs(np.log(g[both]) - np.log(w[both]))
    assert np.percentile(dlog, 99) <= LOG_FTLE_P99_BOUND


def test_numerics_record_plain_on_cpu():
    u, v = (torch.from_numpy(a) for a in bench.bench_winds(GRID, NT))
    rec = bench.numerics_record(u, v, GRID, "cpu")
    assert rec == {k: 0.0 for k in KERNELS}


def test_main_prints_record_last(monkeypatch, capsys):
    small = Grid(lats=np.linspace(-90.0, 90.0, 91),
                 lons=np.linspace(-180.0, 178.0, 180), cyclic_x=True)
    monkeypatch.setattr(bench, "global_quarter_degree_grid", lambda: small)
    monkeypatch.setattr(bench, "NT", 3)
    assert bench.main(["--device", "cpu", "--reps", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(lines[-1])
    assert BENCH_KEYS | PORT_KEYS <= set(rec)
    assert rec["config"]["rebin"] == "sort" and rec["value"] > 0
    assert any(line.startswith("FTLEPipeline built once:") for line in lines)


def test_main_without_a_card_raises():
    with pytest.raises(RuntimeError, match="is_available"):
        bench.main(["--device", "cuda"])
