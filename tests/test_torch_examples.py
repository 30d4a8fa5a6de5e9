"""The port's example workloads (``lagrangiancoherence_tpu_torch/
examples/``) on the CPU: the counterpart of tests/test_cli_examples.py's
``TestExamples``.  Each runs in-process with ``--quick --device cpu`` in
the default dtype, as a user runs it, in under 20 s of CPU time, and
returns the summary it prints.  The run has one torch thread and one BLAS
thread, so all its work is the calling thread's, and that thread's CPU
time is what is bounded: time spent waiting for a core on a shared
machine, and idle BLAS threads spinning, do not count (on an idle machine
the ideal vortex takes ~9 s, the area of influence ~1 s).  In float64, the ideal vortex's attracting FTLE (its
``lcs_ftle``) is held within 1e-5 of the field's largest value against
JAX's ``LCS`` on the same flow (one JAX call).  Both run as ``python
-m``."""
import contextlib
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from lagrangiancoherence_tpu.api import LCS as JaxLCS
from lagrangiancoherence_tpu.field import Field as JaxField
from lagrangiancoherence_tpu.testing import flows as JF
from lagrangiancoherence_tpu_torch.examples import (area_of_influence,
                                                   ideal_vortex)
from lagrangiancoherence_tpu_torch.ops import cuda_settls

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
QUICK_S = 20.0
FTLE_RTOL = 1e-5


@pytest.fixture
def float64():
    before = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(before)


def _run(main, capsys):
    try:
        from threadpoolctl import threadpool_limits
        one_blas_thread = threadpool_limits(1)
    except ImportError:
        one_blas_thread = contextlib.nullcontext()
    launches = cuda_settls.LAUNCHES
    with one_blas_thread:
        t0 = time.thread_time()
        summary = main(["--quick", "--device", "cpu"])
        seconds = time.thread_time() - t0
    assert seconds < QUICK_S, seconds
    assert cuda_settls.LAUNCHES == launches
    return summary, capsys.readouterr().out


def test_ideal_vortex_quick(capsys):
    summary, out = _run(ideal_vortex.main, capsys)
    assert "attracting" in out and "repelling" in out
    assert summary["vortex_ring_max"] > summary["global_median"]
    assert set(summary["ftle"]) == {"attracting", "repelling"}
    assert summary["ftle"]["attracting"].shape == (1, 360, 721)


def test_ideal_vortex_ftle_matches_jax(float64):
    cfg = dict(JF.VORTEX_CONFIG_SUBTROPICAL, nt=5)
    U, V, _, _ = ideal_vortex.make_fields(cfg)
    got = ideal_vortex.lcs_ftle(U, V, -6 * 3600, "cpu")
    # JAX's LCS on the same flow, as examples/ideal_vortex.py calls it
    u, v, lats, lons, times = JF.ideal_vortex(**cfg)
    dims = ("time", "latitude", "longitude")
    coords = dict(time=times, latitude=lats, longitude=lons)
    want = JaxLCS(timestep=-6 * 3600, timedim="time", SETTLS_order=4)(
        u=JaxField(u, dims, coords, name="u"),
        v=JaxField(v, dims, coords, name="v"), verbose=False, isglobal=True,
        interp_to_common_grid=True, truncation=20)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.coords["latitude"],
                                  want.coords["latitude"])
    g, w = np.asarray(got.data), np.asarray(want.data)
    assert g.dtype == np.float64
    assert np.array_equal(np.isnan(g), np.isnan(w))
    assert np.nanmax(np.abs(g - w)) <= FTLE_RTOL * np.nanmax(np.abs(w))


def test_area_of_influence_quick(capsys):
    summary, out = _run(area_of_influence.main, capsys)
    assert "AREA-OF-INFLUENCE PIPELINE OK" in out
    assert summary["total_rain"] > 0 and summary["rain_on_czs"] >= 0
    assert summary["ridge_pixels"] > 0
    np.testing.assert_allclose(
        summary["rain_on_czs"] + summary["rain_on_local_strain"]
        + summary["rain_remainder"], summary["total_rain"], rtol=1e-12)


def test_synthetic_era5_matches_the_jax_example():
    """The example's inputs are the JAX example's closed forms, with numpy
    time labels."""
    import runpy
    jax_example = runpy.run_path(str(REPO / "examples"
                                     / "area_of_influence.py"))
    got = area_of_influence.synthetic_era5(nt=10)
    want = jax_example["synthetic_era5"](nt=10)
    for k in want:
        np.testing.assert_array_equal(got[k].data, want[k].data)
        np.testing.assert_array_equal(
            got[k].coords["time"],
            want[k].coords["time"].astype("datetime64[ns]"))


@pytest.mark.parametrize("module", ["examples.ideal_vortex",
                                    "examples.area_of_influence", "entry"])
def test_runs_as_module(module):
    proc = subprocess.run(
        [sys.executable, "-m", f"lagrangiancoherence_tpu_torch.{module}",
         "--help"], cwd=REPO, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert "--device" in proc.stdout
