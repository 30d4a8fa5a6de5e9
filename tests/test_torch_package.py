"""Guards for the PyTorch/CUDA port's package boundary, on the CPU.

* ``lagrangiancoherence_tpu_torch`` runs its pipeline without importing JAX
  (checked in a fresh interpreter, since this test process imports both);
* the CUDA path refuses CPU tensors and never falls back: the kernel's
  module imports without ``nvcc``, its build raises without it, and the
  launch counter stays 0 on the CPU path;
* ``chip_smoke.py`` fails without a CUDA device, and the port's scipy
  oracle it uses (it may not import the JAX package) agrees with the JAX
  package's oracle;
* the facade, diagnostics, runner, block-pipeline, utility, testing,
  example and entry modules import no ``jax``, ``pandas``, ``h5py`` or
  ``xarray`` (the card's machine has no
  pandas and no h5py), and the package exports the JAX package's public
  names.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lagrangiancoherence_tpu.testing import oracle as O

REPO = Path(__file__).resolve().parents[1]

torch.set_num_threads(1)


def _run(code_or_args, env_extra=None):
    path = os.pathsep.join(p for p in (str(REPO),
                                       os.environ.get("PYTHONPATH")) if p)
    env = dict(os.environ, PYTHONPATH=path, **(env_extra or {}))
    args = code_or_args if isinstance(code_or_args, list) \
        else [sys.executable, "-c", code_or_args]
    return subprocess.run(args, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=240)


def test_port_never_imports_jax():
    code = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)
import lagrangiancoherence_tpu_torch as L
from lagrangiancoherence_tpu_torch.ops import cuda_interp
lats, lons = np.linspace(-90, 90, 9), np.linspace(-180, 160, 10)
u = np.ones((3, 9, 10)); v = 0.5 * np.ones((3, 9, 10))
out, flag = L.ftle_pipeline(u, v, -3600.0, L.Grid(lats, lons, True),
                            settls_order=1, return_overflow=True,
                            device="cpu")
assert out.shape == (9, 10) and int(flag) == 0
assert cuda_interp.LAUNCHES == 0
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m.startswith("lagrangiancoherence_tpu."))
print("BAD", bad)
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert "BAD []" in proc.stdout, proc.stdout


SLICE_MODULES = ("api", "cli", "field", "convert", "devices", "ops.sht",
                 "ops.regrid", "ops.stencil", "ops.cuda_ftle",
                 "ops.morphology", "ops.idw",
                 "models.ridges", "models.area", "models.ridge_filter",
                 "utils.io", "utils.times", "utils.logging", "runners",
                 "parallel.mesh", "parallel.halo", "parallel.pipeline",
                 "utils.profiling",
                 "utils.debug", "testing", "testing.flows", "testing.oracle",
                 "examples", "examples.ideal_vortex",
                 "examples.area_of_influence", "entry", "bench")


def test_slice_modules_import_no_jax_pandas_h5py():
    mods = ", ".join(f"lagrangiancoherence_tpu_torch.{m}"
                     for m in SLICE_MODULES)
    code = f"""
import sys
import {mods}
import lagrangiancoherence_tpu_torch as L
for name in L.__all__:
    getattr(L, name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "pandas", "h5py", "xarray",
              "lagrangiancoherence_tpu"))
print("BAD", bad)
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert "BAD []" in proc.stdout, proc.stdout


def test_exports_cover_the_facade():
    import lagrangiancoherence_tpu as J
    import lagrangiancoherence_tpu_torch as L
    facade = {"LCS", "parcel_propagation", "flowmap_gradient", "latlonsel",
              "Field", "as_field", "find_ridges_spherical_hessian",
              "find_area", "filter_ridges"}
    assert facade <= set(L.__all__) and facade <= set(J.__all__)
    for name in facade:
        assert getattr(L, name).__module__.startswith(
            "lagrangiancoherence_tpu_torch.")
    # every public name of the JAX package, and the port's own two
    assert set(L.__all__) - {"FTLEPipeline", "parcel_propagation_core"} \
        == set(J.__all__)
    assert len(J._EXPORTS) == 16 and set(J._EXPORTS) <= set(L._EXPORTS)


def test_cuda_kernel_refuses_cpu_tensors():
    from lagrangiancoherence_tpu_torch import FTLEPipeline, Grid, ftle_pipeline
    grid = Grid(np.linspace(-90, 90, 9), np.linspace(-180, 160, 10), True)
    u = torch.ones(3, 9, 10, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ftle_pipeline(u, u, 3600.0, grid, kernel="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        FTLEPipeline(grid, kernel="cuda", device="cpu")


def test_cpu_path_never_launches():
    from lagrangiancoherence_tpu_torch import Grid, ftle_pipeline
    from lagrangiancoherence_tpu_torch.ops import (cuda_interp, cuda_settls,
                                                   cuda_window)
    before = cuda_interp.LAUNCHES + cuda_settls.LAUNCHES
    # the blockspec route's base window needs 64 padded rows: 33, not 9
    for ny, engine in ((9, "auto"), (33, "blockspec")):
        grid = Grid(np.linspace(-90, 90, ny), np.linspace(-180, 160, 10),
                    True)
        u = torch.ones(3, ny, 10, dtype=torch.float64)
        for kernel in ("auto", "torch"):
            ftle_pipeline(u, 0.5 * u, 3600.0, grid, settls_order=1,
                          kernel=kernel, engine=engine)
    assert cuda_interp.LAUNCHES + cuda_settls.LAUNCHES == before == 0
    assert set(cuda_window.LAUNCHES.values()) == {0}


def test_kernel_module_imports_without_nvcc_and_build_raises():
    code = """
from lagrangiancoherence_tpu_torch.ops import _build, cuda_interp
assert cuda_interp.LAUNCHES == 0
try:
    _build.load_library()
except RuntimeError as e:
    print("RAISED", "nvcc not found" in str(e))
else:
    print("BUILT")
"""
    proc = _run(code, {"PATH": "/nonexistent", "CUDA_HOME": "/nonexistent"})
    assert proc.returncode == 0, proc.stderr
    if not Path("/usr/local/cuda/bin/nvcc").is_file():
        assert "RAISED True" in proc.stdout, proc.stdout


def test_build_names_library_by_source_hash():
    from lagrangiancoherence_tpu_torch.ops import _build
    path = _build.library_path()
    assert path.parent == REPO / "build" / "kernels"
    assert path == _build.library_path()
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert [p.name for p in _build._sources()] == ["ftle_stencil.cu",
                                                   "settls_step.cu",
                                                   "spline_gather.cu",
                                                   "spline_prefilter.cu",
                                                   "window_gather.cu"]
    assert [p.name for p in _build._headers()] == ["gather_math.cuh"]
    assert set(_build.SIGNATURES) == {
        f"{k}_{t}" for k in ("spline_gather", "settls_step",
                             "tier_window_gather", "pole_ladder_gather",
                             "empty_launch", "spline_prefilter",
                             "ftle_gradient", "ftle_norm")
        for t in ("f32", "f64")}


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    proc = _run([sys.executable, str(REPO / "chip_smoke.py")])
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "torch.cuda.is_available() is False" in proc.stderr


def _chip_smoke():
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    return chip_smoke


def test_chip_smoke_oracle_matches_package_oracle():
    """Phase 5 holds the card against the port's oracle
    (``lagrangiancoherence_tpu_torch.testing.oracle``; chip_smoke.py may not
    import the JAX package), on the port's ``bench.bench_winds`` in float64:
    it agrees with the JAX package's oracle, and chip_smoke.py keeps no copy
    of the oracle, of the winds or of the bench's timer."""
    from lagrangiancoherence_tpu_torch import Grid
    from lagrangiancoherence_tpu_torch.bench import bench_winds
    from lagrangiancoherence_tpu_torch.testing import oracle as PO
    chip_smoke = _chip_smoke()
    for name in ("oracle_ftle", "bench_winds", "event_ms"):
        assert not hasattr(chip_smoke, name), name
    lats = np.linspace(-90.0, 90.0, 19)
    lons = np.linspace(-180.0, 170.0, 36)
    u, v = bench_winds(Grid(lats=lats, lons=lons, cyclic_x=True), 4,
                       np.float64)
    got = PO.oracle_ftle(u, v, lats, lons, -6 * 3600.0, settls_order=2,
                         interp_order=3, cyclic_x=True)
    want = O.oracle_ftle(u, v, lats, lons, -6 * 3600.0, settls_order=2,
                         interp_order=3, cyclic_x=True)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_chip_smoke_area_winds_match_the_example():
    """Phase 8b's fields are the port's example's own (``synthetic_era5``,
    which its case runs on) at 0.25 degrees over the example's box: the JAX
    example's closed forms, so the moisture-flux winds too."""
    import runpy
    from lagrangiancoherence_tpu_torch.examples import area_of_influence
    example = runpy.run_path(str(REPO / "examples" / "area_of_influence.py"))
    cs = _chip_smoke()
    got = area_of_influence.synthetic_era5(nt=cs.AREA_NT, ny=cs.AREA_BOX[0],
                                           nx=cs.AREA_BOX[1])
    lats = got["viwve"].coords["latitude"]
    lons = got["viwve"].coords["longitude"]
    assert (got["viwve"].shape, np.diff(lats).max(), np.diff(lons).min()) \
        == ((16, 221, 233), 0.25, 0.25)
    want = example["synthetic_era5"](nt=16, ny=221, nx=233)
    for k in want:
        np.testing.assert_array_equal(got[k].data, want[k].data)
    np.testing.assert_array_equal(lats, want["viwve"].coords["latitude"])
    np.testing.assert_array_equal(
        got["viwve"].coords["time"],
        want["viwve"].coords["time"].astype("datetime64[ns]"))
    np.testing.assert_allclose((got["viwve"] / got["tcwv"]).data,
                               (want["viwve"] / want["tcwv"]).data,
                               rtol=1e-15)


def test_chip_smoke_area_uncertain_cells():
    """The cells find_area may mark differently in float32: none for a walk
    far from its thresholds, the bracketing cells for a walk that lands on
    a midpoint between grid columns."""
    cs = _chip_smoke()
    lats = lons = np.linspace(-10.0, 10.0, 21)
    ftle = np.full((21, 21), np.log(2.0))     # radius 1 deg
    ridges = np.full((21, 21), np.nan)
    ev = np.zeros((21, 21, 2))
    ridges[10, 10], ev[10, 10] = 1.0, [0.0, 0.8]
    assert not cs.area_uncertain(ftle, ev, ridges, lats, lons).any()
    ev[10, 10] = [0.0, 0.5]          # x steps of 0.5: every other one on a
    unsure = cs.area_uncertain(ftle, ev, ridges, lats, lons)   # midpoint
    assert unsure.any() and unsure[10].any() and not unsure[:9].any()
