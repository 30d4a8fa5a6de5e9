"""Guards for the PyTorch/CUDA port's package boundary, on the CPU.

* ``lagrangiancoherence_tpu_torch`` runs its pipeline without importing JAX
  (checked in a fresh interpreter, since this test process imports both);
* the CUDA path refuses CPU tensors and never falls back: the kernel's
  module imports without ``nvcc``, its build raises without it, and the
  launch counter stays 0 on the CPU path;
* ``chip_smoke.py`` fails without a CUDA device, and its scipy oracle (it
  may not import the JAX package) agrees with the package's oracle.
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
                            settls_order=1, return_overflow=True)
assert out.shape == (9, 10) and int(flag) == 0
assert cuda_interp.LAUNCHES == 0
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m.startswith("lagrangiancoherence_tpu."))
print("BAD", bad)
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert "BAD []" in proc.stdout, proc.stdout


def test_cuda_kernel_refuses_cpu_tensors():
    from lagrangiancoherence_tpu_torch import FTLEPipeline, Grid, ftle_pipeline
    grid = Grid(np.linspace(-90, 90, 9), np.linspace(-180, 160, 10), True)
    u = torch.ones(3, 9, 10, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ftle_pipeline(u, u, 3600.0, grid, kernel="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        FTLEPipeline(grid, kernel="cuda")


def test_cpu_path_never_launches():
    from lagrangiancoherence_tpu_torch import Grid, ftle_pipeline
    from lagrangiancoherence_tpu_torch.ops import cuda_interp, cuda_window
    before = cuda_interp.LAUNCHES
    # the blockspec route's base window needs 64 padded rows: 33, not 9
    for ny, engine in ((9, "auto"), (33, "blockspec")):
        grid = Grid(np.linspace(-90, 90, ny), np.linspace(-180, 160, 10),
                    True)
        u = torch.ones(3, ny, 10, dtype=torch.float64)
        for kernel in ("auto", "torch"):
            ftle_pipeline(u, 0.5 * u, 3600.0, grid, settls_order=1,
                          kernel=kernel, engine=engine)
    assert cuda_interp.LAUNCHES == before == 0
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
    assert [p.name for p in _build._sources()] == ["spline_gather.cu",
                                                   "window_gather.cu"]
    assert [p.name for p in _build._headers()] == ["gather_math.cuh"]
    assert set(_build.SIGNATURES) == {
        f"{k}_{t}" for k in ("spline_gather", "tile_window_gather",
                             "sub_window_gather", "pole_window_gather")
        for t in ("f32", "f64")}


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    proc = _run([sys.executable, str(REPO / "chip_smoke.py")])
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "torch.cuda.is_available() is False" in proc.stderr


def test_chip_smoke_oracle_matches_package_oracle():
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    lats = np.linspace(-90.0, 90.0, 19)
    lons = np.linspace(-180.0, 170.0, 36)
    u, v = chip_smoke.bench_winds(lats, lons, 4)
    got = chip_smoke.oracle_ftle(u, v, lats, lons, -6 * 3600.0,
                                 settls_order=2)
    want = O.oracle_ftle(u, v, lats, lons, -6 * 3600.0, settls_order=2,
                         interp_order=3, cyclic_x=True)
    np.testing.assert_allclose(got, want, rtol=1e-12)
