"""The gradient and norm kernels' surroundings on the CPU: the row scale
kept on the device (``ops/stencil.row_scale``), the choice between the
kernels (``ops/cuda_ftle.py``, ``csrc/ftle_stencil.cu``) and the PyTorch
path of ``models/ftle.py``, and what the wrappers refuse.

The kernels themselves run only on the card (``chip_smoke.py`` phase 3e
holds them bit for bit against the PyTorch path).  Inputs are made with
numpy seeds.
"""
import sys
import types

import numpy as np
import pytest
import torch

from lagrangiancoherence_tpu_torch import Grid
from lagrangiancoherence_tpu_torch.grid import EARTH_RADIUS
from lagrangiancoherence_tpu_torch.models import ftle as F
from lagrangiancoherence_tpu_torch.ops import cuda_ftle as CF
from lagrangiancoherence_tpu_torch.ops import stencil as S
from lagrangiancoherence_tpu_torch.testing import oracle as O

torch.set_num_threads(1)

LATS = np.linspace(-90.0, 90.0, 13)
LONS = np.linspace(-180.0, 150.0, 12)
GRID = Grid(lats=LATS, lons=LONS, cyclic_x=True)


def _departures(dtype, shape=(13, 12), seed=5):
    rng = np.random.RandomState(seed)
    lon = np.broadcast_to(np.linspace(-180.0, 150.0, shape[1]), shape)
    lat = np.broadcast_to(np.linspace(-90.0, 90.0, shape[0])[:, None], shape)
    x = lon + rng.uniform(-3.0, 3.0, shape)
    y = lat + rng.uniform(-2.0, 2.0, shape)
    return torch.tensor(x, dtype=dtype), torch.tensor(y, dtype=dtype)


@pytest.fixture
def default_dtype():
    before = torch.get_default_dtype()
    yield torch.set_default_dtype
    torch.set_default_dtype(before)


@pytest.mark.parametrize("default", [torch.float32, torch.float64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_row_scale_is_the_stencils_expression(dtype, default, default_dtype):
    """The cached row scale equals the longitude derivative's ``cos(lat)``
    expression bit for bit, widened to the default dtype, and the cache
    holds one tensor a key."""
    default_dtype(default)
    y = torch.tensor(LATS, dtype=dtype) * (np.pi / 180.0)
    wide = torch.promote_types(dtype, torch.get_default_dtype())
    want = float((np.pi / 180.0) * (LONS[1] - LONS[0]) * EARTH_RADIUS) \
        * torch.cos(y).to(wide)
    got = S.row_scale(LATS, LONS, dtype, "cpu")
    assert got.dtype == wide == CF.gradient_dtype(dtype)
    assert torch.equal(got, want)
    assert S.row_scale(LATS.copy(), LONS, dtype, torch.device("cpu")) is got
    other = (torch.float64 if dtype == torch.float32 else torch.float32)
    assert S.row_scale(LATS, LONS, other, "cpu") is not got
    assert S.row_scale(LATS, LONS + 1.0, dtype, "cpu") is got
    assert S.row_scale(LATS, LONS * 0.5, dtype, "cpu") is not got
    # the longitude derivative divides by the same tensor
    values = torch.tensor(np.random.RandomState(2).randn(13, 12),
                          dtype=dtype)
    deriv = S.fourth_order_derivative(values.to(torch.float32), dim=1)
    assert torch.equal(S.derivative_spherical_coords(values, LATS, LONS,
                                                     dim=1),
                       deriv.to(dtype) / got[:, None])
    assert S.lat_scale(LATS) == float(
        (np.pi / 180.0) * (LATS[1] - LATS[0]) * EARTH_RADIUS)


@pytest.mark.parametrize("compat", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_tensors_take_the_torch_path(dtype, compat, monkeypatch):
    """On CPU tensors neither kernel launches (``LAUNCHES`` stays 0) and the
    stack is the six spherical derivatives in the reference's order; the
    field agrees with the oracle."""
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel wrapper was called on the CPU")
    monkeypatch.setattr(CF, "ftle_gradient", refuse)
    monkeypatch.setattr(CF, "ftle_norm", refuse)
    CF.reset_launches()
    x, y = _departures(dtype)
    stack = F.flowmap_gradient(x, y, GRID)
    norm = F.ftle_norm(stack, compat=compat)
    assert CF.LAUNCHES == {"ftle_gradient": 0, "ftle_norm": 0}
    assert stack.shape == (9, 13, 12) and stack.dtype == dtype
    assert not stack[6:].any()
    X = EARTH_RADIUS * torch.sin((y - 90.0) * (np.pi / 180.0)) \
        * torch.cos(x * (np.pi / 180.0))
    assert torch.equal(stack[0], S.derivative_spherical_coords(X, LATS, LONS,
                                                               dim=1))
    assert torch.equal(stack[1], S.derivative_spherical_coords(X, LATS, LONS,
                                                               dim=0))
    if dtype == torch.float64 and compat:
        want = O.oracle_ftle_norm(O.oracle_flowmap_gradient(
            x.numpy(), y.numpy(), LATS, LONS))
        np.testing.assert_allclose(norm.numpy(), want, rtol=1e-6)


def _cuda_like(shape, dtype=torch.float32):
    """What ``flowmap_gradient``'s choice reads of a tensor on the card."""
    return types.SimpleNamespace(device=torch.device("cuda", 0), dtype=dtype,
                                 ndim=len(shape), shape=torch.Size(shape))


REFUSALS = {
    "cpu tensors": (lambda: CF.ftle_gradient(
        *_departures(torch.float32), torch.ones(13), 1.0),
        ValueError, "needs a CUDA tensor"),
    "cpu stack": (lambda: CF.ftle_norm(torch.ones(9, 5, 5)), ValueError,
                  "needs a CUDA tensor"),
    "integer departures": (lambda: CF.ftle_gradient(
        torch.ones(6, 6, dtype=torch.int32), torch.ones(6, 6,
                                                        dtype=torch.int32),
        torch.ones(6), 1.0), TypeError, "not supported"),
    "integer stack": (lambda: CF.ftle_norm(
        torch.ones(9, 5, 5, dtype=torch.int64)), TypeError, "not supported"),
    "stack of 8 rows": (lambda: CF.ftle_norm(torch.ones(8, 5, 5)),
                        ValueError, r"\(9, \.\.\.\) stack"),
    "mismatched y": (lambda: CF.ftle_gradient(
        torch.ones(6, 6), torch.ones(6, 6, dtype=torch.float64),
        torch.ones(6), 1.0), TypeError, "must match"),
    "1-d departures": (lambda: CF.ftle_gradient(
        torch.ones(36), torch.ones(36), torch.ones(36), 1.0), ValueError,
        r"ny, nx >= 5"),
    "grid 4x12": (lambda: CF.ftle_gradient(
        torch.ones(4, 12), torch.ones(4, 12), torch.ones(4), 1.0),
        ValueError, r"ny, nx >= 5"),
    "grid 13x4": (lambda: CF.ftle_gradient(
        torch.ones(13, 4), torch.ones(13, 4), torch.ones(13), 1.0),
        ValueError, r"ny, nx >= 5"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_wrappers_refuse_and_callers_fall_back(case):
    """Each wrapper raises on what its kernel does not take, before any
    launch; for grids below 5 x 5 ``flowmap_gradient`` takes the PyTorch
    path even on the card, and at 5 x 5 the kernel."""
    fn, exc, match = REFUSALS[case]
    CF.reset_launches()
    with pytest.raises(exc, match=match):
        fn()
    assert CF.LAUNCHES == {"ftle_gradient": 0, "ftle_norm": 0}
    if case.startswith("grid"):
        ny, nx = (int(n) for n in case.split()[1].split("x"))
        lats = np.linspace(-90.0, 90.0, ny)
        grid = Grid(lats=lats, lons=np.linspace(-180.0, 150.0, nx))
        small = _cuda_like((ny, nx))
        assert not F._gradient_kernel_applies(small, small, grid)
        x, y = _departures(torch.float64, (ny, nx))
        assert F.flowmap_gradient(x, y, grid).shape == (9, ny, nx)
        five = Grid(lats=np.linspace(-90.0, 90.0, 5),
                    lons=np.linspace(-180.0, 108.0, 5))
        assert F._gradient_kernel_applies(_cuda_like((5, 5)),
                                          _cuda_like((5, 5)), five)
        assert not F._gradient_kernel_applies(
            _cuda_like((5, 5)), _cuda_like((5, 5), torch.float64), five)


def test_cuda_ftle_imports_nothing_heavy():
    """The wrapper module imports neither JAX, pandas, h5py nor xarray, and
    builds nothing at import."""
    import subprocess
    code = ("import sys\n"
            "import lagrangiancoherence_tpu_torch.ops.cuda_ftle\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'pandas', 'h5py', 'xarray', "
            "'lagrangiancoherence_tpu'))\n"
            "print('BAD', bad, "
            "'lagrangiancoherence_tpu_torch.ops._build' in sys.modules)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "BAD [] False" in proc.stdout, proc.stdout
