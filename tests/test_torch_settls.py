"""Port parity: lagrangiancoherence_tpu_torch.models.settls against the JAX
package's SETTLS integrator and the scipy oracle, on the CPU in float64.

Bounds: positions within 1e-10 degrees of JAX (the same operations in the
same order; what remains is prefilter-matmul summation order, ~1e-14 per
step) and within 1e-8 of the oracle (the JAX package's own bound,
tests/test_settls.py).
"""
from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lagrangiancoherence_tpu.grid import Grid as JaxGrid
from lagrangiancoherence_tpu.models import settls as JS
from lagrangiancoherence_tpu.testing import flows
from lagrangiancoherence_tpu.testing.oracle import oracle_parcel_propagation
from lagrangiancoherence_tpu_torch.grid import Grid
from lagrangiancoherence_tpu_torch.models import settls as TS
from lagrangiancoherence_tpu_torch.ops import cuda_interp

torch.set_num_threads(1)

JAX_ATOL = 1e-10
ORACLE_ATOL = 1e-8


def _vortex_small():
    """tests/test_settls.py:12-15."""
    cfg = dict(flows.VORTEX_CONFIG_SUBTROPICAL)
    cfg.update(dx=4, dy=4, nt=5)
    return flows.ideal_vortex(**cfg)


@lru_cache(maxsize=None)
def _jax_traj(timestep, settls_order, interp_order):
    """JAX trajectories, one jit compile per configuration (the SETTLS scan
    costs seconds to compile; the final positions are the last step)."""
    u, v, lats, lons, _ = _vortex_small()
    tx, ty = JS.parcel_propagation_core(
        jnp.asarray(u), jnp.asarray(v), timestep,
        JaxGrid(lats=lats, lons=lons, cyclic_x=True),
        settls_order=settls_order, interp_order=interp_order,
        return_traj=True)
    return np.asarray(tx), np.asarray(ty)


def _torch_vortex(timestep, settls_order, interp_order, return_traj):
    u, v, lats, lons, _ = _vortex_small()
    before = cuda_interp.LAUNCHES
    gx, gy, flag = TS.parcel_propagation_core(
        torch.tensor(u), torch.tensor(v), timestep,
        Grid(lats=lats, lons=lons, cyclic_x=True),
        settls_order=settls_order, interp_order=interp_order,
        return_traj=return_traj, return_overflow=True)
    assert cuda_interp.LAUNCHES == before      # the CPU path launches nothing
    assert flag.dtype == torch.int32 and int(flag) == 0
    nt = u.shape[0]
    assert gx.shape == ((nt,) if return_traj else ()) + u.shape[1:]
    return gx.numpy(), gy.numpy()


def _assert_oracle(gx, gy, timestep, settls_order, interp_order,
                   return_traj):
    u, v, lats, lons, _ = _vortex_small()
    ref_x, ref_y = oracle_parcel_propagation(
        u, v, lats, lons, timestep, settls_order=settls_order,
        interp_order=interp_order, cyclic_x=True, return_traj=return_traj)
    np.testing.assert_allclose(gx, ref_x, rtol=0, atol=ORACLE_ATOL)
    np.testing.assert_allclose(gy, ref_y, rtol=0, atol=ORACLE_ATOL)


@pytest.mark.parametrize("return_traj", [False, True])
@pytest.mark.parametrize("timestep,settls_order,interp_order", [
    (-6 * 3600, 2, 3),
    (6 * 3600, 0, 3),
    (-6 * 3600, 1, 1),
])
def test_vortex_matches_jax_and_oracle(timestep, settls_order, interp_order,
                                       return_traj):
    cfg = (timestep, settls_order, interp_order)
    gx, gy = _torch_vortex(*cfg, return_traj)
    jx, jy = _jax_traj(*cfg)
    if not return_traj:
        jx, jy = jx[-1], jy[-1]
    np.testing.assert_allclose(gx, jx, rtol=0, atol=JAX_ATOL)
    np.testing.assert_allclose(gy, jy, rtol=0, atol=JAX_ATOL)
    _assert_oracle(gx, gy, *cfg, return_traj)


@pytest.mark.parametrize("return_traj", [False, True])
def test_vortex_settls4_matches_oracle(return_traj):
    """The flagship's settls_order=4 against the oracle (the JAX parity of
    the iteration form is pinned at order 2 above)."""
    cfg = (-6 * 3600, 4, 3)
    _assert_oracle(*_torch_vortex(*cfg, return_traj), *cfg, return_traj)


def test_noncyclic_saddle_clamps_like_oracle():
    """Non-cyclic clamps (tests/test_settls.py:48-60); the clamp itself is
    pinned bit for bit against JAX below."""
    u, v, lats, lons, _ = flows.ideal_saddle(**flows.SADDLE_CONFIG)
    grid = Grid(lats=lats, lons=lons, cyclic_x=False)
    gx, gy = TS.parcel_propagation_core(u, v, 6 * 3600, grid, settls_order=2,
                                        interp_order=3)
    ref_x, ref_y = oracle_parcel_propagation(u, v, lats, lons, 6 * 3600,
                                             settls_order=2, interp_order=3,
                                             cyclic_x=False)
    np.testing.assert_allclose(gx.numpy(), ref_x, rtol=0, atol=ORACLE_ATOL)
    np.testing.assert_allclose(gy.numpy(), ref_y, rtol=0, atol=ORACLE_ATOL)
    assert gx.min() >= grid.x_min and gx.max() <= grid.x_max


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("cyclic_x", [True, False])
def test_clamp_wrap_matches_jax(cyclic_x, dtype):
    """Q5: torch.remainder reproduces jnp.mod's sign convention bit for bit,
    at 2**27 scale, on both sides of the seam, and for NaN."""
    rng = np.random.RandomState(5)
    px = (rng.uniform(-1, 1, 4000) * 2.0 ** 27).astype(dtype)
    px[:6] = [-180.0, 180.0, -180.5, 180.25, np.nan, 0.0]
    py = rng.uniform(-120, 120, 4000).astype(dtype)
    py[:2] = np.nan
    b = dict(y_min=-90.0, y_max=90.0, x_min=-180.0, x_max=179.75,
             cyclic_x=cyclic_x)
    jx, jy = JS._clamp_wrap(jnp.asarray(px), jnp.asarray(py), **b)
    tx, ty = TS._clamp_wrap(torch.tensor(px), torch.tensor(py), **b)
    assert tx.dtype == torch.from_numpy(px).dtype
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


def test_kernel_resolution():
    cpu = torch.device("cpu")
    assert TS.resolve_kernel("auto", cpu, 3) == "torch"
    assert TS.resolve_kernel("torch", cpu, 2) == "torch"
    assert TS.resolve_kernel("auto", torch.device("cuda"), 3) == "cuda"
    assert TS.resolve_kernel("auto", torch.device("cuda"), 2) == "torch"
    with pytest.raises(ValueError, match="CUDA tensors"):
        TS.resolve_kernel("cuda", cpu, 3)
    with pytest.raises(NotImplementedError, match="orders 1 and 3"):
        TS.resolve_kernel("cuda", torch.device("cuda"), 2)
    with pytest.raises(ValueError, match="kernel="):
        TS.resolve_kernel("pallas", cpu, 3)
    u, v, lats, lons, _ = _vortex_small()
    with pytest.raises(ValueError, match="CUDA tensors"):
        TS.parcel_propagation_core(u, v, 3600.0,
                                   Grid(lats=lats, lons=lons), kernel="cuda")
