"""Port parity of the ``engine="blockspec"`` SETTLS scan and pipeline:
lagrangiancoherence_tpu_torch (plain versions of K2-K4, sort-binned polar
bands, the hoisted pole loop) against the JAX package's XLA scan and its
own ``engine="auto"`` route, on the CPU in float64.

Bounds: positions within 1e-10 degrees of JAX (tests/test_torch_settls.py:
the same operations; the prefilter's summation order differs) and within
1e-12 of the port's K1 route (the windowed gather reads the same taps in
the same order, so they are expected to be equal); FTLE within 1e-5 of
JAX's, relative to the field's largest value (tests/test_ftle.py).
JAX's Pallas scans in interpret mode are not run here: they are the slow
tests of tests/slow_tests.txt.
"""
from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lagrangiancoherence_tpu.grid import Grid as JaxGrid
from lagrangiancoherence_tpu.models import settls as JS
from lagrangiancoherence_tpu.models.pipeline import \
    ftle_pipeline as jax_ftle_pipeline
from lagrangiancoherence_tpu.testing import flows
from lagrangiancoherence_tpu_torch import FTLEPipeline
from lagrangiancoherence_tpu_torch.grid import Grid
from lagrangiancoherence_tpu_torch.models import settls as TS
from lagrangiancoherence_tpu_torch.ops import cuda_interp, cuda_window

torch.set_num_threads(1)

JAX_ATOL = 1e-10
K1_ROUTE_ATOL = 1e-12
FTLE_RTOL = 1e-5
DT = -6 * 3600.0


def _vortex():
    """The ideal vortex of tests/test_pallas_interp.py:108-110 (nt=4)."""
    u, v, lats, lons, _ = flows.ideal_vortex(
        **dict(flows.VORTEX_CONFIG_SUBTROPICAL, nt=4))
    return u, v, lats, lons


@lru_cache(maxsize=None)
def _jax_traj(settls_order):
    u, v, lats, lons = _vortex()
    tx, ty = JS.parcel_propagation_core(
        jnp.asarray(u), jnp.asarray(v), DT,
        JaxGrid(lats=lats, lons=lons, cyclic_x=True),
        settls_order=settls_order, return_traj=True)
    return np.asarray(tx), np.asarray(ty)


def _port(u, v, lats, lons, **kw):
    before = (cuda_interp.LAUNCHES, dict(cuda_window.LAUNCHES))
    out = TS.parcel_propagation_core(
        torch.tensor(u), torch.tensor(v), DT,
        Grid(lats=lats, lons=lons, cyclic_x=True), return_overflow=True,
        **kw)
    assert (cuda_interp.LAUNCHES, cuda_window.LAUNCHES) == before
    return out


@lru_cache(maxsize=None)
def _port_vortex(settls_order, engine):
    tx, ty, flag = _port(*_vortex(), settls_order=settls_order,
                         return_traj=True, engine=engine)
    assert flag.dtype == torch.int32
    return tx.numpy(), ty.numpy(), int(flag)


@pytest.mark.parametrize("settls_order", [1, 2])
def test_vortex_matches_jax_xla_scan(settls_order):
    tx, ty, flag = _port_vortex(settls_order, "blockspec")
    jx, jy = _jax_traj(settls_order)
    assert flag == 0
    np.testing.assert_allclose(tx, jx, rtol=0, atol=JAX_ATOL)
    np.testing.assert_allclose(ty, jy, rtol=0, atol=JAX_ATOL)


@pytest.mark.parametrize("settls_order", [1, 2])
def test_vortex_matches_k1_route(settls_order):
    tx, ty, _ = _port_vortex(settls_order, "blockspec")
    kx, ky, flag = _port_vortex(settls_order, "auto")
    assert flag == 0
    np.testing.assert_allclose(tx, kx, rtol=0, atol=K1_ROUTE_ATOL)
    np.testing.assert_allclose(ty, ky, rtol=0, atol=K1_ROUTE_ATOL)


def _polar_whirl():
    """tests/test_pallas_interp.py:282-296: 97 rows, so that both polar
    bands survive the 8-row alignment."""
    ny, nx = 97, 128
    lats = np.linspace(-90.0, 90.0, ny)
    lons = np.linspace(-180.0, 180.0 - 360.0 / nx, nx)
    LON, LAT = np.meshgrid(np.deg2rad(lons), np.deg2rad(lats))
    t = np.arange(4)[:, None, None]
    u = (20.0 * np.cos(LAT) + 2.0 * np.cos(3 * LON)
         * np.sin(2 * LAT))[None] * (1 + 0.05 * np.sin(t))
    v = (2.0 * np.sin(3 * LON) * np.cos(2 * LAT))[None] \
        * (1 + 0.05 * np.cos(t))
    return u, v, lats, lons


@pytest.mark.parametrize("return_traj", [False, True])
def test_sort_binning_is_layout_invariant(return_traj):
    """Sort-binning the polar bands is a storage permutation carried
    through the scan and undone on the way out (TestSortBinning,
    tests/test_pallas_interp.py:268-360)."""
    u, v, lats, lons = _polar_whirl()
    grid = Grid(lats=lats, lons=lons, cyclic_x=True)
    bands = TS._sort_bands(grid, 3)
    assert bands and all(r0 % 8 == 0 and nr % 8 == 0 for r0, nr in bands)
    res = {rb: _port(u, v, lats, lons, settls_order=1, engine="blockspec",
                     rebin=rb, return_traj=return_traj)
           for rb in ("sort", False)}
    (sx, sy, sf), (nx_, ny_, nf) = res["sort"], res[False]
    assert int(sf) == int(nf) == 0
    assert sx.shape == ((4,) if return_traj else ()) + u.shape[1:]
    np.testing.assert_allclose(sx.numpy(), nx_.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(sy.numpy(), ny_.numpy(), rtol=0, atol=1e-12)


def test_to_tile_storage_tiles_hold_consecutive_ranks():
    """tests/test_pallas_interp.py:362-376."""
    nr, nx = 16, 320
    st = TS._to_tile_storage(torch.arange(nr * nx), nr, nx).numpy()
    assert sorted(st.ravel().tolist()) == list(range(nr * nx))
    for i in range(nr // 8):
        for c0, c1 in [(0, 128), (128, 256), (256, 320)]:
            blk = st[8 * i:8 * i + 8, c0:c1].ravel()
            assert blk.max() - blk.min() == blk.size - 1


def test_engines():
    """"dma" is not ported and raises; "auto" is the K1 route, whose
    overflow word stays 0; anything else is refused."""
    assert TS.resolve_engine("auto") == "dma-all"
    assert TS.resolve_engine("blockspec") == "blockspec"
    u, v, lats, lons = _vortex()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _port(u, v, lats, lons, settls_order=1, engine="dma")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FTLEPipeline(Grid(lats=lats, lons=lons), engine="dma")
    with pytest.raises(ValueError, match="engine="):
        TS.resolve_engine("pallas")
    *_, flag = _port(u, v, lats, lons, settls_order=1, engine="auto")
    assert flag.dtype == torch.int32 and int(flag) == 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        _port(u, v, lats, lons, settls_order=1, engine="blockspec",
              kernel="cuda")


def test_pipeline_blockspec_matches_jax():
    """FTLEPipeline(engine="blockspec") end to end against JAX's
    ftle_pipeline (the XLA scan)."""
    u, v, lats, lons = _vortex()
    want = np.asarray(jax_ftle_pipeline(
        jnp.asarray(u), jnp.asarray(v), DT,
        JaxGrid(lats=lats, lons=lons, cyclic_x=True), settls_order=1))
    model = FTLEPipeline(Grid(lats=lats, lons=lons, cyclic_x=True),
                         settls_order=1, engine="blockspec")
    got, flag = model(u, v, DT, return_overflow=True)
    assert int(flag) == 0
    got = got.numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    scale = np.nanmax(np.abs(want))
    assert np.nanmax(np.abs(got - want)) <= FTLE_RTOL * scale
