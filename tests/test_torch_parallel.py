"""The latitude-block pipeline (lagrangiancoherence_tpu_torch/parallel/) on
the CPU: the counterpart of tests/test_halo.py and tests/test_sharding.py.

JAX runs its mesh on 8 virtual CPU devices; the port runs a mesh's blocks in
sequence in one process, so a mesh of the CPU repeated N times is N blocks.
The blocked runs are held against the port's whole-grid functions
(``parcel_propagation_core``, ``ftle_pipeline``), which
tests/test_torch_settls_step.py and tests/test_torch_pipeline.py hold
against JAX: in float64 the departure points are identical
(``torch.equal``) and the FTLE within the JAX tests' own 1e-10.  JAX's
sharded functions are called twice (each costs ~10-20 s on the CPU,
tests/slow_tests.txt), shared through a module fixture: its
``parcel_propagation_sharded`` and its ``ftle_sharded`` on 4 blocks with
pad rows, held against the port's at the bounds the port's whole-grid
functions meet against JAX's whole grid (departure points within 1e-10;
FTLE within 1e-5 of the field's largest value, since the stencil stage
runs in float32, quirk Q6, where a 1e-13 position difference can flip the
last bit of a sample).  ``kernel="pallas"`` of the JAX tests is
``engine="blockspec"``: its blocks are held against the port's whole-grid
windowed run, the same JAX departure points, and one call of JAX's
``ftle_pipeline``.
"""
from functools import lru_cache

import numpy as np
import pytest
import torch

from lagrangiancoherence_tpu.grid import Grid as JaxGrid
from lagrangiancoherence_tpu.models.pipeline import \
    ftle_pipeline as jax_ftle_pipeline
from lagrangiancoherence_tpu.parallel import mesh as jax_mesh
from lagrangiancoherence_tpu.parallel import pipeline as jax_pipeline
from lagrangiancoherence_tpu.testing import flows
from lagrangiancoherence_tpu_torch import (Grid, ftle_batch, ftle_pipeline,
                                          ftle_sharded,
                                          parcel_propagation_sharded)
from lagrangiancoherence_tpu_torch.models.settls import (
    grid_state, parcel_propagation_core, settls_scan)
from lagrangiancoherence_tpu_torch.ops import cuda_settls
from lagrangiancoherence_tpu_torch.ops.filters import gaussian_filter
from lagrangiancoherence_tpu_torch.ops.interp import prefilter
from lagrangiancoherence_tpu_torch.ops.stencil import (
    derivative_spherical_coords, fourth_order_derivative)
from lagrangiancoherence_tpu_torch.parallel.halo import (
    derivative_spherical_blocked, exchange_cols_cyclic, exchange_rows,
    fourth_order_dim0_blocked, fourth_order_dim1_blocked,
    gaussian_filter_blocked, gaussian_radius)
from lagrangiancoherence_tpu_torch.parallel.mesh import (batch_mesh,
                                                         parcel_mesh)
from lagrangiancoherence_tpu_torch.parallel import pipeline as PP
from lagrangiancoherence_tpu_torch.parallel.pipeline import block_layout

torch.set_num_threads(1)

CPU = torch.device("cpu")
DT = -6 * 3600.0
FTLE_ATOL = 1e-10
BLOCK_ATOL = 1e-12              # blocks against the whole grid, windowed
JAX_DEPARTURE_ATOL = 1e-10      # tests/test_torch_settls_step.py's JAX_ATOL
JAX_FTLE_RTOL = 1e-5            # tests/test_torch_pipeline.py's FTLE_RTOL


def cpus(n):
    return [CPU] * n


@lru_cache(maxsize=None)
def vortex_case():
    """tests/test_sharding.py:19-21: 89 rows, 180 columns, 8 levels."""
    u, v, lats, lons, _ = flows.ideal_vortex(**flows.VORTEX_CONFIG_SUBTROPICAL)
    return u, v, Grid(lats=lats, lons=lons, cyclic_x=True)


@lru_cache(maxsize=None)
def vortex_case_divisible():
    """tests/test_sharding.py:24-35: 96 rows, which 8 blocks divide."""
    cfg = dict(flows.VORTEX_CONFIG_SUBTROPICAL)
    u, v, lats, lons, _ = flows.ideal_vortex(**cfg)
    lats96 = np.linspace(lats[0], lats[0] + 2.0 * 95, 96)
    cfg2 = dict(cfg, lat_min=float(lats96[0]), lat_max=float(lats96[-1]) + 1)
    u2, v2, lats2, lons2, _ = flows.ideal_vortex(**cfg2)
    assert lats2.size == 96, lats2.size
    return u2, v2, Grid(lats=lats2, lons=lons2, cyclic_x=True)


@lru_cache(maxsize=None)
def whole_departures(timestep, settls_order, return_traj=False):
    u, v, grid = vortex_case()
    return parcel_propagation_core(u, v, timestep, grid,
                                   settls_order=settls_order,
                                   return_traj=return_traj, device="cpu")


@lru_cache(maxsize=None)
def whole_ftle(case, timestep, settls_order, sigma=None):
    u, v, grid = case()
    return ftle_pipeline(u, v, timestep, grid, settls_order=settls_order,
                         sigma=sigma, device="cpu")


def assert_ftle(got, want):
    assert got.shape == want.shape and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=FTLE_ATOL)


# ---------------------------------------------------------------------------
# tests/test_halo.py
# ---------------------------------------------------------------------------

def test_exchange_rows_reassembles_neighbours():
    x = torch.arange(64 * 4, dtype=torch.float64).reshape(64, 4)
    out = exchange_rows(list(x.split(8)), 2)
    assert [tuple(b.shape) for b in out] == [(12, 4)] * 8
    # block 3 (rows 24..31) sees rows 22..33; zeros only at the global edges
    assert torch.equal(out[3], x[22:34])
    assert (out[0][:2] == 0).all() and (out[7][-2:] == 0).all()
    ref = exchange_rows(list(x.split(8)), 3, reflect_at_edges=True)
    assert torch.equal(ref[0][:3], x[:3].flip(0))
    assert torch.equal(ref[7][-3:], x[-3:].flip(0))


def test_exchange_cols_wraps_cyclically():
    x = torch.arange(8 * 256, dtype=torch.float64).reshape(8, 256)
    out = exchange_cols_cyclic(list(x.split(128, dim=1)), 2)
    assert [tuple(b.shape) for b in out] == [(8, 132)] * 2
    # the left halo of block 0 = the last 2 columns (cyclic wraparound)
    assert torch.equal(out[0][:, :2], x[:, -2:])
    assert torch.equal(out[1][:, -2:], x[:, :2])


def test_blocked_stencils_match_full():
    """One block with zero halos, and 4 blocks with exchanged halos, equal
    the full-field stencil (bit for bit: the same ops in the same order)."""
    f = torch.tensor(np.random.RandomState(0).randn(24, 32))
    want = fourth_order_derivative(f, dim=0)
    got = fourth_order_dim0_blocked(torch.nn.functional.pad(f, (0, 0, 2, 2)),
                                    2, 0, 24)
    assert torch.equal(got, want)
    pads = exchange_rows(list(f.split(6)), 2)
    got = torch.cat([fourth_order_dim0_blocked(p, 2, 6 * i, 24)
                     for i, p in enumerate(pads)])
    assert torch.equal(got, want)
    want_x = fourth_order_derivative(f, dim=1, isglobal=True)
    got_x = fourth_order_dim1_blocked(torch.cat([f[:, -2:], f, f[:, :2]],
                                                dim=1), 2)
    assert torch.equal(got_x, want_x)
    pads = exchange_cols_cyclic(list(f.split(8, dim=1)), 2)
    got_x = torch.cat([fourth_order_dim1_blocked(p, 2) for p in pads], dim=1)
    assert torch.equal(got_x, want_x)
    r = gaussian_radius(1.5)
    pads = exchange_rows(list(f.split(8)), r, reflect_at_edges=True)
    got_g = torch.cat([gaussian_filter_blocked(p, 1.5) for p in pads])
    assert torch.equal(got_g, gaussian_filter(f, 1.5))


@pytest.mark.parametrize("dim, x_blocks", [(0, 1), (1, 1), (1, 4)])
def test_blocked_spherical_derivative_matches_full(dim, x_blocks):
    """``derivative_spherical_blocked`` on 4 latitude blocks (row halos of
    width 2), or on whole-longitude blocks, or on 4 longitude blocks
    (cyclic halos), equals ``derivative_spherical_coords`` bit for bit."""
    f = torch.tensor(np.random.RandomState(1).randn(24, 32) * 6.4e6)
    lats = np.linspace(-40.0, 52.0, 24)
    lons = np.linspace(0.0, 348.75, 32)
    dlat, dlon = float(lats[1] - lats[0]), float(lons[1] - lons[0])
    want = derivative_spherical_coords(f, lats, lons, dim=dim)
    rows = [slice(6 * i, 6 * i + 6) for i in range(4)]
    if dim == 0:
        pads = exchange_rows([f[r] for r in rows], 2)
        got = torch.cat([derivative_spherical_blocked(
            p, 2, r.start, lats[r], dlat, dlon, 24, dim=0)
            for p, r in zip(pads, rows)])
    elif x_blocks == 1:
        got = torch.cat([derivative_spherical_blocked(
            f[r], 0, r.start, lats[r], dlat, dlon, 24, dim=1) for r in rows])
    else:
        pads = exchange_cols_cyclic(list(f.split(32 // x_blocks, dim=1)), 2)
        got = torch.cat([derivative_spherical_blocked(
            p, 2, 0, lats, dlat, dlon, 24, dim=1, x_blocked=True)
            for p in pads], dim=1)
    assert got.dtype == want.dtype and torch.equal(got, want)


# ---------------------------------------------------------------------------
# the host-side layout against JAX's (parallel/pipeline.py:95-113)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_blocks", [1, 3, 8])
def test_block_layout_matches_jax(n_blocks):
    u, v, grid = vortex_case()
    jgrid = JaxGrid(lats=grid.lats, lons=grid.lons, cyclic_x=True)
    ny = jgrid.shape[0]
    rows = -(-ny // n_blocks)
    home_idx = np.arange(rows * n_blocks)
    home_idx = np.where(home_idx < ny, home_idx, 2 * ny - 1 - home_idx)
    lats_pad = jgrid.lats[home_idx]
    conv_y = 180.0 / (6371000.0 * np.pi)
    conv_x = (conv_y / np.abs(np.cos(lats_pad * (np.pi / 180.0))))[:, None]
    lay = block_layout(grid, n_blocks)
    np.testing.assert_array_equal(lay["home_idx"], home_idx)
    np.testing.assert_array_equal(lay["lats"], lats_pad)
    np.testing.assert_array_equal(lay["conv_x"], conv_x)
    # the blocks' start positions and conv_x: the grid state's rows, which
    # are JAX's mesh rows and its float64 conv_x to the last bit or so
    state = grid_state(grid, 3, dtype=torch.float64, device="cpu")
    px0, py0 = jgrid.mesh_xy
    idx = torch.tensor(home_idx)
    np.testing.assert_array_equal(state["px0"][idx].numpy(), px0[home_idx])
    np.testing.assert_array_equal(state["py0"][idx].numpy(), py0[home_idx])
    np.testing.assert_allclose(state["conv_x"][idx].numpy(), conv_x,
                               rtol=1e-15, atol=0)


def test_too_many_blocks_raise():
    u, v, grid = vortex_case()
    with pytest.raises(ValueError, match="halo width"):
        parcel_propagation_sharded(u, v, DT, grid, parcel_mesh(devices=cpus(
            89)), settls_order=0)


# ---------------------------------------------------------------------------
# tests/test_sharding.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_blocks", [2, 4, 8])
def test_parity_no_sigma(n_blocks):
    u, v, grid = vortex_case()
    out, ovf = ftle_sharded(u, v, DT, grid, parcel_mesh(devices=cpus(
        n_blocks)), settls_order=2, return_overflow=True)
    assert_ftle(out, whole_ftle(vortex_case, DT, 2))
    assert ovf.dtype == torch.int32 and int(ovf) == 0


def test_parity_gaussian_nondivisible():
    # 89 rows over 8 blocks: 7 pad rows, the smoothing of the assembled field
    u, v, grid = vortex_case()
    out = ftle_sharded(u, v, DT, grid, parcel_mesh(devices=cpus(8)),
                       settls_order=1, sigma=1.5)
    assert_ftle(out, whole_ftle(vortex_case, DT, 1, 1.5))


def test_parity_gaussian_divisible():
    # 96 rows over 8 blocks: no pad, the blocked Gaussian with its halos
    u, v, grid = vortex_case_divisible()
    out = ftle_sharded(u, v, DT, grid, parcel_mesh(devices=cpus(8)),
                       settls_order=1, sigma=2.0)
    assert_ftle(out, whole_ftle(vortex_case_divisible, DT, 1, 2.0))


def test_forward_integration():
    u, v, grid = vortex_case()
    out = ftle_sharded(u, v, -DT, grid, parcel_mesh(devices=cpus(8)),
                       settls_order=1)
    assert_ftle(out, whole_ftle(vortex_case, -DT, 1))


def test_batched_fields_and_flags():
    u, v, grid = vortex_case()
    ref = whole_ftle(vortex_case, DT, 1)
    out, flags = ftle_batch(np.stack([u] * 4), np.stack([v] * 4), DT, grid,
                            batch_mesh(devices=cpus(4)), settls_order=1,
                            return_overflow=True)
    assert out.shape == (4,) + ref.shape
    assert torch.equal(out, ref.expand_as(out))
    assert flags.shape == (4,) and flags.dtype == torch.int32
    assert not flags.any()
    with pytest.raises(ValueError, match="does not split"):
        ftle_batch(np.stack([u] * 3), np.stack([v] * 3), DT, grid,
                   batch_mesh(devices=cpus(2)))


def test_mesh_axes_and_2d_mesh():
    m = parcel_mesh(devices=cpus(1))
    assert m.axis_names == ("y",) and m.shape == {"y": 1}
    m = parcel_mesh(devices=cpus(8), x_parallel=2)
    assert m.axis_names == ("y", "x")
    assert m.shape["y"] == 4 and m.shape["x"] == 2
    m = batch_mesh(devices=cpus(3))
    assert m.axis_names == ("t",) and m.shape == {"t": 3}
    assert all(d == CPU for d in m.devices.flat)


def test_bad_split_raises():
    with pytest.raises(ValueError):
        parcel_mesh(devices=cpus(8), x_parallel=3)


def test_default_mesh_needs_a_card():
    """With no ``devices=`` a mesh is made of the CUDA cards, and raises on a
    machine without one, as the entry points' default device does."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default mesh exists")
    for make in (parcel_mesh, batch_mesh):
        with pytest.raises(RuntimeError, match="device=cuda"):
            make(1)


@pytest.mark.parametrize("n_blocks", [1, 2, 3, 4, 8])
def test_departure_parity(n_blocks):
    """Departure points identical to the whole grid's, divisible or not
    (89 rows: 3, 4 and 8 blocks pad 1, 3 and 7 rows); nothing launches on
    the CPU."""
    u, v, grid = vortex_case()
    before = cuda_settls.LAUNCHES
    px, py, ovf = parcel_propagation_sharded(
        u, v, DT, grid, parcel_mesh(devices=cpus(n_blocks)), settls_order=2,
        return_overflow=True)
    rx, ry = whole_departures(DT, 2)
    assert torch.equal(px, rx) and torch.equal(py, ry)
    assert int(ovf) == 0 and cuda_settls.LAUNCHES == before


def test_trajectory_parity():
    u, v, grid = vortex_case()
    tx, ty = parcel_propagation_sharded(u, v, DT, grid,
                                        parcel_mesh(devices=cpus(8)),
                                        settls_order=1, return_traj=True)
    rx, ry = whole_departures(DT, 1, True)
    assert tx.shape == rx.shape == (u.shape[0],) + grid.shape
    assert torch.equal(tx, rx) and torch.equal(ty, ry)


@pytest.mark.parametrize("x_parallel", [2, 4])
def test_yx_mesh_parity(x_parallel):
    u, v, grid = vortex_case()          # nx = 180 divides 2 and 4
    mesh = parcel_mesh(devices=cpus(8), x_parallel=x_parallel)
    assert_ftle(ftle_sharded(u, v, DT, grid, mesh, settls_order=2),
                whole_ftle(vortex_case, DT, 2))
    px, py = parcel_propagation_sharded(u, v, DT, grid, mesh,
                                        settls_order=2)
    rx, ry = whole_departures(DT, 2)
    assert torch.equal(px, rx) and torch.equal(py, ry)


def test_indivisible_nx_rejected():
    u, v, grid = vortex_case()
    mesh = parcel_mesh(devices=cpus(8), x_parallel=8)     # 180 % 8 != 0
    with pytest.raises(ValueError):
        ftle_sharded(u, v, DT, grid, mesh, settls_order=0)


def test_sigma_with_x_sharding_rejected():
    u, v, grid = vortex_case()
    mesh = parcel_mesh(devices=cpus(8), x_parallel=2)
    with pytest.raises(NotImplementedError):
        ftle_sharded(u, v, DT, grid, mesh, settls_order=0, sigma=1.0)


# ---------------------------------------------------------------------------
# the port's block drivers against JAX's, on 4 blocks with 3 pad rows
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_sharded():
    """JAX's ``parcel_propagation_sharded`` (SETTLS-2) and ``ftle_sharded``
    (SETTLS-1, ``sigma=1.5``: the all-gather smoothing) on the vortex case
    over 4 virtual CPU devices (89 rows: 3 pad rows)."""
    u, v, grid = vortex_case()
    jgrid = JaxGrid(lats=grid.lats, lons=grid.lons, cyclic_x=True)
    mesh = jax_mesh.parcel_mesh(4)
    px, py = jax_pipeline.parcel_propagation_sharded(u, v, DT, jgrid, mesh,
                                                     settls_order=2)
    out = jax_pipeline.ftle_sharded(u, v, DT, jgrid, mesh, settls_order=1,
                                    sigma=1.5)
    return np.asarray(px), np.asarray(py), np.asarray(out)


def test_departures_match_jax_sharded(jax_sharded):
    u, v, grid = vortex_case()
    px, py = parcel_propagation_sharded(u, v, DT, grid,
                                        parcel_mesh(devices=cpus(4)),
                                        settls_order=2)
    jx, jy, _ = jax_sharded
    assert px.shape == jx.shape and px.dtype == torch.float64
    np.testing.assert_allclose(px.numpy(), jx, rtol=0, atol=JAX_DEPARTURE_ATOL)
    np.testing.assert_allclose(py.numpy(), jy, rtol=0, atol=JAX_DEPARTURE_ATOL)


def test_ftle_matches_jax_sharded(jax_sharded):
    u, v, grid = vortex_case()
    out = ftle_sharded(u, v, DT, grid, parcel_mesh(devices=cpus(4)),
                       settls_order=1, sigma=1.5)
    want = jax_sharded[2]
    assert out.shape == want.shape and np.isfinite(want).all()
    err = np.abs(out.numpy() - want).max()
    assert err <= JAX_FTLE_RTOL * np.abs(want).max(), err


def test_blockspec_with_x_sharding_rejected():
    """The windowed route needs full-width latitude blocks, as JAX's pallas
    kernel does (tests/test_sharding.py:209-221), on both of its engines;
    on a ("y",) mesh it runs."""
    u, v, grid = vortex_case()
    mesh = parcel_mesh(devices=cpus(8), x_parallel=2)
    for engine in ("blockspec", "dma"):
        with pytest.raises(NotImplementedError, match="full-width"):
            ftle_sharded(u, v, DT, grid, mesh, settls_order=0,
                         engine=engine)
    px, py = parcel_propagation_sharded(u, v, DT, grid,
                                        parcel_mesh(devices=cpus(2)),
                                        settls_order=0, engine="blockspec")
    rx, ry = whole_departures(DT, 0)
    assert torch.equal(px, rx) and torch.equal(py, ry)


# ---------------------------------------------------------------------------
# the windowed route on blocks (tests/test_sharding.py TestShardedPallas)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def whole_blockspec(settls_order):
    """The whole-grid windowed route: departure points and FTLE."""
    u, v, grid = vortex_case()
    pos = parcel_propagation_core(u, v, DT, grid, settls_order=settls_order,
                                  engine="blockspec", device="cpu")
    return pos, ftle_pipeline(u, v, DT, grid, settls_order=settls_order,
                              engine="blockspec", device="cpu")


@lru_cache(maxsize=None)
def jax_ftle(settls_order):
    u, v, grid = vortex_case()
    jgrid = JaxGrid(lats=grid.lats, lons=grid.lons, cyclic_x=True)
    return np.asarray(jax_ftle_pipeline(u, v, DT, jgrid,
                                        settls_order=settls_order))


@pytest.mark.parametrize("seeded", [True, False])
@pytest.mark.parametrize("n_blocks", [2, 8])
def test_blockspec_blocks_match(n_blocks, seeded, jax_sharded, monkeypatch):
    """``parcel_propagation_sharded`` and ``ftle_sharded`` with
    ``engine="blockspec"`` on 2 and 8 blocks (89 rows: 1 and 7 reflected
    pad rows), with the replicated pole block's seed and without it (each
    block then evaluates the pole-home rows it holds): departure points
    within 1e-12 of the whole-grid windowed run (identical in fact) and
    within 1e-10 of JAX's ``parcel_propagation_sharded`` (the XLA kernel);
    FTLE within 1e-10 of the whole-grid windowed field and within 1e-5 of
    JAX's ``ftle_pipeline``, relative to its largest value (the float32
    stencil, Q6, turns the packages' 1e-13 departure differences into
    last-bit flips: 8e-7 of a field of 38 here); overflow 0."""
    if not seeded:
        monkeypatch.setattr(PP, "_pole_seed", lambda *a: None)
    u, v, grid = vortex_case()
    mesh = parcel_mesh(devices=cpus(n_blocks))
    px, py, ovf = parcel_propagation_sharded(
        u, v, DT, grid, mesh, settls_order=2, engine="blockspec",
        return_overflow=True)
    (wx, wy), wf = whole_blockspec(2)
    assert int(ovf) == 0
    for got, whole, jax_ in ((px, wx, jax_sharded[0]),
                             (py, wy, jax_sharded[1])):
        np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=0,
                                   atol=BLOCK_ATOL)
        np.testing.assert_allclose(got.numpy(), jax_, rtol=0,
                                   atol=JAX_DEPARTURE_ATOL)
    out, ovf = ftle_sharded(u, v, DT, grid, mesh, settls_order=2,
                            engine="blockspec", return_overflow=True)
    assert int(ovf) == 0
    assert_ftle(out, wf)
    want = jax_ftle(2)
    assert np.abs(out.numpy() - want).max() <= \
        JAX_FTLE_RTOL * np.abs(want).max()


def test_blockspec_block_scan_trajectories():
    """``settls_scan`` on the windowed route over a block, with its seed,
    returns the whole grid's trajectory rows, and ``debug_per_step`` its
    per-step words; an x-block is refused."""
    u, v, grid = vortex_case()
    state = grid_state(grid, 3, dtype=torch.float64, device="cpu")
    mats = (state["prefilter_y"], state["prefilter_x"])
    ut, vt = torch.tensor(u), torch.tensor(v)
    cu, cv = (prefilter(a, order=3, matrices=mats) for a in (ut, vt))
    dt = torch.tensor(DT)
    scan = dict(settls_order=1, interp_order=3, kernel="torch",
                engine="blockspec")
    tx, ty, _ = settls_scan(ut, vt, cu, cv, state["px0"], state["py0"], dt,
                            state["conv_x"], grid, return_traj=True, **scan)
    home = torch.tensor(block_layout(grid, 4)["home_idx"][69:92])
    seed = PP._pole_seed(state, 3)
    args = (ut, vt, cu, cv, state["px0"][home], state["py0"][home], dt,
            state["conv_x"][home], grid)
    bx, by, flag = settls_scan(*args, return_traj=True, home_rows=home,
                               pole_seed=seed, **scan)
    assert int(flag) == 0
    assert torch.equal(bx, tx[:, home]) and torch.equal(by, ty[:, home])
    fx, _, steps = settls_scan(*args, return_traj=False, home_rows=home,
                               pole_seed=seed, debug_per_step=True, **scan)
    assert torch.equal(fx, tx[-1, home])
    assert steps.tolist() == [0] * (u.shape[0] - 1)
    with pytest.raises(ValueError, match="full-width"):
        settls_scan(ut, vt, cu, cv, state["px0"][:, :90],
                    state["py0"][:, :90], dt, state["conv_x"], grid,
                    return_traj=False, **scan)
