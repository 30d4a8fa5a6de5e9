"""The fused SETTLS step (ops/cuda_settls.py) and the card-by-default
device rule, on the CPU.

* ``settls_step_torch`` over T-1 steps equals the per-group loop it was cut
  from bit for bit (float64 and float32; orders 1 and 3; settls_order 0, 1
  and 4; cyclic and not; NaN and 2**27-degree positions on pole and spline
  rows), and so do ``settls_step`` on CPU tensors and ``settls_scan``;
* ``parcel_propagation_core(kernel="torch", device="cpu")`` matches the JAX
  package's for one step and four steps within 1e-10 degrees (the port's
  position bound, tests/test_torch_settls.py);
* the interleaved coefficient stack holds (cu, cv)[c][t, i, j] at
  [t, i, j, c];
* with no ``device=`` and no tensor, the entry points ask for the card and
  raise without one; CPU tensors stay on the CPU.

The kernel itself runs only on the card: ``chip_smoke.py`` phases 3c, 4 and
6 hold it against ``settls_step_torch`` bit for bit and time it.
"""
from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lagrangiancoherence_tpu.grid import Grid as JaxGrid
from lagrangiancoherence_tpu.models import settls as JS
from lagrangiancoherence_tpu.testing import flows
from lagrangiancoherence_tpu_torch import (LCS, Field, FTLEPipeline, Grid,
                                          ftle_pipeline, parcel_propagation)
from lagrangiancoherence_tpu_torch.grid import EARTH_RADIUS
from lagrangiancoherence_tpu_torch.models import settls as TS
from lagrangiancoherence_tpu_torch.ops import cuda_interp, cuda_settls
from lagrangiancoherence_tpu_torch.ops.cuda_settls import (clamp_wrap,
                                                          interleave,
                                                          settls_step,
                                                          settls_step_torch)
from lagrangiancoherence_tpu_torch.ops.interp import (interp_at_parcels_multi,
                                                      prefilter)

torch.set_num_threads(1)

JAX_ATOL = 1e-10
NT = 4


def _bits(a: torch.Tensor) -> np.ndarray:
    """The raw bits, so that equality also covers NaN payloads and -0."""
    a = a.numpy()
    return a.view(np.int64 if a.dtype == np.float64 else np.int32)


def _assert_bit_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(_bits(g), _bits(w))


@lru_cache(maxsize=None)
def _setup(cyclic: bool, order: int, dtype: torch.dtype):
    """A 13x36 grid with pole rows at +-90, NT levels of seeded winds, their
    planar stacks and the grid state, and start positions with NaN and
    2**27-degree parcels on pole and spline rows."""
    rng = np.random.RandomState(7)
    ny, nx = 13, 36
    lats = np.linspace(-90.0, 90.0, ny)
    lons = np.linspace(-180.0, 170.0, nx) if cyclic \
        else np.linspace(-60.0, 45.0, nx)
    grid = Grid(lats=lats, lons=lons, cyclic_x=cyclic)
    u = 20.0 + 15.0 * rng.randn(NT, ny, nx)
    v = 10.0 * rng.randn(NT, ny, nx)
    tu, tv = (torch.tensor(a, dtype=dtype) for a in (u, v))
    state = TS.grid_state(grid, dtype=dtype, device="cpu")
    cu, cv = (prefilter(a, order=order) for a in (tu, tv))
    px0, py0 = state["px0"].clone(), state["py0"].clone()
    px0 += torch.tensor(rng.uniform(-3, 3, (ny, nx)), dtype=dtype)
    py0 += torch.tensor(rng.uniform(-3, 3, (ny, nx)), dtype=dtype)
    for row in (0, ny - 1, 5):          # two pole rows and a spline row
        px0[row, 3] = 2.0 ** 27
        px0[row, 4] = -2.0 ** 27
        py0[row, 5] = 2.0 ** 27
        px0[row, 6] = float("nan")
        py0[row, 7] = float("nan")
    px0[8, 9] = py0[8, 9] = float("nan")
    W = torch.stack([tu, tv], dim=1).reshape(2 * NT, ny, nx)
    CW = torch.stack([cu, cv], dim=1).reshape(2 * NT, ny, nx)
    dt = torch.full((), -6 * 3600.0, dtype=dtype)
    return grid, tu, tv, cu, cv, W, CW, px0, py0, dt, state["conv_x"]


def _per_group_loop(W, CW, px, py, dt, conv_x, grid, *, settls_order, order):
    """The direct route's step loop as it stood before the fused step: one
    plain gather group at a time, the updates and the clamp as whole-grid
    torch ops (its trajectory)."""
    conv_y = torch.full((), 180.0 / (EARTH_RADIUS * np.pi), dtype=px.dtype)
    bounds = dict(y_min=grid.y_min, y_max=grid.y_max,
                  x_min=grid.x_min, x_max=grid.x_max)

    def gather(t, x, y, nf):
        return interp_at_parcels_multi(W[2 * t:2 * t + nf],
                                       CW[2 * t:2 * t + nf], x, y,
                                       order=order, **bounds)

    def clamp(x, y):
        return clamp_wrap(x, y, cyclic_x=grid.cyclic_x, **bounds)

    traj = [(px, py)]
    for t in range(W.shape[0] // 2 - 1):
        vals = gather(t, px, py, 2)
        ua, va = vals[0], vals[1]
        x, y = clamp(px + dt * conv_x * ua, py + dt * conv_y * va)
        for _ in range(settls_order):
            d = gather(t, x, y, 4)
            x, y = clamp(x + 0.5 * dt * conv_x * (ua + 2.0 * d[0] - d[2]),
                         y + 0.5 * dt * conv_y * (va + 2.0 * d[1] - d[3]))
        px, py = x, y
        traj.append((px, py))
    return traj


CASES = [(dtype, order, so, cyclic)
         for dtype in (torch.float64, torch.float32)
         for order in (3, 1) for so in (0, 1, 4) for cyclic in (True, False)]


@pytest.mark.parametrize("dtype,order,settls_order,cyclic", CASES)
def test_plain_step_equals_per_group_loop(dtype, order, settls_order,
                                          cyclic):
    grid, *_, W, CW, px0, py0, dt, conv_x = _setup(cyclic, order, dtype)
    want = _per_group_loop(W, CW, px0, py0, dt, conv_x, grid,
                           settls_order=settls_order, order=order)
    kw = dict(settls_order=settls_order, order=order, x_min=grid.x_min,
              x_max=grid.x_max, y_min=grid.y_min, y_max=grid.y_max,
              cyclic_x=cyclic)
    px, py = px0, py0
    for t in range(NT - 1):
        px, py = settls_step_torch(W, CW, px, py, conv_x, dt, t, **kw)
        _assert_bit_equal((px, py), want[t + 1])
    # the edge parcels kept their NaNs and left the 2**27 band
    assert torch.isnan(px[8, 9]) and torch.isnan(px[5, 6])
    assert float(py.abs().nan_to_num(0).max()) <= 90.0


@pytest.mark.parametrize("dtype,order,cyclic", [
    (torch.float64, 3, True), (torch.float32, 3, False),
    (torch.float64, 1, False)])
def test_wrapper_and_scan_on_cpu_tensors_take_the_plain_step(dtype, order,
                                                             cyclic):
    """``settls_step`` on CPU tensors (interleaved coefficients, ``out=``
    in place) and ``settls_scan`` with and without trajectories give the
    per-group loop's bits and launch nothing."""
    grid, tu, tv, cu, cv, W, CW, px0, py0, dt, conv_x = _setup(cyclic, order,
                                                               dtype)
    want = _per_group_loop(W, CW, px0, py0, dt, conv_x, grid,
                           settls_order=2, order=order)
    before = cuda_settls.LAUNCHES, cuda_interp.LAUNCHES
    kw = dict(settls_order=2, order=order, x_min=grid.x_min,
              x_max=grid.x_max, y_min=grid.y_min, y_max=grid.y_max,
              cyclic_x=cyclic)
    CI = interleave(cu, cv)
    px, py = px0.clone(), py0.clone()
    for t in range(NT - 1):
        out = settls_step(tu, tv, CI, px, py, conv_x, dt, t, out=(px, py),
                          **kw)
        assert out[0] is px and out[1] is py
        _assert_bit_equal((px, py), want[t + 1])
    scan = dict(settls_order=2, interp_order=order, kernel="torch")
    tx, ty, flag = TS.settls_scan(tu, tv, cu, cv, px0, py0, dt, conv_x, grid,
                                  return_traj=True, **scan)
    assert int(flag) == 0 and tx.shape == (NT,) + px0.shape
    for t in range(NT):
        _assert_bit_equal((tx[t], ty[t]), want[t])
    fx, fy, _ = TS.settls_scan(tu, tv, cu, cv, px0, py0, dt, conv_x, grid,
                               return_traj=False, **scan)
    _assert_bit_equal((fx, fy), want[-1])
    assert (cuda_settls.LAUNCHES, cuda_interp.LAUNCHES) == before


def test_interleaved_stack_layout():
    rng = np.random.RandomState(3)
    cu, cv = (torch.tensor(rng.randn(3, 5, 7)) for _ in range(2))
    ci = interleave(cu, cv)
    assert ci.shape == (3, 5, 7, 2) and ci.is_contiguous()
    planar = (cu, cv)
    for t, i, j, c in ((0, 0, 0, 0), (2, 4, 6, 1), (1, 3, 2, 0), (1, 3, 2, 1)):
        assert ci[t, i, j, c] == planar[c][t, i, j]
    flat = ci.reshape(-1)
    assert flat[((1 * 5 + 3) * 7 + 2) * 2 + 1] == cv[1, 3, 2]


def test_wrapper_refuses_mixed_devices_and_cuda_on_cpu():
    grid, tu, tv, cu, cv, _, _, px0, py0, dt, conv_x = _setup(
        True, 3, torch.float64)
    kw = dict(settls_order=1, order=3, x_min=grid.x_min, x_max=grid.x_max,
              y_min=grid.y_min, y_max=grid.y_max, cyclic_x=True)
    meta = px0.to("meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        settls_step(tu, tv, interleave(cu, cv), meta, py0, conv_x, dt, 0,
                    **kw)
    with pytest.raises(ValueError, match="CUDA tensors"):
        TS.resolve_kernel("cuda", "cpu", 3)
    assert TS.resolve_kernel("auto", "cpu", 3) == "torch"


@lru_cache(maxsize=None)
def _vortex():
    cfg = dict(flows.VORTEX_CONFIG_SUBTROPICAL)
    cfg.update(dx=4, dy=4, nt=5)
    u, v, lats, lons, _ = flows.ideal_vortex(**cfg)
    return u, v, lats, lons


@pytest.mark.parametrize("nt,settls_order,return_traj", [
    (2, 4, False), (5, 2, True)])
def test_core_matches_jax(nt, settls_order, return_traj):
    """One step (T = 2) and four steps (T = 5) against JAX's integrator."""
    u, v, lats, lons = _vortex()
    u, v = u[:nt], v[:nt]
    jx, jy = JS.parcel_propagation_core(
        jnp.asarray(u), jnp.asarray(v), -6 * 3600.0,
        JaxGrid(lats=lats, lons=lons, cyclic_x=True),
        settls_order=settls_order, interp_order=3, return_traj=return_traj)
    gx, gy = TS.parcel_propagation_core(
        u, v, -6 * 3600.0, Grid(lats=lats, lons=lons, cyclic_x=True),
        settls_order=settls_order, interp_order=3, return_traj=return_traj,
        kernel="torch", device="cpu")
    assert gx.device.type == "cpu" and gx.dtype == torch.float64
    assert gx.shape == ((nt,) if return_traj else ()) + u.shape[1:]
    np.testing.assert_allclose(gx.numpy(), np.asarray(jx), rtol=0,
                               atol=JAX_ATOL)
    np.testing.assert_allclose(gy.numpy(), np.asarray(jy), rtol=0,
                               atol=JAX_ATOL)


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")


def test_entry_points_default_to_the_card():
    """With no device= and no tensor, each entry point asks for the card,
    and raises on a machine without one (no CPU fallback)."""
    _no_card()
    u, v, lats, lons = _vortex()
    grid = Grid(lats=lats, lons=lons, cyclic_x=True)
    times = np.datetime64("2000-01-01", "ns") \
        + np.arange(u.shape[0]) * np.timedelta64(6, "h")
    coords = {"time": times, "latitude": lats, "longitude": lons}
    dims = ("time", "latitude", "longitude")
    U, V = Field(u, dims, coords, name="u"), Field(v, dims, coords, name="v")
    calls = {
        "ftle_pipeline": lambda: ftle_pipeline(u, v, -3600.0, grid),
        "FTLEPipeline": lambda: FTLEPipeline(grid),
        "parcel_propagation_core": lambda: TS.parcel_propagation_core(
            u, v, -3600.0, grid),
        "LCS": lambda: LCS(timestep=-3600.0)(u=U, v=V, verbose=False),
        "parcel_propagation": lambda: parcel_propagation(
            U, V, -3600.0, verbose=False),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="device=cuda"):
            call()


def test_cpu_tensors_stay_on_the_cpu():
    u, v, lats, lons = _vortex()
    grid = Grid(lats=lats, lons=lons, cyclic_x=True)
    tu, tv = torch.tensor(u[:3]), torch.tensor(v[:3])
    before = cuda_settls.LAUNCHES
    norm = ftle_pipeline(tu, tv, -3600.0, grid, settls_order=1)
    px, py = TS.parcel_propagation_core(tu, tv, -3600.0, grid,
                                        settls_order=1)
    assert {norm.device.type, px.device.type, py.device.type} == {"cpu"}
    assert cuda_settls.LAUNCHES == before


# ---------------------------------------------------------------------------
# Blocks of the grid: home rows and block shapes
# ---------------------------------------------------------------------------

def _home_idx(ny, n_blocks):
    """The latitude-block pipeline's padded rows (parallel/pipeline.py:
    symmetric reflection past the south end)."""
    k = np.arange(-(-ny // n_blocks) * n_blocks)
    return np.where(k < ny, k, 2 * ny - 1 - k)


@pytest.mark.parametrize("order", [1, 3])
def test_interp_home_rows_match_jax(order):
    """``interp_at_parcels(_multi)(home_rows=...)`` against JAX's with the
    same home rows: a block of reflected pad rows whose pole test keys on
    the rows they reflect, within the interp tests' 1e-12."""
    from lagrangiancoherence_tpu.ops import interp as JI
    from lagrangiancoherence_tpu_torch.ops import interp as TI
    rng = np.random.RandomState(order)
    ny, nx = 13, 36
    lats, lons = np.linspace(-90.0, 90.0, ny), np.linspace(-180.0, 170.0, nx)
    fields = rng.randn(4, ny, nx)
    coeffs = np.asarray(JI.prefilter(jnp.asarray(fields), order=order))
    home = _home_idx(ny, 4)[8:]                       # rows 8..12, 12..10
    px0, py0 = np.meshgrid(lons, lats[home])
    px = px0 + rng.uniform(-5, 5, px0.shape)
    py = np.clip(py0 + rng.uniform(-5, 5, py0.shape), -90, 90)
    b = dict(x_min=lons[0], x_max=lons[-1], y_min=lats[0], y_max=lats[-1],
             order=order)
    hr = home[:, None].astype(np.int32)
    want = np.asarray(JI.interp_at_parcels_multi(
        jnp.asarray(fields), jnp.asarray(coeffs), jnp.asarray(px),
        jnp.asarray(py), home_rows=jnp.asarray(hr), **b))
    got = TI.interp_at_parcels_multi(
        torch.tensor(fields), torch.tensor(coeffs), torch.tensor(px),
        torch.tensor(py), home_rows=torch.tensor(hr), **b).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    # the pole-home rows took the bilinear: they differ from row labels
    plain = TI.interp_at_parcels_multi(
        torch.tensor(fields), torch.tensor(coeffs), torch.tensor(px),
        torch.tensor(py), **b).numpy()
    assert not np.allclose(got[:, -4:], plain[:, -4:])
    one = np.asarray(JI.interp_at_parcels(
        jnp.asarray(fields[1]), jnp.asarray(coeffs[1]), jnp.asarray(px),
        jnp.asarray(py), home_rows=jnp.asarray(hr), **b))
    np.testing.assert_allclose(TI.interp_at_parcels(
        torch.tensor(fields[1]), torch.tensor(coeffs[1]), torch.tensor(px),
        torch.tensor(py), home_rows=torch.tensor(hr), **b).numpy(), one,
        rtol=0, atol=1e-12)


BLOCK_CASES = [(dtype, order, cyclic)
               for dtype in (torch.float64, torch.float32)
               for order in (3, 1) for cyclic in (True, False)]


@pytest.mark.parametrize("dtype,order,cyclic", BLOCK_CASES)
def test_plain_step_on_blocks_equals_the_whole_grid(dtype, order, cyclic):
    """``settls_step_torch`` on latitude blocks (home rows given, the last
    block's reflected pad rows included), on a block starting at row 0 with
    no home rows, and on x-blocks gives the whole grid's rows bit for bit;
    ``settls_step`` on CPU tensors with ``home_rows`` takes the plain
    version and launches nothing."""
    grid, tu, tv, cu, cv, W, CW, px0, py0, dt, conv_x = _setup(cyclic, order,
                                                               dtype)
    ny, nx = px0.shape
    kw = dict(settls_order=2, order=order, x_min=grid.x_min,
              x_max=grid.x_max, y_min=grid.y_min, y_max=grid.y_max,
              cyclic_x=cyclic)
    home = torch.tensor(_home_idx(ny, 4), dtype=torch.int32)
    before = cuda_settls.LAUNCHES
    for t in (0, NT - 2):
        wx, wy = settls_step_torch(W, CW, px0, py0, conv_x, dt, t, **kw)
        wx, wy = wx[home.long()], wy[home.long()]
        for r0, r1, c0, c1 in ((0, 4, 0, nx), (8, 16, 0, nx),
                               (12, 16, 18, 36), (4, 8, 0, 18)):
            hr = home[r0:r1]
            bx = px0[hr.long()][:, c0:c1].contiguous()
            by = py0[hr.long()][:, c0:c1].contiguous()
            cx = conv_x[hr.long()]
            got = settls_step_torch(W, CW, bx, by, cx, dt, t, home_rows=hr,
                                    **kw)
            _assert_bit_equal(got, (wx[r0:r1, c0:c1], wy[r0:r1, c0:c1]))
            got = settls_step(tu, tv, interleave(cu, cv), bx, by, cx, dt, t,
                              home_rows=hr, **kw)
            _assert_bit_equal(got, (wx[r0:r1, c0:c1], wy[r0:r1, c0:c1]))
            if r0 == 0:     # home rows = block rows: none needed
                got = settls_step_torch(W, CW, bx, by, cx, dt, t, **kw)
                _assert_bit_equal(got, (wx[:r1, c0:c1], wy[:r1, c0:c1]))
    assert cuda_settls.LAUNCHES == before


def test_scan_block_mode():
    """``settls_scan`` on a block with ``home_rows`` or ``row_offset``
    equals the whole scan's rows, trajectories included;
    ``debug_per_step`` gives the (T-1,) per-step word (zeros on the direct
    route); the windowed route refuses an x-block."""
    grid, tu, tv, cu, cv, *_, px0, py0, dt, conv_x = _setup(True, 3,
                                                            torch.float64)
    scan = dict(settls_order=2, interp_order=3, kernel="torch")
    tx, ty, _ = TS.settls_scan(tu, tv, cu, cv, px0, py0, dt, conv_x, grid,
                               return_traj=True, **scan)
    rows = slice(5, 11)
    args = (tu, tv, cu, cv, px0[rows], py0[rows], dt, conv_x[rows], grid)
    bx, by, flag = TS.settls_scan(*args, return_traj=True, row_offset=5,
                                  **scan)
    _assert_bit_equal((bx, by), (tx[:, rows], ty[:, rows]))
    assert flag.shape == () and int(flag) == 0
    fx, fy, steps = TS.settls_scan(
        *args, return_traj=False, debug_per_step=True,
        home_rows=torch.arange(5, 11), **scan)
    _assert_bit_equal((fx, fy), (tx[-1, rows], ty[-1, rows]))
    assert steps.dtype == torch.int32 and steps.tolist() == [0] * (NT - 1)
    # without the home rows, rows 0.. of a block are pole-home rows
    gx, _, _ = TS.settls_scan(tu, tv, cu, cv, px0[-6:], py0[-6:], dt,
                              conv_x[-6:], grid, return_traj=False, **scan)
    assert not torch.equal(gx, tx[-1, -6:])
    with pytest.raises(ValueError, match="full-width"):
        TS.settls_scan(tu, tv, cu, cv, px0[rows, :18], py0[rows, :18], dt,
                       conv_x[rows], grid, return_traj=False, row_offset=5,
                       engine="blockspec", **scan)
