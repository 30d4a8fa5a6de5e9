"""The windowed route on latitude blocks, one gather group and the block
sort: lagrangiancoherence_tpu_torch against the JAX package on the CPU in
float64.

* The block sort (``_shard_sortable_groups``, ``_sort_bin_shard``,
  ``_unsort_shard``) equals JAX's on the same numpy-seeded inputs: equal
  arrays.
* ``windowed_interp_multi(home_rows=)`` on a block of a 4-block layout
  against JAX's ``pallas_interp_multi(home_rows=, engine="blockspec",
  interpret=True)``: the first block (the south pole-home rows) and the
  last (the north pole-home rows and 3 reflected pad rows).  Values within
  1e-12 (the prefilters' summation orders differ), overflow words equal.
  JAX's interpret-mode calls cost tens of seconds each on this CPU, so
  these two are the only ones.
* Every block's values equal the whole-grid gather's rows bit for bit (the
  same taps in the same order), but for reflected pad rows that reflect a
  pole-home row: no pole candidate stands for them, so they keep the spline
  values at their substituted positions, as in JAX (pallas_interp.py:
  2379-2433); the pipeline cuts them off.
"""
from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lagrangiancoherence_tpu.ops.pallas_interp as PI
from lagrangiancoherence_tpu.grid import Grid as JaxGrid
from lagrangiancoherence_tpu.models import settls as JS
from lagrangiancoherence_tpu.ops.interp import prefilter as jax_prefilter
from lagrangiancoherence_tpu_torch.grid import Grid
from lagrangiancoherence_tpu_torch.models import settls as TS
from lagrangiancoherence_tpu_torch.ops import cuda_window
from lagrangiancoherence_tpu_torch.ops.interp import prefilter
from lagrangiancoherence_tpu_torch.ops.tiles import substitute_pole_rows
from lagrangiancoherence_tpu_torch.ops.window_interp import \
    windowed_interp_multi
from lagrangiancoherence_tpu_torch.parallel.pipeline import block_layout

torch.set_num_threads(1)

JAX_ATOL = 1e-12
NY, NX, ORDER = 73, 144, 3


def _grid_case(F, seed=0):
    """tests/test_torch_window.py's "smooth" case: seeded fields, displaced
    positions on a 73 x 144 global grid."""
    rng = np.random.RandomState(seed)
    lats = np.linspace(-90, 90, NY)
    lons = np.linspace(-180, 180 - 360 / NX, NX)
    fields = rng.randn(F, NY, NX)
    px0, py0 = np.meshgrid(lons, lats)
    px = px0 + 15 * np.sin(py0 / 30) + 3
    py = np.clip(py0 + 10 * np.cos(px0 / 40), -90, 90)
    px = np.where(px > 180, -180 + (px % 180), px)
    bounds = dict(x_min=lons.min(), x_max=lons.max(), y_min=lats.min(),
                  y_max=lats.max())
    return fields, px, py, bounds, Grid(lats=lats, lons=lons, cyclic_x=True)


def _blocks(grid, n=4):
    home = block_layout(grid, n)["home_idx"]
    rows = home.size // n
    return [home[i * rows:(i + 1) * rows] for i in range(n)]


def _port(fields, px, py, bounds, home, **kw):
    f = torch.tensor(fields)
    c = prefilter(f, order=ORDER)
    if home is None:
        return windowed_interp_multi(f, c, torch.tensor(px), torch.tensor(py),
                                     order=ORDER, **bounds, **kw)
    return windowed_interp_multi(
        f, c, torch.tensor(px[home]), torch.tensor(py[home]), order=ORDER,
        home_rows=torch.tensor(home, dtype=torch.int32), **bounds, **kw)


@lru_cache(maxsize=None)
def _jax_block(block, F, wy):
    fields, px, py, bounds, grid = _grid_case(F)
    home = _blocks(grid)[block]
    cwp = PI.pad_coeffs_for_pallas(jax_prefilter(jnp.asarray(fields),
                                                 order=ORDER))
    out, flag = PI.pallas_interp_multi(
        jnp.asarray(fields), cwp, jnp.asarray(px[home]),
        jnp.asarray(py[home]), ny=NY, nx=NX, order=ORDER, wy=wy, wx=256,
        home_rows=jnp.asarray(home[:, None], jnp.int32), engine="blockspec",
        interpret=True, **bounds)
    return np.asarray(out), int(flag)


@pytest.mark.parametrize("block,F,wy", [(0, 4, 32), (3, 2, 64)])
def test_block_gather_matches_jax(block, F, wy):
    """The first block of 4 (rows 0-18: the south pole-home rows) at F=4,
    and the last (rows 57-72 and the reflected 72, 71, 70: the north
    pole-home rows twice) at F=2, as the scan's groups take them."""
    fields, px, py, bounds, grid = _grid_case(F)
    home = _blocks(grid)[block]
    before = dict(cuda_window.LAUNCHES)
    out, flag = _port(fields, px, py, bounds, home, wy=wy)
    assert cuda_window.LAUNCHES == before
    want, want_flag = _jax_block(block, F, wy)
    assert int(flag) == want_flag == 0
    assert out.shape == want.shape == (F, home.size, NX)
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=JAX_ATOL)


@pytest.mark.parametrize("block", [0, 1, 2, 3])
def test_block_gather_equals_the_whole_grid(block):
    """Each block of 4 against the whole-grid gather's rows, bit for bit;
    the last block's pad rows that reflect pole-home rows take the spline
    values at their substituted positions instead (no candidate stands for
    them)."""
    fields, px, py, bounds, grid = _grid_case(4)
    home = _blocks(grid)[block]
    whole, wflag = _port(fields, px, py, bounds, None)
    out, flag = _port(fields, px, py, bounds, home)
    assert int(flag) == int(wflag) == 0
    real = np.arange(home.size) < NY - block * home.size
    pole = (home < ORDER) | (home >= NY - ORDER)
    keep = torch.tensor(real | ~pole)
    assert torch.equal(out[:, keep], whole[:, home][:, keep])
    if not keep.all():
        assert not torch.equal(out[:, ~keep], whole[:, home][:, ~keep])


def test_substitution_follows_jax():
    """``substitute_pole_rows`` with home rows is JAX's clipped home-row map
    (pallas_interp.py:1717-1723), and without them the whole grid's static
    rows."""
    p = torch.arange(NY * 2, dtype=torch.float64).reshape(NY, 2)
    for home in _blocks(_grid_case(2)[4]) + [np.arange(NY)]:
        got = substitute_pole_rows(p[home], ORDER, NY,
                                   torch.tensor(home, dtype=torch.int32))
        safe = np.clip(np.clip(home, ORDER, NY - 1 - ORDER) - home[0], 0,
                       home.size - 1)
        assert torch.equal(got, p[home][safe])
    assert torch.equal(substitute_pole_rows(p, ORDER),
                       p[np.clip(np.arange(NY), ORDER, NY - 1 - ORDER)])


def _polar_grid():
    """tests/test_torch_settls_blockspec.py's polar whirl grid: 97 rows,
    both polar bands."""
    lats = np.linspace(-90.0, 90.0, 97)
    lons = np.linspace(-180.0, 180.0 - 360.0 / 128, 128)
    return lats, lons


@pytest.mark.parametrize("n_blocks,block", [(4, 0), (4, 1), (4, 3), (8, 7)])
def test_block_sort_matches_jax(n_blocks, block):
    """The block sort and its inverse equal JAX's on seeded positions (a
    NaN longitude included, which keys as cell 0): the sortable groups, the
    sorted positions, conv_x and permutation, and the un-sorted positions."""
    lats, lons = _polar_grid()
    grid = Grid(lats=lats, lons=lons, cyclic_x=True)
    jgrid = JaxGrid(lats=lats, lons=lons, cyclic_x=True)
    home = _blocks(grid, n_blocks)[block]
    rows, nx = home.size, lons.size
    rng = np.random.RandomState(n_blocks * 10 + block)
    px = rng.uniform(-180.0, 180.0, (rows, nx))
    px[rows // 2, 5] = np.nan
    py = rng.uniform(-90.0, 90.0, (rows, nx))
    cx = np.broadcast_to(rng.uniform(1.0, 2.0, (rows, 1)), (rows, nx)).copy()
    perm = np.arange(rows * nx, dtype=np.int32).reshape(rows, nx)
    arrs = (px, py, cx, perm)

    want_ok = JS._shard_sortable_groups(jnp.asarray(home[:, None], jnp.int32),
                                        jgrid, ORDER)
    got_ok = TS._shard_sortable_groups(torch.tensor(home), grid, ORDER)
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    want = JS._sort_bin_shard(tuple(jnp.asarray(a) for a in arrs),
                              jnp.asarray(px), want_ok, jgrid)
    got = TS._sort_bin_shard(tuple(torch.tensor(a) for a in arrs),
                             torch.tensor(px), got_ok, grid)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    nr8 = (rows // 8) * 8
    want_u = JS._unsort_shard(want[:2], want[3], nr8)
    got_u = TS._unsort_shard(got[:2], got[3], nr8)
    for g, w, a in zip(got_u, want_u, arrs):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), a)
