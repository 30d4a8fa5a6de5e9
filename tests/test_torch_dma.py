"""``engine="dma"`` in the port: the windowed route with the manual-DMA
engines' capacity table (``tiles.dma_ladder``), on the CPU in float64.

* ``dma_ladder`` equals JAX's table (restated below from
  pallas_interp.py:1793-1805, with its defaults wx 256, retry_wy 64,
  retry_wx 512).
* One gather group against JAX's ``pallas_interp_multi(engine="dma",
  interpret=True)`` on a shear case whose capacities bind (the tallest
  tier fills, a tile is left to tier A): values within 1e-12, the overflow
  word equal.  JAX's interpret-mode dma engine costs ~45 s on this CPU, so
  it runs once.
* The scan: ``parcel_propagation_core(engine="dma")`` within 1e-9 of JAX's
  XLA scan (tests/test_pallas_interp.py:455-482 mirrored), and the
  ``dma`` pipeline equal to ``blockspec`` with sorting on (both take the
  sort ladder then) and off, and to the direct route; on latitude blocks
  too.
"""
from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lagrangiancoherence_tpu.ops.pallas_interp as PI
from lagrangiancoherence_tpu.grid import Grid as JaxGrid
from lagrangiancoherence_tpu.models.settls import \
    parcel_propagation_core as jax_core
from lagrangiancoherence_tpu.ops.interp import prefilter as jax_prefilter
from lagrangiancoherence_tpu_torch import (FTLEPipeline, ftle_batch,
                                          ftle_pipeline,
                                          parcel_propagation_sharded)
from lagrangiancoherence_tpu_torch.grid import Grid
from lagrangiancoherence_tpu_torch.models import settls as TS
from lagrangiancoherence_tpu_torch.ops.interp import prefilter
from lagrangiancoherence_tpu_torch.ops.tiles import (DEFAULT_LADDER,
                                                     dma_ladder, route_tiles)
from lagrangiancoherence_tpu_torch.ops.window_interp import \
    windowed_interp_multi
from lagrangiancoherence_tpu_torch.parallel.mesh import (batch_mesh,
                                                         parcel_mesh)

torch.set_num_threads(1)

GATHER_ATOL = 1e-12
SCAN_ATOL = 1e-9        # tests/test_pallas_interp.py:479-482
DT = -6 * 3600.0


def jax_dma_table(n, wx=256, retry_wy=64, retry_wx=512):
    """pallas_interp.py:1793-1805, as written there."""
    return [
        (64, wx, max(384, n // 2)),
        (32, 384, max(96, n // 4)),
        (64, 384, max(96, n // 4)),
        (32, retry_wx, max(64, n // 8)),
        (retry_wy, retry_wx, max(64, n // 8)),
        (128, 768, max(96, n // 4)),
        (32, None, max(96, n // 2)),
        (64, None, max(128, n // 2)),
        (192, None, max(16, n // 4)),
    ]


@pytest.mark.parametrize("n_tiles", [1, 22, 276, 1092, 5000])
def test_dma_ladder_matches_jax_table(n_tiles):
    assert list(dma_ladder(n_tiles)) == jax_dma_table(n_tiles)
    # the windows are the blockspec ladder's; only capacities differ
    assert [s[:2] for s in dma_ladder(n_tiles)] == \
        [s[:2] for s in DEFAULT_LADDER]


def test_engines_resolve():
    """Every engine of JAX's set resolves; ``"auto"`` is the direct route."""
    assert {e: TS.resolve_engine(e) for e in TS.ENGINES} == {
        "auto": "dma-all", "dma-all": "dma-all", "blockspec": "blockspec",
        "dma": "dma"}
    with pytest.raises(ValueError, match="engine="):
        TS.resolve_engine("pallas")
    with pytest.raises(ValueError, match="engine="):
        windowed_interp_multi(torch.zeros(2, 9, 10), torch.zeros(2, 9, 10),
                              torch.zeros(9, 10), torch.zeros(9, 10),
                              x_min=0, x_max=1, y_min=0, y_max=1,
                              engine="dma-all")


def _shear_case(F=2, ny=169, nx=128):
    """A violent y shear on a 169 x 128 grid (22 tiles): 16 tiles need the
    tallest tier, whose capacity is max(16, 22 // 4) = 16, and one more is
    left to tier A (bits 1 and 2)."""
    rng = np.random.RandomState(0)
    lats = np.linspace(-90, 90, ny)
    lons = np.linspace(-180, 180 - 360 / nx, nx)
    fields = rng.randn(F, ny, nx)
    px0, py0 = np.meshgrid(lons, lats)
    px = px0 + 120 * np.sin(py0 / 10) * np.cos(px0 / 15)
    py = np.clip(py0 + 90 * np.sin(px0 / 20), -90, 90)
    px = np.where(px > 180, -180 + (px % 180), px)
    px = np.where(px < -180, px % 180, px)
    bounds = dict(x_min=lons.min(), x_max=lons.max(), y_min=lats.min(),
                  y_max=lats.max())
    return fields, px, py, bounds


@lru_cache(maxsize=None)
def _jax_dma_gather():
    fields, px, py, bounds = _shear_case()
    ny, nx = px.shape
    cwp = PI.pad_coeffs_for_pallas(jax_prefilter(jnp.asarray(fields),
                                                 order=3))
    out, flag = PI.pallas_interp_multi(
        jnp.asarray(fields), cwp, jnp.asarray(px), jnp.asarray(py), ny=ny,
        nx=nx, order=3, wy=32, wx=256, engine="dma", interpret=True,
        **bounds)
    return np.asarray(out), int(flag)


def test_dma_gather_matches_jax():
    fields, px, py, bounds = _shear_case()
    ny, nx = px.shape
    tpx, tpy = torch.tensor(px), torch.tensor(py)
    # the capacities bind: the tallest tier is full and a tile is left over
    n_tiles = -(-ny // 8) * -(-nx // 128)
    rt = route_tiles(tpx, tpy, ny=ny, nx=nx, order=3, wy=32,
                     ladder=dma_ladder(n_tiles), **bounds)
    assert int(rt.tiers[-1].count) == rt.tiers[-1].cap == 16
    assert int(rt.overflow) & 2
    f = torch.tensor(fields)
    out, flag = windowed_interp_multi(f, prefilter(f, order=3), tpx, tpy,
                                      order=3, wy=32, engine="dma", **bounds)
    want, want_flag = _jax_dma_gather()
    assert int(flag) == want_flag == 0b110
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=GATHER_ATOL)


def _engine_in_scan_case():
    """tests/test_pallas_interp.py:455-470: 48 x 128, three levels."""
    ny, nx = 48, 128
    lats = np.linspace(-90.0, 90.0, ny)
    lons = np.linspace(-180.0, 180.0 - 360.0 / nx, nx)
    LON, LAT = np.meshgrid(np.deg2rad(lons), np.deg2rad(lats))
    t = np.arange(3)[:, None, None]
    u = 25.0 * np.cos(LAT)[None] * (1 + 0.1 * np.sin(t))
    v = (5.0 * np.sin(3 * LON) * np.cos(LAT))[None] * (1 + 0.1 * np.cos(t))
    return u, v, lats, lons


def test_dma_scan_matches_jax_xla_scan():
    u, v, lats, lons = _engine_in_scan_case()
    want = jax_core(jnp.asarray(u), jnp.asarray(v), DT,
                    JaxGrid(lats=lats, lons=lons, cyclic_x=True),
                    settls_order=2, kernel="xla", return_overflow=True)
    grid = Grid(lats=lats, lons=lons, cyclic_x=True)
    got = TS.parcel_propagation_core(u, v, DT, grid, settls_order=2,
                                     engine="dma", return_overflow=True,
                                     device="cpu")
    assert int(got[2]) == int(want[2]) == 0
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=SCAN_ATOL)
    auto = TS.parcel_propagation_core(u, v, DT, grid, settls_order=2,
                                      device="cpu")
    assert all(torch.equal(g, a) for g, a in zip(got[:2], auto))


def _polar_whirl():
    """tests/test_torch_settls_blockspec.py's polar whirl: 97 rows, both
    polar bands sort-binned."""
    ny, nx = 97, 128
    lats = np.linspace(-90.0, 90.0, ny)
    lons = np.linspace(-180.0, 180.0 - 360.0 / nx, nx)
    LON, LAT = np.meshgrid(np.deg2rad(lons), np.deg2rad(lats))
    t = np.arange(4)[:, None, None]
    u = (20.0 * np.cos(LAT) + 2.0 * np.cos(3 * LON)
         * np.sin(2 * LAT))[None] * (1 + 0.05 * np.sin(t))
    v = (2.0 * np.sin(3 * LON) * np.cos(2 * LAT))[None] \
        * (1 + 0.05 * np.cos(t))
    return u, v, Grid(lats=lats, lons=lons, cyclic_x=True)


@pytest.mark.parametrize("rebin", ["sort", False])
def test_dma_pipeline_equals_blockspec(rebin):
    """With sorting on every gather takes the sort ladder, so ``dma`` and
    ``blockspec`` are the same computation; with it off they take their own
    ladders, whose capacities do not bind here: the same values and words.
    ``FTLEPipeline`` takes the engine too."""
    u, v, grid = _polar_whirl()
    out = {e: ftle_pipeline(u, v, DT, grid, settls_order=1, engine=e,
                            rebin=rebin, return_overflow=True, device="cpu")
           for e in ("dma", "blockspec", "auto")}
    for e in ("blockspec", "auto"):
        assert torch.equal(out["dma"][0], out[e][0])
        assert int(out["dma"][1]) == int(out[e][1]) == 0
    model = FTLEPipeline(grid, settls_order=1, engine="dma", rebin=rebin,
                         device="cpu")
    assert torch.equal(model(u, v, DT), out["dma"][0])


@pytest.mark.parametrize("n_blocks", [3, 8])
def test_dma_on_blocks(n_blocks):
    """Latitude blocks on the ``dma`` engine (97 rows: 2 and 7 reflected
    pad rows) give the whole grid's departure points."""
    u, v, grid = _polar_whirl()
    px, py, flag = parcel_propagation_sharded(
        u, v, DT, grid, parcel_mesh(devices=["cpu"] * n_blocks),
        settls_order=1, engine="dma", return_overflow=True)
    wx, wy = TS.parcel_propagation_core(u, v, DT, grid, settls_order=1,
                                        engine="dma", device="cpu")
    assert int(flag) == 0
    assert torch.equal(px, wx) and torch.equal(py, wy)


def test_dma_batch():
    """``ftle_batch`` takes the engine too: each window through one
    ``FTLEPipeline(engine="dma")``, the same field as the whole-grid
    pipeline."""
    u, v, grid = _polar_whirl()
    out, flags = ftle_batch(np.stack([u, u]), np.stack([v, v]), DT, grid,
                            batch_mesh(devices=["cpu"] * 2), settls_order=1,
                            engine="dma", return_overflow=True)
    want = ftle_pipeline(u, v, DT, grid, settls_order=1, engine="dma",
                         device="cpu")
    assert torch.equal(out, want.expand_as(out))
    assert flags.tolist() == [0, 0]
