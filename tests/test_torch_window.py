"""Port parity of the windowed gather (``engine="blockspec"``):
lagrangiancoherence_tpu_torch.ops.window_interp against the JAX package's
``pallas_interp_multi(engine="blockspec", interpret=True)`` and its XLA
gather, on the CPU in float64.

Bounds: where the overflow word is 0 the windowed values equal the port's
direct gather bit for bit (the same taps, accumulated in the same order)
and agree with JAX within 1e-11 (the JAX package's own Pallas-vs-XLA
bound, tests/test_pallas_interp.py); the pole path within 1e-12 (order-1
bilinear, no contraction).  The overflow bitmask equals JAX's in every
case, the clamped ones included; values of flagged tiles are approximate
in JAX too and are not compared.

JAX interpret-mode calls cost seconds each on this CPU, so four cases go
through them; the rest are held against JAX's XLA gather.
"""
from functools import lru_cache
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lagrangiancoherence_tpu.ops.pallas_interp as PI
from lagrangiancoherence_tpu.ops.interp import (
    interp_at_parcels_multi as jax_gather, prefilter as jax_prefilter)
from lagrangiancoherence_tpu_torch.ops import cuda_window, pole as P
from lagrangiancoherence_tpu_torch.ops.interp import (interp_at_parcels_multi,
                                                      prefilter)
from lagrangiancoherence_tpu_torch.ops.tiles import route_tiles
from lagrangiancoherence_tpu_torch.ops.window_interp import \
    windowed_interp_multi

torch.set_num_threads(1)

JAX_ATOL = 1e-11
POLE_ATOL = 1e-12
NY, NX = 73, 144
POLE_NX = 720       # six pole slots: (8, 16, 288) reaches every level


def _case(disp, F, order, ny=NY, nx=NX, seed=0):
    """tests/test_pallas_interp.py:16-48: seeded fields and displaced
    positions on a global grid."""
    rng = np.random.RandomState(seed)
    lats = np.linspace(-90, 90, ny)
    lons = np.linspace(-180, 180 - 360 / nx, nx)
    fields = rng.randn(F, ny, nx)
    px0, py0 = np.meshgrid(lons, lats)
    if disp == "smooth":
        px = px0 + 15 * np.sin(py0 / 30) + 3
        py = np.clip(py0 + 10 * np.cos(px0 / 40), -90, 90)
    elif disp == "whirl":
        px = px0 + 700 * np.sin(py0 / 7) * np.cos(px0 / 11)
        py = np.clip(py0 + 4 * np.sin(px0 / 20), -90, 90)
    else:
        px = px0 + 120 * np.sin(py0 / 10) * np.cos(px0 / 15)
        py = np.clip(py0 + 60 * np.sin(px0 / 20), -90, 90)
    px = np.where(px > 180, -180 + (px % 180), px)
    px = np.where(px < -180, px % 180, px)
    bounds = dict(x_min=lons.min(), x_max=lons.max(), y_min=lats.min(),
                  y_max=lats.max())
    return fields, px, py, bounds


def _port(fields, px, py, bounds, order, **kw):
    """The windowed gather's values and overflow word, its routing and the
    port's direct gather, at the same inputs."""
    f = torch.tensor(fields)
    c = prefilter(f, order=order)
    px, py = torch.tensor(px), torch.tensor(py)
    out, flag = windowed_interp_multi(f, c, px, py, order=order, **bounds,
                                      **kw)
    rt = route_tiles(px, py, ny=px.shape[0], nx=px.shape[1], order=order,
                     **dict(dict(wy=32), **kw), **bounds)
    direct = interp_at_parcels_multi(f, c, px, py, order=order, **bounds)
    return out, int(flag), rt, direct


def _counts(rt):
    return [int(t.count) for t in rt.tiers]


@lru_cache(maxsize=None)
def _jax_blockspec(disp, F, order, retry, wy, debug):
    """JAX's blockspec route in interpret mode.  ``debug_flags=True``
    names three pole-path locals that pallas_interp_multi never defines
    (pallas_interp.py:2458-2460); they are given module-level stand-ins
    for the call, so that the routing outputs come back."""
    fields, px, py, bounds = _case(disp, F, order)
    cwp = PI.pad_coeffs_for_pallas(jax_prefilter(jnp.asarray(fields),
                                                 order=order))
    with mock.patch.multiple(PI, create=True, pflags1=None, fit1=None,
                             covP=None):
        out, info = PI.pallas_interp_multi(
            jnp.asarray(fields), cwp, jnp.asarray(px), jnp.asarray(py),
            ny=NY, nx=NX, order=order, wy=wy, wx=256, retry_tiles=retry,
            engine="blockspec", interpret=True, debug_flags=debug, **bounds)
    return np.asarray(out), info


@pytest.mark.parametrize("disp,F,order,kw", [
    ("smooth", 4, 3, dict(retry_tiles=8, wy=48)),
    ("smooth", 2, 1, dict(retry_tiles=8, wy=48)),
    ("whirl", 2, 3, dict(retry_tiles=256, wy=32)),
    # every escalation goes to the full-longitude tiers
    ("shear", 2, 3, dict(retry_tiles=20, wy=32,
                         ladder=((64, None, 128), (184, None, 128)))),
    ("shear", 4, 3, dict(retry_tiles=20, wy=32)),
])
def test_values_match_jax_gather(disp, F, order, kw):
    fields, px, py, bounds = _case(disp, F, order)
    out, flag, rt, direct = _port(fields, px, py, bounds, order, **kw)
    assert flag == 0
    assert torch.equal(out, direct)          # the same taps, same order
    want = np.asarray(jax_gather(
        jnp.asarray(fields), jax_prefilter(jnp.asarray(fields), order=order),
        jnp.asarray(px), jnp.asarray(py), order=order, **bounds))
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=JAX_ATOL)
    if "ladder" in kw:
        assert sum(_counts(rt)) > 0


def test_escalation_matches_jax_blockspec():
    """Violent shear with escalation tiers live (tests/test_pallas_interp.py
    :63-67): values and bitmask against JAX's blockspec kernels."""
    want, info = _jax_blockspec("shear", 2, 3, 20, 32, True)
    out, flag, rt, _ = _port(*_case("shear", 2, 3), 3, retry_tiles=20, wy=32)
    assert int(info["overflow"]) == flag == 0
    assert sum(_counts(rt)) > 0
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=JAX_ATOL)


def test_routing_matches_jax_debug_flags():
    """Tier-A fits, per-tier live counts and uncovered tiles equal JAX's
    debug_flags outputs (pallas_interp.py:2443-2460)."""
    _, info = _jax_blockspec("shear", 2, 3, 20, 32, True)
    _, _, rt, _ = _port(*_case("shear", 2, 3), 3, retry_tiles=20, wy=32)
    np.testing.assert_array_equal(rt.fitA.numpy(), np.asarray(info["_fitA"]))
    assert _counts(rt) == [int(c) for c in info["_tier_taken"]]
    assert int(((~rt.fitA) & (~rt.covered)).sum()) == int(info["uncovered"])


def test_clamp_bitmask_matches_jax():
    """No escalation and 16-row windows: tiles clamp, and the bitmask is
    JAX's, bit for bit (tests/test_pallas_interp.py:69-72)."""
    _, flag = _jax_blockspec("shear", 2, 3, 0, 16, False)
    _, port_flag, _, _ = _port(*_case("shear", 2, 3), 3, retry_tiles=0, wy=16)
    assert int(flag) != 0
    assert port_flag == int(flag)


def _pole_lists(ny=NY, nx=NX, order=3):
    """The pole-home rows of a violent shear, sorted by JAX's and the port's
    once-per-step sort (tests/test_pallas_interp.py:620-638)."""
    fields, px, py, bounds = _case("shear", 4, order, ny=ny, nx=nx, seed=3)
    rows = np.r_[0:order, ny - order:ny]
    perm, _ = PI.pole_sort_state(jnp.asarray(px[rows]), jnp.asarray(py[rows]),
                                 order=order, ny=ny, nx=nx, **bounds)
    tperm, _ = P.pole_sort_state(torch.tensor(px[rows]),
                                 torch.tensor(py[rows]), order=order, ny=ny,
                                 nx=nx, **bounds)
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(perm))
    geom = dict(order=order, nx=nx)
    pxp = np.asarray(PI.pole_apply_perm(jnp.asarray(px[rows]), perm, **geom))
    pyp = np.asarray(PI.pole_apply_perm(jnp.asarray(py[rows]), perm, **geom))
    return fields, pxp, pyp, bounds


@pytest.mark.parametrize("ladder,nx", [(P.POLE_LADDER, NX),
                                       ((8, 16, 288), POLE_NX)])
def test_pole_path_matches_jax(ladder, nx, monkeypatch):
    """Presorted pole lists (tests/test_pallas_interp.py:639-650) through
    the three-level ladder; the shrunken ladder escalates slots to levels 2
    and 3.  JAX reads its ladder from LCS_POLE_LADDER, the port takes it as
    an argument."""
    fields, pxp, pyp, bounds = _pole_lists(nx=nx)
    monkeypatch.setenv("LCS_POLE_LADDER", ",".join(map(str, ladder)))
    cwp = PI.pad_coeffs_for_pallas(jax_prefilter(jnp.asarray(fields)))
    want, jflag = PI.pallas_interp_multi(
        jnp.asarray(fields), cwp, jnp.asarray(pxp), jnp.asarray(pyp), ny=NY,
        nx=nx, order=3, engine="blockspec", interpret=True,
        pole_block=True, pole_presorted=True, **bounds)
    f = torch.tensor(fields)
    got, flag = windowed_interp_multi(
        f, prefilter(f), torch.tensor(pxp), torch.tensor(pyp), order=3,
        pole_block=True, pole_presorted=True, pole_ladder=ladder, **bounds)
    assert int(flag) == int(jflag) == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=POLE_ATOL)
    _, key = P.pole_pack(torch.tensor(pxp), torch.tensor(pyp),
                         torch.ones(pxp.shape, dtype=torch.float64), ny=NY,
                         nx=nx, **bounds)
    levels = P.pole_levels(key, ny=NY, ladder=ladder)
    if ladder != P.POLE_LADDER:
        assert all(int(w.sum()) > 0 for w in levels.want[1:])


def test_pole_residue_raises_bit4():
    """Unsorted pole lists smeared over the whole domain cannot fit an
    8-row ladder: the last level clamps and raises bit 4 only
    (tests/test_pallas_interp.py:680-714)."""
    rng = np.random.default_rng(5)
    ny, nx = 49, 128
    _, mpad = P.pole_flat_dims(3, nx)
    f = torch.tensor(rng.standard_normal((2, ny, nx)))
    pxp = torch.tensor(rng.uniform(-180, 180, (2, mpad)))
    pyp = torch.tensor(rng.uniform(-90, 90, (2, mpad)))
    _, flag = windowed_interp_multi(
        f, prefilter(f), pxp, pyp, order=3, pole_block=True,
        pole_presorted=True, pole_ladder=(8, 8, 8), x_min=-180.0,
        x_max=180.0, y_min=-90.0, y_max=90.0)
    assert int(flag) == 1 << 4


def test_list_mode_dead_slots_write_nothing():
    """Slots at or past the count write only their flag, 0, and leave the
    output as it was; the CPU wrapper takes the plain version and counts
    no launch."""
    f = torch.tensor(_case("smooth", 2, 3)[0])
    folds = torch.zeros((2, 80, 256), dtype=torch.float64)
    before = torch.full((2, 80, 256), 7.0, dtype=torch.float64)
    buf = before.clone()
    flags = torch.full((4,), -1, dtype=torch.int32)
    overflow = torch.zeros((1,), dtype=torch.int32)
    n = dict(cuda_window.LAUNCHES)
    cuda_window.tile_window_gather(
        prefilter(f), folds, buf, flags, overflow,
        torch.zeros((10, 2), dtype=torch.int32),
        torch.zeros((10, 2), dtype=torch.int32), f0=0, nf=2, order=3, wy=32,
        wx=256, bit=5, sel=torch.arange(4, dtype=torch.int32),
        count=torch.zeros((), dtype=torch.int32))
    assert cuda_window.LAUNCHES == n
    assert torch.equal(buf, before) and int(overflow) == 0
    assert flags.tolist() == [0, 0, 0, 0]


def test_kernel_choice_is_checked():
    fields, px, py, bounds = _case("smooth", 2, 3)
    f = torch.tensor(fields)
    with pytest.raises(ValueError, match="kernel="):
        windowed_interp_multi(f, f, torch.tensor(px), torch.tensor(py),
                              kernel="pallas", **bounds)
