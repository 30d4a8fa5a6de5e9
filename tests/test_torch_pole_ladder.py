"""The one-launch pole ladder (``pole_ladder_gather``) on the CPU: its plain
version against the three-launch ladder it replaced, restated here from
``_pole_eval_block`` (lagrangiancoherence_tpu/ops/pallas_interp.py:1116-1341):
level 1 over every slot, level 2 over the slots that fit it but not level
1, level 3 over the rest, each later level overwriting its slots, bit 4
from a clamp at level 2 or 3, bit 3 from a level-1 clamp left uncovered.

Bound: ``torch.equal`` on values and on the overflow word, in float64 and
float32 (the same operations in the same order on the same cells; only the
window a slot is evaluated against differs, and a window that holds the
slot's rows does not change a value).  JAX parity of the pole path is in
tests/test_torch_window.py.
"""
import numpy as np
import pytest
import torch

from lagrangiancoherence_tpu_torch import ftle_pipeline
from lagrangiancoherence_tpu_torch.grid import Grid
from lagrangiancoherence_tpu_torch.ops import cuda_window, pole as P
from lagrangiancoherence_tpu_torch.ops.interp import (_to_index,
                                                      interp_at_parcels_multi,
                                                      scale_positions)
from lagrangiancoherence_tpu_torch.ops.window_interp import (
    pole_ladder_gather_plain, windowed_interp_multi)

torch.set_num_threads(1)

NY, NX, ORDER = 73, 720, 3          # three slots a side
BOUNDS = dict(x_min=-180.0, x_max=180.0 - 360.0 / NX, y_min=-90.0,
              y_max=90.0)
SLOT = 1024


def _lists(kind, dtype, seed=0):
    """(raw (6, ny, nx), sorted (2, Mpad) point lists, mask) of the
    pole-home rows of a displaced grid.  ``smooth`` fits level 1 of the
    default ladder; ``shear`` spreads a slot over tens of rows; ``wild``
    adds NaN, points far outside the field and a flung pad tail that the
    mask turns off."""
    rng = np.random.RandomState(seed)
    lats = np.linspace(-90, 90, NY)
    lons = np.linspace(-180, 180 - 360 / NX, NX)
    px0, py0 = np.meshgrid(lons, lats)
    if kind == "smooth":
        px = px0 + 15 * np.sin(py0 / 30) + 3
        py = np.clip(py0 + 2 * np.cos(px0 / 40), -90, 90)
    else:
        px = px0 + 120 * np.sin(py0 / 10) * np.cos(px0 / 15)
        py = np.clip(py0 + 60 * np.sin(px0 / 20), -90, 90)
    rows = np.r_[0:ORDER, NY - ORDER:NY]
    rx, ry = px[rows], py[rows]
    if kind == "wild":
        rx[0, 3:9] = np.nan
        ry[4, 100:110] = np.nan
        rx[1, 50:60] = 2.0 ** 27
        ry[2, 7:30] = 400.0
        ry[5, 7:30] = -400.0
        rx[3, 200:260] = -181.0
    rx, ry = torch.tensor(rx, dtype=dtype), torch.tensor(ry, dtype=dtype)
    geom = dict(order=ORDER, nx=NX)
    perm, inv = P.pole_sort_state(rx, ry, ny=NY, **geom, **BOUNDS)
    pxf, pyf = (P.pole_apply_perm(a, perm, **geom) for a in (rx, ry))
    mask = torch.ones_like(pxf)
    if kind == "wild":
        # the pad points past the real ones, wherever the sort put them,
        # are flung away and masked off: they must not flag
        ms, _ = P.pole_flat_dims(ORDER, NX)
        pad = perm >= ms
        pyf = torch.where(pad, pyf.flip(1), pyf)
        mask = (~pad).to(dtype)
    raw = torch.tensor(rng.randn(6, NY, NX), dtype=dtype)
    return raw, pxf, pyf, mask


def _window_eval(raw, pack, ys, wy, f0, nf):
    """Every slot against the y window [ys, ys + wy): values (nf, S, 1024)
    and the slots with a masked point whose rows leave it (clamped)."""
    _, ny, nx = raw.shape
    yc, xc, vm, mk = pack.reshape(-1, SLOT, 4).unbind(-1)
    y0w = ys.long()[:, None]
    yi = _to_index(torch.floor(yc)).clamp(0, ny - 2)
    oy = yi - y0w
    bad = ((oy < 0) | (oy > wy - 2)) & (mk > 0)
    oy = oy.clamp(0, wy - 2)
    r0 = torch.remainder(y0w + oy, ny) * nx
    r1 = torch.remainder(y0w + oy + 1, ny) * nx
    xi = _to_index(torch.floor(xc)).clamp(0, nx - 2)
    ty, tx = yc - yi.to(yc.dtype), xc - xi.to(xc.dtype)
    flat = raw[f0:f0 + nf].reshape(nf, -1)

    def at(lin):
        return flat[:, lin.reshape(-1)].reshape((nf,) + lin.shape)

    val = (at(r0 + xi) * ((1 - ty) * (1 - tx))[None]
           + at(r0 + xi + 1) * ((1 - ty) * tx)[None]
           + at(r1 + xi) * (ty * (1 - tx))[None]
           + at(r1 + xi + 1) * (ty * tx)[None])
    return torch.where(vm[None] > 0, val, torch.zeros((), dtype=val.dtype)), \
        bad.any(dim=1)


def _three_launch_ladder(raw, pack, f0, nf, ladder):
    """Values (nf, S*1024) and overflow word of the ladder as three
    launches."""
    ny = raw.shape[1]
    pr = P.pole_levels(P.pole_keys(pack, ny), ny=ny, ladder=ladder)
    vals, flags1 = _window_eval(raw, pack, pr.ys[0], pr.wy[0], f0, nf)
    overflow = 0
    for lvl in (1, 2):
        v, flags = _window_eval(raw, pack, pr.ys[lvl], pr.wy[lvl], f0, nf)
        want = pr.want[lvl]
        vals = torch.where(want[None, :, None], v, vals)
        overflow |= int((flags & want).any()) << 4
    covered = pr.fit1 | pr.want[1] | pr.want[2]
    overflow |= int((flags1 & ~covered).any()) << 3
    return vals.reshape(nf, -1), overflow, pr


def _ladder(raw, pack, f0, nf, ladder, fn=pole_ladder_gather_plain):
    n_s = pack.shape[0] // SLOT
    out = torch.full((nf, n_s * 8, 128), 7.0, dtype=raw.dtype)
    overflow = torch.zeros((1,), dtype=torch.int32)
    levels = torch.full((n_s,), -1, dtype=torch.int32)
    fn(raw, pack, out, overflow, f0=f0, nf=nf, ladder=ladder, bit=4,
       levels=levels)
    return out.reshape(nf, -1), int(overflow), levels


CASES = {
    # name: (positions, ladder, levels reached, overflow word)
    "fits level 1": ("smooth", P.POLE_LADDER, {0}, 0),
    "wants level 2": ("shear", (8, 16, 288), {0, 1, 2}, 0),
    "clamps at level 3": ("shear", (8, 8, 8), {0, 2}, 1 << 4),
    "NaN, out of range, pad points": ("wild", (8, 16, 288), {0, 1, 2}, 0),
}


@pytest.mark.parametrize("nf,f0", [(2, 2), (4, 0)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_ladder_equals_three_launch_ladder(case, dtype, nf, f0):
    kind, ladder, reached, word = CASES[case]
    raw, pxf, pyf, mask = _lists(kind, dtype)
    pack = P.pole_pack(pxf, pyf, mask, ny=NY, nx=NX, **BOUNDS)
    assert pack.shape == (6 * SLOT, 4) and pack.is_contiguous()
    want, want_word, pr = _three_launch_ladder(raw, pack, f0, nf, ladder)
    got, got_word, levels = _ladder(raw, pack, f0, nf, ladder)
    assert set(levels.tolist()) == reached
    assert torch.equal(levels.long(), pr.level)
    assert got_word == want_word == word
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    if kind == "wild":
        vm = pack[:, 2]
        assert 0 < int((vm == 0).sum()) < vm.numel()
        assert bool((got[:, vm == 0] == 0).all())      # outside the field: 0


def test_masked_pad_points_never_flag():
    """The flung pad tail clamps at an 8-row last level; with its mask off
    only the real points can raise bit 4, and they fit here."""
    raw, pxf, pyf, mask = _lists("wild", torch.float64)
    ms, _ = P.pole_flat_dims(ORDER, NX)
    ladder = (8, 160, 288)
    pack = P.pole_pack(pxf, pyf, mask, ny=NY, nx=NX, **BOUNDS)
    _, word, _ = _ladder(raw, pack, 0, 2, ladder)
    assert word == 0
    # an 8-row ladder clamps real and pad points alike; with every point
    # masked off nothing flags
    _, word_on, _ = _ladder(raw, pack, 0, 2, (8, 8, 8))
    off = pack.clone()
    off[:, 3] = 0.0
    _, word_off, _ = _ladder(raw, off, 0, 2, (8, 8, 8))
    assert (word_on, word_off) == (1 << 4, 0)


def test_pole_keys_are_the_sort_keys():
    """The slot keys the ladder takes from the packed operand are the keys
    the once-per-step sort used."""
    _, pxf, pyf, mask = _lists("wild", torch.float64)
    pack = P.pole_pack(pxf, pyf, mask, ny=NY, nx=NX, **BOUNDS)
    _, yi = scale_positions(pxf, pyf, nx=NX, ny=NY, **BOUNDS)
    assert torch.equal(P.pole_keys(pack, NY),
                       P._sort_key(yi, NY).reshape(-1, SLOT))
    assert P.ladder_windows(NY, (16, 160, 288)) == (80 + 48, (16, 128, 128))
    assert P.ladder_windows(NY, (3, 20, 4000))[1] == (8, 16, 128)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_pole_block_equals_direct_gather(dtype):
    """``windowed_interp_multi(pole_block=True)`` through the ladder gives
    the direct gather's pole-home rows bit for bit, NaN and out-of-range
    positions included."""
    raw, *_ = _lists("wild", dtype)
    rng = np.random.RandomState(4)
    rx = torch.tensor(rng.uniform(-200, 200, (2 * ORDER, NX)), dtype=dtype)
    ry = torch.tensor(rng.uniform(-95, 95, (2 * ORDER, NX)), dtype=dtype)
    rx[0, :4] = float("nan")
    ry[5, 9] = float("nan")
    got, flag = windowed_interp_multi(raw, raw, rx, ry, order=ORDER, f0=2,
                                      nf=4, pole_block=True,
                                      pole_ladder=(8, 16, 288), **BOUNDS)
    want = torch.cat([
        interp_at_parcels_multi(raw[2:6], raw[2:6], rx[:ORDER], ry[:ORDER],
                                order=ORDER, row_offset=0, **BOUNDS),
        interp_at_parcels_multi(raw[2:6], raw[2:6], rx[ORDER:], ry[ORDER:],
                                order=ORDER, row_offset=NY - ORDER,
                                **BOUNDS)], dim=1)
    assert int(flag) == 0
    assert torch.equal(got, want)


def test_wrapper_on_cpu_takes_the_plain_version_and_counts_no_launch():
    raw, pxf, pyf, mask = _lists("shear", torch.float64)
    pack = P.pole_pack(pxf, pyf, mask, ny=NY, nx=NX, **BOUNDS)
    before = dict(cuda_window.LAUNCHES)
    got = _ladder(raw, pack, 0, 4, (8, 16, 288),
                  fn=cuda_window.pole_ladder_gather)
    want = _ladder(raw, pack, 0, 4, (8, 16, 288))
    assert cuda_window.LAUNCHES == before
    assert torch.equal(got[0], want[0]) and got[1] == want[1]
    assert torch.equal(got[2], want[2])


def test_nothing_launches_on_cpu_tensors():
    """The launch path refuses CPU tensors (only the wrappers' own CPU
    branch takes the plain version), and a refused launch is not counted."""
    raw, pxf, pyf, mask = _lists("smooth", torch.float32)
    pack = P.pole_pack(pxf, pyf, mask, ny=NY, nx=NX, **BOUNDS)
    out = torch.zeros((2, 6 * 8, 128))
    overflow = torch.zeros((1,), dtype=torch.int32)
    before = dict(cuda_window.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_window.empty_launch(raw, pack, out, overflow, f0=0, nf=2,
                                 ladder=P.POLE_LADDER, bit=4)
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_window._check("tier_window_gather", (raw, raw, out),
                           (overflow,))
    assert cuda_window.LAUNCHES == before


def test_kernel_cuda_on_the_cpu_raises():
    lats = np.linspace(-90.0, 90.0, NY)
    lons = np.linspace(-180.0, 180.0 - 360.0 / 144, 144)
    u = np.ones((2, NY, 144))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ftle_pipeline(u, u, -3600.0, Grid(lats=lats, lons=lons,
                                          cyclic_x=True),
                      engine="blockspec", kernel="cuda", device="cpu")
