"""The spline window tiers as one routed gather
(``window_interp.tier_window_gather_plain``, the plain version of the CUDA
kernels ``tier_route_kernel`` and ``tier_gather_kernel``) against the routed
launches it replaces — ``tiles.route_tiles``, whose choices
tests/test_torch_window.py pins to JAX's ``debug_flags``, then tier A,
tier A-sub and one list launch a ladder tier through their plain versions —
on the CPU in float64.

Bounds: none.  Both evaluate the same taps of the same windows in the same
order, so values, per-tile tiers, flags and the overflow word are equal, the
clamped tiles' values included.  The ordered three-pass plan
(``plan_tiers``) is held against ``tiles._assign_plan`` and against a
sequential restatement on random fit matrices whose capacities bind.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from lagrangiancoherence_tpu_torch.ops import cuda_window
from lagrangiancoherence_tpu_torch.ops import window_interp as WI
from lagrangiancoherence_tpu_torch.ops.interp import prefilter
from lagrangiancoherence_tpu_torch.ops.tiles import (DEFAULT_LADDER,
                                                     SORT_LADDER,
                                                     _assign_plan,
                                                     capped_ladder,
                                                     route_tiles)

torch.set_num_threads(1)

NY, NX = 73, 144
# capacities of 1 to 3: every tier the shear case reaches fills, tiles spill
# to later tiers and some are left to tier A
CAPPED_LADDER = tuple((wy, wx, 1 + i % 3)
                      for i, (wy, wx, _) in enumerate(DEFAULT_LADDER))
LADDERS = {"default": dict(retry_tiles=256, ladder=None),
           "sort": dict(retry_tiles=256, ladder=SORT_LADDER),
           "retry0": dict(retry_tiles=0, ladder=None),
           "capped": dict(retry_tiles=20, ladder=CAPPED_LADDER)}


def _case(disp, F, seed=0):
    """tests/test_pallas_interp.py:16-48: seeded fields and displaced
    positions on a global grid."""
    rng = np.random.RandomState(seed)
    lats = np.linspace(-90, 90, NY)
    lons = np.linspace(-180, 180 - 360 / NX, NX)
    fields = rng.randn(F, NY, NX)
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
    return torch.tensor(fields), torch.tensor(px), torch.tensor(py), bounds


def _routed_launches(coeffs, px, py, bounds, *, nf, order, wy, retry_tiles,
                     ladder):
    """The group through ``route_tiles`` and the per-tier plain launches:
    the output, each tile's tier and flag word in the routed gather's form,
    the overflow word and the routing."""
    rt = route_tiles(px, py, ny=NY, nx=NX, order=order, wy=wy,
                     retry_tiles=retry_tiles, ladder=ladder, **bounds)
    n = rt.gy * rt.gx
    out = torch.zeros((nf, rt.gy * 8, rt.gx * 128), dtype=coeffs.dtype)
    overflow = rt.overflow.clone()
    fns = {"tile_window_gather": WI.tile_window_gather_plain,
           "sub_window_gather": WI.sub_window_gather_plain}
    tier = torch.full((n,), -1, dtype=torch.int32)
    flag = torch.zeros((n,), dtype=torch.int32)
    t = 0
    for ln in WI.spline_launches(rt, coeffs, f0=0, nf=nf, order=order, wy=wy):
        f = torch.full((ln.n_flags,), -1, dtype=torch.int32)
        ln.run(fns[ln.kernel], out, f, overflow)
        if ln.mode == "dense":
            flag += f
        elif ln.kernel == "sub_window_gather":
            tier[rt.liveS.reshape(-1) != 0] = -2
            flag += (f.reshape(n, 4) << torch.arange(4, dtype=torch.int32)) \
                .sum(dim=1).int()
        else:
            live = int(rt.tiers[t].count)
            sel = rt.tiers[t].sel[:live].long()
            tier[sel] = t
            flag[sel] += f[:live]
            t += 1
    return out, tier, flag, overflow, rt


def _routed_gather(fn, coeffs, px, py, bounds, *, nf, order, wy, retry_tiles,
                   ladder):
    ln, folds = WI.tier_launch(coeffs, px, py, f0=0, nf=nf, order=order,
                               wy=wy, retry_tiles=retry_tiles, ladder=ladder,
                               **bounds)
    n = ln.n_flags
    out = torch.zeros((nf,) + tuple(folds.shape[1:]), dtype=coeffs.dtype)
    plan = torch.full((n, WI.PLAN_W), -9, dtype=torch.int32)
    fits = torch.full((n,), -9, dtype=torch.int32)
    flags = torch.full((n,), -9, dtype=torch.int32)
    overflow = torch.zeros((1,), dtype=torch.int32)
    ln.run(fn, out, plan, fits, flags, overflow)
    return out, plan, fits, flags, overflow


@pytest.mark.parametrize("F,order", [(2, 3), (4, 1)])
@pytest.mark.parametrize("ladder", sorted(LADDERS))
@pytest.mark.parametrize("disp", ["smooth", "whirl", "shear"])
def test_plain_matches_routed_launches(disp, ladder, F, order):
    fields, px, py, bounds = _case(disp, F)
    coeffs = prefilter(fields, order=order)
    kw = dict(nf=F, order=order, wy=16 if ladder == "retry0" else 32,
              **LADDERS[ladder])
    want, tier, flag, word, rt = _routed_launches(coeffs, px, py, bounds, **kw)
    out, plan, fits, flags, overflow = _routed_gather(
        WI.tier_window_gather_plain, coeffs, px, py, bounds, **kw)
    assert torch.equal(out, want)
    assert torch.equal(plan[:, 0], tier)
    assert torch.equal(flags, flag)
    assert torch.equal(overflow, word)
    assert torch.equal((fits >> WI.FIT_A) & 1, rt.fitA.reshape(-1).int())
    assert torch.equal(plan[:, 0] >= 0, rt.covered.reshape(-1))
    assert torch.equal((plan[:, 0] == -1).int(), rt.liveA.reshape(-1))
    if ladder == "retry0":
        assert int(overflow) == 1 << 2 and int((flags > 0).sum()) > 0
    else:
        assert int(overflow) & (1 << 2) == 0 or ladder == "capped"


def test_capacities_bind_and_leave_tiles_to_tier_a():
    """Capacities of 1 on the violent shear: tiers fill, tiles they turn
    away go to later tiers, the rest stay in tier A, clamp and raise bits 1
    and 2."""
    ladder = tuple((wy, wx, 1) for wy, wx, _ in DEFAULT_LADDER)
    fields, px, py, bounds = _case("shear", 2)
    out, plan, fits, flags, overflow = _routed_gather(
        WI.tier_window_gather_plain, prefilter(fields), px, py, bounds, nf=2,
        order=3, wy=32, retry_tiles=20, ladder=ladder)
    tier = plan[:, 0]
    unfit = (fits >> WI.FIT_A) == 0
    caps = [c for _, _, c in ladder]
    counts = [int((tier == t).sum()) for t in range(len(caps))]
    holds = [int((unfit & ((fits >> t) & 1 > 0)).sum())
             for t in range(len(caps))]
    full = [t for t, c in enumerate(caps) if counts[t] == c < holds[t]]
    assert len(full) >= 3, (counts, caps, holds)
    assert all(n <= c for n, c in zip(counts, caps))
    left = unfit & (tier == -1)
    assert int(left.sum()) > 0
    assert int(overflow) & 0b110 == 0b110
    assert bool((flags[left] > 0).any())
    # a taken tile's window is its tier's, cut to the padded field
    for t, (wy, wx, _) in enumerate(capped_ladder(NY, NX, ladder)):
        rows = plan[tier == t]
        assert bool((rows[:, 6] == wy).all())
        assert bool((rows[:, 7] == (wx or 0)).all())


def _sequential_plan(fits, caps):
    """The three-pass first fit one tile after the other: in each pass a
    tile not yet taken tries the first fitting tier it has not tried, and
    is taken if that tier has capacity left."""
    T, n = fits.shape
    tier = [-1] * n
    tried = [set() for _ in range(n)]
    cnt = [0] * T
    for _ in range(min(3, T)):
        start = list(cnt)
        tries = [0] * T
        for i in range(n):
            if tier[i] >= 0:
                continue
            t = next((t for t in range(T)
                      if fits[t, i] and t not in tried[i]), None)
            if t is None:
                continue
            tried[i].add(t)
            if start[t] + tries[t] < caps[t]:
                tier[i] = t
                cnt[t] += 1
            tries[t] += 1
    return tier


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 9), st.integers(1, 6), st.integers(0, 2 ** 31 - 1),
       st.floats(0.05, 0.9))
def test_plan_equals_assign_plan(T, gy, seed, density):
    """Random fit matrices with capacities of 0 to 4 over up to 24 tiles."""
    rng = np.random.RandomState(seed)
    gx = 4
    n = gy * gx
    fits = rng.rand(T, n) < density
    base = rng.rand(n) < 0.2
    caps = rng.randint(0, 5, size=T).tolist()
    elig = torch.tensor(fits & ~base[None])
    got = WI.plan_tiers(elig, caps).tolist()
    assert got == _sequential_plan(fits & ~base[None], caps)
    lad = [(32, 256, c) for c in caps]
    zeros = torch.zeros((gy, gx), dtype=torch.int32)
    tiers, covered = _assign_plan(
        lad, [(torch.tensor(f).reshape(gy, gx), zeros, zeros) for f in fits],
        torch.tensor(base).reshape(gy, gx), n)
    want = [-1] * n
    for t, tr in enumerate(tiers):
        for i in tr.sel[:int(tr.count)].tolist():
            assert want[i] == -1
            want[i] = t
    assert got == want
    assert covered.reshape(-1).tolist() == [t >= 0 for t in got]


def test_wrapper_on_cpu_tensors_takes_the_plain_version():
    fields, px, py, bounds = _case("shear", 2)
    coeffs = prefilter(fields)
    kw = dict(nf=2, order=3, wy=32, **LADDERS["default"])
    before = dict(cuda_window.LAUNCHES)
    got = _routed_gather(cuda_window.tier_window_gather, coeffs, px, py,
                         bounds, **kw)
    assert cuda_window.LAUNCHES == before
    want = _routed_gather(WI.tier_window_gather_plain, coeffs, px, py, bounds,
                          **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_ladder_length_is_checked():
    fields, px, py, bounds = _case("smooth", 2)
    with pytest.raises(ValueError, match="ladder tiers"):
        _routed_gather(WI.tier_window_gather_plain, prefilter(fields), px, py,
                       bounds, nf=2, order=3, wy=32, retry_tiles=8,
                       ladder=((32, 256, 1),) * 17)
