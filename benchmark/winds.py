"""Seeded winds: a midlatitude jet, planetary waves and a smooth perturbation.

A seeded copy of the port's ``bench_winds`` (the jet and waves of the JAX
package's ``bench.py:54-67``).  Every field is a sum of terms separable in
time, latitude and longitude, so a stack of ``nt`` levels is one product
``(nt, K) @ (K, ny * nx)``: on the card it is made there, on the host by
numpy, with no per-level loop.  The traffic file's ``winds`` block sets the
ranges; the seed (and the slot of a ring of stacks) draws:

* the jet's speed, ``jet_ms``, and its phase in a 5% oscillation over the
  record (as ``bench_winds``' ``1 + 0.05 sin(2 pi t / nt)``);
* ``waves`` planetary waves: zonal wavenumber in ``wavenumbers``, speed in
  ``wave_ms``, phase, and a drift of the phase of up to ``drift`` radians a
  level;
* ``modes`` perturbation modes in each component: zonal wavenumber up to
  ``mode_zonal``, meridional up to ``mode_meridional``, speed in
  ``mode_ms``, phase and drift.

The work a field costs does not depend on the seed: the speeds and the
waves' wavenumbers are a fixed set that the seed only orders (``draw``),
since faster winds move the fused step's gathers farther in memory.  A
``winds`` block with ``"free": true`` draws them uniformly over the same
ranges instead, so the seed changes the work too: for checks of
correctness on winds the fixed set does not hold, not for timed cells.
"""
from __future__ import annotations

import numpy as np

__all__ = ["draw", "terms", "stack_numpy", "stack_torch"]


def _rng(seed: int, slot: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), int(slot)])


def _strata(rng, lo, hi, n: int, free: bool = False) -> np.ndarray:
    """The midpoints of ``n`` equal strata of [lo, hi], in a seeded
    order: every seed draws the same set of values.  ``free``: ``n``
    uniform draws from [lo, hi] instead."""
    if free:
        return rng.uniform(lo, hi, n)
    return lo + (hi - lo) * (rng.permutation(n) + 0.5) / n


def draw(spec: dict, seed: int, slot: int = 0, slots: int = 1) -> dict:
    """The parameters of stack ``slot`` of a ring of ``slots`` (host
    scalars) from ``seed``.  Every speed and wavenumber comes from a fixed
    set in a seeded order: the jets of the ring's slots are the midpoints
    of ``slots`` strata of ``jet_ms``, a slot's waves and modes those of
    ``waves`` and ``modes`` strata of their ranges; phases, drifts and the
    modes' wavenumbers are drawn freely.  So every seed asks the same
    displacements of the gathers, in another arrangement."""
    free = bool(spec.get("free", False))
    jets = _strata(_rng(seed, 1 << 30), *spec["jet_ms"], slots, free)
    rng = _rng(seed, slot)
    n = spec["waves"]
    ms = np.clip(np.rint(_strata(rng, spec["wavenumbers"][0] - 0.5,
                                 spec["wavenumbers"][1] + 0.5, n, free)),
                 *spec["wavenumbers"]).astype(int)
    waves = [dict(m=int(m), amp=float(a),
                  phase=float(rng.uniform(0.0, 2 * np.pi)),
                  drift=float(rng.uniform(-spec["drift"], spec["drift"])))
             for m, a in zip(ms, _strata(rng, *spec["wave_ms"], n, free))]
    modes = {c: [dict(p=int(rng.integers(1, spec["mode_zonal"] + 1)),
                      q=int(rng.integers(1, spec["mode_meridional"] + 1)),
                      amp=float(a),
                      phase=float(rng.uniform(0.0, 2 * np.pi)),
                      drift=float(rng.uniform(-spec["drift"], spec["drift"])))
                 for a in _strata(rng, *spec["mode_ms"], spec["modes"],
                                  free)]
             for c in ("u", "v")}
    return dict(jet=float(jets[slot]),
                jet_phase=float(rng.uniform(0.0, 2 * np.pi)),
                waves=waves, modes=modes)


def terms(params: dict, lats: np.ndarray, lons: np.ndarray, nt: int):
    """``(T_u, B_u), (T_v, B_v)``: float64 time factors (nt, K) and the
    separable spatial factors as pairs (lat (ny,), lon (nx,)), K each, so
    that a component is ``sum_k T[:, k] * lat_k[:, None] * lon_k[None]``."""
    lat = np.deg2rad(np.asarray(lats, dtype=np.float64))
    lon = np.deg2rad(np.asarray(lons, dtype=np.float64))
    t = np.arange(nt, dtype=np.float64)
    one = np.ones_like(lon)
    tu, bu, tv, bv = [], [], [], []
    tu.append(params["jet"] * (1.0 + 0.05 * np.sin(2 * np.pi * t / nt
                                                   + params["jet_phase"])))
    bu.append((np.cos(lat), one))
    for w in params["waves"]:
        a = w["phase"] + w["drift"] * t
        c, s = np.cos(a), np.sin(a)
        cm, sm = np.cos(w["m"] * lon), np.sin(w["m"] * lon)
        # u: amp cos(m lon + a) sin(2 lat); v: amp sin(m lon + a) cos(2 lat)
        tu += [w["amp"] * c, -w["amp"] * s]
        bu += [(np.sin(2 * lat), cm), (np.sin(2 * lat), sm)]
        tv += [w["amp"] * c, w["amp"] * s]
        bv += [(np.cos(2 * lat), sm), (np.cos(2 * lat), cm)]
    for comp, tt, bb in (("u", tu, bu), ("v", tv, bv)):
        for md in params["modes"][comp]:
            # amp cos(lat) cos(q lat) cos(p lon + a): zero at the poles
            a = md["phase"] + md["drift"] * t
            shape = np.cos(lat) * np.cos(md["q"] * lat)
            tt += [md["amp"] * np.cos(a), -md["amp"] * np.sin(a)]
            bb += [(shape, np.cos(md["p"] * lon)),
                   (shape, np.sin(md["p"] * lon))]
    return ((np.stack(tu, axis=1), bu), (np.stack(tv, axis=1), bv))


def stack_numpy(params: dict, lats, lons, nt: int, dtype) -> tuple:
    """(nt, ny, nx) u and v as host arrays of ``dtype``: the product in
    float64, cast once."""
    out = []
    for tt, bb in terms(params, lats, lons, nt):
        basis = np.stack([np.multiply.outer(a, b) for a, b in bb])
        ny, nx = basis.shape[1:]
        f = tt @ basis.reshape(len(bb), ny * nx)
        out.append(f.reshape(nt, ny, nx).astype(dtype, copy=False))
    return tuple(out)


def stack_torch(params: dict, lats, lons, nt: int, dtype, device) -> tuple:
    """(nt, ny, nx) u and v as tensors of ``dtype`` made on ``device``: the
    product in float64 there, cast once."""
    import torch
    out = []
    kw = dict(dtype=torch.float64, device=device)
    for tt, bb in terms(params, lats, lons, nt):
        la = torch.tensor(np.stack([a for a, _ in bb]), **kw)
        lo = torch.tensor(np.stack([b for _, b in bb]), **kw)
        basis = (la[:, :, None] * lo[:, None, :]).reshape(len(bb), -1)
        f = torch.tensor(tt, **kw) @ basis
        out.append(f.reshape(nt, la.shape[1], lo.shape[1]).to(dtype))
        del basis, f
    return tuple(out)
