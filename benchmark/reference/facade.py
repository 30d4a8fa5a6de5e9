"""Plain reference of ``LCS(...)(u, v, isglobal=True, truncation=T)``.

LagrangianCoherence LCS/LCS.py:101-158 on host records: sort to ascending
latitude and longitude; regrid to the common 0.5-degree grid
(LCS/LCS.py:107-114: xarray's linear ``interp``, nearest neighbour where a
target lies outside the source); the triangular truncation of
``windspharm``'s ``VectorWind.truncate`` (LCS/LCS.py:115-118), stated as
the least-squares fit of the spherical harmonics of total wavenumber <= T
under the interpolatory quadrature weights of the latitudes, zonal
wavenumber by zonal wavenumber; then ``ftle.ftle`` on the common grid with
the longitude cyclic.  It imports nothing of the measured program.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import scipy.special
import torch

from . import ftle as F

COMMON_LATS = np.linspace(-89.75, 89.75, 180 * 2)
COMMON_LONS = np.linspace(-180, 179.5, 360 * 2 + 1)


def _axis(src: np.ndarray, dst: np.ndarray):
    """Bracketing indices and weights of ``dst`` in ascending ``src``, the
    nearest index, and whether ``dst`` lies inside ``src``'s span."""
    n = src.size
    hi = np.clip(np.searchsorted(src, dst, side="left"), 1, n - 1)
    lo = hi - 1
    w = np.clip((dst - src[lo]) / (src[hi] - src[lo]), 0.0, 1.0)
    near = np.where(np.abs(src[hi] - dst) < np.abs(dst - src[lo]), hi, lo)
    inside = (dst >= src[0]) & (dst <= src[-1])
    return lo, hi, w, near, inside


def regrid(f: torch.Tensor, lats, lons, dst_lats=COMMON_LATS,
           dst_lons=COMMON_LONS) -> torch.Tensor:
    """(..., ny, nx) on ascending ``lats``/``lons`` → the destination grid:
    bilinear inside the source's span, nearest neighbour outside."""
    dev = f.device
    ylo, yhi, wy, yn, yin = _axis(np.asarray(lats), dst_lats)
    xlo, xhi, wx, xn, xin = _axis(np.asarray(lons), dst_lons)

    def take(yi, xi):
        t = torch.as_tensor
        return f[..., t(yi, device=dev), :][..., t(xi, device=dev)]

    wy = torch.tensor(wy, dtype=f.dtype, device=dev)[:, None]
    wx = torch.tensor(wx, dtype=f.dtype, device=dev)[None, :]
    lin = (take(ylo, xlo) * (1 - wy) * (1 - wx) + take(ylo, xhi) * (1 - wy) * wx
           + take(yhi, xlo) * wy * (1 - wx) + take(yhi, xhi) * wy * wx)
    inside = torch.as_tensor(yin[:, None] & xin[None, :], device=dev)
    return torch.where(inside, lin, take(yn, xn))


def _legendre(m: int, nmax: int, x: np.ndarray) -> np.ndarray:
    """(len(x), nmax - m + 1) orthonormal associated Legendre functions of
    order ``m`` and degrees ``m..nmax``."""
    cols = []
    for n in range(m, nmax + 1):
        norm = np.sqrt((2 * n + 1) / (4 * np.pi) * np.exp(
            scipy.special.gammaln(n - m + 1) - scipy.special.gammaln(n + m + 1)))
        cols.append(norm * scipy.special.lpmv(m, n, x))
    return np.stack(cols, axis=1)


@lru_cache(maxsize=4)
def _projectors(lats_key: bytes, truncation: int) -> np.ndarray:
    """(T + 1, ny, ny): for each zonal wavenumber m, the weighted
    least-squares projection onto degrees m..T."""
    lats = np.frombuffer(lats_key, dtype=np.float64)
    x = np.sin(np.deg2rad(lats))
    ny = x.size
    # interpolatory weights: exact for every polynomial of degree < ny
    vander = np.polynomial.legendre.legvander(x, ny - 1)
    moments = np.zeros(ny)
    moments[0] = 2.0
    w = np.linalg.solve(vander.T, moments)
    out = np.empty((truncation + 1, ny, ny))
    for m in range(truncation + 1):
        p = _legendre(m, truncation, x)
        ptw = p.T * w[None, :]
        out[m] = p @ np.linalg.solve(ptw @ p, ptw)
    return out


def truncate(f: torch.Tensor, lats, truncation: int,
             tf32: bool = False) -> torch.Tensor:
    """Triangular truncation of (..., ny, nx) to total wavenumber <=
    ``truncation``."""
    nx = f.shape[-1]
    lats = np.ascontiguousarray(np.asarray(lats, dtype=np.float64))
    spec = torch.fft.rfft(f, dim=-1)
    # (..., m, ny, 1): each zonal wavenumber's latitude profile
    keep = spec[..., :truncation + 1].transpose(-1, -2).unsqueeze(-1)
    ops = torch.tensor(_projectors(lats.tobytes(), truncation),
                       device=f.device).to(spec.dtype)
    smoothed = F.matmul(ops, keep, tf32).squeeze(-1).transpose(-1, -2)
    out = torch.zeros_like(spec)
    out[..., :truncation + 1] = smoothed
    return torch.fft.irfft(out, n=nx, dim=-1)


def resample_labels(times: np.ndarray, freq: str) -> np.ndarray:
    """The labels of pandas' ``resample(freq)`` for a fixed step of hours
    (``"12h"``): bins from the start of the first record's day, from the
    bin holding the first time to the bin holding the last."""
    if not freq.endswith("h") or not freq[:-1].isdigit():
        raise ValueError(f"the reference resamples to whole hours only, "
                         f"not {freq!r}")
    step = np.timedelta64(int(freq[:-1]), "h").astype("m8[s]")
    t = np.asarray(times).astype("M8[s]")
    day = t.min().astype("M8[D]").astype("M8[s]")
    first = day + (t.min() - day) // step * step
    last = day + (t.max() - day) // step * step
    return np.arange(first, last + step, step)


def resample_linear(a: np.ndarray, times, freq: str):
    """(T, ...) host winds on ``times`` → linear in time at
    ``resample_labels``, NaN outside the record (xarray's
    ``resample().interpolate("linear")``), and the new labels."""
    new = resample_labels(times, freq)
    src = np.asarray(times).astype("M8[s]").astype(np.int64).astype(float)
    dst = new.astype(np.int64).astype(float)
    out = np.empty((dst.size,) + a.shape[1:])
    for k, t in enumerate(dst):
        j = int(np.clip(np.searchsorted(src, t), 1, src.size - 1))
        w = (t - src[j - 1]) / (src[j] - src[j - 1])
        out[k] = (np.nan if t < src[0] or t > src[-1]
                  else a[j - 1] * (1.0 - w) + a[j] * w)
    return out, new


def lcs_ftle(u: np.ndarray, v: np.ndarray, lats, lons, timestep: float, *,
             settls_order: int, truncation: int | None, device,
             dtype=torch.float64, tf32: bool = False, times=None,
             resample: str | None = None) -> np.ndarray:
    """(T, ny, nx) host winds on ``lats``/``lons`` (either order) → the
    (360, 721) FTLE field of the common grid, as a float64 host array.
    ``resample``: a step of hours the winds are first resampled to, linear
    in time from their labels ``times``; the time step becomes that step,
    with ``timestep``'s sign.  ``truncation`` None: no truncation."""
    lats, lons = np.asarray(lats), np.asarray(lons)
    if resample:
        u, new = resample_linear(u, times, resample)
        v, _ = resample_linear(v, times, resample)
        timestep = float(np.sign(timestep)) * float(
            (new[1] - new[0]) / np.timedelta64(1, "s"))
    iy, ix = np.argsort(lats, kind="stable"), np.argsort(lons, kind="stable")
    out = []
    for a in (u, v):
        t = torch.as_tensor(np.ascontiguousarray(a[:, iy][:, :, ix]),
                            device=device).to(dtype)
        t = regrid(t, lats[iy], lons[ix])
        out.append(t if truncation is None
                   else truncate(t, COMMON_LATS, truncation, tf32))
    field = F.ftle(out[0], out[1], COMMON_LATS, COMMON_LONS, timestep,
                   settls_order=settls_order, order=3, cyclic_x=True,
                   tf32=tf32)
    return field.to(torch.float64).cpu().numpy()
