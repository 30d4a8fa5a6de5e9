"""Plain reference of one area-of-influence case.

LagrangianCoherence LCS/area_of_influence.py:90-295 on a regional box,
stated plainly in PyTorch, numpy and scipy (it imports nothing of the
measured program):

* the regional facade FTLE (LCS/LCS.py:81-158 with ``isglobal=False``):
  the winds resampled linearly in time (``facade.resample_linear``), sorted
  to ascending coordinates, SETTLS with the longitude clamped to the box
  (``ftle.departure_points`` with ``cyclic_x=False``), then the deformation
  gradient and its Q1 norm in float64 (the stencil in float32, quirk Q6,
  cyclic in longitude as the reference's default ``isglobal`` leaves it);
* ``threshold_local(..., method='gaussian')``: ``gaussian_filter`` with
  sigma ``(block - 1) / 6``, mode ``reflect``, minus the offset;
* the Hessian ridges of LCS/tools.py:52-155 with ``isglobal=False``: the
  smoothed field's spherical gradient and Hessian (the stencil of
  LCS/tools.py:190-245 in float32, one-sided within two points of every
  edge), the eigenvalue of the larger magnitude and the eigenvector
  matrix's row at the smaller eigenvalue (quirk Q7), under the closed
  form's convention (eigenvalues ascending, the second eigenvector along
  ``(half_diff + disc, b)``);
* Zhang-Suen thinning (Zhang & Suen 1984, CACM 27:236-239): two
  sub-iterations a sweep, outside the image read as 0, until a sweep
  changes nothing;
* ``filter_ridges``: ``scipy.ndimage.label`` with 8-connectivity, each
  component's mean intensity and regionprops' ``major_axis_length`` (4
  times the root of the larger eigenvalue of the pixel coordinates'
  covariance, with the pixel-extent term 1/12 in both variances);
* ``interp_to``: bilinear in each axis on the ascending source, nearest
  outside its span; ``np.gradient`` for the pressure derivatives;
  ``distance_transform_edt`` and the rain sums of :277-285.
"""
from __future__ import annotations

import numpy as np
import scipy.ndimage as ndi
import torch

from . import facade as RF
from . import ftle as F

EIGHT = np.ones((3, 3), dtype=int)


# ---------------------------------------------------------------------------
# stage 2: the regional facade FTLE
# ---------------------------------------------------------------------------

def regional_ftle(u, v, lats, lons, timestep: float, *, settls_order: int,
                  times, resample: str | None, device, dtype=torch.float64,
                  tf32: bool = False):
    """(T, ny, nx) float64 host winds on ``lats``/``lons`` (either order),
    labelled ``times`` → the (ny, nx) FTLE norm on ascending coordinates
    (float64 host array) and its time label.  SETTLS runs in ``dtype``
    (``tf32``: every matmul's operands rounded to TF32), the deformation in
    float64."""
    lats, lons, times = (np.asarray(a) for a in (lats, lons, times))
    if resample:
        new = RF.resample_labels(times, resample)
        u, _ = RF.resample_linear(u, times, resample)
        v, _ = RF.resample_linear(v, times, resample)
        times = new
        timestep = float(np.sign(timestep)) * float(
            (new[1] - new[0]) / np.timedelta64(1, "s"))
    iy, ix = np.argsort(lats, kind="stable"), np.argsort(lons, kind="stable")
    lat_a, lon_a = lats[iy], lons[ix]

    def card(a):
        return torch.as_tensor(np.ascontiguousarray(a[:, iy][:, :, ix]),
                               device=device).to(dtype)

    px, py = F.departure_points(card(u), card(v), lat_a, lon_a, timestep,
                                settls_order=settls_order, order=3,
                                cyclic_x=False, tf32=tf32)
    norm = F.ftle_from_departures(px.to(torch.float64),
                                  py.to(torch.float64), lat_a, lon_a)
    stamp = times[0] if timestep < 0 else times[-1]
    return norm.cpu().numpy(), stamp


# ---------------------------------------------------------------------------
# stage 4: the local threshold
# ---------------------------------------------------------------------------

def threshold_local(image: np.ndarray, block: int, offset: float):
    return ndi.gaussian_filter(np.asarray(image, np.float64),
                               sigma=(block - 1) / 6.0, mode="reflect") \
        - offset


# ---------------------------------------------------------------------------
# stage 5: Hessian ridges, thinning, components
# ---------------------------------------------------------------------------

def _stencil_edges(f: np.ndarray, axis: int) -> np.ndarray:
    """The fourth-order centred difference along ``axis`` of a float32
    array, one-sided ``(f[+1] - f) / 2`` within two points of the start and
    ``(f - f[-1]) / 2`` within two of the end."""
    f = np.moveaxis(f, axis, 0)
    n = f.shape[0]
    out = np.empty_like(f)
    out[2:n - 2] = (np.float32(4 / 3) * (f[3:n - 1] - f[1:n - 3])
                    / np.float32(2)
                    - np.float32(1 / 3) * (f[4:] - f[:n - 4]) / np.float32(4))
    out[0:2] = (f[1:3] - f[0:2]) / np.float32(2)
    out[n - 2:] = (f[n - 2:] - f[n - 3:n - 1]) / np.float32(2)
    return np.moveaxis(out, 0, axis)


def _derivative(f: np.ndarray, lats, lons, axis: int) -> np.ndarray:
    """LCS/tools.py:248-267 on a box: the stencil in float32 (quirk Q6),
    the metric in float64."""
    d = _stencil_edges(f.astype(np.float32), axis).astype(np.float64)
    if axis == 0:
        return d / ((np.pi / 180.0) * (lats[1] - lats[0]) * F.EARTH_RADIUS)
    dx = (np.pi / 180.0) * (lons[1] - lons[0]) * F.EARTH_RADIUS \
        * np.cos(np.asarray(lats, np.float64) * np.pi / 180.0)
    return d / dx[:, None]


def hessian_ridges(field: np.ndarray, lats, lons, sigma: float,
                   tolerance: float) -> dict:
    """The ridge mask of a (ny, nx) field on ascending coordinates, with
    what its tests read: ``eigmin`` (the eigenvalue of the larger
    magnitude), ``lam0``/``lam1`` (ascending), ``dt_prod`` and the Q7
    ``eigvectors`` (2, ny, nx), zeroed where ``eigmin`` >= 0."""
    f = ndi.gaussian_filter(np.asarray(field, np.float64), sigma,
                            mode="reflect")
    gx, gy = _derivative(f, lats, lons, 1), _derivative(f, lats, lons, 0)
    a, b, c = (np.where(np.isfinite(x), x, 0.0)
               for x in (_derivative(gx, lats, lons, 1),
                         _derivative(gx, lats, lons, 0),
                         _derivative(gy, lats, lons, 0)))
    half_tr, half_diff = 0.5 * (a + c), 0.5 * (a - c)
    disc = np.sqrt(half_diff * half_diff + b * b)
    lam0, lam1 = half_tr - disc, half_tr + disc
    vx, vy = half_diff + disc, b
    norm = np.sqrt(vx * vx + vy * vy)
    safe = norm > 0
    v1x = np.where(safe, vx / np.where(safe, norm, 1.0), 1.0)
    v1y = np.where(safe, vy / np.where(safe, norm, 1.0), 0.0)
    # the eigenvector matrix's row 0: (v0[0], v1[0]) with v0 = (-v1y, v1x)
    ev = np.stack([-v1y, v1x])
    eigmin = np.where(np.abs(lam0) >= np.abs(lam1), lam0, lam1)
    dt_prod = ev[0] * gx + ev[1] * gy
    ridges = (np.abs(dt_prod) <= tolerance) & (eigmin < 0)
    return {"ridges": ridges.astype(np.float64), "eigmin": eigmin,
            "lam0": lam0, "lam1": lam1, "dt_prod": dt_prod,
            "eigvectors": np.where(eigmin < 0, ev, 0.0)}


def zhang_suen(mask: np.ndarray, max_sweeps: int = 256) -> np.ndarray:
    """Zhang-Suen thinning of a 2-D mask (nonzero = set), as a bool
    array."""
    m = np.asarray(mask) > 0
    for _ in range(max_sweeps):
        before = m
        for phase in (0, 1):
            p = np.pad(m, 1).astype(np.int32)
            n, ne, e, se = p[:-2, 1:-1], p[:-2, 2:], p[1:-1, 2:], p[2:, 2:]
            s, sw, w, nw = p[2:, 1:-1], p[2:, :-2], p[1:-1, :-2], p[:-2, :-2]
            ring = [n, ne, e, se, s, sw, w, nw, n]
            trans = sum((ring[i] == 0) & (ring[i + 1] == 1) for i in range(8))
            count = n + ne + e + se + s + sw + w + nw
            if phase == 0:
                side = (n * e * s == 0) & (e * s * w == 0)
            else:
                side = (n * e * w == 0) & (n * s * w == 0)
            m = m & ~((count >= 2) & (count <= 6) & (trans == 1) & side)
        if np.array_equal(m, before):
            break
    return m


def components(mask: np.ndarray, intensity: np.ndarray) -> dict:
    """The 8-connected components of ``mask`` (nonzero, NaN read as 0):
    ``labels``, and per component (label - 1) its ``mean_intensity`` (NaN
    intensity read as 0) and ``major_axis_length``."""
    labels, n = ndi.label(np.nan_to_num(np.asarray(mask, np.float64)) > 0,
                          structure=EIGHT)
    inten = np.nan_to_num(np.asarray(intensity, np.float64))
    idx = np.arange(1, n + 1)
    mean = np.asarray(ndi.mean(inten, labels, idx)) if n else np.zeros(0)
    major = np.zeros(n)
    for k, sl in enumerate(ndi.find_objects(labels)):
        ys, xs = np.nonzero(labels[sl] == k + 1)
        cov = np.cov(np.stack([xs, ys]).astype(np.float64), bias=True) \
            + np.eye(2) / 12.0
        major[k] = 4.0 * np.sqrt(max(np.linalg.eigvalsh(cov)[-1], 0.0))
    return {"labels": labels, "n": n, "mean_intensity": mean,
            "major_axis_length": major}


def kept(comp: dict, thresholds: dict) -> np.ndarray:
    """Whether each component meets every ``{criterion: threshold}``."""
    keep = np.ones(comp["n"], dtype=bool)
    for crit, thr in thresholds.items():
        keep &= comp[crit] >= thr
    return keep


# ---------------------------------------------------------------------------
# stages 6-7: the pressure-gradient classification and the rain
# ---------------------------------------------------------------------------

def _axis(src: np.ndarray, dst: np.ndarray):
    order = np.argsort(src, kind="stable")
    s = src[order]
    hi = np.clip(np.searchsorted(s, dst, side="left"), 1, s.size - 1)
    lo = hi - 1
    w = np.clip((dst - s[lo]) / (s[hi] - s[lo]), 0.0, 1.0)
    near = np.where(np.abs(s[hi] - dst) < np.abs(dst - s[lo]), hi, lo)
    inside = (dst >= s[0]) & (dst <= s[-1])
    return order[lo], order[hi], w, order[near], inside


def interp_to(f: np.ndarray, lats, lons, dst_lats, dst_lons) -> np.ndarray:
    """(ny, nx) ``f`` on ``lats``/``lons`` (either order) → bilinear at
    the destination, nearest outside the source's span, in float64."""
    f = np.asarray(f, np.float64)
    ylo, yhi, wy, yn, yin = _axis(np.asarray(lats, np.float64),
                                  np.asarray(dst_lats, np.float64))
    xlo, xhi, wx, xn, xin = _axis(np.asarray(lons, np.float64),
                                  np.asarray(dst_lons, np.float64))
    wy, wx = wy[:, None], wx[None, :]
    lin = (f[np.ix_(ylo, xlo)] * (1 - wy) * (1 - wx)
           + f[np.ix_(ylo, xhi)] * (1 - wy) * wx
           + f[np.ix_(yhi, xlo)] * wy * (1 - wx)
           + f[np.ix_(yhi, xhi)] * wy * wx)
    return np.where(yin[:, None] & xin[None, :], lin, f[np.ix_(yn, xn)])


def pressure_along_ridges(mslp: np.ndarray, eigvectors: np.ndarray, lats,
                          lons) -> np.ndarray:
    """:215-229: the pressure gradient weighted by the ridges' eigenvector
    components, ``sqrt((dp/dlon v)^2 + (dp/dlat u)^2)`` with (v, u) the
    eigenvector's two components; ``mslp`` on the ridges' ascending
    grid."""
    dpdx = np.gradient(mslp, np.asarray(lons, np.float64), axis=1)
    dpdy = np.gradient(mslp, np.asarray(lats, np.float64), axis=0)
    return np.sqrt((dpdx * eigvectors[0]) ** 2 + (dpdy * eigvectors[1]) ** 2)


def rain(pr: np.ndarray, ridges: np.ndarray, high: np.ndarray,
         distance: float) -> dict:
    """:277-285: the four rain sums from the rain on the ridges' grid, the
    filtered ridges (0 where filtered out) and the local-FTLE mask."""
    dist = ndi.distance_transform_edt(~(ridges == 1))
    cz = (ridges > 0) | ((high > 0) & (dist < distance))
    local = np.clip(high - cz.astype(np.float64), 0, None)
    total = float(np.nansum(pr))
    on_cz = float(np.nansum(cz * pr))
    on_local = float(np.nansum(local * pr))
    return {"total_rain": total, "rain_on_czs": on_cz,
            "rain_on_local_strain": on_local,
            "rain_remainder": total - on_cz - on_local}
