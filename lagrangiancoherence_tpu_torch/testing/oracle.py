"""CPU parity oracle: a minimal numpy/scipy re-implementation of the
reference's numerical semantics (including quirks Q1-Q6 from SURVEY.md).

Counterpart of ``lagrangiancoherence_tpu/testing/oracle.py``, with the same
arithmetic, so that the port's tests and ``chip_smoke.py`` hold the port to
the reference without importing the JAX package.  It is not the production
path: it states the semantics without the reference's xarray, numba and
windspharm stack.  Every function cites the reference lines whose
behaviour it reproduces (LagrangianCoherence ``LCS/``).
"""
from __future__ import annotations

import numpy as np
from scipy.linalg import norm as scipy_norm
from scipy.ndimage import gaussian_filter as scipy_gaussian
from scipy.ndimage import map_coordinates

EARTH_RADIUS = 6371000.0

# Wall-clock cost of the reference implementation's flagship workload, as
# the JAX package records it (its testing/oracle.py:24): one global
# 0.25-degree FTLE field (1440x721 parcels, 8-day backward, SETTLS_order=4)
# = 576 full-grid scipy ``map_coordinates`` spline interpolations driven
# one Python call at a time (LCS/trajectory.py:80-124), single-core CPU.
# A benchmark's ``vs_baseline`` is (fields/s) / (1 / this).
REFERENCE_SECONDS_PER_FIELD = 131.9


def oracle_map_coordinates(values, lats, lons, px, py, order=3):
    """xr_map_coordinates(isglobal=True) (LCS/tools.py:11-48):
    Q4 index scaling; order/`wrap` for interior rows; order-1/`constant` for
    the ``order`` rows nearest each pole."""
    ny, nx = values.shape
    new_x = nx * (px - lons.min()) / (lons.max() - lons.min())
    new_y = ny * (py - lats.min()) / (lats.max() - lats.min())
    out = np.empty((ny, nx), dtype=np.float64)
    interior = np.arange(order, ny - order)
    out[interior, :] = map_coordinates(
        values, np.array([new_y[interior, :].ravel(), new_x[interior, :].ravel()]),
        order=order, mode="wrap").reshape(interior.size, nx)
    pole = np.hstack([np.arange(0, order), np.arange(ny - order, ny)])
    out[pole, :] = map_coordinates(
        values, np.array([new_y[pole, :].ravel(), new_x[pole, :].ravel()]),
        order=1, mode="constant").reshape(pole.size, nx)
    return out


def oracle_parcel_propagation(u, v, lats, lons, timestep, settls_order=0,
                              interp_order=3, cyclic_x=True,
                              return_traj=False):
    """SETTLS integrator semantics of LCS/trajectory.py:8-144.

    ``u``/``v`` are (T, ny, nx); winds are traversed in forward storage order
    regardless of the sign of ``timestep`` (quirk Q2)."""
    conv_y = 180.0 / (EARTH_RADIUS * np.pi)
    conv_x = (conv_y / np.abs(np.cos(lats * np.pi / 180.0)))[:, None]
    y_min, y_max = lats.min(), lats.max()
    x_min, x_max = lons.min(), lons.max()

    def clamp_wrap(px, py):
        py = np.where(py > y_min, py, y_min)
        py = np.where(py < y_max, py, y_max)
        if cyclic_x:
            px = np.where(px > -180.0, px, px % 180.0)
            px = np.where(px < 180.0, px, -180.0 + (px % 180.0))
        else:
            px = np.where(px < x_min, x_min, px)
            px = np.where(px > x_max, x_max, px)
        return px, py

    px, py = np.meshgrid(lons, lats)
    traj_x, traj_y = [px.copy()], [py.copy()]
    nt = u.shape[0]
    for t in range(nt - 1):
        va = oracle_map_coordinates(v[t], lats, lons, px, py, interp_order)
        ua = oracle_map_coordinates(u[t], lats, lons, px, py, interp_order)
        py = py + timestep * conv_y * va
        px = px + timestep * conv_x * ua
        px, py = clamp_wrap(px, py)
        for _ in range(settls_order):
            v_t = oracle_map_coordinates(v[t], lats, lons, px, py, interp_order)
            v_n = oracle_map_coordinates(v[t + 1], lats, lons, px, py, interp_order)
            u_t = oracle_map_coordinates(u[t], lats, lons, px, py, interp_order)
            u_n = oracle_map_coordinates(u[t + 1], lats, lons, px, py, interp_order)
            py = py + 0.5 * timestep * conv_y * (va + 2 * v_t - v_n)
            px = px + 0.5 * timestep * conv_x * (ua + 2 * u_t - u_n)
            px, py = clamp_wrap(px, py)
        traj_x.append(px.copy())
        traj_y.append(py.copy())
    if return_traj:
        return np.stack(traj_x), np.stack(traj_y)
    return px, py


def _oracle_stencil(arr, dim, isglobal=True):
    """fourth_order_derivative (LCS/tools.py:190-245)."""
    out = np.zeros_like(arr)
    ny, nx = arr.shape
    if dim == 0:
        for i in range(2, ny - 2):
            out[i] = (4 / 3) * (arr[i + 1] - arr[i - 1]) / 2 \
                     - (1 / 3) * (arr[i + 2] - arr[i - 2]) / 4
        for i in (0, 1):
            out[i] = (arr[i + 1] - arr[i]) / 2
        for i in (-1, -2):
            out[i] = (arr[i] - arr[i - 1]) / 2
    else:
        if isglobal:
            for j in range(nx):
                out[:, j] = (4 / 3) * (arr[:, (j + 1) % nx] - arr[:, (j - 1) % nx]) / 2 \
                            - (1 / 3) * (arr[:, (j + 2) % nx] - arr[:, (j - 2) % nx]) / 4
        else:
            for j in range(2, nx - 2):
                out[:, j] = (4 / 3) * (arr[:, j + 1] - arr[:, j - 1]) / 2 \
                            - (1 / 3) * (arr[:, j + 2] - arr[:, j - 2]) / 4
            for j in (0, 1):
                out[:, j] = (arr[:, j + 1] - arr[:, j]) / 2
            for j in (-1, -2):
                out[:, j] = (arr[:, j] - arr[:, j - 1]) / 2
    return out


def oracle_derivative_spherical(values, lats, lons, dim, isglobal=True):
    """derivative_spherical_coords incl. the float32 cast (quirk Q6,
    LCS/tools.py:248-267)."""
    deriv = _oracle_stencil(values.astype(np.float32), dim, isglobal).astype(np.float64)
    if dim == 0:
        dy = (np.pi / 180.0) * (lats[1] - lats[0]) * EARTH_RADIUS
        return deriv / dy
    dx = (np.pi / 180.0) * (lons[1] - lons[0]) * EARTH_RADIUS \
        * np.cos(lats * np.pi / 180.0)
    return deriv / dx[:, None]


def oracle_flowmap_gradient(x_dep, y_dep, lats, lons, sigma=None):
    """flowmap_gradient (LCS/LCS.py:171-225): sphere map with
    colatitude = lat - 90, six spherical derivatives, three zero radial
    derivatives, stacked in the reference's element order."""
    if sigma is not None:
        x_dep = scipy_gaussian(x_dep, sigma=sigma)
        y_dep = scipy_gaussian(y_dep, sigma=sigma)
    LON = x_dep * np.pi / 180.0
    LAT = (y_dep - 90.0) * np.pi / 180.0
    X = EARTH_RADIUS * np.sin(LAT) * np.cos(LON)
    Y = EARTH_RADIUS * np.sin(LAT) * np.sin(LON)
    Z = EARTH_RADIUS * np.cos(LAT)
    d = oracle_derivative_spherical
    comps = [d(X, lats, lons, 1), d(X, lats, lons, 0),
             d(Y, lats, lons, 1), d(Y, lats, lons, 0),
             d(Z, lats, lons, 1), d(Z, lats, lons, 0),
             np.zeros_like(X), np.zeros_like(X), np.zeros_like(X)]
    return np.stack(comps)  # (9, ny, nx): dxdx,dxdy,dydx,dydy,dzdx,dzdy,0,0,0


def oracle_ftle_norm(def_tensor):
    """Q1-compatible matrix 2-norm (LCS/LCS.py:145-154): the
    9-vector is reshaped row-major to [3,3] — a *scrambled* matrix — and the
    largest singular value of that matrix is taken per point."""
    nine, ny, nx = def_tensor.shape
    vals = def_tensor.reshape(3, 3, ny * nx)
    out = scipy_norm(vals, axis=(0, 1), ord=2)
    return out.reshape(ny, nx)


def oracle_ftle(u, v, lats, lons, timestep, settls_order=0, interp_order=3,
                cyclic_x=True, gauss_sigma=None):
    """End-to-end FTLE pipeline parity oracle (LCS.__call__ core path,
    LCS/LCS.py:129-157, without the isglobal preprocessing)."""
    px, py = oracle_parcel_propagation(u, v, lats, lons, timestep,
                                       settls_order, interp_order, cyclic_x)
    tensor = oracle_flowmap_gradient(px, py, lats, lons, sigma=gauss_sigma)
    return oracle_ftle_norm(tensor)


def _sym_eig_2x2_ascending(a, b, c):
    """Deterministic closed-form eigendecomposition of [[a,b],[b,c]]:
    eigenvalues ascending, v1 direction ((a-c)/2 + disc, b), v0 = perp(v1).
    The oracle shares this convention with the JAX path because LAPACK's 2x2
    ``dgeev`` ordering/signs are build-dependent (see models/ridges.py)."""
    half_tr = 0.5 * (a + c)
    half_diff = 0.5 * (a - c)
    disc = np.sqrt(half_diff ** 2 + b ** 2)
    lam0, lam1 = half_tr - disc, half_tr + disc
    vx, vy = half_diff + disc, b
    n = np.hypot(vx, vy)
    if n > 0:
        v1 = np.array([vx / n, vy / n])
    else:
        v1 = np.array([1.0, 0.0])
    v0 = np.array([-v1[1], v1[0]])
    return lam0, lam1, v0, v1


def oracle_find_ridges(field, lats, lons, sigma=0.5,
                       tolerance_threshold=0.0005e-3, isglobal=True):
    """Python-loop re-statement of find_ridges_spherical_hessian
    (LCS/tools.py:52-155) incl. quirk Q7 (row indexing,
    eigmin := largest-|lambda| eigenvalue), with the deterministic eig
    convention above."""
    if sigma is not None:
        field = scipy_gaussian(field, sigma=sigma)
    d = oracle_derivative_spherical
    ddadx = d(field, lats, lons, 1, isglobal)
    ddady = d(field, lats, lons, 0, isglobal)
    d2dadx2 = d(ddadx, lats, lons, 1, isglobal)
    d2dady2 = d(ddady, lats, lons, 0, isglobal)
    d2dadxdy = d(ddadx, lats, lons, 0, isglobal)
    ny, nx = field.shape
    ridges = np.zeros((ny, nx))
    eigmin = np.zeros((ny, nx))
    dt_prod = np.zeros((ny, nx))
    eigvectors = np.zeros((ny, nx, 2))
    clean = lambda x: np.where(np.isfinite(x), x, 0.0)
    for i in range(ny):
        for j in range(nx):
            a = clean(d2dadx2[i, j]); b = clean(d2dadxdy[i, j])
            c = clean(d2dady2[i, j])
            lam0, lam1, v0, v1 = _sym_eig_2x2_ascending(a, b, c)
            row = np.array([v0[0], v1[0]])           # quirk Q7 row indexing
            em = lam0 if abs(lam0) >= abs(lam1) else lam1
            dt = row[0] * ddadx[i, j] + row[1] * ddady[i, j]
            eigmin[i, j] = em
            dt_prod[i, j] = dt
            if abs(dt) <= tolerance_threshold and np.sign(em) == -1:
                ridges[i, j] = 1.0
            eigvectors[i, j] = row if em < 0 else 0.0
    return ridges, eigmin, dt_prod, eigvectors


def oracle_find_area(ftle, eigvectors, ridges, lats, lons,
                     saturation_ratio=0.5):
    """While-loop walk of find_area (LCS/area_of_influence.py:50-79):
    walk from (pt - |ev| r) in |ev|*res steps, marking nearest cells until
    the walked distance exceeds 2r."""
    res = lats[1] - lats[0]
    sigma = np.exp(ftle) * ridges
    normal_radius = sigma * saturation_ratio
    bounds = np.zeros_like(ftle)
    ny, nx = ftle.shape
    for i in range(ny):
        for j in range(nx):
            if np.isnan(sigma[i, j]) or np.isnan(eigvectors[i, j]).any():
                continue
            ev_y, ev_x = eigvectors[i, j, 0], eigvectors[i, j, 1]
            r = normal_radius[i, j]
            x_lower = lons[j] - abs(ev_x) * r
            y_lower = lats[i] - abs(ev_y) * r
            xx, yy, D = x_lower, y_lower, 0.0
            if abs(ev_x) < 1e-300 and abs(ev_y) < 1e-300 and r > 0:
                continue  # the reference would loop forever here
            while D <= 2 * r:
                xx += abs(ev_x) * res
                yy += abs(ev_y) * res
                bounds[np.argmin(np.abs(lats - yy)),
                       np.argmin(np.abs(lons - xx))] = 1
                D = np.hypot(xx - x_lower, yy - y_lower)
    return bounds
