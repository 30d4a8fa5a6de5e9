"""Triangular spherical-harmonic truncation — PyTorch.

Counterpart of ``lagrangiancoherence_tpu/ops/sht.py``, the functional
replacement for the reference's
``windspharm.xarray.VectorWind.truncate(..., truncation=20)``
(LagrangianCoherence LCS/LCS.py:115-118):

* longitude -> zonal wavenumbers via ``torch.fft.rfft``;
* per zonal wavenumber ``m <= T``, the latitude profile goes through the
  least-squares project+synthesise operator ``S_m`` (``(ny, ny)``, built on
  the host in numpy by the same code as the JAX package's and cached per
  (latitudes, T)), applied as one batched product over ``m``;
* wavenumbers ``m > T`` are zeroed; ``torch.fft.irfft(n=nx)`` returns to
  grid space, so odd ``nx`` (the common grid's 721) round-trips.

See the JAX module for why least squares under interpolatory quadrature
weights is the analysis operator on a regular latitude grid.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..devices import on_device, resolve_device
from .interp import _check_matmul_precision

__all__ = ["legendre_basis", "truncation_operators", "truncate"]


def _normalized_legendre(nmax: int, m: int, x: np.ndarray) -> np.ndarray:
    """Orthonormal associated Legendre functions ``\\bar P_n^m(x)`` for
    ``n = m..nmax`` evaluated at ``x = sin(lat)``, via the standard stable
    three-term recursion (fully normalised, geodesy convention)."""
    x = np.asarray(x, dtype=np.float64)
    npts = x.shape[0]
    out = np.zeros((nmax - m + 1, npts))
    # P_m^m seed: \bar P_m^m = sqrt((2m+1)/(4pi) * (2m-1)!!/(2m)!!) (1-x^2)^{m/2}
    # Build the double-factorial ratio in log space for stability.
    log_ratio = 0.0
    for k in range(1, m + 1):
        log_ratio += np.log((2 * k - 1) / (2 * k))
    pmm = np.sqrt((2 * m + 1) / (4 * np.pi) * np.exp(log_ratio)) \
        * (1.0 - x * x) ** (m / 2.0)
    if m % 2 == 1:
        pmm = -pmm  # Condon-Shortley phase
    out[0] = pmm
    if nmax == m:
        return out
    # P_{m+1}^m
    out[1] = x * np.sqrt(2 * m + 3.0) * pmm
    for n in range(m + 2, nmax + 1):
        a = np.sqrt((4.0 * n * n - 1.0) / (n * n - m * m))
        b = np.sqrt(((n - 1.0) ** 2 - m * m) / (4.0 * (n - 1.0) ** 2 - 1.0))
        out[n - m] = a * (x * out[n - m - 1] - b * out[n - m - 2])
    return out


def _interpolatory_weights(x: np.ndarray) -> np.ndarray:
    """Interpolatory quadrature weights on the nodes ``x`` in (-1, 1): the
    unique weights integrating every polynomial of degree <= ny-1 exactly
    (solved in the orthonormal Legendre basis for conditioning)."""
    ny = x.shape[0]
    V = _normalized_legendre(ny - 1, 0, x)          # (ny modes, ny nodes)
    mu = np.zeros(ny)
    mu[0] = 2.0 * np.sqrt(1.0 / (4.0 * np.pi))      # int of \bar P_0^0 on [-1,1]
    return np.linalg.solve(V, mu)


@lru_cache(maxsize=16)
def legendre_basis(lats_key: bytes, truncation: int) -> np.ndarray:
    """Stacked smoothing operators ``S[m] = P_m (P_m^T W P_m)^{-1} P_m^T W``,
    shape ``(truncation+1, ny, ny)``, read-only; cached per (latitude
    vector, T)."""
    lats = np.frombuffer(lats_key, dtype=np.float64)
    x = np.sin(np.deg2rad(lats))
    w = _interpolatory_weights(x)
    ny = lats.shape[0]
    S = np.zeros((truncation + 1, ny, ny))
    for m in range(truncation + 1):
        P = _normalized_legendre(truncation, m, x).T  # (ny, n_modes)
        PtW = P.T * w[None, :]
        S[m] = P @ np.linalg.solve(PtW @ P, PtW)
    S.setflags(write=False)
    return S


def truncation_operators(lats: np.ndarray, truncation: int) -> np.ndarray:
    lats = np.ascontiguousarray(np.asarray(lats, dtype=np.float64))
    return legendre_basis(lats.tobytes(), truncation)


def truncate(field, lats: np.ndarray, truncation: int = 20,
             device=None) -> torch.Tensor:
    """Triangular truncation of ``field`` (..., ny, nx) to total wavenumber
    <= ``truncation`` on a regular lat/lon grid, on ``device``.  A host
    array is computed in ``torch.get_default_dtype()``, a tensor in its own
    dtype.  On CUDA the operator product needs full-precision float32
    matmuls, as the prefilter does (``ops/interp._check_matmul_precision``).
    """
    device = resolve_device(device, field)
    f = on_device(field, device)
    if device.type == "cuda":
        _check_matmul_precision()
    nx = f.shape[-1]
    spec = torch.fft.rfft(f, dim=-1)          # (..., ny, nx//2+1)
    keep = spec[..., : truncation + 1]        # zonal wavenumbers m <= T
    S = torch.tensor(truncation_operators(lats, truncation),
                     device=device).to(keep.dtype)
    # batched product over m: out[..., y, m] = S[m] @ keep[..., :, m]
    smoothed = torch.einsum("myz,...zm->...ym", S, keep)
    out_spec = torch.zeros_like(spec)
    out_spec[..., : truncation + 1] = smoothed
    return torch.fft.irfft(out_spec, n=nx, dim=-1).to(f.dtype)
