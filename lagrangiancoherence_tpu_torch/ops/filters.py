"""Separable Gaussian smoothing matching ``scipy.ndimage.gaussian_filter`` — PyTorch.

Counterpart of ``lagrangiancoherence_tpu/ops/filters.py``, used for the
optional departure-map smoothing (LagrangianCoherence LCS/LCS.py:187-190).
scipy defaults replicated: ``truncate=4.0`` (radius =
int(4*sigma + 0.5)), ``mode='reflect'`` (symmetric edge padding), float64
kernel taps.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

__all__ = ["gaussian_kernel1d", "gaussian_filter"]


TRUNCATE = 4.0   # scipy's default


@lru_cache(maxsize=32)
def gaussian_kernel1d(sigma: float) -> np.ndarray:
    """scipy's _gaussian_kernel1d for order=0: normalised exp(-x^2/2sigma^2)."""
    radius = int(TRUNCATE * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 * (x / sigma) ** 2)
    phi = phi / phi.sum()
    phi.setflags(write=False)
    return phi


def _symmetric_index(n: int, r: int, device) -> torch.Tensor:
    """Source indices of a length-``n`` axis padded by ``r`` on each side
    in numpy's 'symmetric' mode ((d c b a | a b c d | d c b a))."""
    i = np.arange(-r, n + r) % (2 * n)
    i = np.where(i < n, i, 2 * n - 1 - i)
    return torch.tensor(i, device=device)


def _correlate1d_reflect(arr: torch.Tensor, taps: np.ndarray,
                         dim: int) -> torch.Tensor:
    """1-D correlation with scipy 'reflect' boundary."""
    r = (len(taps) - 1) // 2
    n = arr.shape[dim]
    padded = torch.index_select(arr, dim,
                                _symmetric_index(n, r, arr.device))
    k = torch.tensor(taps, dtype=arr.dtype, device=arr.device)
    out = torch.zeros_like(arr)
    for i in range(len(taps)):
        out = out + k[i] * padded.narrow(dim, i, n)
    return out


def gaussian_filter(arr: torch.Tensor, sigma: float) -> torch.Tensor:
    """2-D Gaussian smoothing over the trailing two axes, scipy-compatible."""
    taps = gaussian_kernel1d(float(sigma))
    out = _correlate1d_reflect(arr, taps, dim=arr.ndim - 2)
    return _correlate1d_reflect(out, taps, dim=arr.ndim - 1)
