"""The cubic spline prefilter as a banded solve on the card.

Counterpart of ``lagrangiancoherence_tpu/ops/interp.py`` ``prefilter``,
which multiplies by the dense inverse of scipy's ``mode='wrap'`` system
(an einsum left to XLA; no Pallas kernel).  The kernel
(``csrc/spline_prefilter.cu``) solves the same mirrored tridiagonal band
line by line instead, with the LU factors of ``interp.spline_band_factors``:
a latitude sweep into the output, then a longitude sweep in place, both
launched by one call.

``spline_prefilter_torch`` is its plain version: the same forward and back
substitution, vectorised over the lines, a Python loop along the axis.
``spline_prefilter`` takes CUDA tensors only and raises on anything the
kernel does not take; ``ops/interp.py`` ``prefilter`` chooses between it and
the dense matmuls.  ``LAUNCHES`` counts calls that launched the kernel, so
a run can show that its prefilter went through it.
"""
from __future__ import annotations

import torch

from ._launch import SUFFIX, entry, stream

__all__ = ["LAUNCHES", "solve_band_torch", "spline_prefilter",
           "spline_prefilter_torch"]

LAUNCHES = 0


def solve_band_torch(x: torch.Tensor, band: torch.Tensor,
                     dim: int) -> torch.Tensor:
    """Solve the tridiagonal system whose LU factors are ``band`` ((3, n):
    multipliers ``l``, pivot reciprocals ``r``, super-diagonal ``c``) along
    axis ``dim`` of ``x``, every other axis a batch of lines."""
    x = x.movedim(dim, 0)
    l, r, c = band.to(x.dtype)
    out = torch.empty_like(x)
    y = x[0]
    out[0] = y
    for i in range(1, x.shape[0]):
        y = x[i] - l[i] * y
        out[i] = y
    z = out[-1] * r[-1]
    out[-1] = z
    for i in range(x.shape[0] - 2, -1, -1):
        z = (out[i] - c[i] * z) * r[i]
        out[i] = z
    return out.movedim(0, dim)


def spline_prefilter_torch(field: torch.Tensor, band_y: torch.Tensor,
                           band_x: torch.Tensor) -> torch.Tensor:
    """The plain version: ``field`` (..., ny, nx) solved along latitude,
    then along longitude."""
    return solve_band_torch(solve_band_torch(field, band_y, -2), band_x, -1)


def spline_prefilter(field: torch.Tensor, band_y: torch.Tensor,
                     band_x: torch.Tensor) -> torch.Tensor:
    """Prefilter coefficients of ``field`` (..., ny, nx), a contiguous
    float32 or float64 CUDA tensor, through the kernel; ``band_y`` (3, ny)
    and ``band_x`` (3, nx) are ``spline_band_factors`` on its device, in
    its dtype.  Returns a new tensor of ``field``'s shape."""
    global LAUNCHES
    if field.dtype not in SUFFIX:
        raise TypeError(f"spline_prefilter: dtype {field.dtype} not "
                        f"supported (float32, float64)")
    if field.ndim < 2:
        raise ValueError(f"spline_prefilter: needs (..., ny, nx), got shape "
                         f"{tuple(field.shape)}")
    if not field.is_contiguous():
        raise ValueError("spline_prefilter: field must be contiguous")
    if field.device.type != "cuda":
        raise ValueError(f"spline_prefilter: needs a CUDA tensor, got "
                         f"device {field.device}; the CPU takes "
                         f"spline_prefilter_torch or the dense prefilter")
    ny, nx = field.shape[-2:]
    for name, band, n in (("band_y", band_y, ny), ("band_x", band_x, nx)):
        if band.device != field.device or band.dtype != field.dtype:
            raise TypeError(f"spline_prefilter: {name} must be on "
                            f"{field.device} in {field.dtype}, got "
                            f"{band.device}, {band.dtype}")
        if tuple(band.shape) != (3, n) or not band.is_contiguous():
            raise ValueError(f"spline_prefilter: {name} must be contiguous "
                             f"(3, {n}), got {tuple(band.shape)}")
    out = torch.empty_like(field)
    batch = field.numel() // (ny * nx) if ny * nx else 0
    if batch:
        # the launch and the kernels' shared-memory limit go to the
        # current device: make it the field's
        with torch.cuda.device(field.device):
            rc = entry("spline_prefilter", field.dtype)(
                field.data_ptr(), out.data_ptr(), band_y.data_ptr(),
                band_x.data_ptr(), batch, ny, nx, stream(field.get_device()))
        if rc != 0:
            raise RuntimeError(f"spline_prefilter launch failed: CUDA error "
                               f"{rc} (grid {ny}x{nx}, batch {batch}, "
                               f"{field.dtype}; 1 = a grid too large for "
                               f"the kernels' shared memory)")
        LAUNCHES += 1
    return out
