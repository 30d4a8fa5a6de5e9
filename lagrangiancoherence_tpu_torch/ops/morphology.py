"""Binary morphology + thresholding — skimage-free, PyTorch.

Counterpart of ``lagrangiancoherence_tpu/ops/morphology.py``.  The
reference's research script leans on skimage
(LagrangianCoherence LCS/area_of_influence.py:14,190-207,233):
``threshold_local`` to binarise local FTLE, ``skeletonize`` to thin ridge
masks, and ``binary_dilation``/``binary_erosion`` for neighbourhood ops.

* ``threshold_local``: gaussian / mean / median windowed threshold, skimage
  conventions (``threshold = filtered(image) - offset``; gaussian sigma =
  ``(block_size - 1) / 6``); the median pads with zeros, as
  ``scipy.signal.medfilt2d`` does;
* ``otsu_threshold``: classic histogram-variance maximisation (numpy);
* ``binary_dilation`` / ``binary_erosion``: connectivity-1 (cross) or
  connectivity-2 (square) footprints;
* ``skeletonize``: Zhang-Suen thinning.  JAX iterates under
  ``lax.while_loop`` until no pixel changes; here the "changed" test is a
  host sync, so it is taken once every ``CHECK_EVERY`` sweeps, never past
  ``max_iter``.  A sweep changes nothing once a sweep has changed nothing,
  so the extra sweeps leave the result identical.  ``SWEEPS`` counts the
  sweeps run, as ``cuda_settls.LAUNCHES`` counts launches.

``threshold_local`` opens the span "Local threshold" (its launches; the
caller's copy to the host ends the device work) and ``skeletonize`` the
span "Skeletonize" (its sweeps and host checks), both at INFO.
"""
from __future__ import annotations

import numpy as np
import torch

from ..devices import on_device, resolve_device
from ..utils.logging import timed_stage
from .filters import _symmetric_index, gaussian_filter

__all__ = ["SWEEPS", "otsu_threshold", "threshold_local", "binary_dilation",
           "binary_erosion", "skeletonize"]

CHECK_EVERY = 8        # Zhang-Suen sweeps between host checks for a change
_MEDIAN_CHUNK = 2 ** 24   # window elements per median pass (memory bound)
SWEEPS = 0             # Zhang-Suen sweeps run by ``skeletonize``


def otsu_threshold(image, nbins: int = 256) -> float:
    """Otsu's threshold (host-side, numpy): maximise inter-class variance."""
    if isinstance(image, torch.Tensor):
        image = image.cpu().numpy()
    vals = np.asarray(image).ravel()
    vals = vals[np.isfinite(vals)]
    hist, edges = np.histogram(vals, bins=nbins)
    centers = 0.5 * (edges[:-1] + edges[1:])
    hist = hist.astype(np.float64)
    w0 = np.cumsum(hist)
    w1 = w0[-1] - w0
    mu_cum = np.cumsum(hist * centers)
    mu_total = mu_cum[-1]
    with np.errstate(divide="ignore", invalid="ignore"):
        mu0 = mu_cum / w0
        mu1 = (mu_total - mu_cum) / w1
        between = w0 * w1 * (mu0 - mu1) ** 2
    between[~np.isfinite(between)] = -1
    return float(centers[int(np.argmax(between[:-1]))])


def _median_zero_padded(img: torch.Tensor, k: int) -> torch.Tensor:
    """``scipy.signal.medfilt2d(img, k)`` over the trailing two axes: the
    median of each k x k window, zero-padded at the edges."""
    r = k // 2
    ny, nx = img.shape[-2:]
    p = torch.nn.functional.pad(img.reshape(-1, 1, ny, nx), (r, r, r, r))
    rows = max(1, _MEDIAN_CHUNK // (k * k * nx))
    out = []
    for y0 in range(0, ny, rows):
        win = p[:, :, y0:min(ny, y0 + rows) + 2 * r]
        cols = torch.nn.functional.unfold(win, k)   # (B, k*k, rows*nx)
        out.append(cols.median(dim=1).values.reshape(p.shape[0], -1, nx))
    return torch.cat(out, dim=1).reshape(img.shape)


def threshold_local(image, block_size: int, method: str = "gaussian",
                    offset: float = 0.0, device=None) -> torch.Tensor:
    """Per-pixel local threshold on ``device``, skimage semantics: pixel >
    threshold is foreground, with ``threshold = local_statistic - offset``
    (the research script uses ``threshold_local(ftle, 301, offset=-.8)``,
    LagrangianCoherence LCS/area_of_influence.py:195-196)."""
    if block_size % 2 == 0:
        raise ValueError("block_size must be odd")
    with timed_stage("Local threshold"):
        img = on_device(image, resolve_device(device, image))
        if method == "gaussian":
            sigma = (block_size - 1) / 6.0
            stat = gaussian_filter(img, sigma=sigma)
        elif method == "mean":
            r = block_size // 2
            ny, nx = img.shape[-2], img.shape[-1]
            p = torch.index_select(img, -2,
                                   _symmetric_index(ny, r, img.device))
            p = torch.index_select(p, -1,
                                   _symmetric_index(nx, r, img.device))
            ii = torch.cumsum(torch.cumsum(p, dim=-2), dim=-1)
            ii = torch.nn.functional.pad(ii, (1, 0, 1, 0))
            b = block_size
            stat = (ii[..., b:b + ny, b:b + nx] - ii[..., :ny, b:b + nx]
                    - ii[..., b:b + ny, :nx] + ii[..., :ny, :nx]) / (b * b)
        elif method == "median":
            stat = _median_zero_padded(img, block_size)
        else:
            raise ValueError(f"unknown method {method!r}")
        return stat - offset


def _shift(m: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """``m`` moved by (dy, dx) over the trailing axes, False shifted in
    (no wrap)."""
    out = torch.roll(m, (dy, dx), dims=(-2, -1))
    if dy == 1:
        out[..., 0, :] = False
    elif dy == -1:
        out[..., -1, :] = False
    if dx == 1:
        out[..., :, 0] = False
    elif dx == -1:
        out[..., :, -1] = False
    return out


def _neighbor_or(mask: torch.Tensor, connectivity: int) -> torch.Tensor:
    up, dn = _shift(mask, 1, 0), _shift(mask, -1, 0)
    out = mask | up | dn | _shift(mask, 0, 1) | _shift(mask, 0, -1)
    if connectivity == 2:
        out = (out | _shift(up, 0, 1) | _shift(up, 0, -1)
               | _shift(dn, 0, 1) | _shift(dn, 0, -1))
    return out


def binary_dilation(mask, connectivity: int = 1, device=None) -> torch.Tensor:
    """Dilate a boolean mask on ``device``; connectivity 1 = cross footprint
    (the skimage default), 2 = full 3x3 square."""
    m = on_device(mask, resolve_device(device, mask)).to(torch.bool)
    return _neighbor_or(m, connectivity)


def binary_erosion(mask, connectivity: int = 1, device=None) -> torch.Tensor:
    m = on_device(mask, resolve_device(device, mask)).to(torch.bool)
    return ~_neighbor_or(~m, connectivity)


def _zhang_suen_sweep(m: torch.Tensor) -> torch.Tensor:
    """One Zhang-Suen sweep (two sub-iterations) of a 2-D boolean mask."""

    def subiter(m, phase):
        pad = torch.nn.functional.pad(m.to(torch.int32), (1, 1, 1, 1))
        p2 = pad[:-2, 1:-1]   # N
        p3 = pad[:-2, 2:]     # NE
        p4 = pad[1:-1, 2:]    # E
        p5 = pad[2:, 2:]      # SE
        p6 = pad[2:, 1:-1]    # S
        p7 = pad[2:, :-2]     # SW
        p8 = pad[1:-1, :-2]   # W
        p9 = pad[:-2, :-2]    # NW
        seq = [p2, p3, p4, p5, p6, p7, p8, p9, p2]
        A = sum(((seq[i] == 0) & (seq[i + 1] == 1)).to(torch.int32)
                for i in range(8))
        B = p2 + p3 + p4 + p5 + p6 + p7 + p8 + p9
        cond_common = m & (B >= 2) & (B <= 6) & (A == 1)
        if phase == 0:
            c = (p2 * p4 * p6 == 0) & (p4 * p6 * p8 == 0)
        else:
            c = (p2 * p4 * p8 == 0) & (p2 * p6 * p8 == 0)
        return m & ~(cond_common & c)

    return subiter(subiter(m, 0), 1)


def skeletonize(mask, max_iter: int = 256, device=None) -> torch.Tensor:
    """Zhang-Suen thinning to a 1-pixel-wide skeleton, on ``device``.

    Sweeps until a sweep changes no pixel, or ``max_iter`` sweeps, as JAX's
    ``lax.while_loop`` does; the change test waits for the device once every
    ``CHECK_EVERY`` sweeps.  Input: 2-D 0/1 or boolean; output in the
    input's dtype (host arrays: ``on_device``'s).
    """
    global SWEEPS
    with timed_stage("Skeletonize"):
        img = on_device(mask, resolve_device(device, mask))
        m = img > 0
        done = 0
        while done < max_iter:
            for _ in range(min(CHECK_EVERY, max_iter - done)):
                before, m = m, _zhang_suen_sweep(m)
                done += 1
                SWEEPS += 1
            # the last sweep changed nothing: the mask is a fixed point
            if not bool((m != before).any()):
                break
        return m.to(img.dtype)
