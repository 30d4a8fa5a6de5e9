"""Connected-component ridge filtering — host-side, numpy and scipy.

Counterpart of ``lagrangiancoherence_tpu/models/ridge_filter.py``, which runs
on the host in the JAX package too; ``filter_ridges`` also takes tensors
(copied to the host) and returns what it was given in the JAX package's
types: a Field for a Field, else a numpy array.

Stand-in for the external ``xr_tools.tools.filter_ridges`` the reference
imports (LagrangianCoherence LCS/area_of_influence.py:5,210-211,228-229,240-242):
label the ridge mask into connected components, compute per-component region
properties, and keep only components meeting every (criterion, threshold)
pair.  Kept ridge pixels keep their value; everything else becomes NaN — the
contract ``find_area`` and the research script's ``.where(~isnan(ridges), 0)`` rely
on.

Labeling runs host-side via ``scipy.ndimage.label`` (8-connectivity); the
per-component statistics are vectorised ``np.bincount`` reductions, so the
cost is one pass over the mask regardless of component count — there is no
hot-loop here (this is post-processing of a single diagnostic field).

Supported criteria (skimage ``regionprops`` definitions):
``area``, ``mean_intensity``, ``max_intensity``, ``major_axis_length``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..field import as_field
from ..utils.logging import timed_stage

__all__ = ["filter_ridges", "label_components", "component_properties"]


def label_components(mask: np.ndarray) -> tuple[np.ndarray, int]:
    """8-connected component labeling of a 0/1 mask."""
    from scipy import ndimage
    labels, n = ndimage.label(np.nan_to_num(mask) > 0,
                              structure=np.ones((3, 3), dtype=int))
    return labels, int(n)


def component_properties(labels: np.ndarray, n: int,
                         intensity: np.ndarray) -> dict[str, np.ndarray]:
    """Vectorised per-component region properties, indexed by label-1."""
    flat = labels.ravel()
    inten = np.nan_to_num(np.asarray(intensity, dtype=np.float64)).ravel()
    counts = np.bincount(flat, minlength=n + 1)[1:].astype(np.float64)
    sums = np.bincount(flat, weights=inten, minlength=n + 1)[1:]
    mean_int = sums / np.maximum(counts, 1)
    # max intensity per label
    max_int = np.full(n, -np.inf)
    np.maximum.at(max_int, flat[flat > 0] - 1, inten[flat > 0])

    yy, xx = np.indices(labels.shape)
    ys = np.bincount(flat, weights=yy.ravel(), minlength=n + 1)[1:]
    xs = np.bincount(flat, weights=xx.ravel(), minlength=n + 1)[1:]
    cy = ys / np.maximum(counts, 1)
    cx = xs / np.maximum(counts, 1)
    y2 = np.bincount(flat, weights=(yy ** 2).ravel(), minlength=n + 1)[1:]
    x2 = np.bincount(flat, weights=(xx ** 2).ravel(), minlength=n + 1)[1:]
    xy = np.bincount(flat, weights=(yy * xx).ravel(), minlength=n + 1)[1:]
    # central second moments per unit area (+1/12 pixel-extent correction,
    # as in skimage regionprops inertia_tensor/axis lengths)
    mu20 = x2 / np.maximum(counts, 1) - cx ** 2 + 1.0 / 12.0
    mu02 = y2 / np.maximum(counts, 1) - cy ** 2 + 1.0 / 12.0
    mu11 = xy / np.maximum(counts, 1) - cx * cy
    tr = mu20 + mu02
    disc = np.sqrt(np.maximum((mu20 - mu02) ** 2 + 4 * mu11 ** 2, 0.0))
    lam1 = 0.5 * (tr + disc)
    major = 4.0 * np.sqrt(np.maximum(lam1, 0.0))
    return dict(area=counts, mean_intensity=mean_int, max_intensity=max_int,
                major_axis_length=major)


def filter_ridges(ridges, intensity, criteria, thresholds):
    """Keep ridge components where every ``criteria[i] >= thresholds[i]``.

    ``ridges``: 0/1 (or NaN-masked) Field/array; ``intensity``: same-shape
    field the intensity criteria are evaluated on (the research script passes FTLE,
    LagrangianCoherence LCS/area_of_influence.py:210).  Either may be a
    tensor on any device.  Returns the ridge values with non-kept pixels
    set to NaN.  The span "Ridge filter" (INFO) covers the call.
    """
    if len(criteria) != len(thresholds):
        raise ValueError("criteria and thresholds must pair up")
    with timed_stage("Ridge filter"):
        ridges, intensity = (a.cpu().numpy() if isinstance(a, torch.Tensor)
                             else a for a in (ridges, intensity))
        is_field = hasattr(ridges, "dims")
        rf = as_field(ridges) if is_field else None
        rmask = np.asarray(rf.data if is_field else ridges, dtype=np.float64)
        ival = np.asarray(intensity.data if hasattr(intensity, "data")
                          and not isinstance(intensity, np.ndarray)
                          else intensity, dtype=np.float64)
        labels, n = label_components(rmask)
        out = np.where(np.nan_to_num(rmask) > 0, rmask, np.nan)
        if n == 0:
            return rf.copy(data=out) if is_field else out
        props = component_properties(labels, n, ival)
        keep = np.ones(n, dtype=bool)
        for crit, thr in zip(criteria, thresholds):
            if crit not in props:
                raise ValueError(f"unknown criterion {crit!r}; "
                                 f"supported: {sorted(props)}")
            keep &= props[crit] >= thr
        keep_mask = np.zeros(labels.shape, dtype=bool)
        keep_mask[labels > 0] = keep[labels[labels > 0] - 1]
        out = np.where(keep_mask, out, np.nan)
        return rf.copy(data=out) if is_field else out
