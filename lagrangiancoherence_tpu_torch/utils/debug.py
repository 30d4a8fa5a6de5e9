"""Numerical-safety helpers — PyTorch.

Counterpart of ``lagrangiancoherence_tpu/utils/debug.py``.  What can go
wrong in the pipeline is numerical — NaNs from bad inputs, out-of-range
coordinates — and these helpers make it loud:

* ``nan_debug()``: ``torch.autograd.set_detect_anomaly`` inside the
  context, with a warning on entry.  It checks backward passes only, and
  the port runs none, so for the pipeline it checks nothing: JAX's
  ``jax_debug_nans`` re-runs every op that makes a NaN, which eager
  PyTorch has no switch for.  Use ``checked_ftle`` for the winds;
* ``checked_ftle``: the FTLE pipeline with a finite-wind check, returning
  an error object the caller can raise (``err.throw()``), as JAX's
  ``checkify`` does, instead of a field silently pocked with NaNs
  (the reference drops them, LagrangianCoherence LCS/LCS.py:146).
"""
from __future__ import annotations

import warnings
from contextlib import contextmanager

import torch

__all__ = ["CheckError", "nan_debug", "checked_ftle"]


@contextmanager
def nan_debug():
    """``torch.autograd.set_detect_anomaly(True)`` inside the context.  It
    warns on entry: the port's pipeline has no backward pass, so nothing of
    it is checked (see the module note)."""
    warnings.warn("nan_debug checks autograd backward passes only, and the "
                  "FTLE pipeline runs none; use checked_ftle to check the "
                  "winds", stacklevel=3)
    with torch.autograd.set_detect_anomaly(True):
        yield


class CheckError:
    """The outcome of a check: ``get()`` is the message of a failed check
    or None, and ``throw()`` raises ``RuntimeError`` with it."""

    def __init__(self, message: str | None = None):
        self.message = message

    def get(self) -> str | None:
        return self.message

    def throw(self) -> None:
        if self.message is not None:
            raise RuntimeError(self.message)


def checked_ftle(u, v, timestep, grid, **kw):
    """``models.pipeline.ftle_pipeline`` with input validation.

    Returns ``(err, field)``: ``err.throw()`` raises when the winds hold a
    non-finite value; the field is computed either way.  ``kw``: as
    ``ftle_pipeline`` (``device=`` included).
    """
    from ..devices import resolve_device
    from ..models.pipeline import ftle_pipeline
    from ..models.settls import _as_tensor

    device = resolve_device(kw.pop("device", None), u, v)
    u = _as_tensor(u, device)
    v = _as_tensor(v, device, u.dtype)
    finite = bool(torch.isfinite(u).all() & torch.isfinite(v).all())
    err = CheckError(None if finite
                     else "non-finite values in the wind fields")
    return err, ftle_pipeline(u, v, timestep, grid, **kw)
