"""End-to-end FTLE pipeline: winds in, FTLE-norm field out — PyTorch.

Counterpart of ``lagrangiancoherence_tpu/models/pipeline.py``: prefilter,
SETTLS integration, flow-map gradient and the closed-form norm, run eagerly
on one device.  ``FTLEPipeline`` holds the grid-derived state — the two
prefilter matrices, ``conv_x`` and the initial mesh — as buffers, so a
caller that computes many fields on one grid builds it once;
``ftle_pipeline`` is the one-call form.
"""
from __future__ import annotations

import logging
from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from ..devices import resolve_device
from ..utils.logging import timed_stage
from .ftle import flowmap_gradient, ftle_norm
from .settls import (_as_tensor, grid_state, parcel_propagation_core,
                     resolve_engine, resolve_kernel)

__all__ = ["FTLEPipeline", "ftle_pipeline"]


class FTLEPipeline(nn.Module):
    """(T, ny, nx) winds → (ny, nx) FTLE norm on one grid.

    Semantics are those of ``LCS.__call__``'s core path (quirks Q1-Q6); see
    models/settls.py and models/ftle.py for the stage contracts.  ``kernel``
    is ``"auto"``, ``"cuda"`` or ``"torch"`` (``settls.resolve_kernel``);
    ``engine`` is ``"auto"``, ``"dma-all"``, ``"blockspec"`` or ``"dma"``
    (``settls.resolve_engine``); ``rebin`` (``"sort"`` or False) is
    ``settls.settls_scan``'s.  JAX's ``pallas_wy``, ``pallas_wx``,
    ``pallas_retry_tiles`` and ``pallas_retry_wy`` are constants here
    (``settls.WY``, ``tiles.WX``, and the ladders of ``ops/tiles.py``).
    ``device``: where the state lives and the
    pipeline computes; default: the CUDA card (``devices.resolve_device``);
    pass ``device="cpu"`` for the CPU.
    """

    def __init__(self, grid, *, settls_order: int = 0, interp_order: int = 3,
                 sigma=None, compat: bool = True, kernel: str = "auto",
                 engine: str = "auto", rebin="sort",
                 dtype: torch.dtype = torch.float64, device=None):
        super().__init__()
        device = resolve_device(device)
        resolve_kernel(kernel, device, interp_order)   # fail at build time
        resolve_engine(engine)
        if rebin not in ("sort", False):
            raise ValueError(f"rebin={rebin!r}: expected 'sort' or False")
        self.grid = grid
        self.settls_order = settls_order
        self.interp_order = interp_order
        self.sigma = sigma
        self.compat = compat
        self.kernel = kernel
        self.engine = engine
        self.rebin = rebin
        with timed_stage("Grid state", logging.DEBUG):
            state = grid_state(grid, interp_order, dtype=dtype, device=device)
        for name, t in state.items():
            self.register_buffer(name, t)

    def load_numpy_state(self, arrays: Mapping[str, np.ndarray]) -> None:
        """Copy host arrays (e.g. the JAX package's prefilter matrices) into
        the buffers of the same names, keeping each buffer's dtype and
        device.

        On the card at order 3 in float32 or float64 the prefilter solves
        the band with ``ops/interp.spline_band_factors``, not with the dense
        matrices, so loading ``prefilter_y``/``prefilter_x`` changes only
        the dense path (the CPU, orders 2/4/5, other dtypes)."""
        buffers = dict(self.named_buffers())
        for name, a in arrays.items():
            if name not in buffers:
                raise KeyError(f"no buffer {name!r}; buffers: "
                               f"{sorted(buffers)}")
            buf = buffers[name]
            a = np.asarray(a)
            if tuple(a.shape) != tuple(buf.shape):
                raise ValueError(f"{name}: shape {a.shape} != "
                                 f"{tuple(buf.shape)}")
            with torch.no_grad():
                buf.copy_(torch.tensor(a, dtype=buf.dtype))

    def forward(self, u, v, timestep, return_overflow: bool = False):
        with timed_stage("FTLE field", logging.DEBUG):
            state = dict(self.named_buffers())
            device, dtype = state["px0"].device, state["px0"].dtype
            u, v = _as_tensor(u, device, dtype), _as_tensor(v, device, dtype)
            px, py, overflow = parcel_propagation_core(
                u, v, timestep, self.grid, settls_order=self.settls_order,
                interp_order=self.interp_order, kernel=self.kernel,
                engine=self.engine, rebin=self.rebin, return_overflow=True,
                device=device, state=state)
            with timed_stage("Gradient and norm", logging.DEBUG):
                norm = ftle_norm(flowmap_gradient(px, py, self.grid,
                                                  sigma=self.sigma),
                                 compat=self.compat)
        if return_overflow:
            return norm, overflow
        return norm


def ftle_pipeline(u, v, timestep, grid, *, settls_order: int = 0,
                  interp_order: int = 3, sigma=None, compat: bool = True,
                  kernel: str = "auto", engine: str = "auto", rebin="sort",
                  return_overflow: bool = False, device=None):
    """(T, ny, nx) winds → (ny, nx) FTLE norm, with ``u``'s dtype.

    ``rebin`` (``"sort"`` or False) applies to the windowed route,
    ``engine="blockspec"`` or ``"dma"`` (``settls.settls_scan``).  JAX's
    ``pallas_wy``, ``pallas_wx``, ``pallas_retry_tiles`` and
    ``pallas_retry_wy`` are constants in the port (``settls.WY``,
    ``tiles.WX``, and the ladders of ``ops/tiles.py``).

    ``device``: where to compute; default: the device of ``u`` or ``v`` if
    a tensor, else the CUDA card (``devices.resolve_device``).  With
    ``return_overflow=True`` the int32 overflow bitmask (always 0 on the
    fused-step route) is returned alongside the field.
    """
    u = _as_tensor(u, resolve_device(device, u, v))
    model = FTLEPipeline(grid, settls_order=settls_order,
                         interp_order=interp_order, sigma=sigma,
                         compat=compat, kernel=kernel, engine=engine,
                         rebin=rebin, dtype=u.dtype, device=u.device)
    return model(u, v, timestep, return_overflow=return_overflow)
