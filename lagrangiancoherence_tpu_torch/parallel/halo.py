"""Halo exchange and blocked stencils for the latitude-block pipeline — PyTorch.

Counterpart of ``lagrangiancoherence_tpu/parallel/halo.py``.  JAX exchanges
halos with ``ppermute`` inside ``shard_map``; here every block of a mesh
axis lives in one process, so the exchange functions take the *list* of
that axis's blocks, in mesh order, and return them padded: a halo is a
slice of the neighbour block moved to the block's device with ``.to``.

The blocked stencils and the Gaussian are functions of one padded block,
in the op order of ``ops/stencil.py`` and ``ops/filters.py``, so that a
block's rows equal the full-field result's.

The port's ``parallel/pipeline.ftle_sharded`` does not use them: one
process holds every block, so it assembles the departure points and takes
the whole-grid gradient.  They are here for fields a caller keeps in
blocks.
"""
from __future__ import annotations

import numpy as np
import torch

from ..grid import EARTH_RADIUS
from ..ops.filters import _correlate1d_reflect, gaussian_kernel1d
from ..ops.interp import _div
from ..ops.stencil import fourth_order_derivative

__all__ = ["exchange_rows", "exchange_cols_cyclic",
           "fourth_order_dim0_blocked", "fourth_order_dim1_blocked",
           "derivative_spherical_blocked", "gaussian_radius",
           "gaussian_filter_blocked"]


def exchange_rows(blocks: list[torch.Tensor], h: int,
                  reflect_at_edges: bool = False) -> list[torch.Tensor]:
    """Pad each (rows, nx) block of a latitude axis to (rows + 2h, nx).

    Block d's top halo is the last ``h`` rows of block d-1, its bottom halo
    the first ``h`` rows of block d+1.  The global edges receive zeros, or
    (``reflect_at_edges``) a symmetric reflection of the edge block's own
    rows: the blocked form of scipy's ``mode='reflect'``.
    """
    n = len(blocks)
    out = []
    for d, x in enumerate(blocks):
        if d > 0:
            top = blocks[d - 1][-h:].to(x.device)
        elif reflect_at_edges:
            top = x[:h].flip(0)
        else:
            top = torch.zeros_like(x[:h])
        if d < n - 1:
            bot = blocks[d + 1][:h].to(x.device)
        elif reflect_at_edges:
            bot = x[x.shape[0] - h:].flip(0)
        else:
            bot = torch.zeros_like(x[:h])
        out.append(torch.cat([top, x, bot], dim=0))
    return out


def exchange_cols_cyclic(blocks: list[torch.Tensor],
                         h: int) -> list[torch.Tensor]:
    """Pad each (rows, cols) block of a longitude axis to (rows, cols + 2h)
    with its neighbours' columns, cyclically: the global longitude axis
    wraps, so the first block's left halo is the last block's right edge."""
    n = len(blocks)
    return [torch.cat([blocks[(d - 1) % n][:, -h:].to(x.device), x,
                       blocks[(d + 1) % n][:, :h].to(x.device)], dim=1)
            for d, x in enumerate(blocks)]


def _centered(sl) -> torch.Tensor:
    """The 4th-order centred stencil of ``ops/stencil.py`` on the shifted
    slices ``sl(k)``."""
    return (4.0 / 3.0) * (sl(1) - sl(-1)) / 2.0 \
        - (1.0 / 3.0) * (sl(2) - sl(-2)) / 4.0


def fourth_order_dim1_blocked(padded: torch.Tensor, h: int) -> torch.Tensor:
    """Longitude derivative of a cyclically halo-padded (rows, cols + 2h)
    block, ``h >= 2``: the reference's 4th-order centred stencil with
    cyclic indexing (LagrangianCoherence LCS/tools.py:221-228).  Returns
    (rows, cols)."""
    cols = padded.shape[1] - 2 * h
    return _centered(lambda k: padded[:, h + k:h + k + cols])


def fourth_order_dim0_blocked(padded: torch.Tensor, h: int, row_start: int,
                              ny_total: int) -> torch.Tensor:
    """Latitude derivative of a halo-padded (rows + 2h, nx) block,
    ``h >= 2``: the centred stencil, one-sided within two rows of the
    *global* edges (LagrangianCoherence LCS/tools.py:200-217).
    ``row_start``: the global row of the block's first row.  Returns
    (rows, nx)."""
    rows = padded.shape[0] - 2 * h

    def sl(k):
        return padded[h + k:h + k + rows]

    out = _centered(sl)
    fwd = (sl(1) - sl(0)) / 2.0
    bwd = (sl(0) - sl(-1)) / 2.0
    grow = (torch.arange(rows, device=padded.device) + row_start)[:, None]
    out = torch.where(grow < 2, fwd, out)
    return torch.where(grow >= ny_total - 2, bwd, out)


def _dx(lats_block, dlon: float, dtype: torch.dtype,
        device) -> torch.Tensor:
    """The longitude metric ``(pi/180) dlon R cos(lat)`` of each block row,
    as ``ops/stencil.derivative_spherical_coords`` forms it."""
    y = torch.as_tensor(np.asarray(lats_block), dtype=dtype,
                        device=device) * (np.pi / 180.0)
    wide = torch.promote_types(dtype, torch.get_default_dtype())
    return float((np.pi / 180.0) * dlon * EARTH_RADIUS) * torch.cos(y).to(wide)


def derivative_spherical_blocked(values_padded: torch.Tensor, h: int,
                                 row_start: int, lats_block, dlat: float,
                                 dlon: float, ny_total: int, dim: int,
                                 isglobal: bool = True,
                                 out_dtype: torch.dtype | None = None,
                                 x_blocked: bool = False) -> torch.Tensor:
    """Blocked ``derivative_spherical_coords`` (quirk Q6 float32 stencil,
    LagrangianCoherence LCS/tools.py:248-267).

    ``dim=0``: the input is a row-padded block (``exchange_rows``, width
    ``h``).  ``dim=1``: the unpadded block with ``h=0``, whose longitude is
    whole; or, with ``x_blocked``, a column-padded block
    (``exchange_cols_cyclic`` of the float32 values, width ``h``).
    ``lats_block``: the latitude of each block row.
    """
    if out_dtype is None:
        out_dtype = values_padded.dtype
    f32 = values_padded.to(torch.float32)
    if dim == 0:
        deriv = fourth_order_dim0_blocked(f32, h, row_start,
                                          ny_total).to(out_dtype)
        return _div(deriv, float((np.pi / 180.0) * dlat * EARTH_RADIUS))
    if x_blocked:
        deriv = fourth_order_dim1_blocked(f32, h).to(out_dtype)
    elif h != 0:
        raise ValueError("the longitude derivative of a whole-longitude "
                         "block is local: pass the unpadded block, h=0")
    else:
        deriv = fourth_order_derivative(f32, dim=1,
                                        isglobal=isglobal).to(out_dtype)
    return deriv / _dx(lats_block, dlon, out_dtype, deriv.device)[:, None]


def gaussian_radius(sigma: float, truncate: float = 4.0) -> int:
    """The halo width ``gaussian_filter_blocked`` needs."""
    return (len(gaussian_kernel1d(float(sigma), truncate)) - 1) // 2


def gaussian_filter_blocked(padded: torch.Tensor, sigma: float,
                            truncate: float = 4.0) -> torch.Tensor:
    """scipy-compatible Gaussian smoothing of one latitude block, padded by
    ``exchange_rows(..., gaussian_radius(sigma), reflect_at_edges=True)``:
    separable correlation over the rows, then over the whole longitude with
    symmetric padding.  Equals the rows of ``ops.filters.gaussian_filter``
    on the assembled field when no block holds pad rows."""
    taps = gaussian_kernel1d(float(sigma), truncate)
    r = (len(taps) - 1) // 2
    rows = padded.shape[0] - 2 * r
    if rows < r:
        raise ValueError(f"{rows} rows a block < gaussian radius {r}")
    k = torch.tensor(taps, dtype=padded.dtype, device=padded.device)
    out = torch.zeros_like(padded[r:r + rows])
    for i in range(len(taps)):
        out = out + k[i] * padded[i:i + rows]
    return _correlate1d_reflect(out, taps, dim=1)
