"""K1 ``spline_gather``: the hand-written CUDA gather of the SETTLS hot path.

Counterpart of ``lagrangiancoherence_tpu/ops/pallas_interp.py``
``pallas_interp_multi``; the kernel (``csrc/spline_gather.cu``) replaces the
Pallas ``_engine_kernel`` (``pallas_interp.py:793``).  It computes what
``ops/interp.py`` ``interp_at_parcels_multi`` computes, one thread per
parcel, reading fields ``[f0, f0 + nf)`` of the resident (T, 2, ny, nx)
raw and prefiltered stacks: the (u, v) pairs of time levels t and t+1 are
adjacent, so a SETTLS gather group reads ``[2t, 2t + 4)`` with no per-step
copy.

Tensors on the CPU take the plain version; CUDA tensors launch the kernel or
raise — there is no fallback.  ``LAUNCHES`` counts kernel launches, so a run
can show that its main path went through the kernel.
"""
from __future__ import annotations

import torch

from .interp import interp_at_parcels_multi

__all__ = ["LAUNCHES", "cuda_interp_multi"]

LAUNCHES = 0

_ENTRY = {torch.float32: "spline_gather_f32", torch.float64: "spline_gather_f64"}
_MAX_GRID_ROWS = 65535   # gridDim.y


def cuda_interp_multi(fields: torch.Tensor, coeffs: torch.Tensor,
                      px: torch.Tensor, py: torch.Tensor, *,
                      x_min, x_max, y_min, y_max, order: int = 3,
                      row_offset: int = 0, f0: int = 0, nf: int | None = None):
    """Fields ``[f0, f0 + nf)`` of the stacks at the parcel positions.

    ``fields``/``coeffs``: (..., ny, nx) raw and prefiltered stacks, whose
    leading axes flatten to the field index (e.g. (T, 2, ny, nx)).
    ``px``/``py``: (rows, cols) positions whose home rows are grid rows
    ``row_offset ..``.  Returns ``((nf, rows, cols) values, overflow)``;
    ``overflow`` is an int32 0-dim tensor, always 0 (a per-parcel gather has
    no window to overflow), kept so that callers never drop the flag.
    """
    global LAUNCHES
    ny, nx = fields.shape[-2:]
    nfields = fields.numel() // (ny * nx) if fields.numel() else 0
    nf = nfields - f0 if nf is None else nf
    bounds = dict(x_min=x_min, x_max=x_max, y_min=y_min, y_max=y_max)
    devices = {t.device for t in (fields, coeffs, px, py)}
    if devices == {torch.device("cpu")}:
        out = interp_at_parcels_multi(
            fields.reshape(nfields, ny, nx)[f0:f0 + nf],
            coeffs.reshape(nfields, ny, nx)[f0:f0 + nf], px, py,
            order=order, row_offset=row_offset, **bounds)
        return out, torch.zeros((), dtype=torch.int32)

    if len(devices) != 1 or px.device.type != "cuda":
        raise ValueError(f"cuda_interp_multi: tensors must all be on one "
                         f"CUDA device or all on the CPU, got {devices}")
    if fields.dtype not in _ENTRY:
        raise TypeError(f"cuda_interp_multi: dtype {fields.dtype} not "
                        f"supported (float32, float64)")
    if any(t.dtype != fields.dtype for t in (coeffs, px, py)):
        raise TypeError("cuda_interp_multi: fields, coeffs, px and py must "
                        "share one dtype")
    if any(not t.is_contiguous() for t in (fields, coeffs, px, py)):
        raise ValueError("cuda_interp_multi: tensors must be contiguous")
    if coeffs.shape != fields.shape:
        raise ValueError(f"cuda_interp_multi: coeffs {tuple(coeffs.shape)} "
                         f"!= fields {tuple(fields.shape)}")
    if px.ndim != 2 or px.shape != py.shape:
        raise ValueError(f"cuda_interp_multi: px/py must be 2-D and equal, "
                         f"got {tuple(px.shape)}, {tuple(py.shape)}")
    if order not in (1, 3):
        raise NotImplementedError(f"the CUDA kernel implements spline "
                                  f"orders 1 and 3, got {order}")
    if nf not in (2, 4) or f0 < 0 or f0 + nf > nfields:
        raise ValueError(f"cuda_interp_multi: fields [{f0}, {f0 + nf}) "
                         f"outside the stack of {nfields}, or nf not 2 or 4")
    if ny < 4 or nx < 4:
        raise ValueError(f"cuda_interp_multi: grid {ny}x{nx} too small")
    rows, cols = px.shape
    if rows > _MAX_GRID_ROWS or rows * cols >= 2 ** 31:
        raise ValueError(f"cuda_interp_multi: {rows}x{cols} positions "
                         f"exceed the launch grid")

    from ._build import load_library
    fn = getattr(load_library(), _ENTRY[fields.dtype])
    out = torch.empty((nf, rows, cols), dtype=fields.dtype, device=px.device)
    if rows and cols:
        stream = torch.cuda.current_stream(px.device).cuda_stream
        rc = fn(fields.data_ptr(), coeffs.data_ptr(), px.data_ptr(),
                py.data_ptr(), out.data_ptr(), ny, nx, rows, cols,
                int(row_offset), order, nf, f0, float(x_min),
                float(x_max) - float(x_min), float(y_min),
                float(y_max) - float(y_min), stream)
        if rc != 0:
            raise RuntimeError(f"spline_gather launch failed: CUDA error "
                               f"{rc}")
        LAUNCHES += 1
    return out, torch.zeros((), dtype=torch.int32, device=px.device)
