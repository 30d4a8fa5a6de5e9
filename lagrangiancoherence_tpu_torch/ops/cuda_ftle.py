"""The flow-map gradient and the FTLE norm as two kernels on the card.

Counterpart of ``lagrangiancoherence_tpu/models/ftle.py`` and
``ops/stencil.py``, which leave both stages to XLA (no Pallas kernel).  The
kernels (``csrc/ftle_stencil.cu``) run the plain path's operations in its
order: ``ftle_gradient`` maps the departure points to the sphere, takes the
six float32 stencils (quirk Q6, cyclic in longitude) and their metric
divisions, and writes the (9, ny, nx) stack; ``ftle_norm`` reads a stack's
nine rows and writes the norm.  Their plain version is the PyTorch path of
``models/ftle.py``, which every CPU tensor takes and which they are held
against on the card bit for bit.

Both take CUDA tensors only and raise on anything the kernels do not take;
``models/ftle.py`` chooses between them and the plain path.  ``LAUNCHES``
counts calls that launched each kernel, so a run can show that its FTLE
went through them.
"""
from __future__ import annotations

import torch

from ._launch import SUFFIX, entry, stream

__all__ = ["DTYPES", "LAUNCHES", "MIN_SIZE", "ftle_gradient", "ftle_norm",
           "gradient_dtype", "reset_launches"]

DTYPES = tuple(SUFFIX)
LAUNCHES = {"ftle_gradient": 0, "ftle_norm": 0}
# the stencil's two-point reach: below 5 rows the edge rules overlap and
# below 5 columns the rolls wrap more than once, which the plain path keeps
MIN_SIZE = 5


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def gradient_dtype(dtype: torch.dtype) -> torch.dtype:
    """The stack's dtype for departure points in ``dtype``: the longitude
    rows' division widens to the default dtype (``ops/stencil.py``)."""
    return torch.promote_types(dtype, torch.get_default_dtype())


def _check_cuda(name: str, t: torch.Tensor) -> None:
    if t.dtype not in DTYPES:
        raise TypeError(f"{name}: dtype {t.dtype} not supported (float32, "
                        f"float64)")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: needs a CUDA tensor, got device "
                         f"{t.device}; the CPU takes the plain path of "
                         f"models/ftle.py")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _launch(name: str, dtype: torch.dtype, device: torch.device, *args):
    # the launch goes to the current device: make it the tensors'
    with torch.cuda.device(device):
        rc = entry(name, dtype)(*args, stream(device.index))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def ftle_gradient(x_dep: torch.Tensor, y_dep: torch.Tensor, dx: torch.Tensor,
                  dy: float) -> torch.Tensor:
    """(9, ny, nx) deformation stack of departure lon/lat ``x_dep``,
    ``y_dep`` (ny, nx), contiguous CUDA tensors of one float dtype with
    ny, nx >= ``MIN_SIZE``; ``dx`` is ``stencil.row_scale`` (ny,) in
    ``gradient_dtype``, ``dy`` ``stencil.lat_scale``.  Returns the stack in
    ``gradient_dtype``."""
    if x_dep.ndim != 2 or min(x_dep.shape) < MIN_SIZE:
        raise ValueError(f"ftle_gradient: needs (ny, nx) with ny, nx >= "
                         f"{MIN_SIZE}, got shape {tuple(x_dep.shape)}")
    if y_dep.dtype != x_dep.dtype or y_dep.device != x_dep.device \
            or y_dep.shape != x_dep.shape:
        raise TypeError(f"ftle_gradient: y_dep must match x_dep "
                        f"({x_dep.dtype}, {x_dep.device}, "
                        f"{tuple(x_dep.shape)}), got {y_dep.dtype}, "
                        f"{y_dep.device}, {tuple(y_dep.shape)}")
    _check_cuda("ftle_gradient", x_dep)
    _check_cuda("ftle_gradient", y_dep)
    ny, nx = x_dep.shape
    out_dtype = gradient_dtype(x_dep.dtype)
    if dx.dtype != out_dtype or dx.device != x_dep.device \
            or tuple(dx.shape) != (ny,) or not dx.is_contiguous():
        raise ValueError(f"ftle_gradient: dx must be contiguous ({ny},) in "
                         f"{out_dtype} on {x_dep.device}, got "
                         f"{tuple(dx.shape)} {dx.dtype} on {dx.device}")
    out = torch.empty((9, ny, nx), dtype=out_dtype, device=x_dep.device)
    _launch("ftle_gradient", x_dep.dtype, x_dep.device, x_dep.data_ptr(),
            y_dep.data_ptr(), dx.data_ptr(), out.data_ptr(), ny, nx,
            float(dy), int(out_dtype == torch.float64))
    return out


def ftle_norm(stack: torch.Tensor, compat: bool = True) -> torch.Tensor:
    """Per-point 2-norm of a (9, ...) deformation stack, a contiguous
    float32 or float64 CUDA tensor: a tensor of ``stack.shape[1:]``."""
    if stack.ndim < 1 or stack.shape[0] != 9:
        raise ValueError(f"ftle_norm: needs a (9, ...) stack, got shape "
                         f"{tuple(stack.shape)}")
    _check_cuda("ftle_norm", stack)
    out = torch.empty(stack.shape[1:], dtype=stack.dtype,
                      device=stack.device)
    if out.numel():
        _launch("ftle_norm", stack.dtype, stack.device, stack.data_ptr(),
                out.data_ptr(), out.numel(), int(bool(compat)))
    return out
