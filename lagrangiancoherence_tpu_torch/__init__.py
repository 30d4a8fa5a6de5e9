"""lagrangiancoherence_tpu_torch — the PyTorch/CUDA port of lagrangiancoherence_tpu.

A second package beside the JAX one, which stays the reference.  Module
names match the JAX package so that each counterpart is easy to find.  The
port imports ``torch`` and never ``jax``; its one hand-written kernel, the
CUDA spline gather of ``ops/cuda_interp.py``, is built with ``nvcc`` at
first use on the GPU.

Public API (lazy-imported to keep ``import lagrangiancoherence_tpu_torch``
light):

- ``ftle_pipeline`` and ``FTLEPipeline`` (models.pipeline)
- ``parcel_propagation_core`` (models.settls)
- ``Grid`` (grid)
"""
from __future__ import annotations

__version__ = "0.1.0"

_EXPORTS = {
    "ftle_pipeline": "lagrangiancoherence_tpu_torch.models.pipeline",
    "FTLEPipeline": "lagrangiancoherence_tpu_torch.models.pipeline",
    "parcel_propagation_core": "lagrangiancoherence_tpu_torch.models.settls",
    "Grid": "lagrangiancoherence_tpu_torch.grid",
}

__all__ = sorted(_EXPORTS) + ["__version__"]


def __getattr__(name: str):
    if name in _EXPORTS:
        import importlib
        mod = importlib.import_module(_EXPORTS[name])
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return __all__
