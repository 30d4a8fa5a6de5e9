"""lagrangiancoherence_tpu_torch — the PyTorch/CUDA port of lagrangiancoherence_tpu.

A second package beside the JAX one, which stays the reference.  Module
names match the JAX package so that each counterpart is easy to find.  The
port imports ``torch`` and never ``jax``.  Its hand-written CUDA kernels are
built with ``nvcc`` at first use on the GPU: the fused SETTLS step
``settls_step`` (``ops/csrc/settls_step.cu``, through
``ops/cuda_settls.py``) on the default gather route; K1 ``spline_gather``
(``ops/csrc/spline_gather.cu``, through ``ops/cuda_interp.py``), one gather
group per launch; and ``tier_window_gather`` (the spline window tiers: every
tile routes itself) and the pole ladder ``pole_ladder_gather``
(``ops/csrc/window_gather.cu``, through ``ops/cuda_window.py``) on the
windowed route (``engine="blockspec"`` or ``"dma"``, on the whole grid or
on latitude blocks).  The entry
points compute on the card unless asked for the CPU (``devices.py``).

Public API (lazy-imported to keep ``import lagrangiancoherence_tpu_torch``
light):

- ``LCS``, ``parcel_propagation``, ``flowmap_gradient`` and ``latlonsel``
  (api), each with ``device=``
- ``Field`` and ``as_field`` (field)
- ``find_ridges_spherical_hessian`` (models.ridges), ``filter_ridges``
  (models.ridge_filter) and ``find_area`` (models.area)
- ``ftle_pipeline`` and ``FTLEPipeline`` (models.pipeline)
- ``parcel_propagation_core`` (models.settls)
- ``ftle_sharded``, ``parcel_propagation_sharded`` and ``ftle_batch``
  (parallel.pipeline): the latitude-block and batch pipelines over a
  ``parallel.mesh`` mesh of devices, run as a loop over its blocks in one
  process (a device may repeat: one card runs N blocks in sequence)
- ``ftle_series`` and ``ftle_series_to_files`` (runners): one FTLE field a
  window of a long wind record, uploaded once, through one
  ``FTLEPipeline``
- ``Grid`` (grid)

Beside them, ``utils/profiling.py`` (``trace``, ``StageTimer``,
``device_memory_stats``), ``utils/debug.py`` (``checked_ftle``,
``nan_debug``), ``testing/`` (the analytic flows and the scipy oracle),
``examples/`` (``python -m lagrangiancoherence_tpu_torch.examples.
ideal_vortex``, ``.area_of_influence``) and ``entry.py`` (``entry``,
``dryrun_multichip``: the counterpart of the JAX package's
``__graft_entry__.py``).
"""
from __future__ import annotations

__version__ = "0.1.0"

_EXPORTS = {
    "LCS": "lagrangiancoherence_tpu_torch.api",
    "parcel_propagation": "lagrangiancoherence_tpu_torch.api",
    "flowmap_gradient": "lagrangiancoherence_tpu_torch.api",
    "latlonsel": "lagrangiancoherence_tpu_torch.api",
    "Field": "lagrangiancoherence_tpu_torch.field",
    "as_field": "lagrangiancoherence_tpu_torch.field",
    "find_ridges_spherical_hessian": "lagrangiancoherence_tpu_torch.models.ridges",
    "filter_ridges": "lagrangiancoherence_tpu_torch.models.ridge_filter",
    "find_area": "lagrangiancoherence_tpu_torch.models.area",
    "ftle_pipeline": "lagrangiancoherence_tpu_torch.models.pipeline",
    "FTLEPipeline": "lagrangiancoherence_tpu_torch.models.pipeline",
    "parcel_propagation_core": "lagrangiancoherence_tpu_torch.models.settls",
    "Grid": "lagrangiancoherence_tpu_torch.grid",
    "ftle_sharded": "lagrangiancoherence_tpu_torch.parallel.pipeline",
    "ftle_batch": "lagrangiancoherence_tpu_torch.parallel.pipeline",
    "parcel_propagation_sharded":
        "lagrangiancoherence_tpu_torch.parallel.pipeline",
    "ftle_series": "lagrangiancoherence_tpu_torch.runners",
    "ftle_series_to_files": "lagrangiancoherence_tpu_torch.runners",
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
