"""What every kernel wrapper needs at a launch, kept cheap: the kernels run
for microseconds, so a launch must not cost the host more than they do.

``entry`` resolves a C entry point of the built library once per name and
dtype (``_build.load_library`` builds at first use and sets each entry
point's ``argtypes`` and ``restype`` once, so a call converts its pointers
and ints directly).  ``stream`` is the handle of torch's current stream on
a device, through ``torch._C._cuda_getCurrentRawStream`` where this torch
has it (no ``Stream`` object is made), else through
``torch.cuda.current_stream``.
"""
from __future__ import annotations

import torch

__all__ = ["SUFFIX", "entry", "stream"]

SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_ENTRIES = {}                 # (entry point, dtype) -> its ctypes function
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def entry(name: str, dtype: torch.dtype):
    """The ctypes function ``{name}_f32`` or ``{name}_f64``."""
    fn = _ENTRIES.get((name, dtype))
    if fn is None:
        from ._build import load_library
        fn = _ENTRIES[name, dtype] = getattr(load_library(),
                                             f"{name}_{SUFFIX[dtype]}")
    return fn


def stream(index: int) -> int:
    """The current CUDA stream's handle on device ``index``."""
    if _RAW_STREAM is not None:
        return _RAW_STREAM(index)
    return torch.cuda.current_stream(index).cuda_stream
