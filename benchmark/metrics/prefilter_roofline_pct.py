"""Share of its roofline that the prefilter reaches on the card.

Device time: the kernels whose launch the profiler's Python stacks place
inside ``prefilter`` (``ops/interp.py``), whatever implements it, over the
fields of the stack-traced stretch.  Bound: the work the function needs,
each wind component's raw levels read once and its coefficients written
once: 2 components x 2 x levels x ny x nx x itemsize bytes (548.2 MB at
the flagship: 33 levels of 721 x 1440 in float32), over 3.35 TB/s.
"""
import numpy as np

from benchmark import peaks, trace

NEEDS = ("stack",)
FUNCTIONS = (("ops/interp.py", "prefilter"),)


def bytes_needed(levels: int, ny: int, nx: int, itemsize: int) -> int:
    return 2 * 2 * levels * ny * nx * itemsize


def read(run):
    hit = trace.device_time_in(run.stack, FUNCTIONS)
    if hit is None:
        return None
    g = run.cfg["grid"]
    b = bytes_needed(run.cfg["levels"], g["ny"], g["nx"],
                     np.dtype(run.cfg["dtype"]).itemsize)
    return peaks.share_pct(peaks.bound_s(nbytes=b), hit[0] / run.stack_units)
