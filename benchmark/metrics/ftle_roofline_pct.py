"""Share of its roofline that the deformation gradient and norm reach on
the card.

Device time: the kernels whose launch the profiler's Python stacks place
inside ``flowmap_gradient`` or ``ftle_norm`` (``models/ftle.py``).  Bound:
bytes, the departure points read once and the field written once: 3 x ny x
nx x itemsize (12.46 MB at the flagship), 3.72 us at 3.35 TB/s.  Its
arithmetic (trigonometry of the sphere map, six stencils, a 2x2
eigenvalue) is a few hundred operations a point, 0.1 GFLOP, below the
bytes' bound.
"""
import numpy as np

from benchmark import peaks, trace

NEEDS = ("stack",)
FUNCTIONS = (("models/ftle.py", "flowmap_gradient"),
             ("models/ftle.py", "ftle_norm"))


def bytes_needed(ny: int, nx: int, itemsize: int) -> int:
    return 3 * ny * nx * itemsize


def read(run):
    hit = trace.device_time_in(run.stack, FUNCTIONS)
    if hit is None:
        return None
    g = run.cfg["grid"]
    b = bytes_needed(g["ny"], g["nx"], np.dtype(run.cfg["dtype"]).itemsize)
    return peaks.share_pct(peaks.bound_s(nbytes=b), hit[0] / run.stack_units)
