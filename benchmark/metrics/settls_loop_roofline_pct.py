"""Share of its roofline that the SETTLS loop reaches on the card.

Device time: the kernels whose launch the profiler's Python stacks place
inside ``settls_scan`` (``models/settls.py``): on the direct route the
coefficients' interleave and the 32 fused steps.  Bound: the larger of the
operations over 67 TFLOP/s and the bytes over 3.35 TB/s, counting only the
work the function needs.

Operations, per parcel and step, for cubic taps: each position evaluated
needs the B-spline weights of its two axes (13 operations an axis: 1 - t,
t^2, t^3, (1-t)^2, (1-t)^3, two scalings, 3 for w1 and 3 for w2) and the
16 products of a y weight and an x weight; each field evaluated there needs
16 multiply-adds (32 operations).  A step evaluates 2 fields at the start
position (the Euler guess) and 4 fields at each of ``settls_order``
iterates: (26 + 16 + 2 x 32) + 4 x (26 + 16 + 4 x 32) = 786 operations at
SETTLS-4, against the 992 of the kernel table (which also counts the
kernel's own index and fold arithmetic).  Index scaling, folds, mirrors,
divisions and the position update are not counted, so that no better
kernel can read over 100%.  At the flagship: 1,038,240 parcels x 32 steps
x 786 = 26.11 GFLOP, 0.3898 ms.

Bytes: both components' coefficients read once (2 x levels x ny x nx x
itemsize), the raw winds of the 2 x order pole-home rows, which take the
bilinear path, read once, and the positions read and written once (4 x ny
x nx x itemsize): 293.0 MB at the flagship, 0.0875 ms.  The operations
bound it.
"""
import numpy as np

from benchmark import peaks, trace

NEEDS = ("stack",)
FUNCTIONS = (("models/settls.py", "settls_scan"),)
WEIGHTS_PER_AXIS = 13
TAPS = 16


def ops_per_parcel_step(settls_order: int) -> int:
    position = 2 * WEIGHTS_PER_AXIS + TAPS
    per_field = 2 * TAPS
    return (position + 2 * per_field) + settls_order * (position
                                                        + 4 * per_field)


def ops_needed(levels, ny, nx, settls_order) -> int:
    return ny * nx * (levels - 1) * ops_per_parcel_step(settls_order)


def bytes_needed(levels, ny, nx, itemsize, order) -> int:
    coeffs = 2 * levels * ny * nx * itemsize
    pole_raw = 2 * levels * 2 * order * nx * itemsize
    positions = 4 * ny * nx * itemsize
    return coeffs + pole_raw + positions


def bound(cfg) -> float:
    g = cfg["grid"]
    item = np.dtype(cfg["dtype"]).itemsize
    return peaks.bound_s(
        flops=ops_needed(cfg["levels"], g["ny"], g["nx"], cfg["settls_order"]),
        nbytes=bytes_needed(cfg["levels"], g["ny"], g["nx"], item,
                            cfg["interp_order"]))


def read(run):
    hit = trace.device_time_in(run.stack, FUNCTIONS)
    if hit is None:
        return None
    return peaks.share_pct(bound(run.cfg), hit[0] / run.stack_units)
