"""Host-to-card rate of the series' record upload, in GB/s (1e9 bytes).

Bytes: computed, not traced: both wind components' levels of the record
at the configuration's itemsize, 2 x record_levels x ny x nx x itemsize a
call (1,029,934,080 at the month's 124 levels of 721 x 1440 in float32),
times the window's calls.  Seconds: the program's "Series record upload"
spans of a traced run's window, summed (one a call; None otherwise).
"""
import numpy as np

SPAN = "Series record upload"


def bytes_per_call(levels: int, ny: int, nx: int, itemsize: int) -> int:
    return 2 * levels * ny * nx * itemsize


def read(run):
    s = [sec for name, sec in run.spans if name == SPAN]
    if not s or len(s) != run.calls or sum(s) <= 0:
        return None
    g = run.cfg["grid"]
    b = bytes_per_call(run.traffic["record_levels"], g["ny"], g["nx"],
                       np.dtype(run.cfg["dtype"]).itemsize)
    return b * run.calls / sum(s) / 1e9
