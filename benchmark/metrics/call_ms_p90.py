"""90th percentile of the wall milliseconds of every call completed in the
window (linear interpolation between order statistics)."""
import numpy as np


def read(run):
    return float(np.percentile(np.asarray(run.call_s) * 1e3, 90))
