"""Median wall milliseconds of every call completed in the window."""
import numpy as np


def read(run):
    return float(np.percentile(np.asarray(run.call_s) * 1e3, 50))
