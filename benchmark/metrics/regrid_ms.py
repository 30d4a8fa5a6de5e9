"""The program's "Regrid to common global grid" span (both wind components,
ended by the copy back to the host), median over the window's calls of a
traced run, in milliseconds."""
import numpy as np

SPAN = "Regrid to common global grid"


def read(run):
    s = [sec for name, sec in run.spans if name == SPAN]
    return float(np.median(s) * 1e3) if s else None
