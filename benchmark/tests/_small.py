"""Cells cut to a size the CPU tests can hold: the configurations' grids at
5 degrees and a few levels, the series' record to a few windows."""
import copy

from benchmark import harness

SEED = 2 ** 31 + 4099
CELLS = ("global-resident", "cli-t20", "global-series-month")


def small(name: str, ny: int = 37, nx: int = 72, levels: int = 5) -> dict:
    c = copy.deepcopy(harness.cell(name))
    c["config"]["grid"].update(ny=ny, nx=nx, lon_last=-180.0 + 360.0
                               * (nx - 1) / nx)
    c["config"]["levels"] = levels
    if c["traffic"]["entry"] == "series":
        c["traffic"]["record_levels"] = levels + 4
    if c["traffic"]["entry"] == "facade":
        c["config"]["levels"] = 3
    return c
