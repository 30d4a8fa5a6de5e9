"""Static grid metadata for the parcel lat/lon mesh (numpy only).

Counterpart of ``lagrangiancoherence_tpu/grid.py`` with the same fields and
the same ``mesh_xy``.  Coordinates live on the host as float64 arrays; the
torch code receives tensors plus this struct.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np

EARTH_RADIUS = 6371000.0  # metres, matches LagrangianCoherence LCS/LCS.py:23

__all__ = ["EARTH_RADIUS", "Grid", "global_quarter_degree_grid"]


@dataclasses.dataclass(frozen=True)
class Grid:
    """Regular lat/lon grid. ``lats``/``lons`` are ascending 1-D float64 host arrays.

    Latitudes in [-90, 90], longitudes in [-180, 180], both sorted ascending
    (LagrangianCoherence LCS/trajectory.py:38-39,49-52).
    """

    lats: np.ndarray
    lons: np.ndarray
    cyclic_x: bool = False

    def __post_init__(self):
        lats = np.asarray(self.lats, dtype=np.float64)
        lons = np.asarray(self.lons, dtype=np.float64)
        if lats.ndim != 1 or lons.ndim != 1:
            raise ValueError("lats and lons must be 1-D")
        if lats.size > 1 and not np.all(np.diff(lats) > 0):
            raise ValueError("lats must be ascending")
        if lons.size > 1 and not np.all(np.diff(lons) > 0):
            raise ValueError("lons must be ascending")
        object.__setattr__(self, "lats", lats)
        object.__setattr__(self, "lons", lons)

    @property
    def ny(self) -> int:
        return self.lats.shape[0]

    @property
    def nx(self) -> int:
        return self.lons.shape[0]

    @property
    def shape(self) -> tuple[int, int]:
        return (self.ny, self.nx)

    @property
    def y_min(self) -> float:
        return float(self.lats[0])

    @property
    def y_max(self) -> float:
        return float(self.lats[-1])

    @property
    def x_min(self) -> float:
        return float(self.lons[0])

    @property
    def x_max(self) -> float:
        return float(self.lons[-1])

    @cached_property
    def mesh_xy(self) -> tuple[np.ndarray, np.ndarray]:
        """Initial parcel positions: meshgrid(lons, lats)
        (LagrangianCoherence LCS/trajectory.py:68-70)."""
        px, py = np.meshgrid(self.lons, self.lats)
        return px, py

    def _key(self):
        return (self.lats.tobytes(), self.lons.tobytes(), self.cyclic_x)

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return isinstance(other, Grid) and self._key() == other._key()


def global_quarter_degree_grid() -> Grid:
    """The flagship benchmark grid: global 0.25 degrees, 721x1440 parcels."""
    lats = np.linspace(-90.0, 90.0, 721)
    lons = np.linspace(-180.0, 179.75, 1440)
    return Grid(lats=lats, lons=lons, cyclic_x=True)
