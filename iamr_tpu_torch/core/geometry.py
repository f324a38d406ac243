"""Domain geometry metadata (host-side, static; the port's copy of
iamr_tpu/core/geometry.py).

Equivalent role to amrex::Geometry: physical domain extents, cell counts,
cell sizes, periodicity, coordinate system. Plain Python and numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Uniform-grid geometry for one AMR level.

    ncell: cells per dimension (nx, ny[, nz])
    prob_lo/prob_hi: physical domain bounds
    periodic: per-dim periodicity
    coord_sys: 0 = Cartesian, 1 = RZ (2D only)
    """

    ncell: Tuple[int, ...]
    prob_lo: Tuple[float, ...]
    prob_hi: Tuple[float, ...]
    periodic: Tuple[bool, ...]
    coord_sys: int = 0

    def __post_init__(self):
        dim = len(self.ncell)
        assert dim in (2, 3), f"dim must be 2 or 3, got {dim}"
        assert len(self.prob_lo) == dim and len(self.prob_hi) == dim
        assert len(self.periodic) == dim

    @property
    def dim(self) -> int:
        return len(self.ncell)

    @property
    def dx(self) -> Tuple[float, ...]:
        return tuple(
            (hi - lo) / n for lo, hi, n in zip(self.prob_lo, self.prob_hi, self.ncell)
        )

    @property
    def cell_volume(self) -> float:
        return float(np.prod(self.dx))

    def cell_centers_1d(self, d: int) -> np.ndarray:
        """Physical coordinates of cell centers along dimension d."""
        dx = self.dx[d]
        return self.prob_lo[d] + (np.arange(self.ncell[d]) + 0.5) * dx

    def node_coords_1d(self, d: int) -> np.ndarray:
        dx = self.dx[d]
        return self.prob_lo[d] + np.arange(self.ncell[d] + 1) * dx

    def cell_centers(self):
        """Meshgrid (ij indexing) of cell-center coordinates, one array per dim."""
        axes = [self.cell_centers_1d(d) for d in range(self.dim)]
        return np.meshgrid(*axes, indexing="ij")

    def face_centers(self, d: int):
        """Meshgrid of face-center coordinates for faces normal to dim d."""
        axes = [
            self.node_coords_1d(k) if k == d else self.cell_centers_1d(k)
            for k in range(self.dim)
        ]
        return np.meshgrid(*axes, indexing="ij")

    def node_centers(self):
        axes = [self.node_coords_1d(d) for d in range(self.dim)]
        return np.meshgrid(*axes, indexing="ij")

    def refine(self, ratio: int) -> "Geometry":
        return dataclasses.replace(
            self, ncell=tuple(n * ratio for n in self.ncell)
        )

    def coarsen(self, ratio: int) -> "Geometry":
        assert all(n % ratio == 0 for n in self.ncell)
        return dataclasses.replace(
            self, ncell=tuple(n // ratio for n in self.ncell)
        )
