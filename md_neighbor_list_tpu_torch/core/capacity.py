"""Capacity policy for fixed-shape padded rows and cell tables (PyTorch port
of ``md_neighbor_list_tpu/core/capacity.py``).

Estimates are ideal-gas means inflated by a Poisson fluctuation margin and a
multiplicative safety factor, rounded up to a multiple of ``align``. They are
starting points only: the consumer detects an overflow and grows, it never
truncates.
"""

from __future__ import annotations

import dataclasses
import math


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class Capacity:
    """Capacities for one (N, rho, rs) problem."""

    neighbors: int  # K: padded neighbor slots per particle
    cell: int  # max particles per cell in the dense cell table
    growth: float = 1.5  # multiplier applied on overflow

    def grown(self) -> "Capacity":
        return dataclasses.replace(
            self,
            neighbors=round_up(int(self.neighbors * self.growth) + 8, 8),
            cell=round_up(int(self.cell * self.growth) + 8, 8),
        )


def _poisson_upper(mean: float, sigmas: float) -> float:
    """Mean + ``sigmas`` standard deviations of a Poisson count."""
    return mean + sigmas * math.sqrt(max(mean, 1.0))


def estimate(rho: float, rs: float, cell_size: float, half_list: bool,
             safety: float = 1.2, sigmas: float = 8.0,
             align: int = 8) -> Capacity:
    """Capacity estimate for density ``rho``, search radius ``rs`` and cell
    edge ``cell_size``. ``sigmas`` is generous on purpose (the largest of
    ~1e5 Poisson counts sits many sigmas above the mean)."""
    mean_nbrs = rho * (4.0 / 3.0) * math.pi * rs**3
    if half_list:
        mean_nbrs *= 0.5
    k = round_up(int(_poisson_upper(mean_nbrs, sigmas) * safety) + 1, align)

    mean_cell = rho * cell_size**3
    cap = round_up(int(_poisson_upper(mean_cell, sigmas) * safety) + 1, align)
    return Capacity(neighbors=k, cell=cap)


def estimate_neighbors(rho: float, rs: float, half_list: bool,
                       safety: float = 1.2, sigmas: float = 8.0,
                       align: int = 8) -> int:
    """K alone, for the all-pairs route, which has no cell grid:
    ``estimate(...).neighbors``, which does not depend on the cell size."""
    return estimate(rho, rs, 1.0, half_list, safety, sigmas, align).neighbors
