"""Sort-based cell binning: spatial keys + a dense cell table (PyTorch port of
``md_neighbor_list_tpu/ops/binning.py``).

One key per particle (row-major cell id or Morton code), a stable sort to put
particles in spatial order, and each particle's rank within its cell from the
run starts of the sorted keys. Two key spaces coexist:
  - the *sort key* (Morton or row-major) fixes the particle memory order;
  - the *cell id* (always row-major) indexes the dense ``(mc^3, cap)`` cell
    table, so the 27-neighbour lookup is arithmetic.
Both are functions of the same integer cell coordinates, so they group
particles identically; only the order of cells differs.

Everything here is plain PyTorch on the positions' device: the JAX package
computes it in XLA, outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from md_neighbor_list_tpu_torch.core.box import Box
from md_neighbor_list_tpu_torch.ops.common import run_first_index

INACTIVE_KEY = 0x7FFFFFFF  # sort key of an inactive slot: after every cell


@dataclasses.dataclass(frozen=True)
class CellGrid:
    """Cell-grid geometry: ``mc`` cells per dim of edge ``cell_size`` >= the
    search radius, so all neighbours of a particle live in the 27 surrounding
    cells."""

    mc: int
    cell_size: float
    L: float

    @property
    def ncells(self) -> int:
        return self.mc**3

    @property
    def usable(self) -> bool:
        """The 27-sweep needs mc >= 3, or neighbour cells alias (pairs
        counted twice); smaller boxes take the all-pairs path."""
        return self.mc >= 3


def make_grid(box: Box, rs: float) -> CellGrid:
    mc = max(int(box.L / rs), 1)
    return CellGrid(mc=mc, cell_size=box.L / mc, L=box.L)


def cell_coords(pos: torch.Tensor, grid: CellGrid) -> torch.Tensor:
    """(N, 3) int32 cell coordinates in [0, mc). Clipped for fp-edge safety
    (a wrapped coordinate can round to exactly L). The scale is the f32
    constant 1/cell_size, as the JAX package takes it."""
    scale = float(np.float32(1.0 / grid.cell_size))
    c = torch.floor(pos * scale).to(torch.int32)
    return torch.clamp(c, 0, grid.mc - 1)


def rowmajor_key(coords: torch.Tensor, mc: int) -> torch.Tensor:
    """c = ix + mc*(iy + mc*iz): the dense cell id."""
    return coords[..., 0] + mc * (coords[..., 1] + mc * coords[..., 2])


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of x so bit k lands at position 3k (int32)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_key(coords: torch.Tensor) -> torch.Tensor:
    """30-bit Morton (Z-order) code from 3x10-bit cell coordinates (mc up to
    1024)."""
    return (_part1by2(coords[..., 0])
            | (_part1by2(coords[..., 1]) << 1)
            | (_part1by2(coords[..., 2]) << 2))


def morton_decode(key: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`morton_key`."""

    def compact(x):
        x = x & 0x09249249
        x = (x | (x >> 2)) & 0x030C30C3
        x = (x | (x >> 4)) & 0x0300F00F
        x = (x | (x >> 8)) & 0x030000FF
        x = (x | (x >> 16)) & 0x000003FF
        return x

    return torch.stack([compact(key), compact(key >> 1), compact(key >> 2)],
                       dim=-1)


class BinData(NamedTuple):
    """Result of binning N particles.

    All particle-indexed fields are in *sorted order*; ``perm[s]`` is the
    pre-sort row of the particle now in slot ``s`` (gather ``x[perm]`` to
    reorder any per-particle tensor)."""

    perm: torch.Tensor  # (N,)  i32
    coords: torch.Tensor  # (N, 3) i32 cell coordinates, sorted order
    table: torch.Tensor  # (ncells, cell_cap) i32 sorted indices, pad N
    cell_max: torch.Tensor  # ()  i32 max particles observed in any cell
    overflow: torch.Tensor  # ()  bool cell table overflow (cell_max > cap)
    active: torch.Tensor | None = None  # (N,) bool sorted order; None = all


def bin_particles(pos: torch.Tensor, grid: CellGrid, cell_cap: int,
                  layout: str = "morton",
                  active: torch.Tensor | None = None) -> BinData:
    """Sort particles spatially and build the dense cell -> particles table.

    A particle's rank within its cell is its sorted row minus the first row
    of its key's run. Ranks >= cell_cap are dropped from the table and
    reported through ``cell_max`` for the overflow protocol.

    ``active``: optional validity mask for fixed-capacity slot arrays.
    Inactive particles sort to the end (key INT32_MAX) and never enter the
    table, so they can never be pair candidates."""
    if layout not in ("morton", "rowmajor"):
        raise ValueError(f"unknown layout {layout!r}")
    n = pos.shape[0]
    coords = cell_coords(pos, grid)
    cell = rowmajor_key(coords, grid.mc)
    sort_key = morton_key(coords) if layout == "morton" else cell
    if active is not None:
        sort_key = torch.where(active, sort_key,
                               torch.full_like(sort_key, INACTIVE_KEY))

    sorted_key, order = torch.sort(sort_key, stable=True)
    coords_s = coords[order]
    cell_s = cell[order]
    active_s = None if active is None else active[order]

    iota = torch.arange(n, dtype=torch.int32, device=pos.device)
    rank = iota - run_first_index(sorted_key)
    if active_s is None:
        cell_max = torch.max(rank) + 1
    else:
        # inactive slots land in the spare row below, cut off with it
        cell_s = torch.where(active_s, cell_s,
                             torch.full_like(cell_s, grid.ncells))
        cell_max = torch.max(torch.where(active_s, rank,
                                         torch.full_like(rank, -1))) + 1

    # the JAX dropping scatter: a spare row and a spare column take the
    # inactive slots and the ranks >= cell_cap, and are cut off
    table = torch.full((grid.ncells + 1, cell_cap + 1), n, dtype=torch.int32,
                       device=pos.device)
    table[cell_s.long(), torch.clamp(rank, max=cell_cap).long()] = iota
    return BinData(perm=order.to(torch.int32), coords=coords_s,
                   table=table[:grid.ncells, :cell_cap].contiguous(),
                   cell_max=cell_max, overflow=cell_max > cell_cap,
                   active=active_s)


# The 27-neighbourhood offset table (dx fastest), moved to the device where a
# sweep uses it.
NEIGHBOR_OFFSETS = np.array(
    [[dx, dy, dz]
     for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)],
    dtype=np.int32,
)  # (27, 3)
