"""The reference's own binning of positions into the cells of a cube, in plain
PyTorch with nothing of the program: the cells of ``lj.Cells`` (mc = floor(L
/ r) a side, side L / mc, the key x + mc * (y + mc * z)), computed in float64
from the float32 positions wrapped into the box.

  cell_keys   each particle's cell key
  misplaced   how many particles sit in a cell other than the one their
              position gives, beyond the rounding band at a cell face

The band: the program bins a float32 position by a float32 product, so a
particle within about 1e-5 of a cell face may fall on either side of it
there. A particle whose position lies within ``lj.BAND`` of a face may sit in
either cell on that face, and anywhere else it has one cell.
"""

from __future__ import annotations

import math

import torch

from mdbench.reference.lj import BAND


def cells_a_side(L: float, r: float) -> int:
    return int(math.floor(float(L) / float(r)))


def _coords(pos: torch.Tensor, L: float, mc: int) -> torch.Tensor:
    """(N, 3) float64: each wrapped coordinate in cell sides."""
    return torch.remainder(pos.to(torch.float64), float(L)) * (mc / float(L))


def cell_keys(pos: torch.Tensor, L: float, r: float) -> torch.Tensor:
    """(N,) int64: the key of the cell of each position (N, 3)."""
    mc = cells_a_side(L, r)
    c = torch.clamp(torch.floor(_coords(pos, L, mc)).to(torch.int64), 0,
                    mc - 1)
    return c[:, 0] + mc * (c[:, 1] + mc * c[:, 2])


def misplaced(key: torch.Tensor, pos: torch.Tensor, L: float,
              r: float) -> int:
    """The particles whose cell ``key`` (N,) is not the cell of their
    position ``pos`` (N, 3): on some axis their coordinate lies more than
    ``BAND`` outside the cell's extent (the first and last cells reach to
    the box's faces, where the wrap may round onto L)."""
    mc = cells_a_side(L, r)
    t = _coords(pos, L, mc)
    c = torch.stack([key % mc, (key // mc) % mc, key // (mc * mc)], dim=1)
    band = BAND * mc / float(L)
    lo = torch.where(c == 0, -math.inf, c - band)
    hi = torch.where(c == mc - 1, math.inf, c + 1 + band)
    out = (key < 0) | (key >= mc**3) | torch.any((t < lo) | (t > hi), dim=1)
    return int(torch.sum(out))
