"""Which rank of a slab decomposition along z holds each atom and does each
pair's work, in plain PyTorch from the positions alone: the count behind the
slab sweep's roofline (``roofline/forces_half_slab.py``).

The box's z side is cut into ``mc_z`` cell layers, ``nz`` a rank: an atom's
layer is floor(z / (L / mc_z)) of its wrapped position (in float64; an atom
within rounding of a layer's face may fall on the other side than in the
program, which moves a count by a few in millions). A rank holds the atoms of
its layers; its ghost layer is the first layer of the rank above it. A pair
within the radius is the work of the rank that holds both atoms, or, across a
face between two ranks, of the rank below the face: the upper atom lies in
that rank's ghost layer. Where mc_z >= 3 every pair has one such rank.
"""

from __future__ import annotations

import torch

from mdbench.reference import lj


def layers(pos: torch.Tensor, L: float, mc_z: int) -> torch.Tensor:
    """(N,) int64: each atom's z cell layer."""
    z = torch.remainder(pos[:, 2].to(torch.float64), L)
    return torch.clamp(torch.floor(z / (L / mc_z)).to(torch.int64), 0,
                       mc_z - 1)


def rank_work(pos: torch.Tensor, L: float, r: float, mc_z: int, nz: int,
              rank: int) -> dict:
    """{"n": atoms held by ``rank``, "ghost": atoms of its ghost layer,
    "pairs_rc": the pairs within ``r`` that are its work}."""
    cz = layers(pos, L, mc_z)
    held = cz // nz == rank
    ghost = cz == ((rank + 1) * nz) % mc_z
    cells = lj.Cells(pos, L, r)
    mine = torch.nonzero(held)[:, 0]
    pairs = 0
    for b0 in range(0, mine.numel(), lj.BLOCK):
        i = mine[b0:b0 + lj.BLOCK]
        j = cells.candidates(i)
        ok = j >= 0
        jj = torch.clamp(j, min=0)
        d = cells.pos[jj] - cells.pos[i][:, None, :]
        d = d - L * torch.round(d / L)
        hit = ok & (torch.sum(d * d, dim=-1) < r * r)
        both = held[jj]
        above = torch.remainder(cz[jj] - cz[i][:, None], mc_z) == 1
        pairs += int(torch.sum(hit & ((both & (jj > i[:, None]))
                                      | (~both & above))))
    return {"n": int(held.sum()), "ghost": int(ghost.sum()),
            "pairs_rc": pairs}
