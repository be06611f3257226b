"""Slab forms of the dense kernels (PyTorch port of
``md_neighbor_list_tpu/ops/slab_kernels.py``).

The box is split along z into P slabs of ``nz`` z-layers each. A rank holds
the dense cell-block layout of its owned layers and, for the sweeps, one ghost
layer of rows after them:

    extended rows axis: [ owned: nz*mc rows | right ghost: mc rows ]

Only the RIGHT ghost layer (the next rank's first owned layer) is read: the
half sweep's offsets have dz >= 0, so the pairs across a slab's LOWER face are
evaluated by the left neighbour, which returns their Newton-3 reaction as one
contiguous layer, the ``seam``. Every halo payload is a contiguous layer
block.

The sweeps are the slab forms of the half-sweep kernels
(``dense_force.dense_lists_half_slab`` / ``dense_forces_half_slab``: no wrap
in z, the partner layer taken from the array). The ring's seam +L shift is
baked into the ghost positions by the receiving rank, so every pair's
arithmetic is the single-box cube's, bit for bit. The rebuild is
``dense_cells.sort_expand`` with ``key_base = mc*mc``.

Validity is a bool tensor here where the JAX functions take it as f32, and
no function takes an ``interpret`` flag: the tensors' device decides.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from md_neighbor_list_tpu_torch.ops import dense_force
from md_neighbor_list_tpu_torch.ops.dense_cells import (DenseState,
                                                        park_lattice,
                                                        sort_expand)


@dataclasses.dataclass(frozen=True)
class SlabSpec:
    """Static geometry of one rank's slab of the dense layout.

    Cells are ANISOTROPIC: x/y use the finest valid grid (mc = floor(L/rs)
    cells, cell_size = L/mc) while z uses mc_z = P*nz cells (cell_z =
    L/mc_z >= rs), so rounding the z cell count down to a multiple of P
    coarsens one dimension only. The sweep stays a 27-neighbourhood: each
    dimension's cell edge is >= rs."""

    mc: int  # x/y cells per dim (full box)
    nz: int  # owned z-layers of this rank
    mc_z: int  # GLOBAL z cells = P * nz
    cap: int  # slots per cell
    L: float  # box side
    cell_size: float  # L / mc  (x/y; >= search radius)
    cell_z: float  # L / mc_z (z;   >= search radius)

    @property
    def rows(self) -> int:  # owned (z, y) cell rows
        return self.nz * self.mc

    @property
    def ncells(self) -> int:
        return self.rows * self.mc

    @property
    def slots(self) -> int:
        return self.ncells * self.cap

    def ext(self) -> "SlabSpec":
        """Spec covering the extended (owned + right ghost layer) block."""
        return dataclasses.replace(self, nz=self.nz + 1)


@functools.lru_cache(maxsize=8)
def _ghost_park(spec: SlabSpec, device: torch.device) -> torch.Tensor:
    """(3, mc, mc, cap): the park lattice of the ghost layer's ext-local rows
    nz*mc.. (made once per geometry and device)."""
    return park_lattice(spec.ext(), device)[:, spec.rows:].contiguous()


def _repark_ghost(ext_pos: torch.Tensor, ext_valid: torch.Tensor,
                  spec: SlabSpec) -> torch.Tensor:
    """Re-park the ghost layer's EMPTY slots with ext-local row ids.

    Each rank parks its empty slots with RANK-LOCAL row ids, so a received
    ghost layer carries the sender's ids, and at nz = 1 the sender's
    first-layer park y-values coincide with the receiver's own first layer's:
    two parked slots would meet in the (dz=1, dy=0) window at r2 = 0 and give
    NaN forces. Re-parking the ghost rows at ext-local ids (rows nz*mc..)
    restores the collision-free lattice. Real ghost positions (and their seam
    shift) pass through untouched."""
    rows = spec.rows
    g = torch.where(ext_valid[rows:][None], ext_pos[:, rows:],
                    _ghost_park(spec, ext_pos.device))
    return torch.cat([ext_pos[:, :rows], g], dim=1)


def slab_forces_half(ext_pos: torch.Tensor, ext_valid: torch.Tensor,
                     spec: SlabSpec, rc: float, want_pe: bool = False):
    """Half-sweep Newton-3 LJ forces over one rank's slab.

    ``ext_pos`` (3, (nz+1)*mc, mc, cap) f32 and ``ext_valid``
    ((nz+1)*mc, mc, cap) bool: owned rows followed by the right-ghost layer
    (positions already seam-shifted).

    Returns (force (3, nz*mc, mc, cap), seam (3, mc, mc, cap), pe | None):
    ``force`` is complete EXCEPT for the reactions computed by the left
    neighbour; ``seam`` holds this rank's reactions onto its right-ghost
    layer, to be shifted right and added to the receiver's first layer. PE
    is attributed once per pair, to the evaluating rank's own slot. Both
    tensors are views of one array."""
    force, pe = dense_force.dense_forces_half_slab(
        _repark_ghost(ext_pos, ext_valid, spec), spec, rc, want_pe)
    return force[:, :spec.rows], force[:, spec.rows:], pe


def slab_forces_interior(pos: torch.Tensor, spec: SlabSpec, rc: float):
    """Half-sweep forces of the owned INTERIOR layers: every pair that does
    not touch the ghost layer, so the per-step ghost shift can be in flight
    while this runs.

    ``pos`` (3, nz*mc, mc, cap): the owned state only; the grid walks layers
    0..nz-2. Requires nz >= 2.

    Returns (f_low (3, (nz-1)*mc, mc, cap), top_rxn (3, mc, mc, cap)):
    ``f_low`` is the complete force on layers 0..nz-2 from the interior
    pairs; ``top_rxn`` is the reaction of layer nz-2 onto layer nz-1, to be
    added to the boundary pass's own-layer force. Layer 0 still needs the
    left neighbour's seam."""
    if spec.nz < 2:
        raise ValueError("the interior split needs >= 2 owned layers")
    force, _ = dense_force.dense_forces_half_slab(pos, spec, rc)
    cut = (spec.nz - 1) * spec.mc
    return force[:, :cut], force[:, cut:]


def slab_forces_boundary(last_pos: torch.Tensor, gpos: torch.Tensor,
                         gvalid: torch.Tensor, spec: SlabSpec, rc: float):
    """Half-sweep forces of the LAST owned layer: the only part of the force
    pass that reads the ghost layer, run after the ghost shift lands.

    ``last_pos`` (3, mc, mc, cap): the last owned layer (its empty slots on
    the rank-local park lattice); ``gpos`` / ``gvalid``: the received
    right-ghost layer, seam-shifted, re-parked here at ext-local rows as
    ``_repark_ghost`` does, so each pair's arithmetic is the combined
    pass's.

    Returns (f_last (3, mc, mc, cap), seam (3, mc, mc, cap)): the own-layer
    force from the boundary pairs (add ``slab_forces_interior``'s top_rxn and
    the left neighbour's seam) and the Newton-3 reaction onto the ghost layer
    to shift right."""
    g = torch.where(gvalid[None], gpos, _ghost_park(spec, gpos.device))
    force, _ = dense_force.dense_forces_half_slab(
        torch.cat([last_pos, g], dim=1), spec, rc)
    return force[:, :spec.mc], force[:, spec.mc:]


def slab_lists_half(ext_pos: torch.Tensor, ext_valid: torch.Tensor,
                    spec: SlabSpec, radius: float):
    """Slab form of ``dense_lists_half``: (counts, masks) over the owned rows,
    each pair attributed to the evaluating rank (ghost-layer pairs to the
    lower slab), so global pairs = the sum over ranks of sum(counts * valid).
    The masks have ``dense_lists_half``'s layout."""
    return dense_force.dense_lists_half_slab(
        _repark_ghost(ext_pos, ext_valid, spec), spec, radius)


def slab_keys(pos: torch.Tensor, valid: torch.Tensor, spec: SlabSpec,
              z0_cell: int, wrap: bool = True) -> torch.Tensor:
    """Per-slot sort key of the slab rebuild, over WRAPPED positions
    ``pos`` (3, ...) and ``valid`` (...).

    With s = (iz_global - z0 + 1) mod mc_z (z0 = this rank's first global
    z-cell): s = 0 marks a LEFT emigrant, s in [1, nz] an owned layer,
    s = nz + 1 a RIGHT emigrant, s > nz + 1 a lost particle (moved more than
    one layer since the last rebuild: impossible under the skin protocol,
    dropped and caught by the global count check). The key x + mc*(y + mc*s)
    sorts emigrants below/above the owned key range [mc^2, mc^2*(nz+1)),
    which ``slab_sort_expand`` drops. Invalid slots get the park key
    mc^2*(nz+2).

    ``wrap=False`` (the P = 1 self-halo mode, where nz = mc_z and z0 = 0):
    the ring mod would map the TOP owned layer (iz = mc_z - 1, s = 0) to a
    left-emigrant key and drop it; with no neighbours there are no
    emigrants, so s = iz + 1 directly and every valid slot is owned."""
    mc = spec.mc
    inv = float(np.float32(1.0 / spec.cell_size))
    inv_z = float(np.float32(1.0 / spec.cell_z))
    ix = torch.clamp(torch.floor(pos[0] * inv).to(torch.int32), 0, mc - 1)
    iy = torch.clamp(torch.floor(pos[1] * inv).to(torch.int32), 0, mc - 1)
    iz = torch.clamp(torch.floor(pos[2] * inv_z).to(torch.int32), 0,
                     spec.mc_z - 1)
    s = iz - z0_cell + 1
    if wrap:
        s = torch.remainder(s, spec.mc_z)
    key = ix + mc * (iy + mc * s)
    return torch.where(valid, key, torch.full_like(key, mc * mc * (spec.nz + 2)))


def slab_sort_expand(keys: torch.Tensor, pos: torch.Tensor,
                     vel: torch.Tensor, pid: torch.Tensor,
                     spec: SlabSpec) -> tuple[DenseState, torch.Tensor]:
    """``sort_expand`` with the slab key layout (owned rows start at key
    mc^2, after the left-emigrant block): the K1 slab form. ``pos`` and
    ``vel`` (3, M) f32 and ``pid`` (M,) i32, where the JAX function sorts
    seven f32 channels, pid the seventh."""
    return sort_expand(keys, pos, vel, pid, spec, key_base=spec.mc * spec.mc)


__all__ = [
    "SlabSpec", "slab_forces_half", "slab_forces_interior",
    "slab_forces_boundary", "slab_lists_half", "slab_keys",
    "slab_sort_expand", "DenseState",
]
