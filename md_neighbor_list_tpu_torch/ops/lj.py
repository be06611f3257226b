"""LJ force/energy evaluation over padded neighbour rows (PyTorch port of
``md_neighbor_list_tpu/ops/lj.py``).

For every listed pair inside rc, accumulate ``f = 24(2 s6^2 - s6)/r^2 * dr``;
half lists apply Newton's third law by scattering ``-f*dr`` onto the partner
(``index_add_``: float atomics on the card, so forces there are not bitwise
from run to run; sentinel entries go to spare rows, ``SPARE_ROWS``). Full
lists trade twice the pair work for no scatter.

Rows are processed in chunks (a Python loop where the JAX package runs
``lax.fori_loop``; the last chunk is not padded), so peak memory is
O(chunk * K), independent of N; the energy and virial are summed per chunk in
f32, in the JAX order.
"""

from __future__ import annotations

import torch

from md_neighbor_list_tpu_torch.core.box import Box
from md_neighbor_list_tpu_torch.ops.common import (lj_force_scalar,
                                                   lj_pair_virial,
                                                   lj_potential)

# Spare force rows past the N real ones. A sentinel entry of a row (index N)
# carries a zero force; the JAX package scatters every one of them onto one
# extra row, which on the card would make all of a chunk's sentinel entries
# (most of its entries) atomic adds to a single address, serialized. They are
# spread over these rows instead, and cut off with them.
SPARE_ROWS = 1 << 16


def _chunks(pos: torch.Tensor, idx: torch.Tensor, box: Box, rc: float,
            chunk: int):
    """Yield (rows, idx_c (B, K), dr (B, K, 3), r2 (B, K), mask (B, K)) per
    chunk, ``rows`` the slice of its B <= ``chunk`` rows."""
    n = idx.shape[0]
    pos_gather = torch.cat([pos, pos.new_zeros((1, 3))])
    r2cut = float(torch.tensor(rc * rc, dtype=torch.float32))
    for start in range(0, n, chunk):
        rows = slice(start, min(start + chunk, n))
        idx_c = idx[rows]
        jpos = pos_gather[torch.clamp(idx_c, max=n).long()]  # (B, K, 3)
        dr = box.min_image(pos[rows, None, :] - jpos)
        r2 = torch.sum(dr * dr, dim=-1)
        yield rows, idx_c, dr, r2, (idx_c < n) & (r2 < r2cut)


def forces_energy(pos: torch.Tensor, idx: torch.Tensor, box: Box, rc: float,
                  half: bool, chunk: int = 8192,
                  energy_rows: torch.Tensor | None = None,
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Forces (N, 3) and total shifted potential energy (0-d f32) from padded
    rows.

    ``idx`` rows index into ``pos`` (same order); sentinel entries == N are
    masked. Energy counts each pair once (half rows are unique pairs; full
    rows are halved). ``energy_rows`` optionally restricts which rows
    contribute potential energy (a decomposition's owned-slot mask, so ghost
    rows do not count a pair twice)."""
    n = idx.shape[0]
    force = pos.new_zeros((n + SPARE_ROWS, 3))
    spare = n + torch.arange(min(chunk, n) * idx.shape[1],
                             device=pos.device) % SPARE_ROWS
    energy = pos.new_zeros(())
    for rows, idx_c, dr, r2, mask in _chunks(pos, idx, box, rc, chunk):
        fvec = lj_force_scalar(r2, mask)[..., None] * dr  # force on i from j
        force[rows] += torch.sum(fvec, dim=1)
        u_rows = torch.sum(lj_potential(r2, mask, rc), dim=1)  # (B,)
        if energy_rows is not None:
            u_rows = u_rows * energy_rows[rows].to(u_rows.dtype)
        u = torch.sum(u_rows)
        if half:
            # Newton-3 partner scatter: each listed pair pushes -f*dr onto j
            dst = idx_c.reshape(-1).long()
            dst = torch.where(dst < n, dst, spare[:dst.numel()])
            force.index_add_(0, dst, (-fvec).reshape(-1, 3))
            energy = energy + u
        else:
            energy = energy + 0.5 * u
    return force[:n], energy


def pe_virial(pos: torch.Tensor, idx: torch.Tensor, box: Box, rc: float,
              half: bool, chunk: int = 8192,
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(total shifted PE, total pair virial W) from padded rows: W = sum over
    unordered pairs of dr . F_pair; the instantaneous pressure is
    P = (2*KE + W) / (3*V). Same row chunks and pair attribution as
    ``forces_energy``."""
    energy = pos.new_zeros(())
    vir = pos.new_zeros(())
    scale = 1.0 if half else 0.5
    for _, _, _, r2, mask in _chunks(pos, idx, box, rc, chunk):
        energy = energy + scale * torch.sum(lj_potential(r2, mask, rc))
        vir = vir + scale * torch.sum(lj_pair_virial(r2, mask))
    return energy, vir
