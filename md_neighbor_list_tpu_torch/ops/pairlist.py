"""27-cell pair sweep -> fixed-capacity padded neighbour lists (PyTorch port
of ``md_neighbor_list_tpu/ops/pairlist.py``).

Visit the 27 cells around each particle's cell (periodic), test every
candidate against the search radius and compact the hits into per-particle
rows; half lists drop Newton-3 duplicates. This is the *correctness* sweep,
plain PyTorch on the positions' device: gathers from the dense cell table,
one distance mask and cumsum-based compaction. The fast path is the dense
cell-block engine (``ops/dense_cells.py`` + ``ops/dense_force.py``).

Rows are processed in chunks of ``chunk`` particles (a Python loop writing
into preallocated outputs where the JAX package maps over padded chunk
starts; the last chunk is not padded here), so the (chunk, 27*cell_cap)
candidate tile is the only large intermediate.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from md_neighbor_list_tpu_torch.core.box import Box
from md_neighbor_list_tpu_torch.ops import oracle
from md_neighbor_list_tpu_torch.ops.binning import (BinData, CellGrid,
                                                    bin_particles,
                                                    rowmajor_key)
from md_neighbor_list_tpu_torch.ops.common import compact_rows


# Rows whose entries the stable build translates at once
TRANSLATE_ROWS = 1 << 16


class NeighborLists(NamedTuple):
    """Padded neighbour lists over *sorted* particle order.

    ``idx[i, :]`` holds sorted-space neighbour indices of sorted particle i,
    padded with the sentinel N; ``perm`` maps sorted slot -> pre-sweep row so
    callers can reorder their own per-particle state to match."""

    idx: torch.Tensor  # (N, K) i32
    count: torch.Tensor  # (N,)  i32 true neighbour count (may exceed K!)
    perm: torch.Tensor  # (N,)  i32
    max_count: torch.Tensor  # () i32  max over particles of count
    cell_max: torch.Tensor  # () i32  max particles in any cell
    overflow: torch.Tensor  # () bool  any capacity exceeded


def _r2_f32(radius: float) -> float:
    """radius^2 rounded to f32, as the mask compares it."""
    return float(torch.tensor(radius * radius, dtype=torch.float32))


def sweep_from_bins(pos_sorted: torch.Tensor, bins: BinData, box: Box,
                    grid: CellGrid, radius: float, k_cap: int, half: bool,
                    chunk: int = 2048) -> tuple[torch.Tensor, torch.Tensor]:
    """For each sorted particle, gather the 27 neighbour cells' candidates
    from the table and compact the in-range ones into K slots.

    Returns (idx (N, K), count (N,)). Candidate validity is an explicit
    ``cand < N`` mask. Half lists keep ``cand > i`` in sorted order. r2 is
    summed as dx*dx + dy*dy + dz*dz, each product and sum rounded to f32.
    The mask is the JAX package's bit for bit except for a pair whose r2
    lies within an ulp of the cutoff: XLA on the CPU contracts the sum into
    fused multiply-adds, which can put such a pair one ulp on the other side
    (``tests/test_torch_cutoff_band.py``)."""
    n = pos_sorted.shape[0]
    dev = pos_sorted.device
    cell_cap = bins.table.shape[1]
    idx = torch.empty((n, k_cap), dtype=torch.int32, device=dev)
    cnt = torch.empty((n,), dtype=torch.int32, device=dev)
    # a sentinel row keeps the gathers in bounds; masked out by cand < n
    pos_gather = torch.cat([pos_sorted, pos_sorted.new_zeros((1, 3))])
    # NEIGHBOR_OFFSETS (dx fastest, then dy, dz) made on the device: a copy
    # from the host would have no place in a captured graph
    k = torch.arange(27, dtype=torch.int32, device=dev)
    offsets = torch.stack([k % 3, k // 3 % 3, k // 9], dim=-1) - 1
    r2cut = _r2_f32(radius)

    for start in range(0, n, chunk):
        rows = slice(start, start + chunk)
        c = bins.coords[rows]  # (B, 3)
        i_sorted = torch.arange(start, start + c.shape[0], dtype=torch.int32,
                                device=dev)[:, None]
        nbr_coords = torch.remainder(c[:, None, :] + offsets[None], grid.mc)
        nbr_cell = rowmajor_key(nbr_coords, grid.mc)  # (B, 27)
        cand = bins.table[nbr_cell.long()].reshape(c.shape[0], 27 * cell_cap)

        cpos = pos_gather[torch.clamp(cand, max=n).long()]  # (B, C, 3)
        dr = box.min_image(pos_sorted[rows, None, :] - cpos)
        r2 = dr[..., 0] * dr[..., 0] + dr[..., 1] * dr[..., 1] \
            + dr[..., 2] * dr[..., 2]

        mask = (cand < n) & (r2 < r2cut) & (cand != i_sorted)
        if half:
            mask &= cand > i_sorted
        if bins.active is not None:
            # inactive rows emit empty lists (inactive particles never enter
            # the table, so the candidates are clean already)
            mask &= bins.active[rows, None]
        idx[rows], cnt[rows] = compact_rows(cand, mask, k_cap, fill=n)
    return idx, cnt


def build_neighbor_lists(pos: torch.Tensor, box: Box, grid: CellGrid,
                         radius: float, k_cap: int, cell_cap: int,
                         half: bool, layout: str = "morton",
                         chunk: int = 2048
                         ) -> tuple[torch.Tensor, NeighborLists]:
    """Bin + sweep. Returns (pos_sorted, NeighborLists).

    Takes the all-pairs oracle when the box is too small for a 27-sweep
    (grid.mc < 3): same output contract, so tiny systems and large ones
    share every downstream consumer."""
    n = pos.shape[0]
    if not grid.usable:
        idx, cnt = oracle.neighbors(pos, box, radius, k_cap, half)
        mx = torch.max(cnt)
        return pos, NeighborLists(
            idx=idx, count=cnt,
            perm=torch.arange(n, dtype=torch.int32, device=pos.device),
            max_count=mx,
            cell_max=torch.zeros((), dtype=torch.int32, device=pos.device),
            overflow=mx > k_cap)

    bins = bin_particles(pos, grid, cell_cap, layout)
    pos_sorted = pos[bins.perm.long()]
    idx, cnt = sweep_from_bins(pos_sorted, bins, box, grid, radius, k_cap,
                               half, chunk)
    mx = torch.max(cnt)
    return pos_sorted, NeighborLists(
        idx=idx, count=cnt, perm=bins.perm, max_count=mx,
        cell_max=bins.cell_max, overflow=(mx > k_cap) | bins.overflow)


def build_neighbor_lists_stable(pos: torch.Tensor, box: Box, grid: CellGrid,
                                radius: float, k_cap: int, cell_cap: int,
                                half: bool, layout: str = "morton",
                                active: torch.Tensor | None = None,
                                chunk: int = 2048) -> NeighborLists:
    """Sweep that leaves particle order untouched: rows and entries of the
    returned ``idx`` are in the *caller's* slot order.

    Bins and sorts like the fast path, then translates both the row order
    and the entry values back through the permutation."""
    n = pos.shape[0]
    if not grid.usable:
        raise ValueError(
            "cell grid too small for 27-sweep (mc < 3); stable builds need a "
            "usable grid")
    bins = bin_particles(pos, grid, cell_cap, layout, active)
    perm = bins.perm.long()
    idx_s, cnt_s = sweep_from_bins(pos[perm], bins, box, grid, radius, k_cap,
                                   half, chunk)
    # sorted-space entries -> original slots (sentinel n -> n), a block of
    # rows at a time: no (N, K) int64 index or second (N, K) copy is made
    perm_ext = torch.cat([bins.perm, bins.perm.new_full((1,), n)])
    idx = torch.empty_like(idx_s)
    for start in range(0, n, TRANSLATE_ROWS):
        rows = slice(start, start + TRANSLATE_ROWS)
        idx[perm[rows]] = perm_ext[torch.clamp(idx_s[rows], max=n).long()]
    cnt = torch.zeros_like(cnt_s)
    cnt[perm] = cnt_s
    mx = torch.max(cnt)
    return NeighborLists(
        idx=idx, count=cnt,
        perm=torch.arange(n, dtype=torch.int32, device=pos.device),
        max_count=mx, cell_max=bins.cell_max,
        overflow=(mx > k_cap) | bins.overflow)
