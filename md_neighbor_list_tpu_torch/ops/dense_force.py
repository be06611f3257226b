"""Sweep kernels of the dense engine: the half-sweep neighbour-list build,
Newton-3 LJ forces, pe/virial observable pass and counts, and the full
27-cell sweep's forces and counts (the symmetric parity passes).

This module is the port of ``md_neighbor_list_tpu/ops/pallas_force.py`` (the
name changes because nothing here is Pallas): ``dense_lists_half``,
``dense_forces_half``, ``dense_pe_virial``, ``dense_counts_half``,
``dense_forces`` and ``dense_counts`` launch hand-written CUDA kernels
(``csrc/lists_half.cu``, which also holds the half count, ``force_half.cu``,
``pe_virial_half.cu`` and ``force_full.cu``, which also holds the full count)
on CUDA tensors; ``build_half_list``, the NVE step's half list, launches
``csrc/list_sparse.cu``, and ``dense_forces_list``, the step's force over
the half list of its last rebuild, ``csrc/force_list.cu``.
Beside each stands its plain PyTorch version (``lists_half_plain``,
``forces_half_plain``, ``pe_virial_half_plain``, ``counts_half_plain``,
``forces_full_plain``, ``counts_full_plain``, ``build_half_list_plain``,
``forces_list_plain``), taken only for tensors that
lie on the CPU; it is what the CPU tests run and what the kernels are held against
on the card.

Half sweep: every unordered pair is visited once. The own cell (z, y, x)
sees, for each of the five offset rows ``HALF_OFFSETS5[k] = (dz, dy)``, a
window of 3*cap lanes: the x-cells x-1, x, x+1 of row (z+dz, y+dy), each
moved by -L/+L where it wrapped around the box. In the own row (k = 0) the
x-1 segment is left to the neighbour's sweep and inside the own cell only
slot j > i is kept.

CONTRACT of the half sweep: ``pos4`` satisfies the park invariant
(``dense_cells``): empty slots sit on the park lattice, so no validity input
exists and they receive exactly zero force, count and mask bits.

Every kernel has one body for every cap. The list and half-count kernels
(``csrc/lists_half.cu``) and the half-force and pe/virial kernels
(``csrc/half_sweep.cuh``) stage the occupied slots of the cell and of its 14
partner cells (x < OCCUPIED_BELOW) and test those only; the full-force and
full-count kernels likewise stage the valid slots of the 27 cells
(``csrc/force_full.cu``). Where a cell's partners do not fit the shared
memory a block plans for, they are staged in passes.

Slab forms of the half sweep (``dense_lists_half_slab``,
``dense_forces_half_slab``): the same kernels over an array of nz_arr z-layers,
(3, nz_arr*mc, mc, cap), walking its first nz_arr - 1 layers with no wrap in
z: the partner layer of layer z is z + dz itself, and the last layer is read
only as a partner. The slab engine (``ops/slab_kernels.py``) reads its owned
layers followed by a ghost layer this way, or its owned layers alone, or its
last owned layer and the ghost. x and y wrap as in the cube.

Full sweep: every pair is visited from both partners over all nine (dz, dy)
rows, nothing is written outside the own cell, and totals over slots count
each pair twice. It takes ``valid`` and honours it whatever the state holds:
a slot with ``valid`` False gives nothing and receives nothing, even at an
in-box position (``make_windows`` parks by ``valid``).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from md_neighbor_list_tpu_torch.ops import _cuda
from md_neighbor_list_tpu_torch.ops.common import lj_shift
from md_neighbor_list_tpu_torch.ops.dense_cells import (PARK_BASE,
                                                       park_positions)

HALF_OFFSETS5 = [(0, 0), (0, 1), (1, -1), (1, 0), (1, 1)]

MASK_BITS = 32  # bits per packed i32 mask word

# The half-sweep kernels (lists, counts, forces, pe/virial) test occupied
# slots only: a slot whose stored x lies below this holds a particle, a
# parked one lies above.
OCCUPIED_BELOW = PARK_BASE / 2
# Box sides from this up are refused: a position drifts a little past the box
# between rebuilds and an image-shifted partner lies below 2 L, so L stays
# under a quarter of OCCUPIED_BELOW, far from it.
MAX_BOX = PARK_BASE / 8


def mask_words(cap: int) -> int:
    """Packed mask words per (window lane, offset row): one bit per own
    slot, MASK_BITS bits per word."""
    return (cap + MASK_BITS - 1) // MASK_BITS


def _f32(x: float) -> float:
    return float(np.float32(x))


def _check_state(pos4: torch.Tensor, spec, zwrap: bool = True) -> int:
    """Check the state a half- or full-sweep wrapper reads; return its
    z-layers. The cube forms (``zwrap``) take (3, mc*mc, mc, cap); the slab
    forms (3, nz_arr*mc, mc, cap) with nz_arr >= 2."""
    mc, cap = spec.mc, spec.cap
    if spec.L >= MAX_BOX:
        raise ValueError(
            f"box side {spec.L} too large for the park lattice: the sweep "
            f"kernels tell occupied slots by x < {OCCUPIED_BELOW:g} and "
            f"need L < {MAX_BOX:g}")
    rows = mc * mc if zwrap or pos4.dim() != 4 else pos4.shape[1]
    if pos4.shape != (3, rows, mc, cap) or pos4.dtype != torch.float32:
        raise ValueError(
            f"expected f32 positions of shape {(3, rows, mc, cap)}, "
            f"got {pos4.dtype} {tuple(pos4.shape)}")
    if zwrap and spec.rows != rows:
        raise ValueError("the sweep kernels take the cubic layout only")
    if not zwrap and (rows % mc or rows < 2 * mc):
        raise ValueError(f"a slab form reads whole z-layers of {mc} rows, at "
                         f"least two; got {rows} rows")
    if pos4.is_cuda:
        _cuda.check_cuda(pos4)
    return rows // mc


def _check_valid(valid: torch.Tensor, pos4: torch.Tensor, spec) -> None:
    if valid.shape != (spec.rows, spec.mc, spec.cap) or \
            valid.dtype != torch.bool:
        raise ValueError(
            f"expected bool validity of shape {(spec.rows, spec.mc, spec.cap)}"
            f", got {valid.dtype} {tuple(valid.shape)}")
    if pos4.is_cuda:
        _cuda.check_cuda(pos4, valid)


# ----------------------------------------------------- plain sweep geometry
def _half_keep(cap: int, device) -> torch.Tensor:
    """(cap, 3cap) bool: pairs the own row (k = 0) keeps."""
    slot = torch.arange(cap, device=device)[:, None]
    lane = torch.arange(3 * cap, device=device)[None, :]
    return (lane >= 2 * cap) | ((lane >= cap) & (lane - cap > slot))


def _layer_pairs(grid: torch.Tensor, spec, z: int, r2cut: float,
                 zwrap: bool = True):
    """For own z-layer ``z`` of ``grid`` (3, mcz, mcy, mcx, cap), yield per
    offset row k: (dz, dy, dxv, dyv, dzv, hit), each (mcy, mcx, cap, 3cap),
    d = own - partner with the partner's periodic image pre-shifted. Without
    ``zwrap`` (slab forms) the partner layer is z + dz of the array as it is."""
    mc, cap = spec.mc, spec.cap
    dev = grid.device
    fL = _f32(spec.L)
    own = grid[:, z]  # (3, mcy, mcx, cap)
    xcell = torch.arange(mc, device=dev)[None, :, None]
    sh_m = torch.where(xcell == 0, -fL, 0.0).to(torch.float32)
    sh_p = torch.where(xcell == mc - 1, fL, 0.0).to(torch.float32)
    yrow = torch.arange(mc, device=dev)[:, None, None, None]
    keep0 = _half_keep(cap, dev)
    for k, (dz, dy) in enumerate(HALF_OFFSETS5):
        zp = (z + dz) % mc if zwrap else z + dz
        nbr = torch.roll(grid[:, zp], -dy, dims=1)  # row y+dy at y
        left = torch.roll(nbr, 1, dims=2)  # cell x holds x-1's data
        right = torch.roll(nbr, -1, dims=2)
        wx = torch.cat([left[0] + sh_m, nbr[0], right[0] + sh_p], dim=-1)
        wy = torch.cat([left[1], nbr[1], right[1]], dim=-1)
        wz = torch.cat([left[2], nbr[2], right[2]], dim=-1)
        xj, yj, zj = wx[:, :, None, :], wy[:, :, None, :], wz[:, :, None, :]
        if dy == 1:
            yj = yj + torch.where(yrow + 1 >= mc, fL, 0.0).to(torch.float32)
        elif dy == -1:
            yj = yj + torch.where(yrow - 1 < 0, -fL, 0.0).to(torch.float32)
        if zwrap and dz == 1 and z + 1 >= mc:
            zj = zj + fL
        dxv = own[0][..., None] - xj
        dyv = own[1][..., None] - yj
        dzv = own[2][..., None] - zj
        r2 = dxv * dxv + dyv * dyv + dzv * dzv
        hit = r2 < r2cut
        if k == 0:
            hit = hit & keep0
        yield k, dz, dy, dxv, dyv, dzv, r2, hit


def _grid(a: torch.Tensor, spec) -> torch.Tensor:
    """(..., layers*mc, mc, cap) -> (..., layers, mc, mc, cap)."""
    return a.reshape(a.shape[:-3] + (-1, spec.mc, spec.mc, spec.cap))


# -------------------------------------------------------------- K2: lists
def lists_half_plain(pos4: torch.Tensor, spec, radius: float,
                     zwrap: bool = True):
    """Plain PyTorch version of ``dense_lists_half`` (and, without
    ``zwrap``, of ``dense_lists_half_slab``), one z-layer at a time."""
    mc, cap = spec.mc, spec.cap
    words = mask_words(cap)
    dev = pos4.device
    grid = _grid(pos4, spec)
    nz = mc if zwrap else grid.shape[1] - 1  # layers walked
    r2cut = _f32(radius * radius)
    masks = torch.empty((5, words, nz, mc, mc, 3 * cap), dtype=torch.int32,
                        device=dev)
    counts = torch.zeros((nz, mc, mc, cap), dtype=torch.int32, device=dev)
    weight = (torch.ones((), dtype=torch.int64, device=dev)
              << (torch.arange(cap, device=dev) % MASK_BITS))[:, None]
    for z in range(nz):
        for k, _, _, _, _, _, _, hit in _layer_pairs(grid, spec, z, r2cut,
                                                     zwrap):
            counts[z] += hit.sum(dim=-1, dtype=torch.int32)
            bits = hit * weight  # (mcy, mcx, cap, 3cap) i64, distinct bits
            for w in range(words):
                word = bits[:, :, MASK_BITS * w:MASK_BITS * (w + 1)].sum(dim=2)
                # reinterpret the low 32 bits as i32 (bit 31 = sign bit)
                word = torch.where(word >= 2**31, word - 2**32, word)
                masks[k, w, z] = word.to(torch.int32)
    return (counts.reshape(nz * mc, mc, cap),
            masks.reshape(5, words, nz * mc, mc, 3 * cap))


def dense_lists_half(pos4: torch.Tensor, spec, radius: float):
    """The neighbour-list build artifact at ``radius``:

      counts (R, mc, cap) i32 — half neighbour count per slot (each
        unordered pair attributed once); total pairs = sum(counts * valid).
      masks (5, words, R, mc, 3cap) i32 — packed hit masks: for offset row k,
        cell row r, own cell x and window lane l, bit i of word w says own
        slot MASK_BITS*w + i of cell (r, x) has the (z+dz, y+dy) row's window
        lane l — partner cell x + l//cap - 1, slot l % cap — within
        ``radius``. The total popcount equals the total pair count.

    Kernel: ``csrc/lists_half.cu``, replacing ``_list_half_kernel`` and
    ``_list_half_kernel_grouped`` of md_neighbor_list_tpu/ops/pallas_force.py
    (same bits). Bound on this card by the mask write (5*words*3 words per
    slot). A block stages the occupied slots (x < OCCUPIED_BELOW) of the
    cell and of its 14 partner cells and tests those only, a lane building
    one word register per partner and storing it at the partner's lane;
    counts come from warp reductions, exact integers. CPU tensors take
    ``lists_half_plain``."""
    _check_state(pos4, spec)
    if not pos4.is_cuda:
        return lists_half_plain(pos4, spec, radius)
    shape = (spec.rows, spec.mc, spec.cap)
    masks = torch.empty((5, mask_words(spec.cap), spec.rows, spec.mc,
                         3 * spec.cap), dtype=torch.int32, device=pos4.device)
    counts = torch.empty(shape, dtype=torch.int32, device=pos4.device)
    _cuda.launch("lists_half", pos4, masks, counts, spec.mc, spec.cap,
                 _f32(spec.L), _f32(radius * radius), OCCUPIED_BELOW)
    return counts, masks


def dense_lists_half_slab(pos: torch.Tensor, spec, radius: float):
    """Slab form of ``dense_lists_half``: ``pos`` (3, nz_arr*mc, mc, cap),
    the first nz_arr - 1 layers walked with no z wrap (module docstring).
    Returns counts ((nz_arr-1)*mc, mc, cap) and masks (5, words,
    (nz_arr-1)*mc, mc, 3cap) in ``dense_lists_half``'s layout; the pairs
    with the last layer are attributed to the layer below it.

    Kernel: ``csrc/lists_half.cu``, entry ``lists_half_slab`` (the list
    kernel with ZWRAP = false), replacing the list kernels as
    md_neighbor_list_tpu/ops/slab_kernels.py::slab_lists_half runs them. CPU
    tensors take ``lists_half_plain(..., zwrap=False)``."""
    nz_arr = _check_state(pos, spec, zwrap=False)
    if not pos.is_cuda:
        return lists_half_plain(pos, spec, radius, zwrap=False)
    rows = (nz_arr - 1) * spec.mc
    masks = torch.empty((5, mask_words(spec.cap), rows, spec.mc,
                         3 * spec.cap), dtype=torch.int32, device=pos.device)
    counts = torch.empty((rows, spec.mc, spec.cap), dtype=torch.int32,
                         device=pos.device)
    _cuda.launch("lists_half_slab", pos, masks, counts, spec.mc, spec.cap,
                 _f32(spec.L), _f32(radius * radius), nz_arr - 1, nz_arr,
                 OCCUPIED_BELOW)
    return counts, masks


# ------------------------------------------------------------- K5: counts
def counts_half_plain(pos4: torch.Tensor, spec, radius: float) -> torch.Tensor:
    """Plain PyTorch version of ``dense_counts_half``."""
    grid = _grid(pos4, spec)
    r2cut = _f32(radius * radius)
    counts = torch.zeros(grid.shape[1:], dtype=torch.int32, device=pos4.device)
    for z in range(spec.mc):
        for *_, hit in _layer_pairs(grid, spec, z, r2cut):
            counts[z] += hit.sum(dim=-1, dtype=torch.int32)
    return counts.reshape(spec.rows, spec.mc, spec.cap)


def dense_counts_half(pos4: torch.Tensor, spec, radius: float) -> torch.Tensor:
    """Per-slot half neighbour counts (R, mc, cap) i32 at ``radius``: each
    unordered pair attributed once, to the own slot of the half sweep. Total
    pairs = sum(counts * valid). Equal, bitwise, to the ``counts`` of
    ``dense_lists_half`` and to ``mask_slot_counts`` of its masks.

    Kernel: ``csrc/lists_half.cu``, entry ``count_half`` (the list kernel
    without its masks), replacing ``_count_half_kernel`` of
    md_neighbor_list_tpu/ops/pallas_force.py. Bound by fp32 operations (the
    list kernel's distance tests with no mask to write). It tests occupied
    slots only (x < OCCUPIED_BELOW) and makes its counts as the list kernel
    does, by warp reductions, integers throughout (the TPU body sums f32 and
    casts). CPU tensors take ``counts_half_plain``."""
    _check_state(pos4, spec)
    if not pos4.is_cuda:
        return counts_half_plain(pos4, spec, radius)
    counts = torch.empty((spec.rows, spec.mc, spec.cap), dtype=torch.int32,
                         device=pos4.device)
    _cuda.launch("count_half", pos4, counts, spec.mc, spec.cap, _f32(spec.L),
                 _f32(radius * radius), OCCUPIED_BELOW)
    return counts


# ------------------------------------------------------------- K3: forces
def _lj_terms(r2: torch.Tensor, hit: torch.Tensor):
    """(s2, s6) with an exact divide; non-hits (r2 may be 0) read as r2 = 1."""
    s2 = 1.0 / torch.where(hit, r2, torch.ones_like(r2))
    return s2, s2 * s2 * s2


def forces_half_plain(pos4: torch.Tensor, spec, rc: float,
                      want_pe: bool = False, zwrap: bool = True):
    """Plain PyTorch version of ``dense_forces_half`` (and, without
    ``zwrap``, of ``dense_forces_half_slab``), one z-layer at a time:
    own-slot sums over window lanes, and the negated reaction summed over own
    slots, folded from window lanes onto partner cells
    (seg0[x+1] + seg1[x] + seg2[x-1]) and added at the partner row."""
    mc, cap = spec.mc, spec.cap
    grid = _grid(pos4, spec)
    nz = mc if zwrap else grid.shape[1] - 1  # layers walked
    r2cut = _f32(rc * rc)
    ushift = lj_shift(rc)
    force = torch.zeros_like(grid)
    pe = torch.zeros_like(grid[0, :nz]) if want_pe else None
    for z in range(nz):
        for _, dz, dy, dxv, dyv, dzv, r2, hit in _layer_pairs(grid, spec, z,
                                                              r2cut, zwrap):
            s2, s6 = _lj_terms(r2, hit)
            f = torch.where(hit, 24.0 * s6 * (2.0 * s6 - 1.0) * s2, 0.0)
            zp = (z + dz) % mc if zwrap else z + dz
            for c, d in enumerate((dxv, dyv, dzv)):
                p = f * d  # (mcy, mcx, cap, 3cap)
                force[c, z] += p.sum(dim=-1)
                r = p.sum(dim=-2)  # reaction per window lane (mcy, mcx, 3cap)
                fold = (torch.roll(r[..., :cap], -1, dims=1)
                        + r[..., cap:2 * cap]
                        + torch.roll(r[..., 2 * cap:], 1, dims=1))
                force[c, zp] -= torch.roll(fold, dy, dims=0)  # row y+dy
            if want_pe:
                u = torch.where(hit, 4.0 * (s6 * s6 - s6) - ushift, 0.0)
                pe[z] += u.sum(dim=-1)
    return (force.reshape(pos4.shape),
            pe.reshape(nz * mc, mc, cap) if want_pe else None)


def dense_forces_half(pos4: torch.Tensor, spec, rc: float,
                      want_pe: bool = False):
    """LJ forces via the half-sweep Newton-3 kernel — the hot force path.
    Returns (force (3, R, mc, cap), pe (R, mc, cap) | None). The per-slot PE
    is attributed once per pair, to the own slot of the half sweep: total
    PE = sum(pe * valid), no halving.

    Kernel: ``csrc/force_half.cu`` over ``csrc/half_sweep.cuh``, replacing
    ``_force_half_kernel`` of md_neighbor_list_tpu/ops/pallas_force.py
    together with the reaction fold and partner-row sums around it. Bound on
    this card by fp32 operations (the distance tests between occupied slots).
    A block per own cell stages the cell's occupied slots and the occupied
    partners of its five offset rows, compacted; partners lie along the
    lanes and keep their reactions in registers, the own-slot sums live in
    warp-private shared memory walked with a stagger (no atomic inside the
    block), and the pair term has no branch. Reactions and own-slot sums
    leave the block by one f32 atomicAdd per component and slot; their
    order varies between runs, so forces match the plain version to
    rounding, not bitwise. 1/r2 is correctly rounded in both forms.
    CPU tensors take ``forces_half_plain``."""
    _check_state(pos4, spec)
    if not pos4.is_cuda:
        return forces_half_plain(pos4, spec, rc, want_pe)
    force = torch.zeros_like(pos4)  # the kernel accumulates into it
    geom = (spec.mc, spec.cap, _f32(spec.L), _f32(rc * rc))
    if not want_pe:
        _cuda.launch("forces_half", pos4, force, *geom, OCCUPIED_BELOW)
        return force, None
    pe = torch.empty_like(pos4[0])
    _cuda.launch("forces_half_pe", pos4, force, pe, *geom,
                 _f32(lj_shift(rc)), OCCUPIED_BELOW)
    return force, pe


def dense_forces_half_slab(pos: torch.Tensor, spec, rc: float,
                           want_pe: bool = False):
    """Slab form of ``dense_forces_half``: ``pos`` (3, nz_arr*mc, mc, cap),
    the first nz_arr - 1 layers walked with no z wrap (module docstring).
    Returns (force shaped like ``pos``, pe ((nz_arr-1)*mc, mc, cap) | None).
    ``force`` holds every own-slot sum and every reaction: the last layer's
    is the reaction of the layer below onto it (the slab engine's seam, or its
    interior pass's top reaction). PE is attributed to the own slot.

    Kernel: ``csrc/force_half.cu``, entries ``forces_half_slab`` and
    ``forces_half_slab_pe`` (the half-force kernel of ``dense_forces_half``
    with ZWRAP = false: occupied slots only, so the ghost layer's
    re-parked slots are never tested),
    replacing the half-force kernel as
    md_neighbor_list_tpu/ops/slab_kernels.py runs it in
    ``slab_forces_half``, ``slab_forces_interior`` and
    ``slab_forces_boundary``: the reactions that the TPU kernel writes through
    its output maps land here by the kernel's atomics at the partner's slot,
    the seam layer included. CPU tensors take
    ``forces_half_plain(..., zwrap=False)``."""
    nz_arr = _check_state(pos, spec, zwrap=False)
    if not pos.is_cuda:
        return forces_half_plain(pos, spec, rc, want_pe, zwrap=False)
    force = torch.zeros_like(pos)  # the kernel accumulates into it
    geom = (spec.mc, spec.cap, _f32(spec.L), _f32(rc * rc))
    layers = (nz_arr - 1, nz_arr)
    if not want_pe:
        _cuda.launch("forces_half_slab", pos, force, *geom, *layers,
                     OCCUPIED_BELOW)
        return force, None
    pe = torch.empty(((nz_arr - 1) * spec.mc, spec.mc, spec.cap),
                     dtype=torch.float32, device=pos.device)
    _cuda.launch("forces_half_slab_pe", pos, force, pe, *geom,
                 _f32(lj_shift(rc)), *layers, OCCUPIED_BELOW)
    return force, pe


# ------------------------------------------------- K3 on the half list
# The NVE step's force between rebuilds reads the half list at rs that the
# last rebuild built (``build_half_list``): each slot's partners within rs in
# the ten sparse cells, K2's bits there counted and packed into per-slot
# partner lanes, then the step's forces (``dense_forces_list``). The
# window lanes are half_row_lane's numbering (csrc/half_sweep.cuh): partner cell pc = v // cap (0: the own cell, 1: its
# x+1, then cells x-1, x, x+1 of rows 1-4), slot v % cap. The force sweeps
# the four dense cells (the own cell and its face neighbours, where 71 % of
# the pairs lie) and walks the list in the ten others (csrc/force_list.cu).

# The largest cap the list-driven force takes: the block plans its shared
# memory within this (csrc/force_list.cu), and a window lane fits an int16.
LIST_MAX_CAP = 448
DENSE_CELLS = (0, 1, 3, 9)  # window cells the force sweeps
SPARSE_CELLS = (2, 4, 5, 6, 7, 8, 10, 11, 12, 13)  # and those it reads listed


class HalfList(NamedTuple):
    """The half list at rs of the state of one rebuild, as the step's force
    reads it (flat slots of the (R, mc, cap) arrays): each slot's partners
    in the ten sparse cells."""
    start: torch.Tensor  # (R, mc, cap) i32: each slot's first entry
    nsparse: torch.Tensor  # (R, mc, cap) i32: its partners listed
    lanes: torch.Tensor  # (capacity,) i16: partner window lanes by slot


def list_capacity(spec, n: int, rs: float) -> int:
    """Entries the list of ``n`` particles holds: their partners in the
    sparse cells at the largest density the cells hold on average (``cap``
    a cell). A partner at offset d (in cells; rs <= the cell size) of a
    particle anywhere in its cell lies in another cell along axis c with
    chance |d_c|, so in an edge or corner cell (two or three axes; the half
    window holds half of those) with, summed over the ball of radius
    r = rs / cell, half of the integral of |x||y| + |x||z| + |y||z| -
    2|x||y||z|: 4r^5/5 - r^6/6 cells. At N = 1M, cap 40 that is 24M entries
    (48 MB) against 13.0M in the liquid; it grows with cap. A multiple of 8
    (the force kernel reads a cell's entries 8 at a time)."""
    r = rs / spec.cell_size
    per = math.ceil((0.8 * r**5 - r**6 / 6.0) * spec.cap)
    return min(-(-n * per // 8) * 8, 2**31 - 8)


def half_list_buffers(spec, n: int, rs: float, device) -> HalfList:
    """Empty list buffers for ``n`` particles in ``spec`` at ``rs``."""
    shape = (spec.rows, spec.mc, spec.cap)
    return HalfList(
        start=torch.zeros(shape, dtype=torch.int32, device=device),
        nsparse=torch.zeros(shape, dtype=torch.int32, device=device),
        lanes=torch.zeros(list_capacity(spec, n, rs), dtype=torch.int16,
                          device=device))


def _window_lanes(cap: int, device):
    """(k, l) of every window lane v in [0, 14cap): its offset row and its
    lane within the row's 3cap."""
    v = torch.arange(14 * cap, device=device)
    k = torch.where(v < 2 * cap, 0, 1 + (v - 2 * cap) // (3 * cap))
    l = torch.where(v < 2 * cap, cap + v, v - 2 * cap - (k - 1) * 3 * cap)
    return k, l


def _cell_lanes(cells, cap: int, device) -> torch.Tensor:
    """The window lanes of ``cells``, cell by cell."""
    return torch.cat([torch.arange(pc * cap, (pc + 1) * cap, device=device)
                      for pc in cells])


@functools.lru_cache(maxsize=4)
def _window_slots(spec, device: str):
    """(ncells, 14cap) flat slot of each own cell's window lanes, and
    (3, ncells, 14cap) the image shift added to the partner's position."""
    mc, cap = spec.mc, spec.cap
    fL = _f32(spec.L)
    k, l = _window_lanes(cap, device)
    off = torch.tensor(HALF_OFFSETS5, device=device)[k]  # (14cap, 2)
    cell = torch.arange(mc**3, device=device)[:, None]
    x, y, z = cell % mc, (cell // mc) % mc, cell // (mc * mc)
    coords, shifts = [], []
    for c0, d in ((z, off[:, 0]), (y, off[:, 1]), (x, l // cap - 1)):
        c = c0 + d
        shifts.append(torch.where(c >= mc, fL, torch.where(c < 0, -fL, 0.0))
                      .to(torch.float32))
        coords.append(c % mc)
    zz, yy, xx = coords
    idx = ((zz * mc + yy) * mc + xx) * cap + l % cap
    return idx, torch.stack(shifts[::-1])  # shifts in x, y, z


def _sparse_bits(masks: torch.Tensor, spec):
    """K2's bits in the sparse cells: (slots, 10cap) 0/1, own slot by list
    column, and the window lane of each column (cell by cell of
    ``SPARSE_CELLS``, slot by slot: the list order)."""
    mc, cap = spec.mc, spec.cap
    dev = masks.device
    order = _cell_lanes(SPARSE_CELLS, cap, dev)
    k, l = _window_lanes(cap, dev)
    words = masks.reshape(5, -1, mc**3, 3 * cap)[k[order], :, :, l[order]]
    i = torch.arange(cap, device=dev)
    bits = (words[:, i // MASK_BITS, :] >> (i % MASK_BITS)[None, :, None]) & 1
    return bits.permute(2, 1, 0).reshape(spec.slots, -1), order


def count_half_list_plain(masks: torch.Tensor, counts: torch.Tensor,
                          nsparse: torch.Tensor, spec) -> None:
    """Each slot's count of K2's bits (``masks``) in the ten sparse cells
    (``SPARSE_CELLS``) into ``nsparse``: the length of its list."""
    bits, _ = _sparse_bits(masks, spec)
    nsparse.reshape(-1).copy_(bits.sum(1))


def pack_half_list_plain(masks: torch.Tensor, counts: torch.Tensor,
                         start: torch.Tensor, lanes: torch.Tensor,
                         spec) -> None:
    """The set bits of K2's masks in the ten sparse cells into the list:
    slot s's partners there at ``lanes[start[s]:start[s] + nsparse[s]]``,
    in list order (cell by cell of ``SPARSE_CELLS``, slot by slot), those
    past ``lanes.numel()`` dropped. The four dense cells' bits are not
    packed: the force sweeps those cells."""
    bits, order = _sparse_bits(masks, spec)
    n = bits.sum(1)
    slot, col = torch.nonzero(bits, as_tuple=True)
    before = torch.cumsum(n, 0) - n
    at = start.reshape(-1).long()[slot] + torch.arange(
        slot.numel(), device=masks.device) - before[slot]
    keep = at < lanes.numel()
    lanes[at[keep]] = order[col[keep]].to(torch.int16)


def build_half_list_plain(pos4: torch.Tensor, spec, rs: float,
                          out: HalfList) -> torch.Tensor:
    """Plain PyTorch version of ``build_half_list``: K2's masks and counts
    at ``rs`` (``lists_half_plain``), each slot's count of partners in the
    sparse cells, its start (an exclusive prefix sum of those counts,
    clipped at the capacity), then the pack."""
    counts, masks = lists_half_plain(pos4, spec, rs)
    count_half_list_plain(masks, counts, out.nsparse, spec)
    flat = out.nsparse.reshape(-1)
    ends = torch.cumsum(flat, 0, dtype=torch.int64)
    capacity = out.lanes.numel()
    out.start.reshape(-1).copy_(torch.clamp(ends - flat, max=capacity))
    pack_half_list_plain(masks, counts, out.start, out.lanes, spec)
    return ends[-1] > capacity


def build_half_list(pos4: torch.Tensor, spec, rs: float,
                    out: HalfList) -> torch.Tensor:
    """The half list at ``rs`` of the rebuilt state ``pos4`` into ``out``:
    each slot's partners within ``rs`` in the ten sparse cells
    (``SPARSE_CELLS``), K2's bits there (``dense_lists_half``), counted
    (``nsparse``), placed from each slot's start (an exclusive prefix sum of
    the counts over flat slots, clipped at the capacity) in list order (cell
    by cell of ``SPARSE_CELLS``, slot by slot), the entries past the
    capacity not stored. Returns a 0-d bool tensor: the list has more
    entries than its capacity, so some are not stored (the caller raises
    the carry's overflow flag). Nothing is read on the host.

    Kernel: ``csrc/list_sparse.cu`` (``list_sparse_kernel``), bitwise its
    plain version: a block per own cell tests its occupied slots against
    those of the ten sparse cells only, keeps the hits in shared memory,
    places the cell's entries by a single-pass scan over the cells
    (decoupled look-back, its status words zeroed by a kernel just before)
    and stores them as one contiguous range. No mask reaches device memory.
    CPU tensors take ``build_half_list_plain``."""
    _check_state(pos4, spec)
    if not pos4.is_cuda:
        return build_half_list_plain(pos4, spec, rs, out)
    _cuda.check_cuda(pos4, *out)
    if out.lanes.data_ptr() % 16:
        raise ValueError("the list's lanes must be 16-byte aligned")
    status = torch.empty(spec.mc**3 + 1, dtype=torch.int64, device=pos4.device)
    overflow = torch.empty((), dtype=torch.bool, device=pos4.device)
    _cuda.launch("list_sparse", pos4, out.start, out.nsparse, out.lanes,
                 status, overflow, spec.mc, spec.cap, _f32(spec.L),
                 _f32(rs * rs), OCCUPIED_BELOW, out.lanes.numel())
    return overflow


def list_pairs(lst: HalfList, spec):
    """The listed pairs (those in the sparse cells) that the list stores
    (none past its capacity): (own slot, partner slot) flat indices and the
    (3, pairs) image shift added to the partner's position."""
    dev = lst.lanes.device
    start = lst.start.reshape(-1).long()
    n = torch.clamp(torch.minimum(lst.nsparse.reshape(-1).long(),
                                  lst.lanes.numel() - start), min=0)
    own = torch.repeat_interleave(torch.arange(spec.slots, device=dev), n)
    before = torch.cumsum(n, 0) - n
    entry = start[own] + torch.arange(own.numel(), device=dev) - before[own]
    v = lst.lanes[entry].long()
    idx, shift = _window_slots(spec, str(dev))
    cell = own // spec.cap
    return own, idx[cell, v], shift[:, cell, v]


def dense_pairs(pos4: torch.Tensor, spec):
    """The occupied slot pairs of the dense cells, the half sweep's within
    them: (own slot, partner slot, (3, pairs) image shift). With
    ``list_pairs`` these are the pairs the step's force evaluates."""
    dev = pos4.device
    cap = spec.cap
    v = _cell_lanes(DENSE_CELLS, cap, dev)
    idx, shift = _window_slots(spec, str(dev))
    own = torch.arange(spec.slots, device=dev)[:, None]
    cell = own // cap
    part = idx[cell, v]  # (S, 4cap)
    occupied = pos4[0].reshape(-1) < OCCUPIED_BELOW
    keep = occupied[own] & occupied[part]
    keep &= (v >= cap) | (v % cap > own % cap)  # own cell: slot j > i
    o, j = torch.nonzero(keep, as_tuple=True)
    return o, part[o, j], shift[:, cell[o, 0], v[j]]


def forces_list_plain(pos4: torch.Tensor, lst: HalfList, spec,
                      rc: float) -> torch.Tensor:
    """Plain PyTorch version of ``dense_forces_list``: the pairs of the
    dense cells as the half sweep takes them and the list's pairs in the
    sparse cells, each pair's force added to the own slot and taken from
    the partner."""
    dev = pos4.device
    S = spec.slots
    p = pos4.reshape(3, S)
    force = torch.zeros((3, S), dtype=torch.float32, device=dev)
    for own, part, shift in (dense_pairs(pos4, spec),
                             list_pairs(lst, spec)):
        dxv, dyv, dzv = (p[c, own] - (p[c, part] + shift[c])
                         for c in range(3))
        r2 = dxv * dxv + dyv * dyv + dzv * dzv
        hit = r2 < _f32(rc * rc)
        s2, s6 = _lj_terms(r2, hit)
        f = torch.where(hit, 24.0 * s6 * (2.0 * s6 - 1.0) * s2, 0.0)
        for c, d in enumerate((dxv, dyv, dzv)):
            force[c].index_add_(0, own, f * d)
            force[c].index_add_(0, part, -(f * d))
    return force.reshape(pos4.shape)


def dense_forces_list(pos4: torch.Tensor, lst: HalfList, spec, rc: float,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """LJ forces (3, R, mc, cap) at ``rc`` over the pairs of the half list
    ``lst`` (``build_half_list`` at rs on the state of the last rebuild,
    whose slots and image shifts ``pos4`` still has): the NVE step's force
    between rebuilds. The same pairs as ``dense_forces_half`` on ``pos4``
    while no particle has moved more than skin/2 since that rebuild, each
    pair's force computed as there; added in another order. ``out``: the
    tensor to write (zeroed here), else a new one.

    Kernel: ``csrc/force_list.cu`` (``force_half_kernel<0, true>``, K3's
    trace name), replacing ``_force_half_kernel`` of
    md_neighbor_list_tpu/ops/pallas_force.py as the JAX step runs it: a
    block per own cell sweeps the own cell and its three face neighbours as
    ``dense_forces_half`` does (71 % of the pairs, at a hit rate near 40 %)
    and walks the list's entries in the ten edge and corner cells, four own
    slots a warp, each pair's reaction by a global atomicAdd. What bounds it
    is the 12 blocks an SM holds at 40 registers a thread, and what a block
    spills and keeps in shared memory, not the latency of its loads: a
    persistent form that staged the next cells' windows by asynchronous
    copies ran slower (PERF.md, section 6). CPU tensors take
    ``forces_list_plain``."""
    if spec.cap > LIST_MAX_CAP:
        raise ValueError(f"the list-driven force takes cap <= {LIST_MAX_CAP},"
                         f" got {spec.cap}")
    _check_state(pos4, spec)
    if not pos4.is_cuda:
        force = forces_list_plain(pos4, lst, spec, rc)
        return force if out is None else out.copy_(force)
    force = torch.zeros_like(pos4) if out is None else out.zero_()
    _cuda.check_cuda(pos4, lst.start, lst.nsparse, lst.lanes, force)
    _cuda.launch("forces_list", pos4, lst.start, lst.nsparse, lst.lanes,
                 force, spec.mc, spec.cap, _f32(spec.L), _f32(rc * rc),
                 OCCUPIED_BELOW, lst.lanes.numel())
    return force


# ---------------------------------------------------------- K4: pe/virial
def pe_virial_half_plain(pos4: torch.Tensor, spec, rc: float):
    """Plain PyTorch version of ``dense_pe_virial``."""
    mc, cap = spec.mc, spec.cap
    grid = _grid(pos4, spec)
    r2cut = _f32(rc * rc)
    ushift = lj_shift(rc)
    pe = torch.zeros_like(grid[0])
    vir = torch.zeros_like(grid[0])
    for z in range(mc):
        for _, _, _, _, _, _, r2, hit in _layer_pairs(grid, spec, z, r2cut):
            _, s6 = _lj_terms(r2, hit)
            pe[z] += torch.where(hit, 4.0 * (s6 * s6 - s6) - ushift,
                                 0.0).sum(dim=-1)
            vir[z] += torch.where(hit, 24.0 * s6 * (2.0 * s6 - 1.0),
                                  0.0).sum(dim=-1)
    shape = (spec.rows, mc, cap)
    return pe.reshape(shape), vir.reshape(shape)


def dense_pe_virial(pos4: torch.Tensor, spec, rc: float):
    """Per-slot (pe, virial) within the LJ cutoff, attributed once per pair:
    total PE = sum(pe * valid), total virial W = sum(vir * valid), pressure
    P = (2*KE + W) / (3*V).

    Kernel: ``csrc/pe_virial_half.cu``, replacing ``_pe_virial_half_kernel``
    of md_neighbor_list_tpu/ops/pallas_force.py. Bound by fp32 operations like
    the force kernel, whose body (``csrc/half_sweep.cuh``: occupied slots
    only, warp-private sums, no branch) it shares without the reaction:
    every sum stays inside the own cell's block and is folded in a fixed
    order, so no atomic is needed and the result repeats bitwise; parked
    slots get zeros.
    CPU tensors take ``pe_virial_half_plain``."""
    _check_state(pos4, spec)
    if not pos4.is_cuda:
        return pe_virial_half_plain(pos4, spec, rc)
    pe = torch.empty_like(pos4[0])
    vir = torch.empty_like(pos4[0])
    _cuda.launch("pe_virial_half", pos4, pe, vir, spec.mc, spec.cap,
                 _f32(spec.L), _f32(rc * rc), _f32(lj_shift(rc)),
                 OCCUPIED_BELOW)
    return pe, vir


# ------------------------------------------------ full sweep: windows, K6, K7
def make_windows(pos4: torch.Tensor, valid: torch.Tensor,
                 spec) -> torch.Tensor:
    """(R, 3, mc, 3cap) candidate windows: channels x, y, z; lane segments
    [x-1 | x | x+1] of every cell row, the wrapped segments' x moved by
    -L/+L. Slots with ``valid`` False sit on the park lattice, so validity is
    geometry: no pair with such a slot passes any cutoff.

    The input of the full sweep's plain versions. The CUDA kernels do not
    read a window array (it would triple the bytes they move): they read the
    state and ``valid`` and apply the shifts themselves."""
    mc = spec.mc
    w3 = park_positions(pos4, valid, spec)  # (3, R, mc, cap)
    left = torch.roll(w3, 1, dims=2)  # cell x holds x-1's data
    right = torch.roll(w3, -1, dims=2)
    xcell = torch.arange(mc, device=pos4.device)[None, :, None]
    fL = _f32(spec.L)
    left[0] += torch.where(xcell == 0, -fL, 0.0).to(torch.float32)
    right[0] += torch.where(xcell == mc - 1, fL, 0.0).to(torch.float32)
    out = torch.cat([left, w3, right], dim=-1)  # (3, R, mc, 3cap)
    return out.permute(1, 0, 2, 3).contiguous()


def _full_layer_pairs(windows: torch.Tensor, spec, z: int, r2cut: float):
    """For own z-layer ``z`` of ``windows`` (R, 3, mc, 3cap), yield per
    neighbour row (dz, dy): (dxv, dyv, dzv, r2, hit), each
    (mcy, mcx, cap, 3cap), d = own - partner; the self pair of the centre
    cell is no hit."""
    mc, cap = spec.mc, spec.cap
    dev = windows.device
    fL = _f32(spec.L)
    win = windows.reshape(mc, mc, 3, mc, 3 * cap)  # (z, y, channel, x, lane)
    own = win[z, :, :, :, cap:2 * cap]  # (mcy, 3, mcx, cap)
    yrow = torch.arange(mc, device=dev)[:, None, None, None]
    slot = torch.arange(cap, device=dev)[:, None]
    lane = torch.arange(3 * cap, device=dev)[None, :]
    not_self = lane - cap != slot  # (cap, 3cap)
    for dz in (-1, 0, 1):
        zsh = fL * float((z + dz) // mc)  # -L, 0 or +L
        for dy in (-1, 0, 1):
            nbr = torch.roll(win[(z + dz) % mc], -dy, dims=0)  # row y+dy at y
            ysh = fL * torch.div(yrow + dy, mc, rounding_mode="floor").to(
                torch.float32)
            dxv = own[:, 0, :, :, None] - nbr[:, 0, :, None, :]
            dyv = own[:, 1, :, :, None] - (nbr[:, 1, :, None, :] + ysh)
            dzv = own[:, 2, :, :, None] - (nbr[:, 2, :, None, :] + zsh)
            r2 = dxv * dxv + dyv * dyv + dzv * dzv
            hit = r2 < r2cut
            if dz == 0 and dy == 0:
                hit = hit & not_self
            yield dxv, dyv, dzv, r2, hit


def forces_full_plain(pos4: torch.Tensor, valid: torch.Tensor, spec,
                      rc: float, want_pe: bool = True):
    """Plain PyTorch version of ``dense_forces``, one z-layer at a time over
    ``make_windows``."""
    mc, cap = spec.mc, spec.cap
    windows = make_windows(pos4, valid, spec)
    r2cut = _f32(rc * rc)
    ushift = lj_shift(rc)
    force = torch.zeros_like(_grid(pos4, spec))
    pe = torch.zeros_like(force[0]) if want_pe else None
    for z in range(mc):
        for dxv, dyv, dzv, r2, hit in _full_layer_pairs(windows, spec, z,
                                                        r2cut):
            s2, s6 = _lj_terms(r2, hit)
            f = torch.where(hit, 24.0 * s6 * (2.0 * s6 - 1.0) * s2, 0.0)
            for c, d in enumerate((dxv, dyv, dzv)):
                force[c, z] += (f * d).sum(dim=-1)
            if want_pe:
                pe[z] += torch.where(hit, 4.0 * (s6 * s6 - s6) - ushift,
                                     0.0).sum(dim=-1)
    shape = (spec.rows, mc, cap)
    return (force.reshape((3,) + shape),
            pe.reshape(shape) if want_pe else None)


def dense_forces(pos4: torch.Tensor, valid: torch.Tensor, spec, rc: float,
                 want_pe: bool = True):
    """LJ forces (3, R, mc, cap) by the full symmetric sweep and, when
    ``want_pe``, the per-slot shifted potential (R, mc, cap), else None. Every
    pair is evaluated at both partners and nothing is reacted: total
    PE = 0.5 * sum(pe * valid). The parity pass for ``dense_forces_half``.

    Kernel: ``csrc/force_full.cu``, replacing ``_force_kernel`` of
    md_neighbor_list_tpu/ops/pallas_force.py. Bound by fp32 operations (the
    distance tests between valid slots of 27 cells). A block stages the valid
    slots of the cell and of the 27 cells around it; a thread takes one own
    slot against one chunk of the partners, its sums in registers, and the
    block adds the chunks in a fixed order: no atomics, so the result is
    bitwise the same from run to run. 1/r2 is correctly rounded in both
    forms. CPU tensors take ``forces_full_plain``."""
    _check_state(pos4, spec)
    _check_valid(valid, pos4, spec)
    if not pos4.is_cuda:
        return forces_full_plain(pos4, valid, spec, rc, want_pe)
    force = torch.empty_like(pos4)
    geom = (spec.mc, spec.cap, _f32(spec.L), _f32(rc * rc))
    if not want_pe:
        _cuda.launch("force_full", pos4, valid, force, *geom)
        return force, None
    pe = torch.empty_like(pos4[0])
    _cuda.launch("force_full_pe", pos4, valid, force, pe, *geom,
                 _f32(lj_shift(rc)))
    return force, pe


def counts_full_plain(pos4: torch.Tensor, valid: torch.Tensor, spec,
                      radius: float) -> torch.Tensor:
    """Plain PyTorch version of ``dense_counts``."""
    windows = make_windows(pos4, valid, spec)
    r2cut = _f32(radius * radius)
    counts = torch.zeros((spec.mc,) * 3 + (spec.cap,), dtype=torch.int32,
                         device=pos4.device)
    for z in range(spec.mc):
        for *_, hit in _full_layer_pairs(windows, spec, z, r2cut):
            counts[z] += hit.sum(dim=-1, dtype=torch.int32)
    return counts.reshape(spec.rows, spec.mc, spec.cap)


def dense_counts(pos4: torch.Tensor, valid: torch.Tensor, spec,
                 radius: float) -> torch.Tensor:
    """Per-slot full neighbour counts (R, mc, cap) i32 within ``radius``,
    each pair counted at both partners: pair count = sum(counts * valid) / 2.
    The symmetric parity pass for the half sweep's pair count.

    Kernel: ``csrc/force_full.cu``, entry ``count_full`` (the full-force
    kernel's sweep with an integer count in place of the force), replacing
    ``_count_kernel`` of md_neighbor_list_tpu/ops/pallas_force.py. Bound by
    fp32 operations (the distance tests between valid slots of the 27
    cells). Exact integers: equal, bitwise, to ``counts_full_plain``, which
    CPU tensors take."""
    _check_state(pos4, spec)
    _check_valid(valid, pos4, spec)
    if not pos4.is_cuda:
        return counts_full_plain(pos4, valid, spec, radius)
    counts = torch.empty((spec.rows, spec.mc, spec.cap), dtype=torch.int32,
                         device=pos4.device)
    _cuda.launch("count_full", pos4, valid, counts, spec.mc, spec.cap,
                 _f32(spec.L), _f32(radius * radius))
    return counts


def mask_slot_counts(masks: torch.Tensor, cap: int) -> torch.Tensor:
    """Decode per-slot half counts from the slot-packed masks
    ((5, words, R, mc, 3cap) i32 -> (R, mc, cap) i32): slot MASK_BITS*w + i
    tallies bit i of word w over all offset rows and window lanes."""
    cols = []
    for w in range(masks.shape[1]):
        for b in range(min(MASK_BITS, cap - w * MASK_BITS)):
            cols.append(torch.sum((masks[:, w] >> b) & 1, dim=(0, 3),
                                  dtype=torch.int32))
    return torch.stack(cols, dim=-1)  # (R, mc, cap)
