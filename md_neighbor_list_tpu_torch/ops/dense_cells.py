"""Dense cell-block particle layout and its rebuild (PyTorch port of
``md_neighbor_list_tpu/ops/dense_cells.py``).

Particles live in a dense 4-D slot structure: component arrays of shape
(R, mc, cap) with R = mc*mc rows (z, y), axis 1 the x-cell and axis 2 the slot
within the cell; ``pid < 0`` marks an empty slot. Positions and velocities are
channel-leading, (3, R, mc, cap), so the sweep kernels address clean planes.

Rebuild = wrap, cell keys, one stable sort by key, row starts, and the
``expand`` kernel that reads the records through the sort's permutation into
the dense slots.
Everything but ``expand`` is plain tensor code. A cell that holds more than
``cap`` particles is truncated; the caller detects the loss by counting valid
slots and recovers by growing ``cap``.

THE PARK INVARIANT: every engine-visible ``DenseState`` keeps its empty slots
at the positions of ``park_lattice`` with zero velocity. The rebuild
establishes it and the integrator preserves it exactly (parked slots receive
exactly zero force). The half-sweep kernels therefore read the raw state with
no validity input: any two parked slots that can meet in a sweep window differ
by at least two cell sizes in x or y, so no padding pair enters a cutoff.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from md_neighbor_list_tpu_torch.core.box import Box
from md_neighbor_list_tpu_torch.ops import _cuda


@dataclasses.dataclass(frozen=True)
class DenseSpec:
    """Static geometry of the dense layout."""

    mc: int  # cells per dimension (>= 3)
    cap: int  # slots per cell
    L: float  # box side
    cell_size: float  # L / mc  (>= search radius)

    @property
    def rows(self) -> int:  # R: (z, y) cell rows
        return self.mc * self.mc

    @property
    def ncells(self) -> int:
        return self.mc**3

    @property
    def slots(self) -> int:  # S: total slots
        return self.ncells * self.cap


def grow_cap(cap: int) -> int:
    """Next cell capacity after an overflow: +25% (at least 8), rounded up
    to a multiple of 8. Gentle on purpose: pair-evaluation cost scales with
    cap."""
    return ((cap + max(8, cap // 4) + 7) // 8) * 8


# Base of the park lattice. Positions in the box lie far below half of it,
# so the half-sweep kernels tell an occupied slot by x < PARK_BASE / 2.
PARK_BASE = 1.0e5


def _park_step(spec) -> float:
    """Park lattice spacing 2*cell, rounded to f32 once."""
    return float(np.float32(2.0 * spec.cell_size))


def park_lattice(spec, device="cuda") -> torch.Tensor:
    """(3, R, mc, cap) park positions for empty slots. The x channel
    separates slots within a cell row ((x*cap + slot) * 2*cell), the y channel
    separates rows (row * 2*cell), z is constant; each axis spans O(10^4)
    above the base 1e5, where f32 spacing is ~0.01, so the lattice is exact
    and no two parked slots that meet in a window can alias."""
    mc, cap = spec.mc, spec.cap
    step = _park_step(spec)
    base = PARK_BASE
    f32 = dict(dtype=torch.float32, device=device)
    lane_id = (torch.arange(mc, **f32)[None, :, None] * cap
               + torch.arange(cap, **f32)[None, None, :])
    row_id = torch.arange(spec.rows, **f32)[:, None, None]
    shape = (spec.rows, mc, cap)
    return torch.stack([
        (base + lane_id * step).expand(shape),
        (base + row_id * step).expand(shape),
        torch.full(shape, base, **f32),
    ])


def park_positions(pos4: torch.Tensor, valid: torch.Tensor,
                   spec) -> torch.Tensor:
    """Restore the park invariant for state producers that do not park
    themselves (``rebuild_reference``, ``from_packed``)."""
    return torch.where(valid[None], pos4, park_lattice(spec, pos4.device))


def make_spec(box: Box, rs: float, cap: int = 32) -> DenseSpec:
    mc = max(int(box.L / rs), 1)
    if mc < 3:
        raise ValueError(
            f"box too small for the dense cell layout (mc={mc} < 3 at "
            f"L={box.L:.3g}, rs={rs})"
        )
    return DenseSpec(mc=mc, cap=cap, L=box.L, cell_size=box.L / mc)


class DenseState(NamedTuple):
    """Dense-slot particle state; ``pid`` < 0 marks an empty slot (its pos
    is on the park lattice and its vel is zero)."""

    pos: torch.Tensor  # (3, R, mc, cap) f32
    vel: torch.Tensor  # (3, R, mc, cap) f32
    pid: torch.Tensor  # (R, mc, cap) i32

    def valid(self) -> torch.Tensor:
        return self.pid >= 0


# --------------------------------------------------------------------- keys
def cell_keys(state: DenseState, spec: DenseSpec) -> torch.Tensor:
    """Row-major cell key per slot; empty slots get a beyond-last key so the
    sort parks them at the end, outside every row.

    The position is multiplied by the f32 reciprocal of the cell size and
    floored (dividing instead gives other cells at cell boundaries); the clip
    absorbs a wrapped coordinate that rounded to exactly L."""
    inv = float(np.float32(1.0 / spec.cell_size))
    coords = torch.clamp(
        torch.floor(state.pos * inv).to(torch.int32), 0, spec.mc - 1
    )  # (3, R, mc, cap)
    ix, iy, iz = coords[0], coords[1], coords[2]
    key = ix + spec.mc * (iy + spec.mc * iz)  # matches dense flatten order
    return torch.where(state.valid(), key,
                       torch.full_like(key, spec.ncells))


def row_starts(sorted_keys: torch.Tensor, spec,
               key_base: int = 0) -> torch.Tensor:
    """(R+1,) i32 first sorted index of each (z, y) row: row r's cells span
    keys [key_base + r*mc, key_base + (r+1)*mc), so start[r] = #keys below
    that. Records keyed below ``key_base`` (a slab's left emigrants) lie
    before row 0 and those keyed at or beyond ``key_base + R*mc`` after the
    last row: no row holds them."""
    q = key_base + torch.arange(spec.rows + 1, dtype=sorted_keys.dtype,
                                device=sorted_keys.device) * spec.mc
    return torch.searchsorted(sorted_keys, q, out_int32=True)


# ------------------------------------------------------------ expand kernel
def expand_plain(pos: torch.Tensor, vel: torch.Tensor, pid: torch.Tensor,
                 order: torch.Tensor, keys_s: torch.Tensor,
                 row_start: torch.Tensor, spec,
                 key_base: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``expand`` (same arguments, same outputs):
    a batched gather through the sort's permutation. ``row_start`` is not
    needed here; the kernel uses it to find each row's records."""
    mc, cap = spec.mc, spec.cap
    dev = pos.device
    ncell = spec.rows * mc
    cells = key_base + torch.arange(ncell + 1, dtype=keys_s.dtype, device=dev)
    off = torch.searchsorted(keys_s, cells)  # (ncell+1,) run starts
    length = (off[1:] - off[:-1])[:, None]
    slot = torch.arange(cap, device=dev)[None, :]
    valid = slot < torch.clamp(length, max=cap)  # (ncell, cap)
    src = torch.where(valid, off[:-1, None] + slot, torch.zeros_like(slot))
    shape = (spec.rows, mc, cap)
    valid = valid.reshape(shape)
    rec = order[src.reshape(shape)]  # the record each slot takes
    park = park_lattice(spec, dev)
    fill = torch.cat([park, torch.zeros_like(park)])
    posvel = torch.where(valid[None], torch.cat([pos[:, rec], vel[:, rec]]),
                         fill)
    pid4 = torch.where(valid, pid[rec], torch.full_like(rec, -1,
                                                        dtype=torch.int32))
    return posvel, pid4


def expand(pos: torch.Tensor, vel: torch.Tensor, pid: torch.Tensor,
           order: torch.Tensor, keys_s: torch.Tensor, row_start: torch.Tensor,
           spec, key_base: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Record stream -> dense cap-stride slots per cell, read through the
    stable sort's permutation.

    pos, vel (3, M) f32 and pid (M,) i32 are the records as they are, not
    sorted; order (M,) i64 is the stable sort's permutation (sorted position
    i holds record ``order[i]``), keys_s (M,) i32 the sorted keys and
    row_start (R+1,) i32 from ``row_starts`` with the same ``key_base``.
    Returns posvel (6, R, mc, cap) f32 and pid (R, mc, cap) i32: the run of
    records keyed ``key_base + c`` fills cell c's slots (c, 0..len-1) in
    sorted order, cut at cap; the other slots get the park lattice, zero
    velocity and pid -1. Records keyed outside [key_base, key_base + R*mc)
    are dropped: empty slots, and a slab's emigrants and foreign records
    (``ops/slab_kernels.py``, ``key_base = mc*mc``).

    Kernel: ``csrc/expand.cu``, replacing ``_expand_kernel`` of
    md_neighbor_list_tpu/ops/dense_cells.py. Bound by bytes on this card:
    each record within the rows is read once through ``order`` (the TPU
    sorts eight payloads because it has no gather; here the sort carries
    none), every slot written once. The JAX package's other forms of that
    kernel — ``_expand_kernel_blocked`` and the ``fuse_keys``/``split_dma``
    forms — are DMA and matrix-unit layouts of the same function with the
    same bits, so this one kernel stands for them all and ``rebuild_dense``
    takes no such flag; nor does the port need the JAX ``group``/``window``
    sizing, which sets the TPU's DMA window (``ops/incremental.py`` keeps its
    overflow predicate). A ``key_base`` other than 0 launches the slab form
    (entry ``expand_slab``, its own launch count). CPU tensors take
    ``expand_plain``."""
    if not pos.is_cuda:
        return expand_plain(pos, vel, pid, order, keys_s, row_start, spec,
                            key_base)
    args = (pos, vel, pid, order, keys_s, row_start)
    _cuda.check_cuda(*args)
    for t, dt in zip(args, (torch.float32, torch.float32, torch.int32,
                            torch.int64, torch.int32, torch.int32)):
        if t.dtype != dt:
            raise ValueError(f"expand: expected {dt}, got {t.dtype}")
    M = keys_s.shape[0]
    if pos.shape != (3, M) or vel.shape != (3, M) or pid.shape != (M,) or \
            order.shape != (M,) or row_start.shape != (spec.rows + 1,):
        raise ValueError("expand: inconsistent record or row_start shapes")
    shape = (spec.rows, spec.mc, spec.cap)
    posvel = torch.empty((6,) + shape, dtype=torch.float32, device=pos.device)
    pid4 = torch.empty(shape, dtype=torch.int32, device=pos.device)
    geom = (M, spec.rows, spec.mc, spec.cap, _park_step(spec))
    if key_base:
        _cuda.launch("expand_slab", *args, posvel, pid4, *geom, key_base)
    else:
        _cuda.launch("expand", *args, posvel, pid4, *geom)
    return posvel, pid4


def sort_expand(keys: torch.Tensor, pos: torch.Tensor, vel: torch.Tensor,
                pid: torch.Tensor, spec,
                key_base: int = 0) -> tuple[DenseState, torch.Tensor]:
    """The rebuild core: one stable sort by cell key, row starts, and the
    expand kernel reading the records through the sort's permutation.
    ``keys`` (M,) i32, ``pos`` and ``vel`` (3, M) f32, ``pid`` (M,) i32.
    Records keyed outside [key_base, key_base + rows*mc) are dropped: empty
    slots (keyed beyond), and a slab's emigrants and foreign records. The
    sort must be stable: slot order inside a cell is the records' order in the
    input, which ``dense_ref.rebuild_reference`` reproduces.

    Returns (DenseState, row_start). Counting the valid slots is the caller's
    overflow check."""
    keys_s, order = torch.sort(keys, stable=True)
    row_start = row_starts(keys_s, spec, key_base)
    posvel, pid4 = expand(pos, vel, pid, order, keys_s, row_start, spec,
                          key_base)
    return DenseState(pos=posvel[:3], vel=posvel[3:], pid=pid4), row_start


def rebuild_dense(state: DenseState,
                  spec: DenseSpec) -> tuple[DenseState, torch.Tensor]:
    """Full spatial rebuild: wrap -> keys -> stable sort -> expand.

    Positions are wrapped here and only here: between rebuilds the engine
    integrates unwrapped coordinates, so the sweep's pre-shifted periodic
    images stay exact when a particle crosses the box boundary."""
    pos = torch.remainder(state.pos, spec.L)
    keys = cell_keys(state._replace(pos=pos), spec).reshape(-1)
    return sort_expand(keys, pos.reshape(3, -1), state.vel.reshape(3, -1),
                       state.pid.reshape(-1), spec)


# ----------------------------------------------------- packed <-> dense I/O
def from_packed(pos: torch.Tensor, vel: torch.Tensor, pid: torch.Tensor,
                spec: DenseSpec) -> DenseState:
    """Seed a dense state from packed (N, 3) arrays: the N particles go into
    the first N flat slots (any cells); a ``rebuild_dense`` call sorts them
    into place. N must be <= spec.slots."""
    n = pos.shape[0]
    if n > spec.slots:
        raise ValueError(f"{n} particles > {spec.slots} dense slots")
    shape = (spec.rows, spec.mc, spec.cap)
    dev = pos.device
    pos4 = park_lattice(spec, dev).reshape(3, -1).clone()
    pos4[:, :n] = pos.to(torch.float32).T
    vel4 = torch.zeros((3, spec.slots), dtype=torch.float32, device=dev)
    vel4[:, :n] = vel.to(torch.float32).T
    pid4 = torch.full((spec.slots,), -1, dtype=torch.int32, device=dev)
    pid4[:n] = pid.to(torch.int32)
    return DenseState(pos=pos4.reshape((3,) + shape),
                      vel=vel4.reshape((3,) + shape), pid=pid4.reshape(shape))


def to_packed(state: DenseState, n: int, L: float | None = None):
    """Host-side extraction (tests and rollback only — transfers O(S)):
    numpy (pos (N, 3), vel (N, 3)) in original-pid order. Pass ``L`` to wrap
    positions into [0, L)."""
    pid = state.pid.reshape(-1).cpu().numpy()
    keep = pid >= 0
    if keep.sum() != n:
        raise ValueError(f"dense state holds {keep.sum()} != {n}")
    out = []
    for arr in (state.pos, state.vel):
        a = arr.reshape(3, -1).cpu().numpy()[:, keep].T
        dst = np.empty((n, 3), np.float32)
        dst[pid[keep]] = a
        out.append(dst)
    if L is not None:
        out[0] = np.mod(out[0], np.float32(L))
    return out[0], out[1]
