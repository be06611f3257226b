"""State carried across the two packages, as numpy arrays.

This system has no weights; its state is what weights are elsewhere. The
functions here take exactly the arrays ``np.asarray`` gives from the JAX
package's ``System`` / ``DenseState`` / ``DenseCarry`` (same shapes and
dtypes: (3, R, mc, cap) f32, (R, mc, cap) i32, (N, 3) f32, (N,) i32) and
return the port's NamedTuples on ``device``, and back; likewise the list
artifact ``(counts, masks)`` of ``dense_lists_half``, whose layout is the same
in both packages, so either package's decoder reads either's masks; and the
slab engine's ``SlabCarry`` and the XLA slab engine's ``DDState``, whose JAX
forms stack the P ranks' states on a leading axis and whose port forms are one
state per rank; and the padded-row ``Simulator``'s ``Carry`` (system, rows,
reference positions, counters). The module imports neither package's
counterpart: the caller does the ``np.asarray``.
"""

from __future__ import annotations

import numpy as np
import torch

from md_neighbor_list_tpu_torch.core.system import System
from md_neighbor_list_tpu_torch.models.dense_lj import DenseCarry
from md_neighbor_list_tpu_torch.models.lj_nve import Carry, NeighborState
from md_neighbor_list_tpu_torch.ops.dense_cells import DenseSpec, DenseState
from md_neighbor_list_tpu_torch.parallel.dense_slab import SlabCarry
from md_neighbor_list_tpu_torch.parallel.slab import DDState

# SlabCarry fields in order, with their types
_SLAB_DTYPES = (torch.float32, torch.float32, torch.int32, torch.float32,
                torch.int32, torch.float32, torch.float32, torch.int32,
                torch.int32, torch.bool)
# DDState fields in order, with their types
_DD_DTYPES = (torch.float32, torch.float32, torch.float32, torch.int32,
              torch.float32, torch.int32, torch.int32, torch.int32,
              torch.float32, torch.int32, torch.bool)


def _tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    """A fresh tensor on ``device`` (never a view of the numpy buffer: the
    engine updates its state in place)."""
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def spec_from(mc: int, cap: int, L: float, cell_size: float) -> DenseSpec:
    return DenseSpec(mc=int(mc), cap=int(cap), L=float(L),
                     cell_size=float(cell_size))


def system_from_numpy(pos, vel, force, pid, device="cuda") -> System:
    return System(pos=_tensor(pos, torch.float32, device),
                  vel=_tensor(vel, torch.float32, device),
                  force=_tensor(force, torch.float32, device),
                  pid=_tensor(pid, torch.int32, device))


def system_to_numpy(system: System):
    return tuple(t.cpu().numpy() for t in system)


def dense_state_from_numpy(pos, vel, pid, device="cuda") -> DenseState:
    return DenseState(pos=_tensor(pos, torch.float32, device),
                      vel=_tensor(vel, torch.float32, device),
                      pid=_tensor(pid, torch.int32, device))


def dense_state_to_numpy(state: DenseState):
    return tuple(t.cpu().numpy() for t in state)


def carry_from_numpy(pos, vel, pid, force, ref_pos, n_rebuilds, overflow,
                     device="cuda") -> DenseCarry:
    return DenseCarry(
        state=dense_state_from_numpy(pos, vel, pid, device),
        force=_tensor(force, torch.float32, device),
        ref_pos=_tensor(ref_pos, torch.float32, device),
        n_rebuilds=_tensor(n_rebuilds, torch.int32, device),
        overflow=_tensor(overflow, torch.bool, device))


def carry_to_numpy(carry: DenseCarry):
    """(pos, vel, pid, force, ref_pos, n_rebuilds, overflow) — the argument
    order of ``carry_from_numpy``."""
    return dense_state_to_numpy(carry.state) + tuple(
        t.cpu().numpy() for t in carry[1:])


def sim_carry_from_numpy(pos, vel, force, pid, idx, ref_pos, max_count,
                         cell_max, overflow, n_rebuilds,
                         device="cuda") -> Carry:
    """The ``Simulator`` carry from its ten arrays in field order (the
    System's four, then the NeighborState's six)."""
    return Carry(
        system=system_from_numpy(pos, vel, force, pid, device),
        nbr=NeighborState(
            idx=_tensor(idx, torch.int32, device),
            ref_pos=_tensor(ref_pos, torch.float32, device),
            max_count=_tensor(max_count, torch.int32, device),
            cell_max=_tensor(cell_max, torch.int32, device),
            overflow=_tensor(overflow, torch.bool, device),
            n_rebuilds=_tensor(n_rebuilds, torch.int32, device)))


def sim_carry_to_numpy(carry: Carry):
    """The ten arrays of ``sim_carry_from_numpy``, in its argument order."""
    return system_to_numpy(carry.system) + tuple(
        t.cpu().numpy() for t in carry.nbr)


def lists_from_numpy(counts, masks, device="cuda"):
    """The list artifact (counts (R, mc, cap) i32, masks
    (5, words, R, mc, 3cap) i32) as tensors on ``device``."""
    return (_tensor(counts, torch.int32, device),
            _tensor(masks, torch.int32, device))


def lists_to_numpy(counts: torch.Tensor, masks: torch.Tensor):
    return counts.cpu().numpy(), masks.cpu().numpy()


def _split_ranks(kind, dtypes, arrays, device) -> list:
    """One ``kind`` per rank from its fields' arrays, each with the leading
    axis P."""
    if len(arrays) != len(kind._fields):
        raise ValueError(f"expected {len(kind._fields)} arrays, got "
                         f"{len(arrays)}")
    arrays = [np.asarray(a) for a in arrays]
    return [kind(*(_tensor(a[r], dt, device)
                   for a, dt in zip(arrays, dtypes)))
            for r in range(arrays[0].shape[0])]


def _stack_ranks(states) -> tuple:
    """The fields' arrays in order, the ranks stacked on the leading axis."""
    return tuple(np.stack([s[i].cpu().numpy() for s in states])
                 for i in range(len(states[0])))


def slab_carries_from_numpy(*arrays, device="cuda") -> list[SlabCarry]:
    """The P per-rank carries of a JAX ``SlabCarry`` given as its ten arrays
    in field order (pos, vel, pid, gpos, gpid, force, ref_pos, n_rebuilds,
    n_migrated, overflow), each with the leading axis P."""
    return _split_ranks(SlabCarry, _SLAB_DTYPES, arrays, device)


def slab_carries_to_numpy(carries) -> tuple:
    """Inverse of ``slab_carries_from_numpy``: the ten arrays in field order,
    the ranks stacked on the leading axis (the JAX ``SlabCarry``'s shapes)."""
    return _stack_ranks(carries)


def dd_states_from_numpy(*arrays, device="cuda") -> list[DDState]:
    """The P per-rank states of a JAX ``DDState`` given as its eleven arrays
    in field order (pos, vel, force, pid, ghost_pos, ghost_pid, send_idx,
    idx, ref_pos, n_rebuilds, overflow), each with the leading axis P."""
    return _split_ranks(DDState, _DD_DTYPES, arrays, device)


def dd_states_to_numpy(states) -> tuple:
    """Inverse of ``dd_states_from_numpy``: the eleven arrays in field order,
    the ranks stacked on the leading axis (the JAX ``DDState``'s shapes)."""
    return _stack_ranks(states)
