"""Velocity-Verlet NVE integrator pieces (PyTorch port of
``md_neighbor_list_tpu/ops/integrate.py``): kick-drift-kick with a periodic
position wrap. The step sizes are taken as f32 constants, as the JAX package
takes them; ``half_kick``, ``drift`` and ``kinetic_energy`` return new tensors.

The dense engine's step (``models/dense_lj.py``) works in place on its slot
arrays (3, R, mc, cap) through ``kick_drift_vote`` (the opening half kick, the
unwrapped drift and the displacement vote) and ``kick`` (the closing half
kick). On CUDA tensors they launch ``csrc/integrate.cu``, one pass each; on
the CPU they run their plain versions, ``kick_drift_vote_plain`` and
``kick_plain``, which are PyTorch's ``add_`` sequence and ``vote``, and which
the kernels equal bit for bit on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from md_neighbor_list_tpu_torch.core.box import Box
from md_neighbor_list_tpu_torch.ops import _cuda


def half_kick(vel: torch.Tensor, force: torch.Tensor,
              dt: float) -> torch.Tensor:
    return vel + float(np.float32(0.5 * dt)) * force


def drift(pos: torch.Tensor, vel: torch.Tensor, dt: float,
          box: Box) -> torch.Tensor:
    return box.wrap(pos + float(np.float32(dt)) * vel)


def kinetic_energy(vel: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.sum(vel * vel)


def vote(pos: torch.Tensor, ref_pos: torch.Tensor, pid: torch.Tensor,
         skin: float) -> torch.Tensor:
    """The displacement vote: 0-d bool, some particle (``pid >= 0``) has
    moved more than skin/2 from ``ref_pos``. Unwrapped coordinates make the
    displacement an exact difference."""
    disp = pos - ref_pos
    d2 = torch.sum(disp * disp, dim=0)  # (R, mc, cap)
    d2max = torch.max(torch.where(pid >= 0, d2, 0.0))
    return 4.0 * d2max > skin * skin


def _check_slots(pid: torch.Tensor, *arrays: torch.Tensor) -> None:
    """Raise unless the arrays are f32 (3, *pid.shape) and pid is i32, all
    contiguous on one CUDA device."""
    if pid.dtype != torch.int32 or any(
            a.dtype != torch.float32 or a.shape != (3, *pid.shape)
            for a in arrays):
        raise ValueError("the integrator takes f32 (3, R, mc, cap) arrays and "
                         "an i32 (R, mc, cap) pid")
    _cuda.check_cuda(pid, *arrays)


def _check_flag(pid: torch.Tensor, flag: torch.Tensor) -> None:
    if flag.dtype != torch.bool or flag.numel() != 1:
        raise ValueError("the vote flag is a one-element bool tensor")
    _cuda.check_cuda(pid, flag)


def kick_drift_vote_plain(vel: torch.Tensor, pos: torch.Tensor,
                          force: torch.Tensor, ref_pos: torch.Tensor,
                          pid: torch.Tensor, dt: float, skin: float | None):
    """Plain version of ``kick_drift_vote``: returns the vote as a new 0-d
    bool, or None where ``skin`` is None."""
    vel.add_(force, alpha=0.5 * dt)
    pos.add_(vel, alpha=dt)
    return None if skin is None else vote(pos, ref_pos, pid, skin)


def kick_drift_vote(vel: torch.Tensor, pos: torch.Tensor,
                    force: torch.Tensor, ref_pos: torch.Tensor,
                    pid: torch.Tensor, dt: float, skin: float | None,
                    flag: torch.Tensor):
    """The step's opening half kick ``vel += (dt/2) force`` and drift ``pos
    += dt vel`` in place (``dt`` an f32 value), then, unless ``skin`` is None,
    the displacement vote of ``pos`` against ``ref_pos``. Returns the vote (a
    0-d bool tensor) or None. Empty slots must hold the park invariant
    (``ops/dense_cells.py``: zero velocity, zero force), as engine states do.

    On CUDA tensors, kernel ``csrc/integrate.cu`` (``kick_drift_vote``) in
    one pass over the slots, the vote raised in ``flag`` (a 0-d bool that must
    be false; the closing ``kick`` lowers it), which is what it returns; on
    the CPU, ``kick_drift_vote_plain`` (``flag`` unused)."""
    if not vel.is_cuda:
        return kick_drift_vote_plain(vel, pos, force, ref_pos, pid, dt, skin)
    voting = skin is not None
    _check_slots(pid, vel, pos, force, ref_pos)
    if voting:
        _check_flag(pid, flag)
    _cuda.launch("kick_drift_vote", vel, pos, force,
                 ref_pos if voting else None, pid, flag if voting else None,
                 pid.numel(), 0.5 * dt, dt,
                 float(np.float32(skin * skin)) if voting else 0.0)
    return flag if voting else None


def kick_plain(vel: torch.Tensor, force: torch.Tensor, dt: float) -> None:
    """Plain version of ``kick``."""
    vel.add_(force, alpha=0.5 * dt)


def kick(vel: torch.Tensor, force: torch.Tensor, pid: torch.Tensor,
         dt: float, lower: torch.Tensor | None = None) -> None:
    """The step's closing half kick ``vel += (dt/2) force`` in place, empty
    slots holding the park invariant. On CUDA tensors, kernel
    ``csrc/integrate.cu`` (``kick``), which also lowers the vote flag
    ``lower`` (if given) for the next step; on the CPU ``kick_plain``."""
    if not vel.is_cuda:
        kick_plain(vel, force, dt)
        return
    _check_slots(pid, vel, force)
    if lower is not None:
        _check_flag(pid, lower)
    _cuda.launch("kick", vel, force, pid, lower, pid.numel(), 0.5 * dt)
