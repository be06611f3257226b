"""DenseSimulator — the dense-layout LJ/NVE engine (PyTorch port of
``md_neighbor_list_tpu/models/dense_lj.py``).

Velocity Verlet with displacement-triggered rebuilds and overflow rollback +
cap growth; the particle state lives in the dense cell-block layout
(``ops/dense_cells.py``) and the hot ops are the half-sweep kernels
(``ops/dense_force.py``):

  step:   kick -> unwrapped drift -> rebuild vote -> (sort + expand) ->
          half-sweep force kernel -> kick
  Verlet reuse: between rebuilds the *binning* is reused — cell size >= rs
  guarantees every rc-pair stays inside the stale neighbourhood while
  2*max_disp <= skin.

The engine runs eagerly. The rebuild vote is a device scalar read on the host
once per step (one synchronisation); a device-side branch is left to a CUDA
graph over a chunk. Within a chunk the state is updated IN PLACE: ``step_fn``
and ``run`` consume the carry they are given, and ``run`` clones the carry at
the start of each chunk so that an overflow can roll back to it.

Which implementation runs is decided by the device alone: tensors on a CUDA
device go through the CUDA kernels, tensors on the CPU through their plain
versions. The default device is the card; ``device="cpu"`` is for the caller
to ask for.

``incremental=True`` sends every rebuild through the incremental rebuild
(``ops/incremental.py``: only the particles that changed cell are sorted and
merged in by the K8 kernel), and through the full rebuild when the mover
stream trips the JAX package's window predicate. The branch costs one host
read per rebuild. Unlike the JAX package, whose ``"jnp"`` engine ignores the
flag, the port honours it on the CPU too, where it runs the plain versions.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from md_neighbor_list_tpu_torch.core.box import Box
from md_neighbor_list_tpu_torch.core.config import MDConfig
from md_neighbor_list_tpu_torch.core.system import (System, init_lattice,
                                                    init_random)
from md_neighbor_list_tpu_torch.ops import dense_force
from md_neighbor_list_tpu_torch.ops.dense_cells import (DenseState,
                                                        from_packed, grow_cap,
                                                        make_spec,
                                                        rebuild_dense,
                                                        to_packed)
from md_neighbor_list_tpu_torch.ops.incremental import \
    rebuild_dense_incremental


class DenseCarry(NamedTuple):
    state: DenseState
    force: torch.Tensor  # (3, R, mc, cap)
    ref_pos: torch.Tensor  # (3, R, mc, cap) positions at the last rebuild
    n_rebuilds: torch.Tensor  # () i32
    overflow: torch.Tensor  # () bool (sticky)


def _clone(carry: DenseCarry) -> DenseCarry:
    return DenseCarry(
        state=DenseState(*(t.clone() for t in carry.state)),
        force=carry.force.clone(), ref_pos=carry.ref_pos.clone(),
        n_rebuilds=carry.n_rebuilds.clone(), overflow=carry.overflow.clone())


class DenseSimulator:
    """LJ/NVE on the dense cell layout, on ``device`` (default: the card)."""

    def __init__(self, config: MDConfig, cap: int = 40, device="cuda",
                 incremental: bool = False):
        self.config = config
        self.incremental = incremental
        # rebuilds by branch: incremental ones kept, and full rebuilds taken
        # because the mover stream tripped the window predicate
        self.incremental_rebuilds = 0
        self.full_fallbacks = 0
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "DenseSimulator runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain versions")
        self.box = Box.from_density(config.n, config.rho)
        self.cap = cap
        self.spec = make_spec(self.box, config.rs, cap)

    def _grow(self) -> None:
        self.cap = grow_cap(self.cap)
        self.spec = make_spec(self.box, self.config.rs, self.cap)

    # ------------------------------------------------------------ internals
    def _forces(self, state: DenseState, want_pe: bool = False):
        """(force, pe_slots) with pe attributed once per pair."""
        return dense_force.dense_forces_half(state.pos, self.spec,
                                             self.config.rc, want_pe)

    def _rebuild_state(self, state: DenseState) -> DenseState:
        """The rebuild of the step loop and of ``_rebuild_and_lists``: the
        full one, or with ``incremental`` the incremental one unless its
        window predicate holds (the JAX engine's ``lax.cond``, here one host
        read). Taking the full path is the reference's own algorithm, never a
        response to a kernel's failure."""
        if self.incremental:
            new, window_overflow = rebuild_dense_incremental(state, self.spec)
            if not bool(window_overflow):
                self.incremental_rebuilds += 1
                return new
            self.full_fallbacks += 1
        return rebuild_dense(state, self.spec)[0]

    def _do_rebuild(self, carry: DenseCarry) -> DenseCarry:
        state = self._rebuild_state(carry.state)
        kept = torch.sum(state.valid())
        return carry._replace(
            state=state,
            ref_pos=state.pos.clone(),  # state.pos is drifted in place
            n_rebuilds=carry.n_rebuilds + 1,
            overflow=carry.overflow | (kept != self.config.n),
        )

    def step_fn(self, carry: DenseCarry) -> DenseCarry:
        """One velocity-Verlet step. Updates ``carry``'s tensors in place."""
        cfg = self.config
        dt = float(np.float32(cfg.dt))
        state = carry.state
        state.vel.add_(carry.force, alpha=0.5 * dt)
        # UNWRAPPED drift: positions are wrapped only inside the rebuild, so
        # the stale-bin image shifts stay exact across the periodic boundary
        state.pos.add_(state.vel, alpha=dt)

        # unwrapped coordinates make the displacement an exact difference
        need = cfg.rebuild_every_step
        if not need:
            disp = state.pos - carry.ref_pos
            d2 = torch.sum(disp * disp, dim=0)  # (R, mc, cap)
            d2max = torch.max(torch.where(state.valid(), d2, 0.0))
            # the one host read of the step: the vote decides what to launch
            need = bool(4.0 * d2max > cfg.skin * cfg.skin)
        if need:
            carry = self._do_rebuild(carry)

        force, _ = self._forces(carry.state)
        carry.state.vel.add_(force, alpha=0.5 * dt)
        return carry._replace(force=force)

    def _run_chunk(self, carry: DenseCarry, nsteps: int) -> DenseCarry:
        for _ in range(nsteps):
            carry = self.step_fn(carry)
        return carry

    def _initial_build(self, state: DenseState) -> DenseCarry:
        carry = DenseCarry(
            state=state,
            force=torch.zeros_like(state.pos),
            ref_pos=state.pos,
            n_rebuilds=torch.zeros((), dtype=torch.int32, device=self.device),
            overflow=torch.zeros((), dtype=torch.bool, device=self.device),
        )
        carry = self._do_rebuild(carry)
        force, _ = self._forces(carry.state)
        return carry._replace(force=force)

    def _rebuild_and_lists(self, state: DenseState):
        """The timed neighbour-list build: wrap + keys + sort + expand + the
        one-pass half-list kernel emitting the complete artifact — packed hit
        masks and half counts (total pairs = sum of counts over valid
        slots). Returns (new_state, counts, masks, total)."""
        new = self._rebuild_state(state)
        counts, masks = dense_force.dense_lists_half(new.pos, self.spec,
                                                     self.config.rs)
        total = torch.sum(torch.where(new.valid(), counts, 0))
        return new, counts, masks, total

    @staticmethod
    def _kinetic(state: DenseState) -> torch.Tensor:
        return 0.5 * torch.sum(
            torch.where(state.valid()[None], state.vel, 0.0) ** 2)

    # ------------------------------------------------------------------ API
    def init(self, generator: torch.Generator | None = None,
             lattice: bool = True) -> DenseCarry:
        cfg = self.config
        if lattice:
            system, _ = init_lattice(cfg.n, cfg.rho, generator,
                                     cfg.temperature, self.device)
        else:
            system, _ = init_random(generator, cfg.n, cfg.rho,
                                    cfg.temperature, self.device)
        return self.build(system)

    def build(self, system: System) -> DenseCarry:
        """Dense carry from a packed system; grows ``cap`` until every
        particle has a slot."""
        while True:
            if system.n <= self.spec.slots:
                state = from_packed(system.pos, system.vel, system.pid,
                                    self.spec)
                carry = self._initial_build(state)
                if not bool(carry.overflow):
                    return carry
            self._grow()

    def run(self, carry: DenseCarry, nsteps: int,
            chunk: int = 100) -> DenseCarry:
        """Advance ``nsteps`` steps in chunks. A chunk that overflowed a
        cell is undone: the state at its start is rebuilt with a larger
        ``cap`` (``n_rebuilds`` restarts there) and the chunk is redone."""
        done = 0
        while done < nsteps:
            this = min(chunk, nsteps - done)
            snapshot = _clone(carry)
            carry = self._run_chunk(carry, this)
            if bool(carry.overflow):
                pos, vel = to_packed(snapshot.state, self.config.n,
                                     self.spec.L)
                n = self.config.n
                system = System(
                    pos=torch.from_numpy(pos).to(self.device),
                    vel=torch.from_numpy(vel).to(self.device),
                    force=torch.zeros((n, 3), dtype=torch.float32,
                                      device=self.device),
                    pid=torch.arange(n, dtype=torch.int32,
                                     device=self.device),
                )
                self._grow()
                carry = self.build(system)
                continue
            done += this
        return carry

    def energies(self, carry: DenseCarry):
        """(KE, PE) as 0-d tensors; PE is the shifted LJ potential."""
        v = carry.state.valid()
        _, pe_slots = self._forces(carry.state, want_pe=True)
        return self._kinetic(carry.state), torch.sum(
            torch.where(v, pe_slots, 0.0))

    def thermo(self, carry: DenseCarry):
        """(KE, PE, W): kinetic energy, shifted potential and total pair
        virial W = sum over pairs of dr . F_pair — the inputs of the
        instantaneous pressure P = (2*KE + W) / (3*V)."""
        v = carry.state.valid()
        pe_s, w_s = dense_force.dense_pe_virial(carry.state.pos, self.spec,
                                                self.config.rc)
        return (self._kinetic(carry.state),
                torch.sum(torch.where(v, pe_s, 0.0)),
                torch.sum(torch.where(v, w_s, 0.0)))

    def pressure(self, carry: DenseCarry) -> float:
        """Instantaneous virial pressure P = (2*KE + W) / (3*V) in reduced
        units (V = L^3)."""
        ke, _, w = self.thermo(carry)
        vol = float(self.spec.L) ** 3
        return float((2.0 * ke + w) / (3.0 * vol))

    def to_system(self, carry: DenseCarry):
        """numpy (pos, vel, force) packed in pid order — host-side."""
        pos, vel = to_packed(carry.state, self.config.n, self.spec.L)
        pid = carry.state.pid.reshape(-1).cpu().numpy()
        keep = pid >= 0
        f = carry.force.reshape(3, -1).cpu().numpy()[:, keep].T
        force = np.empty_like(f)
        force[pid[keep]] = f
        return pos, vel, force
