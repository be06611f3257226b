"""The LJ/NVE simulator over padded neighbour rows: Verlet-list reuse with a
displacement-triggered rebuild (PyTorch port of
``md_neighbor_list_tpu/models/lj_nve.py``, the ``xla`` engine).

  step:  kick -> drift + wrap -> rebuild vote -> (bin + sweep, state permuted
         into the new sorted order) -> forces over the rows -> kick

The list is rebuilt only when ``2 * max_displacement > skin``, the criterion
under which no pair can cross into rc undetected. Every op is plain PyTorch
on ``device`` (the card unless the caller asks for the CPU); the JAX package
computes the same in XLA, outside any Pallas kernel.

The engine runs eagerly, and its step is functional: ``step_fn`` returns new
tensors and leaves the carry it was given as it was. Where the JAX step
branches on the device (``lax.cond``), the vote is read on the host once a
step; the sticky overflow flag is read once a chunk. A chunk that overflowed
is rolled back to the carry it started from, the capacities grow, and the
chunk is redone: never a silent truncation.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from md_neighbor_list_tpu_torch.core.box import Box
from md_neighbor_list_tpu_torch.core.capacity import Capacity, estimate
from md_neighbor_list_tpu_torch.core.config import MDConfig
from md_neighbor_list_tpu_torch.core.system import (System, init_lattice,
                                                    init_random)
from md_neighbor_list_tpu_torch.ops import lj
from md_neighbor_list_tpu_torch.ops.binning import CellGrid, make_grid
from md_neighbor_list_tpu_torch.ops.integrate import (drift, half_kick,
                                                      kinetic_energy)
from md_neighbor_list_tpu_torch.ops.pairlist import build_neighbor_lists


class NeighborState(NamedTuple):
    """Verlet-list state: padded rows, the positions they were built at, and
    capacity telemetry."""

    idx: torch.Tensor  # (N, K) i32, sorted-space rows
    ref_pos: torch.Tensor  # (N, 3) positions at build time
    max_count: torch.Tensor  # () i32
    cell_max: torch.Tensor  # () i32
    overflow: torch.Tensor  # () bool, sticky across the steps of a chunk
    n_rebuilds: torch.Tensor  # () i32


class Carry(NamedTuple):
    system: System
    nbr: NeighborState


class Simulator:
    """LJ/NVE over padded rows for one configuration, on ``device``."""

    def __init__(self, config: MDConfig, capacity: Capacity | None = None,
                 device="cuda"):
        if config.backend == "pallas":
            raise ValueError(
                "backend='pallas' is the dense engine: use "
                "models.dense_lj.DenseSimulator")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Simulator runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU")
        self.config = config
        self.box = Box.from_density(config.n, config.rho)
        self.grid: CellGrid = make_grid(self.box, config.rs)
        if capacity is None:
            capacity = estimate(rho=config.rho, rs=config.rs,
                                cell_size=self.grid.cell_size,
                                half_list=config.half_list)
            if config.neighbor_capacity is not None:
                capacity = Capacity(
                    neighbors=config.neighbor_capacity,
                    cell=capacity.cell if config.cell_capacity is None
                    else config.cell_capacity)
        self.capacity = capacity

    # ---------------------------------------------------------- internals
    def _do_rebuild(self, system: System, nbr: NeighborState | None) -> Carry:
        """Bin + sweep, and the state permuted into the new sorted order.
        ``nbr`` None: a first build (counters from zero)."""
        cfg, cap = self.config, self.capacity
        pos_sorted, nl = build_neighbor_lists(
            system.pos, self.box, self.grid, cfg.rs, cap.neighbors, cap.cell,
            cfg.half_list, cfg.layout)
        perm = nl.perm.long()
        system = System(pos=pos_sorted, vel=system.vel[perm],
                        force=system.force[perm], pid=system.pid[perm])
        if nbr is None:
            n_rebuilds = torch.ones((), dtype=torch.int32, device=self.device)
            overflow = nl.overflow
        else:
            n_rebuilds = nbr.n_rebuilds + 1
            overflow = nl.overflow | nbr.overflow  # sticky
        return Carry(system, NeighborState(
            idx=nl.idx, ref_pos=pos_sorted, max_count=nl.max_count,
            cell_max=nl.cell_max, overflow=overflow, n_rebuilds=n_rebuilds))

    def _forces(self, carry: Carry):
        return lj.forces_energy(carry.system.pos, carry.nbr.idx, self.box,
                                self.config.rc, self.config.half_list)

    def step_fn(self, carry: Carry) -> Carry:
        """One velocity-Verlet step; returns a new carry."""
        cfg, box = self.config, self.box
        system, nbr = carry
        vel = half_kick(system.vel, system.force, cfg.dt)
        pos = drift(system.pos, vel, cfg.dt, box)
        system = system._replace(pos=pos, vel=vel)

        need = cfg.rebuild_every_step
        if not need:
            disp = box.min_image(pos - nbr.ref_pos)
            d2max = torch.max(torch.sum(disp * disp, dim=-1))
            # the one host read of the step: the vote decides what runs
            need = bool(4.0 * d2max > float(np.float32(cfg.skin * cfg.skin)))
        if need:
            system, nbr = self._do_rebuild(system, nbr)

        force, _ = self._forces(Carry(system, nbr))
        vel = half_kick(system.vel, force, cfg.dt)
        return Carry(system._replace(vel=vel, force=force), nbr)

    def _run_chunk(self, carry: Carry, nsteps: int) -> Carry:
        for _ in range(nsteps):
            carry = self.step_fn(carry)
        return carry

    def _initial_build(self, system: System) -> Carry:
        carry = self._do_rebuild(system, None)
        force, _ = self._forces(carry)
        return carry._replace(system=carry.system._replace(force=force))

    def _grow(self) -> None:
        self.capacity = self.capacity.grown()

    # ---------------------------------------------------------------- API
    def init(self, generator: torch.Generator | None = None,
             lattice: bool = True) -> Carry:
        """Create and neighbour-build an initial state; grows the capacities
        until the initial build fits."""
        cfg = self.config
        if lattice:
            system, _ = init_lattice(cfg.n, cfg.rho, generator,
                                     cfg.temperature, self.device)
        else:
            if generator is None:
                raise ValueError("a random start needs a generator")
            system, _ = init_random(generator, cfg.n, cfg.rho,
                                    cfg.temperature, self.device)
        return self.build(system)

    def build(self, system: System) -> Carry:
        """Carry from a System (any row order, on any device); grows the
        capacities until the build fits."""
        system = System(*(t.to(self.device) for t in system))
        while True:
            carry = self._initial_build(system)
            if not bool(carry.nbr.overflow):
                return carry
            self._grow()

    def rebuild_only(self, system: System) -> Carry:
        """Bin + sweep only, with the state permuted: the timed list build.
        Its ``nbr.n_rebuilds`` is 1."""
        return self._do_rebuild(system, None)

    def run(self, carry: Carry, nsteps: int, chunk: int = 100) -> Carry:
        """Advance ``nsteps`` steps in chunks of ``chunk``. Between chunks the
        host reads the sticky overflow flag and, on overflow, rebuilds the
        carry the chunk started from with grown capacities and redoes the
        chunk."""
        done = 0
        while done < nsteps:
            this = min(chunk, nsteps - done)
            snapshot = carry  # step_fn leaves it untouched
            carry = self._run_chunk(carry, this)
            if bool(carry.nbr.overflow):
                self._grow()
                carry = self.build(snapshot.system)
                continue
            done += this
        return carry

    def energies(self, carry: Carry):
        """(KE, PE) as 0-d tensors; PE is the shifted LJ potential."""
        _, pe = self._forces(carry)
        return kinetic_energy(carry.system.vel), pe

    def thermo(self, carry: Carry):
        """(KE, PE, W): kinetic energy, shifted potential and total pair
        virial W = sum over pairs of dr . F — the inputs of the instantaneous
        pressure P = (2*KE + W) / (3*V)."""
        pe, w = lj.pe_virial(carry.system.pos, carry.nbr.idx, self.box,
                             self.config.rc, self.config.half_list)
        return kinetic_energy(carry.system.vel), pe, w

    def pressure(self, carry: Carry) -> float:
        """Instantaneous virial pressure P = (2*KE + W) / (3*V) in reduced
        units (V = L^3)."""
        ke, _, w = self.thermo(carry)
        vol = float(self.box.L) ** 3
        return float((2.0 * ke + w) / (3.0 * vol))
