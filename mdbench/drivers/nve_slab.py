"""NVE steps of the dense slab engine over a ring of ranks, one a card:
``DenseSlabSimulator.run`` in chunks (``lib/ranks.py`` starts the ranks and
hands each its ``Ring``; with none the engine runs its P = 1 mode).

Traffic parameters (``traffic/<mix>.json``): those of ``nve``.

The start: on every rank the configuration's simple-cubic lattice with
Maxwell velocities at its temperature from the seed, as ``nve`` makes it (the
same seed gives the same start on every card), handed to
``DenseSlabSimulator.build``, which keeps each rank's slab. Rebuilds are
displacement-triggered, the vote max-reduced over the ring. The
configuration's ``mesh_devices`` is the ring's size.

The check is ``nve``'s, on the state gathered from every rank
(``Ring.gather``: the slots of all ranks read back in particle order), judged
on rank 0: ``force_err`` (the initial build's forces and the forces after the
window, the seam's reactions in them), ``step_gap`` (``check_steps`` steps by
``run`` on the ring and by the float64 reference), ``energy_drift`` and
``lost`` (atoms missing, or held by two ranks or twice by one).

For the slab sweep's roofline each rank counts its own work on the gathered
state (``reference/slabs.py``), in a traced run only (``measure_work``).

``counters``: the steps that the window and the traced stretch ran, and the
rebuilds and the atoms migrated between slabs over them, read from the
carry's ``n_rebuilds`` and ``n_migrated`` at the end of set-up and before
the check's steps (rebuilds and migrated None where an overflow rebuilt the
carry, which starts them anew).
"""

from __future__ import annotations

import dataclasses

from mdbench.drivers import nve
from mdbench.lib import inputs


class Run(nve.Run):
    def __init__(self, cell, seed: int, device, n: int | None = None,
                 ring=None):
        from md_neighbor_list_tpu_torch.parallel.dense_slab import \
            DenseSlabSimulator
        c, t = cell.config, cell.traffic
        self.cfg = dataclasses.replace(nve.md_config(c, n),
                                       mesh_devices=int(c["mesh_devices"]))
        self.L = inputs.box_side(self.cfg.n, self.cfg.rho)
        self.chunk = int(t["chunk"])
        self.check_steps = int(t["check_steps"])
        self.trace_units = int(t["trace_chunks"]) * self.chunk
        self.sim = DenseSlabSimulator(self.cfg, cap=int(c["cap"]),
                                      device=device, ring=ring)
        self.root = self.sim.ring.rank == 0
        system, pos0, vel0 = nve.start_system(self.cfg, seed,
                                              self.sim.device)
        self.carry = self.sim.build(system)
        del system
        # the program's forces on the harness's input
        (force0,), self.lost0 = self._gathered([self.carry.force])
        if self.root:
            self.pos0, self.vel0, self.force0 = pos0, vel0, force0
        del pos0, vel0, force0
        self.carry = self.sim.run(self.carry, int(t["warm_steps"]),
                                  chunk=self.chunk)
        self.work = {}
        self.steps, self._counted = 0, self._counters()

    def _counters(self) -> tuple[int, int]:
        return int(self.carry.n_rebuilds), int(self.carry.n_migrated)

    def unit(self) -> int:
        done = super().unit()
        self.steps += done
        return done

    def advance(self, steps: int) -> None:
        super().advance(steps)
        self.steps += steps

    def _gathered(self, fields):
        """Every rank's slot arrays (3, rows, mc, cap) read back in particle
        order, on every rank: (n, 3) tensors and the atoms missing or held
        twice (``nve.packed``)."""
        ring = self.sim.ring
        pid = ring.gather(self.carry.pid).reshape(-1)
        return nve.packed(pid, [ring.gather(f).movedim(0, 1).reshape(3, -1)
                                for f in fields], self.cfg.n)

    def finish(self) -> None:
        c = self.carry
        now = self._counters()
        diff = [b - a for a, b in zip(self._counted, now)]
        sound = now[0] >= self._counted[0]
        self.counters = {"steps": self.steps,
                         "rebuilds": diff[0] if sound else None,
                         "migrated": diff[1] if sound else None}
        (self.pos, self.vel, self.force), self.lost = self._gathered(
            [c.pos, c.vel, c.force])
        self.carry = self.sim.run(self.carry, self.check_steps,
                                  chunk=self.chunk)
        (self.pos_k,), lost_k = self._gathered([self.carry.pos])
        self.lost = max(self.lost, lost_k, self.lost0)
        self.cap = self.sim.cap
        self.spec, self.rank = self.sim.spec, self.sim.ring.rank
        self.work = {"cap": self.cap}
        if not self.root:  # only rank 0 checks; the positions stay for
            del self.vel, self.force, self.pos_k  # measure_work
        del self.carry, self.sim

    def measure_work(self) -> None:
        """This rank's atoms, ghost atoms and pairs within rc, counted by
        the reference on the gathered state after the window."""
        from mdbench.reference import slabs
        self.work = {"cap": self.cap, "rc": self.cfg.rc, **slabs.rank_work(
            self.pos, self.L, self.cfg.rc, self.spec.mc_z, self.spec.nz,
            self.rank)}
