"""Neighbour-list builds back to back through the incremental rebuild:
``drivers/build.py``'s frames, drift, window, reservoir and check, with
``DenseSimulator`` built with ``incremental=True`` where the configuration's
``rebuild`` is ``"incremental"``.

Traffic parameters: those of ``build``.

The inputs. ``build``'s frames from the seed, each handed to the program
binned: every particle in a slot of the cell that the reference's own
binning gives its frame position (``reference/cells.py``), a cell's particles
in its first slots in row order, the other slots parked. Build j drifts frame
j mod M as ``build`` does, so its input is a state whose particles have
moved less than half a skin since it was binned, as at a Verlet list's
rebuild: the particles that crossed a cell face are the movers that the
incremental rebuild sorts. (``build`` hands the program its frames in row
order, in the first slots, where every particle would be a mover.)

The check is ``build``'s (``pair_miss``, ``total_err``, ``state_err``) and,
over the same kept builds:

  cell_err   particles whose slot lies in a cell other than the one that the
             reference's binning gives their input position, beyond the
             rounding band at a cell face: the incremental rebuild's promise
             that each particle ends in the cell of its position

For K8's roofline the reference counts the movers of the last build: the
particles whose cell there is not the cell they were binned into.
``counters``, as in ``nve_inc``: the builds of the window and the traced
stretch, the rebuilds kept and the full fallbacks among them, and the
movers a build.
"""

from __future__ import annotations

import numpy as np
import torch

from mdbench.drivers import build, nve_inc
from mdbench.drivers.nve import md_config
from mdbench.lib import inputs
from mdbench.reference import cells


def binned(pos, vel, pid, key, spec):
    """A dense state of the particles (pos, vel, pid) with each in a slot of
    the cell ``key`` (N,) names, a cell's particles in its first slots in
    row order; the other slots parked as ``from_packed`` parks them."""
    from md_neighbor_list_tpu_torch.ops.dense_cells import from_packed
    state = from_packed(pos[:0], vel[:0], pid[:0], spec)
    order = torch.argsort(key, stable=True)
    ks = key[order]
    rank = torch.arange(ks.numel(), device=ks.device) \
        - torch.searchsorted(ks, ks)
    if ks.numel() and int(rank.max()) >= spec.cap:
        raise ValueError(f"a cell of the frame holds more than {spec.cap} "
                         "particles")
    slot = ks * spec.cap + rank
    state.pos.view(3, -1)[:, slot] = pos[order].T
    state.vel.view(3, -1)[:, slot] = vel[order].T
    state.pid.view(-1)[slot] = pid[order]
    return state


class Run(build.Run):
    def __init__(self, cell, seed: int, device, n: int | None = None):
        from md_neighbor_list_tpu_torch.ops.dense_cells import DenseState
        self.DenseState = DenseState
        c, t = cell.config, cell.traffic
        self.cfg = md_config(c, n)
        self.device = torch.device(device)
        n = self.cfg.n
        self.L = inputs.box_side(n, self.cfg.rho)
        self.samples = int(t["samples"])
        self.trace_units = int(t["trace_builds"])
        self.sim = nve_inc.engine(c, self.cfg, device)
        spec, rs = self.sim.spec, self.cfg.rs
        if cells.cells_a_side(self.L, rs) != spec.mc:
            raise ValueError("the reference's cells are not the program's")
        base = inputs.lattice(n, self.L, device)
        pid = torch.arange(n, dtype=torch.int32, device=device)
        self.frames, self.states, self.homes, vmax = [], [], [], []
        for i in range(int(t["frames"])):
            g = inputs.generator(seed, 1 + i, device)
            pos = inputs.shuffled(
                inputs.jittered(base, g, float(t["jitter"]), self.L), g)
            vel = inputs.maxwell(g, n, self.cfg.temperature, device)
            self.frames.append((pos, vel))
            self.homes.append(cells.cell_keys(pos, self.L, rs))
            self.states.append(binned(pos, vel, pid, self.homes[-1], spec))
            vmax.append(float(torch.sqrt(torch.sum(vel * vel, dim=1)).max()))
        rng = np.random.default_rng([seed % 2**63, 7])
        self.frac = rng.uniform(float(t["drift_lo"]), float(t["drift_hi"]),
                                size=1 << 20)
        self.pick = np.random.default_rng([seed % 2**63, 11]).random(1 << 20)
        self.vmax = vmax
        self.buf = torch.empty_like(self.states[0].pos)
        self.tmp = torch.empty_like(self.buf)
        self.on_card = self.device.type == "cuda"
        self.kept = [None] * self.samples  # [j, (pos, pid, masks, total)]
        self.marks = []
        self.j = 0
        for _ in range(max(2, self.samples)):  # the capture, the copies
            self.unit()
        self.j = 0
        self.marks = []
        for k in self.kept:
            k[0] = -1
        self.work = {}
        self._counted = nve_inc.engine_counts(self.sim)

    def finish(self) -> None:
        """``build``'s, after the counters and each kept build's slot
        cells: (pid, the cell of its slot) of every held slot."""
        self.counters = {"builds": self.j, **nve_inc.counters(
            self._counted, nve_inc.engine_counts(self.sim))}
        cap = self.sim.spec.cap
        held = {j: got[1] for j, got in self.kept if j >= 0}
        held[self.j - 1] = self.last[0].pid
        self.slot_cells = {}
        for j, pid in held.items():
            flat = pid.reshape(-1).to(torch.int64)
            slots = torch.nonzero(flat >= 0).squeeze(1)
            self.slot_cells[j] = (flat[slots], slots // cap)
        del held
        super().finish()

    def _reference(self):
        first = not hasattr(self, "_ref")
        ref = super()._reference()
        if first:
            j = self.last_j
            moved = cells.cell_keys(self.input_of(j), self.L, self.cfg.rs) \
                != self.homes[j % len(self.homes)]
            self.work["movers"] = int(torch.sum(moved))
        return ref

    def check(self, control: bool = False) -> dict:
        out = super().check(control)
        if control:
            return out
        n, rs = self.cfg.n, self.cfg.rs
        misplaced = 0
        for j, (ids, key) in self.slot_cells.items():
            ok = ids < n  # a pid past n is state_err's
            misplaced += cells.misplaced(key[ok], self.input_of(j)[ids[ok]],
                                         self.L, rs)
        return {**out, "cell_err": misplaced}
