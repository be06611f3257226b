"""NVE steps of the dense engine from a face-centred cubic start:
``drivers/nve.py``'s run, window and check, from another start.

Traffic parameters (``traffic/<mix>.json``): those of ``nve``.

The start: an fcc lattice of k^3 unit cells (4k^3 sites) filling the
configuration's box, with Maxwell velocities at the configuration's
temperature from the seed (zero net momentum). The sites are a*(i, j, l) plus
a*(0, 0, 0), a*(1/2, 1/2, 0), a*(1/2, 0, 1/2), a*(0, 1/2, 1/2), shifted by
a/4 off the box's faces (a = L/k): LAMMPS's ``lattice fcc`` in a box of
``region box block`` whole unit cells. ``n`` shrinks to the largest 4k^3 at
or under the number asked for (the CPU tests' small sizes).

The program makes the start where its configuration names the lattice
(``MDConfig.lattice = "fcc"``): ``DenseSimulator.init`` with the seed's
generator, the deployment's own path. The harness makes the same start with
its own code, and the check holds the program's to it:

  start_err     the largest difference between the program's positions and
                velocities after its initial build and the harness's start
                (0: the deployment's start, bit for bit)

Where the program's configuration knows no lattice, the harness's start is
handed to ``build``, as ``nve`` hands its own.
"""

from __future__ import annotations

import dataclasses

import torch

from mdbench.drivers import nve
from mdbench.lib import inputs


def fcc_n(n: int) -> int:
    """The largest 4k^3 at or under ``n``."""
    k = 1
    while 4 * (k + 1)**3 <= n:
        k += 1
    return 4 * k**3


def fcc(n: int, L: float, device) -> torch.Tensor:
    """(n, 3) f32: the sites of an fcc lattice of k^3 unit cells (n = 4k^3)
    filling a cube of side ``L``; four sites a cell, cell by cell."""
    k = round((n / 4) ** (1.0 / 3.0))
    if 4 * k**3 != n:
        raise ValueError(f"an fcc lattice holds 4k^3 sites, not {n}")
    site = torch.arange(n, dtype=torch.int64, device=device)
    cell, b = site // 4, site % 4
    ijk = torch.stack([cell % k, (cell // k) % k, cell // (k * k)], dim=-1)
    # the basis in half lattice constants: (0,0,0) (1,1,0) (1,0,1) (0,1,1)
    half = torch.stack([(b == 1) | (b == 2), (b == 1) | (b == 3),
                        (b == 2) | (b == 3)], dim=-1)
    frac = ijk.to(torch.float32) + 0.5 * half.to(torch.float32) + 0.25
    return (frac * (L / k)).contiguous()


def start_system(cfg, seed: int, device):
    """The harness's start: (system for ``build``, pos, vel)."""
    from md_neighbor_list_tpu_torch.core.system import System
    n = cfg.n
    pos = fcc(n, inputs.box_side(n, cfg.rho), device)
    vel = inputs.maxwell(inputs.generator(seed, 0, device), n,
                         cfg.temperature, device)
    system = System(pos=pos, vel=vel, force=torch.zeros_like(pos),
                    pid=torch.arange(n, dtype=torch.int32, device=device))
    return system, pos, vel


def md_config(cfg: dict, n: int):
    """``nve``'s configuration, naming the fcc lattice where the program's
    ``MDConfig`` has the field; (config, whether it names it)."""
    from md_neighbor_list_tpu_torch.core.config import MDConfig
    base = nve.md_config(cfg, n)
    if "lattice" not in {f.name for f in dataclasses.fields(MDConfig)}:
        return base, False
    return dataclasses.replace(base, lattice="fcc"), True


class Run(nve.Run):
    """``nve.Run`` from the fcc start, made by the program where it can."""

    def __init__(self, cell, seed: int, device, n: int | None = None):
        from md_neighbor_list_tpu_torch.models.dense_lj import DenseSimulator
        c, t = cell.config, cell.traffic
        self.cfg, names_lattice = md_config(c, fcc_n(n or c["n"]))
        self.L = inputs.box_side(self.cfg.n, self.cfg.rho)
        self.chunk = int(t["chunk"])
        self.check_steps = int(t["check_steps"])
        self.trace_units = int(t["trace_chunks"]) * self.chunk
        self.sim = DenseSimulator(self.cfg, cap=int(c["cap"]), device=device)
        system, self.pos0, self.vel0 = start_system(self.cfg, seed, device)
        self.carry = (self.sim.init(inputs.generator(seed, 0, device))
                      if names_lattice else self.sim.build(system))
        # the program's start and its forces on it
        (self.force0, pos, vel), self.lost0 = nve.packed(
            self.carry.state.pid,
            [self.carry.force, self.carry.state.pos, self.carry.state.vel],
            self.cfg.n)
        self.start_err = float(max((pos - self.pos0).abs().max(),
                                   (vel - self.vel0).abs().max()))
        del system, pos, vel
        self.carry = self.sim.run(self.carry, int(t["warm_steps"]),
                                  chunk=self.chunk)
        self.work = {}

    def check(self, control: bool = False) -> dict:
        out = super().check(control)
        return out if control else {**out, "start_err": self.start_err}
