"""NVE steps of the dense engine: ``DenseSimulator.run`` in chunks.

Traffic parameters (``traffic/<mix>.json``): ``chunk`` steps a call of
``run`` (the window's unit), ``warm_steps`` in set-up (the graph's capture
and the first rebuilds fall there), ``check_steps`` that the program and the
reference step from the program's state after the window, and
``trace_chunks`` chunks in the traced stretch.

The start: the configuration's simple-cubic lattice with Maxwell velocities
at its temperature from the seed (zero net momentum), made here and handed to
``build``. Rebuilds are displacement-triggered, as the engine makes them.

The check. A trajectory of tens of thousands of steps cannot be followed by
a float64 reference (it is chaotic), so the reference follows the program
step by step from the program's own state, and checks the start and the
trajectory by themselves:

  force_err     the forces of the program's state after its initial build
                (on the harness's input) and after the window, against the
                reference's forces on the same positions: the largest
                component error beyond the band's share, over the rms of the
                particles' sums of |pair force| (on the lattice start the
                forces themselves cancel to 0)
  step_gap      from the state after the window, ``check_steps`` steps by
                the program (through ``run``) and by the reference in
                float64: the largest distance between the two, in sigma
  energy_drift  |E(end) - E(start)| / |E(start)|, both by the reference: on
                the harness's start, and on the program's state after the
                window (NVE conserves the energy; the trajectory's check)
  lost          particles missing or held twice after the window

A state that the reference cannot follow (positions not finite, or cells
holding many times the mean: ``lj.Unphysical``) reads None for the numbers
that need it, which fails them.
"""

from __future__ import annotations

import sys

import torch

from mdbench.lib import inputs
from mdbench.lib import window
from mdbench.reference import lj


def md_config(cfg: dict, n: int | None):
    from md_neighbor_list_tpu_torch.core.config import MDConfig
    return MDConfig(n=n or cfg["n"], rho=cfg["rho"], rc=cfg["rc"],
                    skin=cfg["skin"], dt=cfg["dt"],
                    temperature=cfg["temperature"],
                    half_list=cfg["half_list"])


def start_system(cfg, seed: int, device):
    """The harness's start: (system for ``build``, pos, vel)."""
    from md_neighbor_list_tpu_torch.core.system import System
    n = cfg.n
    L = inputs.box_side(n, cfg.rho)
    pos = inputs.lattice(n, L, device)
    vel = inputs.maxwell(inputs.generator(seed, 0, device), n,
                         cfg.temperature, device)
    system = System(pos=pos, vel=vel, force=torch.zeros_like(pos),
                    pid=torch.arange(n, dtype=torch.int32, device=device))
    return system, pos, vel


def packed(state_pid: torch.Tensor, fields, n: int):
    """The program's slot arrays (3, ...) read back in particle order:
    (n, 3) tensors, and the number of particles missing or held twice."""
    pid = state_pid.reshape(-1).to(torch.int64)
    keep = pid >= 0
    ids = pid[keep]
    seen = torch.bincount(ids, minlength=n)[:n] if ids.numel() else \
        torch.zeros(n, dtype=torch.int64, device=pid.device)
    lost = int(torch.sum(seen != 1)) + int(torch.sum(ids >= n))
    out = []
    for f in fields:
        dst = torch.zeros((n, 3), dtype=torch.float32, device=pid.device)
        ok = ids < n
        dst[ids[ok]] = f.reshape(3, -1)[:, keep][:, ok].T
        out.append(dst)
    return out, lost


def force_error(force: torch.Tensor, ref) -> float:
    """Largest component error beyond each particle's band share, over the
    rms of the particles' sums of |pair force| (``ref``: the reference's
    ``Forces``)."""
    err = (force.to(torch.float64) - ref.force).abs().amax(dim=1)
    beyond = torch.clamp(err - ref.band, min=0.0)
    return float(beyond.max() / torch.sqrt(torch.mean(ref.scale**2)))


class Run:
    unit_name = "steps"

    def __init__(self, cell, seed: int, device, n: int | None = None):
        from md_neighbor_list_tpu_torch.models.dense_lj import DenseSimulator
        c, t = cell.config, cell.traffic
        self.cfg = md_config(c, n)
        self.L = inputs.box_side(self.cfg.n, self.cfg.rho)
        self.chunk = int(t["chunk"])
        self.check_steps = int(t["check_steps"])
        self.trace_units = int(t["trace_chunks"]) * self.chunk
        self.sim = DenseSimulator(self.cfg, cap=int(c["cap"]), device=device)
        system, self.pos0, self.vel0 = start_system(self.cfg, seed, device)
        self.carry = self.sim.build(system)
        # the program's forces on the harness's input
        (self.force0,), self.lost0 = packed(self.carry.state.pid,
                                            [self.carry.force], self.cfg.n)
        self.carry = self.sim.run(self.carry, int(t["warm_steps"]),
                                  chunk=self.chunk)
        self.work = {}

    def unit(self) -> int:
        self.carry = self.sim.run(self.carry, self.chunk, chunk=self.chunk)
        return self.chunk

    def advance(self, steps: int) -> None:
        self.carry = self.sim.run(self.carry, steps, chunk=self.chunk)

    def end_to_end(self, units: int, seconds: float) -> dict:
        return {"steps_per_s": {"value": window.rate(units, seconds),
                                "unit": "steps/s"}}

    def finish(self) -> None:
        n = self.cfg.n
        st = self.carry.state
        (self.pos, self.vel, self.force), self.lost = packed(
            st.pid, [st.pos, st.vel, self.carry.force], n)
        self.carry = self.sim.run(self.carry, self.check_steps,
                                  chunk=self.chunk)
        (self.pos_k,), lost_k = packed(self.carry.state.pid,
                                       [self.carry.state.pos], n)
        self.lost = max(self.lost, lost_k, self.lost0)
        self.cap = self.sim.cap
        del self.carry, self.sim

    def _reference(self):
        """The reference's forces on the start and on the state after the
        window, once."""
        if not hasattr(self, "_ref"):
            L, rc = self.L, self.cfg.rc
            self._ref = (lj.forces(self.pos0, L, rc),
                         lj.forces(self.pos, L, rc))
            self.work = {"n": self.cfg.n, "pairs_rc": self._ref[1].pairs,
                         "rc": rc, "cap": self.cap}
        return self._ref

    def check(self, control: bool = False) -> dict:
        try:
            return self._check(control)
        except lj.Unphysical as e:  # a state the reference cannot follow
            print(f"mdbench: the program's state is unphysical: {e}",
                  file=sys.stderr, flush=True)
            names = ("force_err",) if control else ("force_err", "step_gap",
                                                    "energy_drift")
            return {**{k: None for k in names},
                    **({} if control else {"lost": self.lost})}

    def _check(self, control: bool) -> dict:
        L, rc, dt = self.L, self.cfg.rc, float(self.cfg.dt)
        ref0, ref1 = self._reference()
        if control:  # the reference in bfloat16 in the program's place
            f0 = lj.forces(self.pos0, L, rc, precision="bf16").force
            f1 = lj.forces(self.pos, L, rc, precision="bf16").force
            return {"force_err": max(force_error(f0, ref0),
                                     force_error(f1, ref1))}
        err = max(force_error(self.force0, ref0),
                  force_error(self.force, ref1))
        e0 = float(0.5 * torch.sum(self.vel0.to(torch.float64)**2) + ref0.pe)
        e1 = float(0.5 * torch.sum(self.vel.to(torch.float64)**2) + ref1.pe)
        x, _ = lj.verlet(self.pos, self.vel, ref1.force, L, rc, dt,
                         self.check_steps)
        d = self.pos_k.to(torch.float64) - x
        d = d - L * torch.round(d / L)
        return {"force_err": err,
                "step_gap": float(d.abs().max()),
                "energy_drift": abs(e1 - e0) / abs(e0),
                "lost": self.lost}
