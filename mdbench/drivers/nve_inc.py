"""NVE steps of the dense engine under its incremental rebuild:
``drivers/nve.py``'s start, run, window and check, with ``DenseSimulator``
built with ``incremental=True`` where the configuration's ``rebuild`` is
``"incremental"`` (the port's option: at a rebuild only the particles that
changed cell are sorted and merged in, and the full rebuild runs where the
mover stream trips the window predicate).

Traffic parameters (``traffic/<mix>.json``): those of ``nve``.

``counters`` (the result's ``window.counters``), over the window and the
traced stretch: the steps, the rebuilds, how many of them kept the merged
state (``incremental_rebuilds``) and how many took the full rebuild
(``full_fallbacks``), and the movers an incremental pass sorted
(``movers_per_rebuild``), from the engine's device counters read at the end
of set-up and before the check's steps. A program whose engine counts no
movers cannot report the cell: the run stops at its start, exit 1.
"""

from __future__ import annotations

from mdbench.drivers import nve
from mdbench.lib import inputs


def incremental(config: dict) -> bool:
    """Whether the configuration names the incremental rebuild."""
    return config.get("rebuild") == "incremental"


def engine(config: dict, cfg, device):
    """The program's ``DenseSimulator`` of ``cfg`` (an ``MDConfig``) as the
    configuration ``config`` names it: its cap, its rebuild path. Refused,
    before any work, where the engine counts no movers."""
    from md_neighbor_list_tpu_torch.models.dense_lj import DenseSimulator
    if not hasattr(DenseSimulator, "movers"):
        raise RuntimeError("DenseSimulator counts no movers: this cell "
                           "reports the movers a rebuild")
    return DenseSimulator(cfg, cap=int(config["cap"]), device=device,
                          incremental=incremental(config))


def engine_counts(sim) -> tuple:
    """(incremental rebuilds kept, full fallbacks, movers sorted) so far, by
    the engine's device counters: one host read each, outside any chunk."""
    return sim.incremental_rebuilds, sim.full_fallbacks, sim.movers


def counters(before: tuple, after: tuple) -> dict:
    """What the engine counted between two ``engine_counts``."""
    kept, full, movers = (b - a for a, b in zip(before, after))
    passes = kept + full
    return {"rebuilds": passes, "incremental_rebuilds": kept,
            "full_fallbacks": full,
            "movers_per_rebuild": movers / passes if passes else None}


class Run(nve.Run):
    def __init__(self, cell, seed: int, device, n: int | None = None):
        c, t = cell.config, cell.traffic
        self.cfg = nve.md_config(c, n)
        self.L = inputs.box_side(self.cfg.n, self.cfg.rho)
        self.chunk = int(t["chunk"])
        self.check_steps = int(t["check_steps"])
        self.trace_units = int(t["trace_chunks"]) * self.chunk
        self.sim = engine(c, self.cfg, device)
        system, self.pos0, self.vel0 = nve.start_system(self.cfg, seed,
                                                        device)
        self.carry = self.sim.build(system)
        # the program's forces on the harness's input
        (self.force0,), self.lost0 = nve.packed(self.carry.state.pid,
                                                [self.carry.force], self.cfg.n)
        self.carry = self.sim.run(self.carry, int(t["warm_steps"]),
                                  chunk=self.chunk)
        self.work = {}
        self.steps, self._counted = 0, engine_counts(self.sim)

    def unit(self) -> int:
        done = super().unit()
        self.steps += done
        return done

    def advance(self, steps: int) -> None:
        super().advance(steps)
        self.steps += steps

    def finish(self) -> None:
        self.counters = {"steps": self.steps, **counters(
            self._counted, engine_counts(self.sim))}
        super().finish()
