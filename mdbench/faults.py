"""Faults planted in the program under the harness, to show that the check
catches them: each breaks the timed path underneath, from the window's first
unit on (``Switch``), and a run must come out with ``correct`` false. The CPU
tests plant them at a small size; on the card ``run.py --fault <name>`` reads
a fault's numbers at the cell's own size.

  frozen  a step or build that returns its state unchanged: ``run`` gives
          back the carry it was handed, a build the first build's outputs
  half    half of the batch left out: the forces or list masks of the first
          half of the slots left at zero
  alter   one answer altered where it is produced: one force component, one
          mask bit
  ring    the exchange between cards left out (``nve_slab``): the seam's
          Newton-3 reactions that each rank sends to the rank above it are
          dropped, so the first layer of every slab misses the forces of the
          pairs across its lower face

The NVE drivers' ``half`` and ``alter`` break the step's force where the
step makes it (``DenseSimulator._step_forces``, over the half list); both NVE
drivers (``nve``, ``nve_fcc``) run that step.
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("frozen", "half", "alter")  # of the one-card drivers
SLAB_FAULTS = ("frozen", "ring")  # of nve_slab


class Switch:
    """Turns a planted fault on when the window starts (``arm``): the
    program's set-up, its warm-up and the graph's capture run sound, and
    the timed path is broken underneath from its first unit on. Code that
    a graph captures reads the switch on the device (``flag``), so that its
    replays follow it."""

    def __init__(self):
        self.on = False
        self._flags = {}

    def flag(self, device) -> torch.Tensor:
        """A 0-d float32 on ``device``: 1.0 once armed, else 0.0."""
        key = str(device)
        if key not in self._flags:
            self._flags[key] = torch.full((), float(self.on),
                                          dtype=torch.float32, device=device)
        return self._flags[key]

    def arm(self) -> None:
        self.on = True
        for f in self._flags.values():
            f.fill_(1.0)


def _patch(stack, owner, name, make):
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    stack.callback(setattr, owner, name, orig)


def _frozen_run(switch):
    """``run`` that gives back the carry it was handed once armed."""
    def run(orig):
        def broken(self, carry, nsteps, chunk=100):
            if switch.on:
                return carry
            return orig(self, carry, nsteps, chunk)
        return broken
    return run


@contextlib.contextmanager
def planted(fault: str, driver: str):
    """Plant ``fault`` into what ``driver``'s window drives, for the block;
    yields the ``Switch`` that the harness arms at the window's start."""
    if fault not in FAULTS + SLAB_FAULTS:
        raise ValueError(f"fault {fault!r}: one of {FAULTS + SLAB_FAULTS}")
    from md_neighbor_list_tpu_torch.models import dense_lj
    switch = Switch()
    nve = driver in ("nve", "nve_fcc")
    with contextlib.ExitStack() as stack:
        if nve and fault == "frozen":
            _patch(stack, dense_lj.DenseSimulator, "run", _frozen_run(switch))
        elif nve and fault in ("half", "alter"):
            def step_forces(orig):
                def broken(self, carry):
                    orig(self, carry)
                    f, on = carry.force, switch.flag(carry.force.device)
                    if fault == "half":
                        f[:, :f.shape[1] // 2] *= 1.0 - on
                    else:  # one component of the first occupied slot
                        held = carry.state.pid.reshape(-1) >= 0
                        first = torch.argmax(held.to(torch.int32))
                        slot = torch.arange(held.numel(), device=held.device)
                        f[0].view(-1).add_((slot == first) * on)
                return broken
            _patch(stack, dense_lj.DenseSimulator, "_step_forces",
                   step_forces)
        elif driver == "nve_slab" and fault == "frozen":
            from md_neighbor_list_tpu_torch.parallel import dense_slab
            _patch(stack, dense_slab.DenseSlabSimulator, "run",
                   _frozen_run(switch))
        elif driver == "nve_slab" and fault == "ring":
            from md_neighbor_list_tpu_torch.parallel import dense_slab

            def boundary(orig):
                def broken(*args, **kwargs):
                    f_last, seam = orig(*args, **kwargs)
                    return f_last, seam * (1.0 - switch.flag(seam.device))
                return broken
            _patch(stack, dense_slab, "slab_forces_boundary", boundary)
        elif driver == "build" and fault in FAULTS:
            def build(orig):
                first = []

                def broken(self, state):
                    out = orig(self, state)
                    if not switch.on:
                        return out
                    if fault == "frozen":
                        st = type(out[0])
                        if not first:
                            first.append((st(*(t.clone() for t in out[0])),
                                          *(t.clone() for t in out[1:])))
                        return first[0]
                    masks = out[2]
                    if fault == "half":
                        masks[:, :, :masks.shape[2] // 2] = 0
                    else:
                        masks.view(-1)[0] ^= 1
                    return out
                return broken
            _patch(stack, dense_lj.DenseSimulator, "_rebuild_and_lists",
                   build)
        else:
            raise ValueError(f"no fault {fault!r} for driver {driver!r}")
        yield switch
