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
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("frozen", "half", "alter")


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


@contextlib.contextmanager
def planted(fault: str, driver: str):
    """Plant ``fault`` into what ``driver``'s window drives, for the block;
    yields the ``Switch`` that the harness arms at the window's start."""
    if fault not in FAULTS:
        raise ValueError(f"fault {fault!r}: one of {FAULTS}")
    from md_neighbor_list_tpu_torch.models import dense_lj
    switch = Switch()
    with contextlib.ExitStack() as stack:
        if driver == "nve" and fault == "frozen":
            def run(orig):
                def broken(self, carry, nsteps, chunk=100):
                    if switch.on:
                        return carry
                    return orig(self, carry, nsteps, chunk)
                return broken
            _patch(stack, dense_lj.DenseSimulator, "run", run)
        elif driver == "nve":
            def forces(orig):
                def broken(self, state, want_pe=False):
                    f, pe = orig(self, state, want_pe)
                    f = f.clone()
                    on = switch.flag(f.device)
                    if fault == "half":
                        f[:, :f.shape[1] // 2] *= 1.0 - on
                    else:
                        first = torch.argmax(
                            (state.pid.reshape(-1) >= 0).to(torch.int32))
                        f[0].view(-1)[first] += on
                    return f, pe
                return broken
            _patch(stack, dense_lj.DenseSimulator, "_forces", forces)
        elif driver == "build":
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
