"""Checkpoint / resume (PyTorch port of
``md_neighbor_list_tpu/utils/checkpoint.py``).

The particle state and a step counter round-trip through one ``.npz`` file
with the JAX package's keys (``pos``, ``vel``, ``force`` in pid order,
``step``, ``meta_*``), so a state written by either package loads in the
other bit for bit. Resume is exact because the engines rebuild all derived
state (neighbour structure, forces) deterministically from (pos, vel).
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

from md_neighbor_list_tpu_torch.core.system import System


def save(path: str | pathlib.Path, system: System, step: int = 0,
         meta: dict | None = None) -> None:
    """Write the state (in pid order) and the step counter to ``path``."""
    order = np.argsort(system.pid.cpu().numpy())
    np.savez(
        path,
        pos=system.pos.cpu().numpy()[order],
        vel=system.vel.cpu().numpy()[order],
        force=system.force.cpu().numpy()[order],
        step=np.int64(step),
        **({f"meta_{k}": v for k, v in (meta or {}).items()}),
    )


def load(path: str | pathlib.Path, device="cuda") -> tuple[System, int]:
    """Read a checkpoint back as a fresh pid-ordered System on ``device``."""
    with np.load(path) as z:
        n = z["pos"].shape[0]
        system = System(
            pos=torch.tensor(z["pos"], dtype=torch.float32, device=device),
            vel=torch.tensor(z["vel"], dtype=torch.float32, device=device),
            force=torch.tensor(z["force"], dtype=torch.float32, device=device),
            pid=torch.arange(n, dtype=torch.int32, device=device),
        )
        return system, int(z["step"])
