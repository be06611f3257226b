"""Velocity-Verlet NVE integrator pieces (PyTorch port of
``md_neighbor_list_tpu/ops/integrate.py``): kick-drift-kick with a periodic
position wrap. The step sizes are taken as f32 constants, as the JAX package
takes them; every function returns new tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from md_neighbor_list_tpu_torch.core.box import Box


def half_kick(vel: torch.Tensor, force: torch.Tensor,
              dt: float) -> torch.Tensor:
    return vel + float(np.float32(0.5 * dt)) * force


def drift(pos: torch.Tensor, vel: torch.Tensor, dt: float,
          box: Box) -> torch.Tensor:
    return box.wrap(pos + float(np.float32(dt)) * vel)


def kinetic_energy(vel: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.sum(vel * vel)
