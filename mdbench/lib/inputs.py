"""The benchmark's inputs, made on the device from ``--seed`` by the
harness's own code: the same seed gives the same inputs, and the reference is
handed the very same tensors.

Each stream of random numbers has its own generator, seeded from the run's
seed and the stream's number, so that one input can be made again after the
window (the frame of call j, the drift of build j) without replaying the
others.
"""

from __future__ import annotations

import math

import torch


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for stream ``stream`` of run ``seed`` (any
    whole number, also past 32 bits)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + int(stream) * 7_919 + 12_345)
                  % 2**63)
    return g


def box_side(n: int, rho: float) -> float:
    return float((n / rho) ** (1.0 / 3.0))


def lattice(n: int, L: float, device) -> torch.Tensor:
    """(n, 3) f32: the first n sites of the smallest simple-cubic lattice of
    m^3 >= n sites filling the box, each at its cell's centre."""
    m = math.ceil(n ** (1.0 / 3.0))
    while m**3 < n:
        m += 1
    while (m - 1)**3 >= n:
        m -= 1
    idx = torch.arange(n, dtype=torch.int64, device=device)
    ijk = torch.stack([idx % m, (idx // m) % m, idx // (m * m)], dim=-1)
    return ((ijk.to(torch.float32) + 0.5) * (L / m)).contiguous()


def maxwell(g: torch.Generator, n: int, temperature: float,
            device) -> torch.Tensor:
    """(n, 3) f32 Maxwell velocities at ``temperature`` (unit mass), with the
    centre-of-mass drift removed."""
    vel = torch.randn((n, 3), generator=g, dtype=torch.float32,
                      device=device) * math.sqrt(temperature)
    return vel - vel.mean(dim=0, keepdim=True)


def jittered(base: torch.Tensor, g: torch.Generator, jitter: float,
             L: float) -> torch.Tensor:
    """``base`` with every coordinate moved by a uniform draw in
    [-jitter, jitter), wrapped into [0, L)."""
    u = torch.rand(base.shape, generator=g, dtype=torch.float32,
                   device=base.device)
    return torch.remainder(base + (2.0 * u - 1.0) * jitter, L)


def shuffled(pos: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    """The rows of ``pos`` in a seeded order."""
    return pos[torch.randperm(pos.shape[0], generator=g,
                              device=pos.device)].contiguous()
