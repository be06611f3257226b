"""Particle state and initializers (PyTorch port of
``md_neighbor_list_tpu/core/system.py``).

``System`` is a NamedTuple of tensors that all live on one device. Random
draws take an explicit ``torch.Generator``; a generator's stream differs from
``jax.random``'s, so parity tests hand both packages the same numpy arrays
instead of the same seed.

The starts: ``init_lattice`` (simple cubic, the JAX package's), ``init_fcc``
(face-centred cubic, LAMMPS's ``lattice fcc``; the port's own) and
``init_random``; ``init_start`` picks the lattice a configuration names
(``MDConfig.lattice``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from md_neighbor_list_tpu_torch.core.box import Box


class System(NamedTuple):
    """MD particle state; ``pid`` tracks the original particle identity."""

    pos: torch.Tensor  # (N, 3) f32, wrapped into [0, L)
    vel: torch.Tensor  # (N, 3) f32
    force: torch.Tensor  # (N, 3) f32
    pid: torch.Tensor  # (N,)  i32 original particle id

    @property
    def n(self) -> int:
        return self.pos.shape[0]


def _fresh(pos: torch.Tensor, vel: torch.Tensor) -> System:
    n = pos.shape[0]
    return System(
        pos=pos.to(torch.float32),
        vel=vel.to(torch.float32),
        force=torch.zeros((n, 3), dtype=torch.float32, device=pos.device),
        pid=torch.arange(n, dtype=torch.int32, device=pos.device),
    )


def _generator(generator: torch.Generator | None, device) -> torch.Generator:
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    return generator


def init_lattice(n: int, rho: float, generator: torch.Generator | None = None,
                 temperature: float = 1.0,
                 device="cuda") -> tuple[System, Box]:
    """Place ``n`` particles on a simple-cubic lattice inside the rho-box.

    The box side is fixed by density (L = (n/rho)^(1/3)); the lattice uses
    ``ceil(n^(1/3))`` sites per dim and keeps the first ``n`` sites, so no two
    particles overlap. Velocities are Maxwell at ``temperature`` with the
    center-of-mass drift removed (zero net momentum)."""
    box = Box.from_density(n, rho)
    m = math.ceil(n ** (1.0 / 3.0))
    while m**3 < n:  # guard fp roundoff in ceil
        m += 1
    spacing = box.L / m
    idx = torch.arange(n, dtype=torch.int32, device=device)
    ix = idx % m
    iy = (idx // m) % m
    iz = idx // (m * m)
    pos = (torch.stack([ix, iy, iz], dim=-1).to(torch.float32) + 0.5) * spacing
    vel = _maxwell(_generator(generator, device), n, temperature, device)
    return _fresh(pos, vel), box


def init_fcc(n: int, rho: float, generator: torch.Generator | None = None,
             temperature: float = 1.0,
             device="cuda") -> tuple[System, Box]:
    """Place ``n`` = 4k^3 particles on a face-centred cubic lattice of k^3
    unit cells filling the rho-box (raises ``ValueError`` for any other n).

    The box side is fixed by density, as in ``init_lattice``; the lattice
    constant is a = L/k, and the sites are a*(i, j, l) + a*(0, 0, 0),
    a*(1/2, 1/2, 0), a*(1/2, 0, 1/2), a*(0, 1/2, 1/2), shifted by a/4 off the
    box's faces, cell by cell (i fastest, then j, l) and in that basis order
    within a cell. Nearest neighbours lie a/sqrt(2) apart. Velocities are
    Maxwell at ``temperature`` with zero net momentum, as ``init_lattice``
    makes them."""
    k = round((n / 4) ** (1.0 / 3.0))
    if n <= 0 or 4 * k**3 != n:
        raise ValueError(f"an fcc start needs n = 4k^3 particles, got {n}")
    box = Box.from_density(n, rho)
    cell = torch.arange(k**3, dtype=torch.int32, device=device)
    corner = torch.stack([cell % k, (cell // k) % k, cell // (k * k)],
                         dim=-1).to(torch.float32)
    basis = torch.tensor([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0], [0.5, 0.0, 0.5],
                          [0.0, 0.5, 0.5]], dtype=torch.float32, device=device)
    sites = corner[:, None, :] + (basis + 0.25)[None]  # (k^3, 4, 3)
    pos = sites.reshape(n, 3) * (box.L / k)
    vel = _maxwell(_generator(generator, device), n, temperature, device)
    return _fresh(pos, vel), box


def init_start(config, generator: torch.Generator | None = None,
               device="cuda") -> tuple[System, Box]:
    """The lattice start ``config`` (an ``MDConfig``) names: ``"sc"``
    (``init_lattice``) or ``"fcc"`` (``init_fcc``), at its n, rho and
    temperature."""
    init = init_fcc if config.lattice == "fcc" else init_lattice
    return init(config.n, config.rho, generator, config.temperature, device)


def init_random(generator: torch.Generator | None, n: int, rho: float,
                temperature: float = 1.0, device="cuda") -> tuple[System, Box]:
    """Uniform-random positions in the rho-box (may overlap — for
    neighbor-list parity tests where forces are never integrated)."""
    box = Box.from_density(n, rho)
    generator = _generator(generator, device)
    pos = torch.rand((n, 3), generator=generator, dtype=torch.float32,
                     device=device) * box.L
    vel = _maxwell(generator, n, temperature, device)
    return _fresh(pos, vel), box


def _maxwell(generator: torch.Generator, n: int, temperature: float,
             device) -> torch.Tensor:
    vel = torch.randn((n, 3), generator=generator, dtype=torch.float32,
                      device=device) * math.sqrt(temperature)
    return vel - vel.mean(dim=0, keepdim=True)
