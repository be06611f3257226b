"""Run configuration and the benchmark presets (the port's own copy of
``md_neighbor_list_tpu/core/config.py``: the two packages share no module).

The port adds to the JAX package's configuration the start's lattice
(``lattice``, whose default keeps the JAX package's simple-cubic start) and
the preset ``lammps_lj``; the five presets they share are field by field the
JAX package's.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MDConfig:
    """Full configuration of one simulation / benchmark run."""

    n: int = 16384
    rho: float = 1.0
    rc: float = 2.5  # LJ cutoff (sigma units)
    skin: float = 0.3  # Verlet skin; search radius rs = rc + skin
    dt: float = 0.001
    steps: int = 1000
    temperature: float = 1.0

    # Neighbor-list strategy
    layout: str = "morton"  # particle sort order: "morton" | "rowmajor"
    half_list: bool = True  # Newton-3rd-law dedup (C4) vs full lists
    rebuild_every_step: bool = False  # C2 mode: no skin reuse
    backend: str = "auto"  # pair sweep impl: "auto" | "xla" | "pallas"

    # Capacity overrides (None → Capacity.estimate)
    neighbor_capacity: int | None = None
    cell_capacity: int | None = None

    # Distributed (C5): number of slab devices along x; 1 = single chip
    mesh_devices: int = 1

    # The start's lattice (core/system.py::init_start): "sc" simple cubic
    # (init_lattice) | "fcc" face-centred cubic, n = 4k^3 (init_fcc)
    lattice: str = "sc"

    def __post_init__(self):
        if self.layout not in ("morton", "rowmajor"):
            raise ValueError(f"layout must be 'morton' or 'rowmajor', got {self.layout!r}")
        if self.backend not in ("auto", "xla", "pallas"):
            raise ValueError(f"backend must be auto|xla|pallas, got {self.backend!r}")
        if self.lattice not in ("sc", "fcc"):
            raise ValueError(f"lattice must be 'sc' or 'fcc', got {self.lattice!r}")
        if self.n <= 0 or self.rho <= 0 or self.rc <= 0 or self.skin < 0:
            raise ValueError("n, rho, rc must be positive and skin non-negative")

    @property
    def rs(self) -> float:
        return self.rc + self.skin


PRESETS: dict[str, MDConfig] = {
    # C1 — brute-force O(N^2) oracle config
    "c1_brute": MDConfig(n=16384, steps=100, rebuild_every_step=True),
    # C2 — cell list, full rebuild every step, pair-count parity
    "c2_cell": MDConfig(n=100_000, steps=100, rebuild_every_step=True,
                        layout="rowmajor"),
    # C3 — Verlet skin + displacement-triggered rebuild in NVE
    "c3_verlet": MDConfig(n=100_000, steps=1000),
    # C4 — sorted SoA, half lists, N=1M on a single device
    "c4_sorted": MDConfig(n=1_000_000, steps=1000, layout="morton",
                          half_list=True),
    # C5 — slab domain decomposition, N=8M over 8 devices
    "c5_dd": MDConfig(n=8_000_000, steps=1000, mesh_devices=8),
    # LAMMPS bench/in.lj (3d LJ melt) scaled by 4 a side (-var x 4 -var y 4
    # -var z 4): 80^3 fcc unit cells at rho* = 0.8442, velocity create 1.44,
    # lj/cut 2.5, neighbor 0.3 bin, fix nve, timestep 0.005
    "lammps_lj": MDConfig(n=2_048_000, rho=0.8442, rc=2.5, skin=0.3,
                          dt=0.005, temperature=1.44, half_list=True,
                          layout="morton", lattice="fcc"),
}
