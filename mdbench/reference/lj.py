"""The plain reference of the configuration: Lennard-Jones particles in a
periodic cube, in plain PyTorch, with nothing of the program.

It finds every pair within a radius by its own cell list (cells of side at
least the radius, 27 neighbouring cells, the minimum image), a block of
particles at a time so that N = 1M and 8M fit, and computes in float64 from
the float32 inputs it is handed:

  half_pairs   the keys i * N + j (i < j) of the pairs within r, sorted, and
               the keys of the pairs in the rounding band around r
  forces       the LJ force on each particle (pairs within rc), the shifted
               potential energy, and each particle's sum of |pair force| over
               the pairs in the band around rc and over all its pairs
  verlet       velocity-Verlet steps from a given state

The band: the program rounds r^2 step by step in float32 from float32
coordinates (an image shift and a difference), so a pair within about 1e-5 of
the cutoff may fall on either side of it there. A pair whose reference
distance lies within ``BAND`` of the cutoff is the band's: a mismatch on it
is not a fault, and anything else is. ``precision="bf16"`` is the control:
the same search with the distance test and the pair terms in bfloat16 (the
difference taken in float32 and rounded), the sums in float32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

BAND = 2e-5  # half-width of the rounding band around a cutoff, in sigma
BLOCK = 16384  # particles per block


class Unphysical(ValueError):
    """Positions that are not finite, or a cell that holds many times the
    mean: no state of these configurations (a liquid or a jittered lattice
    at rho = 1), and more than the reference's cell list can hold."""


class Cells:
    """The cell list of float32 positions ``pos`` (N, 3) in a cube of side
    ``L`` for radius ``r``."""

    def __init__(self, pos: torch.Tensor, L: float, r: float):
        self.pos32 = torch.remainder(pos.to(torch.float32), L)
        self.pos = torch.remainder(pos.to(torch.float64), L)
        self.n = pos.shape[0]
        self.L = float(L)
        self.r = float(r)
        dev = pos.device
        if not bool(torch.isfinite(pos).all()):
            raise Unphysical("positions that are not finite")
        mc = int(math.floor(self.L / self.r))
        self.mc = mc
        if mc < 3:  # too few cells for 27 distinct ones: every particle
            self.table = None
            return
        c = torch.clamp(torch.floor(self.pos / (self.L / mc)).to(torch.int64),
                        0, mc - 1)
        self.cell = c
        key = c[:, 0] + mc * (c[:, 1] + mc * c[:, 2])
        order = torch.argsort(key, stable=True)
        counts = torch.bincount(key, minlength=mc**3)
        start = torch.cumsum(counts, 0) - counts
        cap = int(counts.max())
        if cap > 64 + 16 * self.n / mc**3:
            raise Unphysical(f"a cell holds {cap} particles, "
                             f"{self.n / mc**3:.1f} on average")
        ks = key[order]
        rank = torch.arange(self.n, device=dev) - start[ks]
        self.table = torch.full((mc**3, cap), -1, dtype=torch.int64,
                                device=dev)
        self.table[ks, rank] = order
        o = torch.arange(-1, 2, device=dev)
        self.offsets = torch.cartesian_prod(o, o, o)  # (27, 3)

    def candidates(self, i: torch.Tensor) -> torch.Tensor:
        """(B, C) candidate partners of particles ``i`` (B,), -1 padded:
        every particle of the 27 cells around each, itself excluded."""
        if self.table is None:
            cand = torch.arange(self.n, device=i.device).expand(len(i), -1)
        else:
            mc = self.mc
            nc = torch.remainder(self.cell[i][:, None, :]
                                 + self.offsets[None], mc)
            keys = nc[..., 0] + mc * (nc[..., 1] + mc * nc[..., 2])
            cand = self.table[keys].reshape(len(i), -1)
        return torch.where(cand == i[:, None], -1, cand)

    def blocks(self, precision: str = "f64", block: int = BLOCK):
        """Per block: (i (B,), j (B, C), d (B, C, 3), r2 (B, C), ok (B, C)):
        d = x_j - x_i by the minimum image, r2 = |d|^2, ok the real
        candidates. f64: from the float64 positions; bf16: the difference
        in float32, rounded to bfloat16, r2 summed in bfloat16."""
        for b0 in range(0, self.n, block):
            i = torch.arange(b0, min(b0 + block, self.n),
                             device=self.pos.device)
            j = self.candidates(i)
            ok = j >= 0
            jj = torch.clamp(j, min=0)
            if precision == "f64":
                d = self.pos[jj] - self.pos[i][:, None, :]
                d = d - self.L * torch.round(d / self.L)
            elif precision == "bf16":
                L32 = float(torch.tensor(self.L, dtype=torch.float32))
                d = self.pos32[jj] - self.pos32[i][:, None, :]
                d = (d - L32 * torch.round(d / L32)).to(torch.bfloat16)
            else:
                raise ValueError(f"precision={precision!r}")
            r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] \
                + d[..., 2] * d[..., 2]
            yield i, j, d, r2, ok


def _in_band(r2: torch.Tensor, r: float) -> torch.Tensor:
    r2 = r2.to(torch.float64)
    return (r2 >= (r - BAND)**2) & (r2 <= (r + BAND)**2)


def half_pairs(pos: torch.Tensor, L: float, r: float,
               precision: str = "f64") -> tuple[torch.Tensor, torch.Tensor]:
    """(keys, band): sorted int64 keys i * N + j, i < j, of the pairs within
    ``r``, and of the pairs in the band around ``r`` (f64 distances)."""
    cells = Cells(pos, L, r)
    n = cells.n
    keys, band = [], []
    for i, j, _, r2, ok in cells.blocks(precision):
        half = ok & (j > i[:, None])
        ii = i[:, None].expand_as(j)
        hit = half & (r2.to(torch.float64) < r * r)
        keys.append(ii[hit] * n + j[hit])
        if precision == "f64":
            near = half & _in_band(r2, r)
            band.append(ii[near] * n + j[near])
    keys = torch.sort(torch.cat(keys)).values
    band = torch.sort(torch.cat(band)).values if band else keys[:0]
    return keys, band


def _pair_terms(r2: torch.Tensor, hit: torch.Tensor, rc: float):
    """(f, u): the LJ pair force over r (F_i = -f * d) and the shifted
    potential of each hit, in ``r2``'s precision; 0 where not hit."""
    one = torch.ones_like(r2)
    s2 = one / torch.where(hit, r2, one)
    s6 = s2 * s2 * s2
    f = 24.0 * s6 * (2.0 * s6 - 1.0) * s2
    sc6 = (1.0 / (rc * rc))**3
    u = 4.0 * (s6 * s6 - s6) - 4.0 * (sc6 * sc6 - sc6)
    zero = torch.zeros_like(r2)
    return torch.where(hit, f, zero), torch.where(hit, u, zero)


class Forces(NamedTuple):
    force: torch.Tensor  # (N, 3) f64: the LJ force on each particle
    pe: torch.Tensor  # 0-d f64: the shifted potential energy
    band: torch.Tensor  # (N,) f64: sum of |pair force| over the rc band
    scale: torch.Tensor  # (N,) f64: sum of |pair force| over all its pairs
    pairs: int  # pairs within rc


def forces(pos: torch.Tensor, L: float, rc: float,
           precision: str = "f64") -> Forces:
    """The LJ force on each particle from every pair within ``rc`` (full
    neighbour sums), the shifted potential energy, each particle's sum of
    |pair force| over the pairs in the band around ``rc`` (by f64 distances:
    what a pair on either side of the cutoff may add or leave out) and over
    all its pairs (the size of what its force sums, which rounding errors
    scale with; on a lattice the force itself is 0), and the number of pairs
    within ``rc``."""
    cells = Cells(pos, L, rc)
    dev = pos.device
    force = torch.zeros((cells.n, 3), dtype=torch.float64, device=dev)
    band = torch.zeros(cells.n, dtype=torch.float64, device=dev)
    scale = torch.zeros(cells.n, dtype=torch.float64, device=dev)
    pe = torch.zeros((), dtype=torch.float64, device=dev)
    hits = 0
    for i, j, d, r2, ok in cells.blocks(precision):
        hit = ok & (r2.to(torch.float64) < rc * rc)
        hits += int(hit.sum())
        f, u = _pair_terms(r2, hit, rc)
        pair = -(f[..., None] * d)  # force on i from j
        acc = torch.float64 if precision == "f64" else torch.float32
        force[i] = torch.sum(pair.to(acc), dim=1).to(torch.float64)
        pe += 0.5 * torch.sum(u.to(acc)).to(torch.float64)
        if precision == "f64":
            r = torch.sqrt(r2)
            scale[i] = torch.sum(torch.abs(f) * r, dim=1)
            near = ok & _in_band(r2, rc)
            fb, _ = _pair_terms(r2, near, rc)
            band[i] = torch.sum(torch.abs(fb) * r, dim=1)
    return Forces(force, pe, band, scale, hits // 2)


def verlet(pos: torch.Tensor, vel: torch.Tensor, force: torch.Tensor,
           L: float, rc: float, dt: float, steps: int):
    """``steps`` velocity-Verlet steps in float64 from (pos, vel, force):
    returns (pos, vel) with positions unwrapped."""
    x = pos.to(torch.float64).clone()
    v = vel.to(torch.float64).clone()
    f = force.to(torch.float64).clone()
    for _ in range(steps):
        v += 0.5 * dt * f
        x += dt * v
        f = forces(x, L, rc).force
        v += 0.5 * dt * f
    return x, v


def brute_half_pairs(pos: torch.Tensor, L: float, r: float) -> torch.Tensor:
    """Sorted keys of the pairs within ``r`` by testing every pair: the check
    of the cell list at small N."""
    p = pos.to(torch.float64)
    n = p.shape[0]
    d = p[None, :, :] - p[:, None, :]
    d = d - L * torch.round(d / L)
    r2 = torch.sum(d * d, dim=-1)
    i, j = torch.nonzero((r2 < r * r) & torch.triu(
        torch.ones((n, n), dtype=torch.bool, device=p.device), 1),
        as_tuple=True)
    return torch.sort(i * n + j).values
