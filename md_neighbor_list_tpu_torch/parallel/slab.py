"""SlabSimulator: slab domain decomposition of the padded-row ("xla") engine
(PyTorch port of ``md_neighbor_list_tpu/parallel/slab.py``).

The periodic box is split into P slabs along x over a ring of P ranks
(``parallel/mesh.py``: ``Ring`` over ``torch.distributed``, one process a
rank; or ``LocalRing``, P threads of one process). Per rank, all state lives
in fixed-capacity slot arrays:

  combined index space per rank, size M = cap + 2*gcap:
    [0, cap)            owned slots          (pid >= 0 marks occupancy)
    [cap, cap+gcap)     ghosts from the LEFT  neighbour (x just below my lo)
    [cap+gcap, M)       ghosts from the RIGHT neighbour (x just above my hi)

Protocol per step (neighbour shifts, one scalar ``max`` vote: the JAX
package's ``ppermute`` and ``pmax``). The JAX step puts the rebuild under one
``lax.cond`` with its ``ppermute`` calls inside; here the rebuild is three
branches on the one vote, and every exchange is made every step, between
them, so that no branch holds a collective:

  kick; drift; vote = max over the ring of (4*max_disp^2 > skin^2), a 0-d
  device tensor
  branch 1    migrate out: the emigrants to the +-1 neighbours packed, one
              (mig, 7) f32 tensor a direction (pos, vel, pid bit-cast)
  shift       the two packs (unread without a rebuild)
  branch 2    merge in: stable recompaction of stayers + immigrants into the
              owned slots; the face bands (within rs of each face) recorded
              as the send index lists
  shift       the ghosts both ways: positions and pids gathered at the send
              lists (between rebuilds the same sets, fresh positions: the
              ghost *set* stays valid by the skin argument)
  branch 3    bin + sweep the combined set (stable slot order, inactive
              slots masked)
  forces over the combined set with FULL lists -> owned forces complete
  locally (no reverse force exchange); kick.

Geometric preconditions (checked): slab width w > rs (the halo is only +-1
deep); P >= 2; for P == 2, w >= 2*rs (else one particle could land twice in
the same rank's ghost blocks). There is no P = 1 mode: ``Simulator`` is the
one-rank engine.

Plain PyTorch on the rank's device, no kernel: the JAX engine reaches no
Pallas call. As the JAX ``jit(shard_map(lax.scan(step)))`` does, a chunk runs
as one device program on the card where the ring can be captured (an NCCL
group): ``run`` replays a CUDA graph of one step (``utils/graphs.py``), each
branch a conditional node on the vote, the exchanges captured between them.
The step writes every result into the state's own storage; ``run`` clones
the state at the start of each chunk for the rollback and reads the sticky
overflow flag once a chunk, reduced over the ring so that every rank grows
and rebuilds together. On a ``LocalRing`` (host barriers) and on the CPU the
same step runs eagerly. ``step_fn`` is that eager step: it returns a new
state and reads the vote on the host once.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from md_neighbor_list_tpu_torch.core.box import Box
from md_neighbor_list_tpu_torch.core.capacity import estimate, round_up
from md_neighbor_list_tpu_torch.core.config import MDConfig
from md_neighbor_list_tpu_torch.core.system import System, init_start
from md_neighbor_list_tpu_torch.ops import lj
from md_neighbor_list_tpu_torch.ops.binning import CellGrid, make_grid
from md_neighbor_list_tpu_torch.ops.common import compact_rows
from md_neighbor_list_tpu_torch.ops.integrate import (drift, half_kick,
                                                      kinetic_energy)
from md_neighbor_list_tpu_torch.ops.pairlist import \
    build_neighbor_lists_stable
from md_neighbor_list_tpu_torch.parallel.mesh import Ring, rank_device
from md_neighbor_list_tpu_torch.utils.graphs import ChunkRunner, eager_cond


@dataclasses.dataclass(frozen=True)
class DDCapacity:
    """Static per-rank capacities, grown on overflow."""

    local: int  # owned particle slots per rank
    ghost: int  # ghost slots per side
    mig: int  # migration buffer slots per direction
    neighbors: int  # K, full-list padded rows
    cell: int  # dense cell-table depth
    growth: float = 1.5

    def grown(self) -> "DDCapacity":
        g = self.growth
        return dataclasses.replace(
            self,
            local=round_up(int(self.local * g) + 8, 8),
            ghost=round_up(int(self.ghost * g) + 8, 8),
            mig=round_up(int(self.mig * g) + 8, 8),
            neighbors=round_up(int(self.neighbors * g) + 8, 8),
            cell=round_up(int(self.cell * g) + 8, 8),
        )


def estimate_dd(config: MDConfig, box: Box, cell_size: float) -> DDCapacity:
    p = config.mesh_devices
    per_dev = config.n / p
    base = estimate(config.rho, config.rs, cell_size, half_list=False)
    face = config.rho * box.L * box.L  # particles per unit slab depth
    return DDCapacity(
        local=round_up(int(per_dev * 1.3) + 64, 8),
        ghost=round_up(int(face * config.rs * 1.5) + 64, 8),
        mig=round_up(int(face * max(config.skin, 0.1) * 2.0) + 64, 8),
        neighbors=base.neighbors,
        cell=base.cell,
    )


class DDState(NamedTuple):
    """One rank's slab state (the JAX state's entry of this rank)."""

    pos: torch.Tensor  # (cap, 3)
    vel: torch.Tensor  # (cap, 3)
    force: torch.Tensor  # (cap, 3)
    pid: torch.Tensor  # (cap,) i32, -1 = empty
    ghost_pos: torch.Tensor  # (2, gcap, 3)  [0]=from-left, [1]=from-right
    ghost_pid: torch.Tensor  # (2, gcap) i32
    send_idx: torch.Tensor  # (2, gcap) i32  [0]=low-face sends, [1]=high-face
    idx: torch.Tensor  # (M, K) i32 neighbour rows, sentinel M
    ref_pos: torch.Tensor  # (cap, 3)
    n_rebuilds: torch.Tensor  # () i32
    overflow: torch.Tensor  # () bool (sticky)


def check_geometry(config: MDConfig) -> tuple[Box, CellGrid, float]:
    """(box, grid, slab width) of a slab run, or the JAX package's
    ``ValueError`` for a configuration it refuses. Needs no ring, so a caller
    can check before any rank starts."""
    if config.mesh_devices < 2:
        raise ValueError("SlabSimulator needs mesh_devices >= 2; "
                         "use Simulator for a single chip")
    box = Box.from_density(config.n, config.rho)
    grid = make_grid(box, config.rs)
    if not grid.usable:
        raise ValueError("box too small for a cell grid; DD unsupported")
    p = config.mesh_devices
    w = box.L / p
    if w <= config.rs:
        raise ValueError(
            f"slab width {w:.3f} must exceed rs={config.rs} "
            "(halo exchange is only +-1 neighbor deep)")
    if p == 2 and w < 2 * config.rs:
        raise ValueError("P=2 requires slab width >= 2*rs")
    return box, grid, w


def _clone(st: DDState) -> DDState:
    return DDState(*(t.clone() for t in st))


def _gather_rows(arr: torch.Tensor, idx: torch.Tensor, fill) -> torch.Tensor:
    """Gather rows with one sentinel row appended (idx == len(arr) -> fill)."""
    ext = torch.cat([arr, torch.full((1,) + arr.shape[1:], fill,
                                     dtype=arr.dtype, device=arr.device)])
    return ext[idx.long()]


class SlabSimulator:
    """LJ/NVE over P slabs, this rank being ``ring.rank``. API mirrors
    ``Simulator``. ``ring`` is a ``parallel.mesh.Ring`` or ``LocalRing`` of
    ``config.mesh_devices`` ranks; ``device`` "cuda" runs on
    ``cuda:rank % device_count``."""

    def __init__(self, config: MDConfig, capacity: DDCapacity | None = None,
                 device="cuda", ring: Ring | None = None):
        self.box, self.grid, self.w = check_geometry(config)
        self.ring = Ring() if ring is None else ring
        if self.ring.size != config.mesh_devices:
            raise ValueError(
                f"config.mesh_devices = {config.mesh_devices} but the ring "
                f"has {self.ring.size} ranks")
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "SlabSimulator runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU")
        self.device = rank_device(device, self.ring.rank)
        self.config = config
        self.p = config.mesh_devices
        self.capacity = capacity or estimate_dd(config, self.box,
                                                self.grid.cell_size)
        # the f32 constants of the JAX step: XLA turns x / f32(w) into
        # x * f32(1 / f32(w)), so the slab index takes that product; the
        # face bands are f32 sums of the rank's f32 lo
        w32 = np.float32(self.w)
        self._inv_w = float(np.float32(1.0) / w32)
        lo = np.float32(self.ring.rank) * w32
        self._band_low = float(lo + np.float32(config.rs))
        self._band_high = float((lo + w32) - np.float32(config.rs))
        self._runner = ChunkRunner()

    # ------------------------------------------------------------ per rank
    def _combined(self, st: DDState):
        xpos = torch.cat([st.pos, st.ghost_pos[0], st.ghost_pos[1]])
        xpid = torch.cat([st.pid, st.ghost_pid[0], st.ghost_pid[1]])
        return xpos, xpid >= 0

    def _forces(self, st: DDState):
        """(owned forces, PE of the owned rows) over the combined set."""
        xpos, _ = self._combined(st)
        cl = st.pid.shape[0]
        owned = torch.cat([st.pid >= 0, torch.zeros(
            (xpos.shape[0] - cl,), dtype=torch.bool, device=self.device)])
        f_all, u = lj.forces_energy(xpos, st.idx, self.box, self.config.rc,
                                    half=False, energy_rows=owned)
        return f_all[:cl], u

    def _pack(self, st: DDState, idx: torch.Tensor, vel: bool
              ) -> torch.Tensor:
        """The records of the slots ``idx`` (sentinel ``cl``: position and
        velocity 0, pid -1) as one f32 tensor, a row a record: position,
        velocity if ``vel``, pid bit-cast to f32. One shift moves it."""
        cols = [_gather_rows(st.pos, idx, 0.0)]
        if vel:
            cols.append(_gather_rows(st.vel, idx, 0.0))
        cols.append(_gather_rows(st.pid, idx, -1).view(torch.float32)[:, None])
        return torch.cat(cols, dim=1)

    def _migrate_out(self, st: DDState, send: torch.Tensor,
                     stay_pid: torch.Tensor) -> None:
        """Branch 1 of a rebuild: the emigrants' records packed for the
        right and left neighbours into ``send`` (2, mig, 7), the stayers'
        pids (-1 elsewhere) into ``stay_pid``, the migration's overflow into
        the sticky flag."""
        p, ring = self.p, self.ring
        cl, mig = st.pid.shape[0], self.capacity.mig
        valid = st.pid >= 0
        t = torch.clamp(torch.floor(st.pos[:, 0] * self._inv_w).to(
            torch.int32), 0, p - 1)
        delta = torch.remainder(t - ring.rank, p)
        go_r = valid & (delta == 1)
        # at P = 2 both neighbours are one rank: every emigrant goes right
        go_l = (valid & (delta == p - 1) if p > 2
                else torch.zeros_like(valid))
        lost = valid & (delta != 0) & ~go_r & ~go_l  # moved >1 slab: a bug
        stay = valid & ~go_r & ~go_l & ~lost

        slots = torch.arange(cl, dtype=torch.int32, device=self.device)
        idx_r, cnt_r = compact_rows(slots, go_r, mig, fill=cl)
        idx_l, cnt_l = compact_rows(slots, go_l, mig, fill=cl)
        send[0].copy_(self._pack(st, idx_r, vel=True))
        send[1].copy_(self._pack(st, idx_l, vel=True))
        stay_pid.copy_(torch.where(stay, st.pid, -1))
        st.overflow.logical_or_((cnt_r > mig) | (cnt_l > mig)
                                | torch.any(lost))

    def _merge_in(self, st: DDState, from_left: torch.Tensor,
                  from_right: torch.Tensor, stay_pid: torch.Tensor) -> None:
        """Branch 2: the stayers and the immigrants compacted stably into
        the owned slots; then the face bands (within rs of each face) and
        their send lists into ``send_idx``. Overflows into the flag."""
        cl, gcap = st.pid.shape[0], self.capacity.ghost
        all_pos = torch.cat([st.pos, from_left[:, :3], from_right[:, :3]])
        all_vel = torch.cat([st.vel, from_left[:, 3:6], from_right[:, 3:6]])
        all_pid = torch.cat([stay_pid, from_left[:, 6].view(torch.int32),
                             from_right[:, 6].view(torch.int32)])
        valid_all = all_pid >= 0
        # the stable compaction of the JAX argsort(~valid)[:cl]: occupied
        # slots first, each group in slot order
        order = torch.argsort((~valid_all).to(torch.int32), stable=True)[:cl]
        new_pid = all_pid[order]
        st.vel.copy_(torch.where((new_pid >= 0)[:, None], all_vel[order],
                                 0.0))
        st.pos.copy_(all_pos[order])
        st.pid.copy_(new_pid)

        valid = st.pid >= 0
        x = st.pos[:, 0]
        low = valid & (x < self._band_low)
        high = valid & (x >= self._band_high)
        slots = torch.arange(cl, dtype=torch.int32, device=self.device)
        idx_low, cnt_low = compact_rows(slots, low, gcap, fill=cl)
        idx_high, cnt_high = compact_rows(slots, high, gcap, fill=cl)
        st.send_idx.copy_(torch.stack([idx_low, idx_high]))
        st.overflow.logical_or_((torch.sum(valid_all) > cl)
                                | (cnt_low > gcap) | (cnt_high > gcap))

    def _exchange_ghosts(self, st: DDState) -> None:
        """Every step: positions and pids at the recorded send lists, both
        ways. The low-face set goes to the left neighbour (``shift_minus``:
        its from-right block), the high-face set to the right one. Between
        rebuilds the sets and their pids are as the last rebuild left them,
        so only the positions are new."""
        from_right = self.ring.shift_minus(
            self._pack(st, st.send_idx[0], vel=False))
        from_left = self.ring.shift_plus(
            self._pack(st, st.send_idx[1], vel=False))
        st.ghost_pos.copy_(torch.stack([from_left[:, :3], from_right[:, :3]]))
        st.ghost_pid.copy_(torch.stack([from_left[:, 3].view(torch.int32),
                                        from_right[:, 3].view(torch.int32)]))

    def _sweep(self, st: DDState) -> None:
        """Branch 3: the full lists over the combined set."""
        cfg, cap = self.config, self.capacity
        xpos, xactive = self._combined(st)
        nl = build_neighbor_lists_stable(
            xpos, self.box, self.grid, cfg.rs, cap.neighbors, cap.cell,
            half=False, layout=cfg.layout, active=xactive)
        st.idx.copy_(nl.idx)
        st.ref_pos.copy_(st.pos)
        st.n_rebuilds.add_(1)
        st.overflow.logical_or_(nl.overflow)

    def _rebuild(self, st: DDState, branch=lambda body: body()) -> None:
        """The rebuild of ``st`` in place, as three branches on the one vote
        (``branch(body)``; by default each is taken) with the exchanges
        between them made unconditionally: migrate out, shift the two
        packs, merge in and select the face bands, exchange the ghosts,
        sweep. On a step with no rebuild the packs are not read and the
        ghost exchange refreshes the positions."""
        send = torch.zeros((2, self.capacity.mig, 7), dtype=torch.float32,
                           device=self.device)
        stay_pid = torch.empty_like(st.pid)
        branch(lambda: self._migrate_out(st, send, stay_pid))
        from_left = self.ring.shift_plus(send[0])
        from_right = self.ring.shift_minus(send[1])
        branch(lambda: self._merge_in(st, from_left, from_right, stay_pid))
        self._exchange_ghosts(st)
        branch(lambda: self._sweep(st))

    def _step(self, st: DDState, cond) -> None:
        """One velocity-Verlet step written into ``st``'s tensors, the
        rebuild's three branches through ``cond`` on the ring's vote."""
        cfg, box = self.config, self.box
        vel = half_kick(st.vel, st.force, cfg.dt)
        st.pos.copy_(drift(st.pos, vel, cfg.dt, box))
        st.vel.copy_(vel)

        if cfg.rebuild_every_step:
            self._rebuild(st)
        else:
            disp = box.min_image(st.pos - st.ref_pos)
            d2 = torch.max(torch.where(st.pid >= 0,
                                       torch.sum(disp * disp, dim=-1), 0.0))
            d2 = self.ring.max(d2)
            pred = 4.0 * d2 > float(np.float32(cfg.skin * cfg.skin))
            if cond is eager_cond:  # one host read for the three branches
                need = bool(pred)
                self._rebuild(st, lambda body: body() if need else None)
            else:
                self._rebuild(st, lambda body: cond(pred, body))

        force, _ = self._forces(st)
        st.vel.copy_(half_kick(st.vel, force, cfg.dt))
        st.force.copy_(force)

    def step_fn(self, st: DDState) -> DDState:
        """One velocity-Verlet step, eager (the vote read on the host once);
        returns a new state."""
        out = _clone(st)
        self._step(out, eager_cond)
        return out

    def _run_chunk(self, st: DDState, nsteps: int) -> DDState:
        """``nsteps`` steps in place: replays of one captured graph on the
        card where the ring can be captured, else eager steps."""
        self._runner.run(lambda cond: self._step(st, cond), nsteps, list(st),
                         key=self.capacity, capturable=self.ring.capturable)
        return st

    def _initial_build(self, st: DDState) -> DDState:
        self._rebuild(st)
        st.force.copy_(self._forces(st)[0])
        return st

    def _overflowed(self, st: DDState) -> bool:
        """The sticky flag of any rank (a collective: every rank calls it)."""
        return bool(self.ring.max(st.overflow.to(torch.int32)))

    # ----------------------------------------------------------------- host
    def _scatter(self, system: System) -> DDState:
        """This rank's slab of a global System (the same on every rank), in
        the first slots in the System's row order."""
        cap, dev, p = self.capacity, self.device, self.p
        cl, gcap, K = cap.local, cap.ghost, cap.neighbors
        M = cl + 2 * gcap
        # the JAX host's numpy slab index: an f32 division, truncated
        w = torch.tensor(np.float32(self.w), device=dev)
        slab = torch.clamp((system.pos[:, 0] / w).to(torch.int64), 0, p - 1)
        counts = torch.bincount(slab, minlength=p).tolist()
        for d, held in enumerate(counts):  # the same verdict on every rank
            if held > cl:
                raise ValueError(
                    f"slab {d} holds {held} particles > capacity {cl}; "
                    "grow DDCapacity.local")
        sel = torch.nonzero(slab == self.ring.rank)[:, 0]
        k = sel.shape[0]
        pos = torch.zeros((cl, 3), dtype=torch.float32, device=dev)
        vel = torch.zeros_like(pos)
        pid = torch.full((cl,), -1, dtype=torch.int32, device=dev)
        pos[:k] = system.pos[sel]
        vel[:k] = system.vel[sel]
        pid[:k] = system.pid[sel]
        return DDState(
            pos=pos, vel=vel, force=torch.zeros_like(pos), pid=pid,
            ghost_pos=torch.zeros((2, gcap, 3), dtype=torch.float32,
                                  device=dev),
            ghost_pid=torch.full((2, gcap), -1, dtype=torch.int32,
                                 device=dev),
            send_idx=torch.full((2, gcap), cl, dtype=torch.int32, device=dev),
            idx=torch.full((M, K), M, dtype=torch.int32, device=dev),
            ref_pos=pos.clone(),
            n_rebuilds=torch.zeros((), dtype=torch.int32, device=dev),
            overflow=torch.zeros((), dtype=torch.bool, device=dev))

    def gather(self, st: DDState) -> System:
        """Inverse of ``_scatter``: the global System in original-pid order,
        on every rank (a collective)."""
        pid = self.ring.gather(st.pid).reshape(-1)
        keep = pid >= 0
        n = self.config.n
        held = int(keep.sum())
        if held != n:
            raise AssertionError(f"lost particles: {held} != {n}")
        order = pid[keep].long()
        out = {}
        for name in ("pos", "vel", "force"):
            a = self.ring.gather(getattr(st, name)).reshape(-1, 3)[keep]
            dst = torch.empty((n, 3), dtype=torch.float32, device=a.device)
            dst[order] = a
            out[name] = dst
        return System(pos=out["pos"], vel=out["vel"], force=out["force"],
                      pid=torch.arange(n, dtype=torch.int32,
                                       device=self.device))

    # ------------------------------------------------------------------ API
    def init(self, generator: torch.Generator | None = None) -> DDState:
        """A lattice start (the configuration's ``lattice``): every rank makes
        the same System (a generator of its own with the same seed, or None)
        and takes its own slab of it."""
        cfg = self.config
        system, _ = init_start(cfg, generator, self.device)
        return self.build(system)

    def build(self, system: System) -> DDState:
        """Slab state from a global System (the same on every rank); grows
        every capacity until no rank overflows."""
        system = System(*(t.to(self.device) for t in system))
        while True:
            st = self._initial_build(self._scatter(system))
            if not self._overflowed(st):
                return st
            self.capacity = self.capacity.grown()

    def run(self, st: DDState, nsteps: int, chunk: int = 100) -> DDState:
        """Advance ``nsteps`` steps in chunks; returns a new state and leaves
        ``st`` as it was (as the JAX ``run`` does). The steps work in place
        on one clone of ``st``, whose storage the captured step keeps for
        the whole call. A chunk in which any rank overflowed is undone on
        every rank: the state at its start is gathered, every capacity
        grows, and it is rebuilt and redone. The sticky flag is read once a
        chunk."""
        snapshot, work, done = st, _clone(st), 0
        while done < nsteps:
            this = min(chunk, nsteps - done)
            self._run_chunk(work, this)
            if self._overflowed(work):
                system = self.gather(snapshot)
                self.capacity = self.capacity.grown()
                snapshot = self.build(system)
                work = _clone(snapshot)
                continue
            done += this
            if done < nsteps:
                snapshot = _clone(work)
        return work

    def energies(self, st: DDState):
        """(KE, PE) summed over the ring, as 0-d tensors on every rank."""
        valid = st.pid >= 0
        ke = kinetic_energy(torch.where(valid[:, None], st.vel, 0.0))
        _, pe = self._forces(st)
        return self.ring.sum(ke), self.ring.sum(pe)
