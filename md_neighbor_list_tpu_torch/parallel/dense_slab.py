"""DenseSlabSimulator: slab domain decomposition of the dense engine (PyTorch
port of ``md_neighbor_list_tpu/parallel/dense_slab.py``).

One process per slab, on ``torch.distributed`` (``parallel/mesh.py``); each
runs the dense engine over its own z-slab, and every halo payload is a
contiguous dense layer block:

  decomposition  slabs along z: nz contiguous z-layers of cell rows per rank
                 (z leads the dense layout's rows, so a layer is one
                 contiguous (3, mc, mc, cap) block: no send lists, no gathers)
  per step       the vote, 1 scalar max, a 0-d device tensor on which the
                 rebuild's local work branches; the BOUNDARY LAYERS both
                 ways, each one packed (7, mc*mc*cap) shift of wrapped
                 pos, vel and pid (emigrants can only live there, having
                 moved <= 1 cell), read only when the rebuild runs; 1 shift
                 of my first owned layer (positions and pids) -> the left
                 neighbour's right-ghost block (the ghost SET stays valid
                 between rebuilds by the skin argument), posted before the
                 interior force pass and waited on after it; 1 shift
                 returning the Newton-3 seam reactions; 1 sum of the
                 rebuild's (kept, emigrated) counts, zero without a rebuild
  per rebuild    wrap; key own + received records relative to my slab
                 (emigrants and foreigners sort outside the owned key range
                 and drop out); one stable sort + the expand kernel re-bins
                 everything
  forces         half-sweep kernels with dz >= 0 in their slab forms: pairs
                 across my LOWER face are evaluated by the left neighbour,
                 which shifts back one contiguous reaction layer (seam)

Conservation: a particle is kept by exactly one rank (the key ranges partition
the ring); the global sum of kept slots must equal N at every rebuild, else
the sticky overflow flag triggers the host-side rollback with cap growth that
the dense engine uses.

P = 1 is the SELF-HALO mode: the whole distributed program runs on one rank
(shifts are the identity), so the decomposition can be driven on one card. It
keeps the JAX package's two specialisations: no boundary exchange (it would
enter each boundary particle twice into the sort), and unwrapped keys (the
ring mod would alias the top layer to a left-emigrant key). For production
single-card runs ``DenseSimulator`` is the engine (no ghost layer).

As in ``models/dense_lj.py`` a chunk of steps runs as one device program on
the card, as the JAX ``jit(shard_map(lax.scan(step)))`` does: ``run`` replays
a CUDA graph of one step (``utils/graphs.py``) in which the rebuild's local
work is a conditional node on the reduced vote, and the ring's shifts and
``all_reduce`` calls are captured with the rest of the step, outside the
branch: every rank makes every exchange every step, and a conditional body
holds none (a body that holds NCCL's work of a group of more than one
process is refused by ``cudaGraphInstantiate``, PERF.md). The step updates the carry IN PLACE (every rebuilt
tensor, the ghosts and the force are copied into the carry's own storage);
``run`` clones the carry at the start of each chunk for the rollback. That
needs a ring whose exchanges can be captured (``ring.capturable``: no group,
or an NCCL group of any size). On a ``LocalRing``, whose exchanges are host
barriers, and on the CPU the same step runs eagerly and reads the vote on the
host, by design; ``step_fn`` is that eager step on any ring.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from md_neighbor_list_tpu_torch.core.box import Box
from md_neighbor_list_tpu_torch.core.config import MDConfig
from md_neighbor_list_tpu_torch.core.system import System, init_start
from md_neighbor_list_tpu_torch.ops.dense_cells import grow_cap
from md_neighbor_list_tpu_torch.ops.slab_kernels import (SlabSpec,
                                                         slab_forces_boundary,
                                                         slab_forces_half,
                                                         slab_forces_interior,
                                                         slab_keys,
                                                         slab_lists_half,
                                                         slab_sort_expand)
from md_neighbor_list_tpu_torch.parallel.mesh import Ring, rank_device
from md_neighbor_list_tpu_torch.utils.graphs import ChunkRunner, eager_cond


def make_slab_spec(box: Box, rs: float, p: int, cap: int = 40) -> SlabSpec:
    """x/y keep the finest valid grid; the GLOBAL z cell count is rounded
    DOWN to a multiple of P (uniform slabs), coarsening only the z edge,
    which stays >= rs (see SlabSpec)."""
    mc = max(int(box.L / rs), 1)
    mc_z = (mc // p) * p
    if mc < 3 or mc_z < p:
        raise ValueError(
            f"box too small for a {p}-slab dense grid (mc={mc}, "
            f"mc_z={mc_z} at L={box.L:.3g}, rs={rs}); fewer ranks or "
            "more particles")
    return SlabSpec(mc=mc, nz=mc_z // p, mc_z=mc_z, cap=cap, L=box.L,
                    cell_size=box.L / mc, cell_z=box.L / mc_z)


class SlabCarry(NamedTuple):
    """One rank's slab state (the JAX carry's entry of this rank)."""

    pos: torch.Tensor  # (3, rows, mc, cap) owned, wrapped at rebuild only
    vel: torch.Tensor  # (3, rows, mc, cap)
    pid: torch.Tensor  # (rows, mc, cap) i32, < 0 = empty slot
    gpos: torch.Tensor  # (3, mc, mc, cap) right-ghost layer, seam-shifted
    gpid: torch.Tensor  # (mc, mc, cap) i32
    force: torch.Tensor  # (3, rows, mc, cap)
    ref_pos: torch.Tensor  # (3, rows, mc, cap) positions at the last rebuild
    n_rebuilds: torch.Tensor  # () i32
    n_migrated: torch.Tensor  # () i32 particles re-homed across slabs
    overflow: torch.Tensor  # () bool (sticky)


def _clone(carry: SlabCarry) -> SlabCarry:
    return SlabCarry(*(t.clone() for t in carry))


class DenseSlabSimulator:
    """LJ/NVE over P dense slabs, this process being rank ``ring.rank``. API
    mirrors ``DenseSimulator``. ``ring`` is a ``parallel.mesh.Ring`` (None:
    P = 1 with no process group); ``config.mesh_devices`` must be its size.
    ``device`` "cuda" runs on ``cuda:rank % device_count``. ``run`` replays a
    captured step where ``ring.capturable`` holds, and runs the eager step on
    a ``LocalRing``."""

    def __init__(self, config: MDConfig, cap: int = 40, device="cuda",
                 ring: Ring | None = None):
        if config.mesh_devices < 1:
            raise ValueError("DenseSlabSimulator needs mesh_devices >= 1")
        self.ring = Ring() if ring is None else ring
        if self.ring.size != config.mesh_devices:
            raise ValueError(
                f"config.mesh_devices = {config.mesh_devices} but the ring "
                f"has {self.ring.size} ranks")
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "DenseSlabSimulator runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run the plain versions")
        self.device = rank_device(device, self.ring.rank)
        self.config = config
        self.box = Box.from_density(config.n, config.rho)
        self.p = config.mesh_devices
        self.cap = cap
        self.spec = make_slab_spec(self.box, config.rs, self.p, cap)
        self._runner = ChunkRunner()

    def _grow(self) -> None:
        self.cap = grow_cap(self.cap)
        self.spec = make_slab_spec(self.box, self.config.rs, self.p, self.cap)

    # ------------------------------------------------------------ internals
    def _exchange_boundary(self, carry: SlabCarry) -> list[torch.Tensor]:
        """The migration transport of a rebuild, made every step before the
        vote's branch (a step's exchanges stay outside its branches): my
        boundary layers' records, wrapped positions, velocities and pids
        (bit-cast to f32), packed into one (7, mc*mc*cap) tensor a
        direction. Returns [the left neighbour's top layer, the right
        neighbour's bottom layer]; at P = 2 with one layer a rank the first
        only (both neighbours are one rank, and a second copy of its one
        layer would be kept twice); at P = 1 none (the self-halo mode)."""
        spec, ring = self.spec, self.ring
        mc, nz = spec.mc, spec.nz
        if self.p == 1:
            return []

        def pack(rows: slice) -> torch.Tensor:
            return torch.cat([
                torch.remainder(carry.pos[:, rows], spec.L).reshape(3, -1),
                carry.vel[:, rows].reshape(3, -1),
                carry.pid[rows].reshape(1, -1).view(torch.float32)])

        recv = [ring.shift_plus(pack(slice((nz - 1) * mc, nz * mc)))]
        if not (self.p == 2 and nz == 1):
            recv.append(ring.shift_minus(pack(slice(0, mc))))
        return recv

    def _rebuild_local(self, carry: SlabCarry,
                       recv: list[torch.Tensor]) -> torch.Tensor:
        """The rebuild's local work, in place: own and received records
        keyed relative to my slab (emigrants and foreigners key themselves
        out), one stable sort and the expand kernel; the rebuilt slots and
        the reference positions copied into ``carry``. Returns this rank's
        (kept, emigrated) counts for the ring's sums (``_settle``)."""
        spec = self.spec
        mc, nz = spec.mc, spec.nz
        pos = torch.remainder(carry.pos, spec.L)
        z0 = self.ring.rank * nz
        valid = carry.pid >= 0
        if self.p == 1:
            # self-halo mode: every particle is resident; the unwrapped
            # keys own all mc_z layers
            k_own = slab_keys(pos, valid, spec, z0, wrap=False)
            keys = k_own.reshape(-1)
            rec_pos, rec_vel = pos.reshape(3, -1), carry.vel.reshape(3, -1)
            pids = carry.pid.reshape(-1)
        else:
            # emigrants live only in the boundary layers (they moved <= 1
            # cell since the last rebuild), so the exchanged layers ARE the
            # migration; records enter the sort in the wrapped global frame
            rpid = [r[6].view(torch.int32) for r in recv]
            k_own = slab_keys(pos, valid, spec, z0)
            keys = torch.cat([k_own.reshape(-1)] + [
                slab_keys(r[:3], q >= 0, spec, z0) for r, q in zip(recv, rpid)])
            rec_pos = torch.cat([pos.reshape(3, -1)] + [r[:3] for r in recv],
                                dim=1)
            rec_vel = torch.cat([carry.vel.reshape(3, -1)]
                                + [r[3:6] for r in recv], dim=1)
            pids = torch.cat([carry.pid.reshape(-1)] + rpid)
        new, _ = slab_sort_expand(keys, rec_pos, rec_vel, pids, spec)
        # migration diagnostic: own records that keyed out of my slab
        emigrant = valid & ((k_own < mc * mc) | (k_own >= mc * mc * (nz + 1)))
        for dst, src in ((carry.pos, new.pos), (carry.vel, new.vel),
                         (carry.pid, new.pid), (carry.ref_pos, new.pos)):
            dst.copy_(src)
        carry.n_rebuilds.add_(1)
        return torch.stack([torch.sum(new.pid >= 0), torch.sum(emigrant)])

    def _settle(self, carry: SlabCarry, counts: torch.Tensor,
                pred: torch.Tensor) -> None:
        """After the branch, every step: one ring sum of the (kept,
        emigrated) counts, zero where no rank rebuilt. Conservation (every
        particle kept by exactly one rank) raises the sticky overflow only
        where the rebuild ran (``pred``)."""
        total = self.ring.sum(counts)
        carry.n_migrated.add_(total[1].to(torch.int32))
        carry.overflow.logical_or_(pred & (total[0] != self.config.n))

    def _post_ghosts(self, carry: SlabCarry):
        """Post my first owned layer, positions and pids (bit-cast), to the
        left neighbour: its right ghosts. The pids change only at a
        rebuild, so between rebuilds they arrive as they were. Returns the
        pending shift (``_set_ghosts`` takes what it brings)."""
        mc = self.spec.mc
        pack = torch.cat([carry.pos[:, :mc].reshape(3, -1),
                          carry.pid[:mc].reshape(1, -1).view(torch.float32)])
        return self.ring.shift_minus(pack, async_op=True)

    def _set_ghosts(self, carry: SlabCarry, recv: torch.Tensor) -> None:
        """Copy a received right-ghost layer into ``carry.gpos`` and
        ``carry.gpid``, with the ring seam's +L on its z channel on rank P-1
        (whose right neighbour is rank 0), added by the RECEIVER with one
        rounded f32 add: the ghost images then equal the cube's in-kernel
        ``z + L`` bit for bit."""
        spec = self.spec
        shape = (spec.mc, spec.mc, spec.cap)
        carry.gpos.copy_(recv[:3].reshape((3,) + shape))
        carry.gpid.copy_(recv[3].view(torch.int32).reshape(shape))
        if self.ring.rank == self.p - 1:
            carry.gpos[2] += float(np.float32(spec.L))

    def _rebuild(self, carry: SlabCarry) -> None:
        """A whole rebuild of ``carry`` in place, outside a step (the
        initial build, a timed list build): the boundary exchange, the
        local rebuild, the ring's sums and the ghost layer."""
        counts = self._rebuild_local(carry, self._exchange_boundary(carry))
        self._settle(carry, counts, torch.ones(
            (), dtype=torch.bool, device=carry.pos.device))
        self._set_ghosts(carry, self._post_ghosts(carry).wait())

    def _ext(self, carry: SlabCarry):
        """The extended (owned + ghost) positions and validity."""
        return (torch.cat([carry.pos, carry.gpos], dim=1),
                torch.cat([carry.pid >= 0, carry.gpid >= 0], dim=0))

    def _forces(self, carry: SlabCarry, want_pe: bool = False):
        """(force, pe_slots) by the combined slab pass, the left neighbour's
        seam added to my first layer."""
        force, seam, pe = slab_forces_half(*self._ext(carry), self.spec,
                                           self.config.rc, want_pe)
        recv = self.ring.shift_plus(seam)
        force[:, :self.spec.mc] += recv
        return force, pe

    def _step(self, carry: SlabCarry, cond) -> None:
        """One velocity-Verlet step, in place, the rebuild's local work
        branching through ``cond`` on the ring's vote. Every exchange is
        made every step, outside the branch: the vote, the boundary layers,
        the ghost layer (with its pids), the seam and the rebuild's sums."""
        cfg, spec, ring = self.config, self.spec, self.ring
        mc, nz = spec.mc, spec.nz
        dt = float(np.float32(cfg.dt))
        carry.vel.add_(carry.force, alpha=0.5 * dt)
        carry.pos.add_(carry.vel, alpha=dt)  # unwrapped between rebuilds

        recv = self._exchange_boundary(carry)
        counts = torch.zeros(2, dtype=torch.int64, device=carry.pos.device)

        def rebuild() -> None:
            counts.copy_(self._rebuild_local(carry, recv))

        if cfg.rebuild_every_step:
            pred = torch.ones((), dtype=torch.bool, device=carry.pos.device)
            rebuild()
        else:
            disp = carry.pos - carry.ref_pos  # exact: both unwrapped
            d2 = torch.sum(disp * disp, dim=0)
            d2max = ring.max(torch.max(torch.where(carry.pid >= 0, d2, 0.0)))
            pred = 4.0 * d2max > cfg.skin * cfg.skin
            cond(pred, rebuild)

        # ghosts of the post-vote state: posted before the interior pass,
        # which does not read them, and waited on after it
        pending = self._post_ghosts(carry)
        if nz >= 2:
            cut = (nz - 1) * mc
            f_low, top_rxn = slab_forces_interior(carry.pos, spec, cfg.rc)
            self._set_ghosts(carry, pending.wait())
            f_last, seam = slab_forces_boundary(
                carry.pos[:, cut:], carry.gpos, carry.gpid >= 0, spec, cfg.rc)
            recv_seam = ring.shift_plus(seam)
            carry.force[:, :cut].copy_(f_low)
            torch.add(f_last, top_rxn, out=carry.force[:, cut:])
            carry.force[:, :mc] += recv_seam
        else:  # a single owned layer: no interior exists
            self._set_ghosts(carry, pending.wait())
            carry.force.copy_(self._forces(carry)[0])
        self._settle(carry, counts, pred)
        carry.vel.add_(carry.force, alpha=0.5 * dt)

    def step_fn(self, carry: SlabCarry) -> SlabCarry:
        """One velocity-Verlet step, eager (the vote read on the host).
        Updates ``carry``'s tensors in place and returns it."""
        self._step(carry, eager_cond)
        return carry

    def _run_chunk(self, carry: SlabCarry, nsteps: int) -> SlabCarry:
        """``nsteps`` steps in place: replays of one captured graph on the
        card where the ring can be captured, else eager steps."""
        self._runner.run(lambda cond: self._step(carry, cond), nsteps,
                         list(carry), key=self.spec,
                         capturable=self.ring.capturable)
        return carry

    def _initial_build(self, carry: SlabCarry) -> SlabCarry:
        """The first rebuild, ghosts and forces, into ``carry``'s tensors:
        the carry whose storage the steps keep."""
        self._rebuild(carry)
        carry.force.copy_(self._forces(carry)[0])
        return carry

    # ----------------------------------------------------------------- host
    def _slab_of(self, pos: torch.Tensor) -> torch.Tensor:
        """The slab (rank) of each packed position, from its z cell."""
        spec = self.spec
        iz = torch.clamp((pos[:, 2] / spec.cell_z).to(torch.int64), 0,
                         spec.mc_z - 1)
        return iz // spec.nz

    def _scatter(self, system: System, slab: torch.Tensor) -> SlabCarry:
        """This rank's slab of a global System, in the first slots in pid
        order (any slots: the initial rebuild sorts them into place)."""
        spec, dev = self.spec, self.device
        shape = (spec.rows, spec.mc, spec.cap)
        sel = torch.nonzero(slab == self.ring.rank)[:, 0]
        k = sel.shape[0]
        pos = torch.zeros((3, spec.slots), dtype=torch.float32, device=dev)
        vel = torch.zeros_like(pos)
        pid = torch.full((spec.slots,), -1, dtype=torch.int32, device=dev)
        pos[:, :k] = system.pos[sel].T
        vel[:, :k] = system.vel[sel].T
        pid[:k] = system.pid[sel]
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        ghost = (spec.mc, spec.mc, spec.cap)
        return SlabCarry(
            pos=pos.reshape((3,) + shape), vel=vel.reshape((3,) + shape),
            pid=pid.reshape(shape),
            gpos=torch.zeros((3,) + ghost, dtype=torch.float32, device=dev),
            gpid=torch.full(ghost, -1, dtype=torch.int32, device=dev),
            force=torch.zeros((3,) + shape, dtype=torch.float32, device=dev),
            ref_pos=pos.reshape((3,) + shape).clone(),
            n_rebuilds=zero, n_migrated=zero.clone(),
            overflow=torch.zeros((), dtype=torch.bool, device=dev))

    def gather(self, carry: SlabCarry) -> System:
        """The global System in original-pid order, on every rank
        (host-side; positions wrapped into [0, L))."""
        pid = self.ring.gather(carry.pid).reshape(-1)
        keep = pid >= 0
        n = self.config.n
        if int(keep.sum()) != n:
            raise ValueError(f"lost particles: {int(keep.sum())} != {n}")
        order = pid[keep].long()
        out = {}
        for name in ("pos", "vel", "force"):
            a = self.ring.gather(getattr(carry, name))  # (P, 3, rows, mc, cap)
            a = a.movedim(1, -1).reshape(-1, 3)[keep]
            dst = torch.empty((n, 3), dtype=torch.float32, device=a.device)
            dst[order] = a
            out[name] = dst
        return System(pos=torch.remainder(out["pos"], self.box.L),
                      vel=out["vel"], force=out["force"],
                      pid=torch.arange(n, dtype=torch.int32,
                                       device=self.device))

    # ------------------------------------------------------------------ API
    def init(self, generator: torch.Generator | None = None) -> SlabCarry:
        """A lattice start (the configuration's ``lattice``): every rank makes
        the same System (same generator, same seed) and takes its own slab of
        it. For another start pass a System to ``build``."""
        cfg = self.config
        system, _ = init_start(cfg, generator, self.device)
        return self.build(system)

    def build(self, system: System) -> SlabCarry:
        """Slab carry from a global System (the same on every rank); grows
        ``cap`` until every slab's particles have slots and no cell
        overflows."""
        system = System(*(t.to(self.device) for t in system))
        while True:
            slab = self._slab_of(system.pos)
            fullest = int(torch.bincount(slab, minlength=self.p).max())
            if fullest <= self.spec.slots:  # the same verdict on every rank
                carry = self._initial_build(self._scatter(system, slab))
                if not bool(carry.overflow):
                    return carry
            self._grow()

    def run(self, carry: SlabCarry, nsteps: int,
            chunk: int = 100) -> SlabCarry:
        """Advance ``nsteps`` steps in chunks. A chunk in which any rank's
        cell overflowed is undone on every rank (the flag is global): the
        state at its start is gathered, rebuilt with a larger ``cap``, and
        the chunk is redone."""
        done = 0
        while done < nsteps:
            this = min(chunk, nsteps - done)
            snapshot = _clone(carry)
            carry = self._run_chunk(carry, this)
            if bool(carry.overflow):
                system = self.gather(snapshot)
                self._grow()
                carry = self.build(system)
                continue
            done += this
        return carry

    def energies(self, carry: SlabCarry):
        """(KE, PE) summed over the ring, as 0-d tensors; PE is the shifted
        LJ potential, by the want_pe form of the combined pass."""
        v = carry.pid >= 0
        ke = 0.5 * torch.sum(torch.where(v[None], carry.vel, 0.0) ** 2)
        _, pe = self._forces(carry, want_pe=True)
        pe = torch.sum(torch.where(v, pe, 0.0))
        return self.ring.sum(ke), self.ring.sum(pe)

    def lists(self, carry: SlabCarry):
        """(this rank's counts (rows, mc, cap), global exact pair count): the
        distributed list artifact at rs, each pair attributed to one rank."""
        counts, _ = slab_lists_half(*self._ext(carry), self.spec,
                                    self.config.rs)
        total = self.ring.sum(torch.sum(torch.where(carry.pid >= 0, counts, 0)))
        return counts, int(total)
