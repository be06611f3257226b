"""DenseSimulator — the dense-layout LJ/NVE engine (PyTorch port of
``md_neighbor_list_tpu/models/dense_lj.py``).

Velocity Verlet with displacement-triggered rebuilds and overflow rollback +
cap growth; the particle state lives in the dense cell-block layout
(``ops/dense_cells.py``) and the hot ops are the half-sweep kernels
(``ops/dense_force.py``):

  step:   kick -> unwrapped drift -> rebuild vote -> (sort + expand +
          half list at rs) -> force over the listed pairs -> kick
          (on the card the kicks, the drift and the vote are two passes of
          ``csrc/integrate.cu``, ``ops/integrate.py``)
  Verlet reuse: between rebuilds the binning and the half list at rs of the
  last rebuild are reused — every rc-pair of the drifted state was within
  rs at the rebuild while 2*max_disp <= skin, so it is in the list.

The list (``ops/dense_force.py::build_half_list``: one kernel, each slot's
partners within rs in the ten sparse cells of its window, placed by a
single-pass scan) is built where every rebuild ends, in ``take``, into buffers
the engine owns, and read by the list-driven force kernel at every step
(``dense_forces_list``); it is a function of the carry's ``ref_pos`` (the
positions of its last rebuild), so a carry the list was not built for (a
restored or another carry) has it built again from its ``ref_pos`` when it
is stepped. A configuration that rebuilds every step would build a list for
one step only: its step keeps the half sweep (``dense_forces_half``), as do
the observables.

A chunk of steps runs as one device program on the card, as the JAX
``run_chunk`` (``jit(lax.scan(step))``) does: ``run`` replays a CUDA graph of
one step (``utils/graphs.py``) in which the rebuild is a conditional node on
the device's displacement vote, and the host reads the sticky overflow flag
once a chunk. The step updates the carry IN PLACE: every rebuilt tensor and
the force are copied into the carry's own storage, so the graph's addresses
hold from step to step and from rebuild to rebuild. ``run`` consumes the
carry it is given and clones it at the start of each chunk, so that an
overflow can roll back to it. On the CPU the same step runs eagerly and reads
the vote on the host; ``step_fn`` is that eager step on either device, as the
JAX ``step_fn`` is one step outside the scan.

Tracing (``utils/trace.py``): ``run`` marks each chunk as the host span
``chunk`` tiled by ``chunk.snapshot`` (the clone), ``chunk.launch`` (up to the
last replay: the capture key, any capture, the replays), ``chunk.settle``
(the branch counters' read, in the incremental engine the device counts of
its rebuilds by branch, then the overflow flag's) and, when taken,
``chunk.redo`` (the rollback), and counts ``steps`` and ``redos``; the
incremental engine's counts go into ``incremental_rebuilds`` and
``full_fallbacks``. The step's displacement-triggered rebuild is the branch
``rebuilds`` and, on the card, the device span ``rebuild`` inside it. In the
incremental engine the span opens in that branch, which makes the incremental
pass, and closes at the end of whichever branch follows it, the full fallback
or the take of the merged state, so that each rebuild has one begin and one
end marker around all its work; the pass itself is the device span
``increment``, in the step and in the timed list build. The step's half
list, built where a rebuild ends (``take``), is the device span ``halflist``
on the card: inside ``rebuild`` in the step, and also in the initial build,
which carries no ``rebuild``. The timed list build (``_rebuild_and_lists``)
carries neither.

The timed list build, ``_rebuild_and_lists``, is one device program on the
card too, as the JAX ``jit`` of the rebuild and the list kernel is: the
caller's state is copied into the engine's own buffers and one captured graph
(the rebuild, its branches as conditional nodes, then the list kernel) is
replayed. On the CPU the same build step runs eagerly on the same buffers.
On either device what it returns are the engine's own tensors, which the
next build overwrites.

Which implementation runs is decided by the device alone: tensors on a CUDA
device go through the CUDA kernels, tensors on the CPU through their plain
versions. The default device is the card; ``device="cpu"`` is for the caller
to ask for.

``incremental=True`` sends every rebuild through the incremental rebuild
(``ops/incremental.py``: only the particles that changed cell are sorted and
merged in by the K8 kernel), and through the full rebuild when the mover
stream trips the JAX package's window predicate (the JAX ``lax.cond``). In the
step the two are branches of their own on flags the incremental branch sets,
since conditional nodes do not nest; a build without a vote (the initial and
the timed list build) has only the fallback's branch, written over the merged
state that it then takes. The counts of each, and of the movers the
incremental passes sorted, are kept on the device. Unlike the JAX package,
whose ``"jnp"`` engine ignores the flag, the port honours it on the CPU too,
where it runs the plain versions.
"""

from __future__ import annotations

import weakref
from typing import NamedTuple

import numpy as np
import torch

from md_neighbor_list_tpu_torch.core.box import Box
from md_neighbor_list_tpu_torch.core.config import MDConfig
from md_neighbor_list_tpu_torch.core.system import (System, init_random,
                                                    init_start)
from md_neighbor_list_tpu_torch.ops import dense_force, integrate
from md_neighbor_list_tpu_torch.ops.dense_cells import (DenseState,
                                                        from_packed, grow_cap,
                                                        make_spec,
                                                        rebuild_dense,
                                                        to_packed)
from md_neighbor_list_tpu_torch.ops.incremental import \
    rebuild_dense_incremental
from md_neighbor_list_tpu_torch.utils import trace
from md_neighbor_list_tpu_torch.utils.graphs import ChunkRunner, eager_cond


class DenseCarry(NamedTuple):
    state: DenseState
    force: torch.Tensor  # (3, R, mc, cap)
    ref_pos: torch.Tensor  # (3, R, mc, cap) positions at the last rebuild
    n_rebuilds: torch.Tensor  # () i32
    overflow: torch.Tensor  # () bool (sticky)


def _clone(carry: DenseCarry) -> DenseCarry:
    return DenseCarry(
        state=DenseState(*(t.clone() for t in carry.state)),
        force=carry.force.clone(), ref_pos=carry.ref_pos.clone(),
        n_rebuilds=carry.n_rebuilds.clone(), overflow=carry.overflow.clone())


class DenseSimulator:
    """LJ/NVE on the dense cell layout, on ``device`` (default: the card)."""

    def __init__(self, config: MDConfig, cap: int = 40, device="cuda",
                 incremental: bool = False):
        self.config = config
        self.incremental = incremental
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "DenseSimulator runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain versions")
        self.box = Box.from_density(config.n, config.rho)
        self.cap = cap
        self.spec = make_spec(self.box, config.rs, cap)
        # rebuilds by branch, counted on the device: incremental ones kept,
        # and full rebuilds taken because the mover stream tripped the window
        # predicate; and the two as trace.COUNTS has them
        self._taken = torch.zeros(2, dtype=torch.int64, device=self.device)
        self._counted = [0, 0]
        # the flags for the branches after an incremental pass: take the full
        # rebuild, keep the merged state
        self._window = torch.zeros(2, dtype=torch.bool, device=self.device)
        # the movers (particles that changed cell) of every incremental pass
        self._movers = torch.zeros((), dtype=torch.int64, device=self.device)
        # the step's displacement vote on the card, raised by the integrator's
        # first pass and lowered by its closing kick
        self._flag = torch.zeros((), dtype=torch.bool, device=self.device)
        self._runner = ChunkRunner()
        # the list build's input buffers (made for a spec), its chunk runner
        # and what its step leaves: (counts, masks, total)
        self._build_in: DenseState | None = None
        self._build_runner = ChunkRunner()
        self._lists = None
        # the step's half list (made for a spec) and the ref_pos of the carry
        # it was built for
        self._list: dense_force.HalfList | None = None
        self._list_of = None

    @property
    def incremental_rebuilds(self) -> int:
        return self._settle_counts()[0]

    @property
    def full_fallbacks(self) -> int:
        return self._settle_counts()[1]

    def _settle_counts(self) -> list[int]:
        """The list builds' replays settled (their launches counted), and
        ``_taken`` read once and what it gained since the last read added to
        ``trace.COUNTS["incremental_rebuilds"]`` and ``["full_fallbacks"]``
        (no read for the full engine, whose ``_taken`` stays zero). Returns
        ``_taken`` as read."""
        self._build_runner.settle()
        if not self.incremental:
            return [0, 0]
        taken = self._taken.tolist()
        for name, now, was in zip(("incremental_rebuilds", "full_fallbacks"),
                                  taken, self._counted):
            trace.add(name, now - was)
        self._counted = taken
        return taken

    @property
    def movers(self) -> int:
        """Movers sorted by every incremental pass so far (kept or not)."""
        return int(self._movers)

    def _grow(self) -> None:
        self.cap = grow_cap(self.cap)
        self.spec = make_spec(self.box, self.config.rs, self.cap)

    # ------------------------------------------------------------ internals
    def _reads_list(self) -> bool:
        """Whether the step's force reads the half list of the last rebuild
        (else the half sweep): unless the configuration rebuilds every step,
        for any cap the list-driven kernel takes."""
        return (not self.config.rebuild_every_step
                and self.cap <= dense_force.LIST_MAX_CAP)

    def _half_list(self) -> dense_force.HalfList:
        """The step's list buffers, made for the current spec."""
        spec = self.spec
        if self._list is None or \
                self._list.start.shape != (spec.rows, spec.mc, spec.cap):
            self._list = None  # free the old buffers first
            self._list = dense_force.half_list_buffers(
                spec, self.config.n, self.config.rs, self.device)
        return self._list

    def _list_tensors(self) -> list:
        """The list tensors a step reads and its rebuild writes."""
        if not self._reads_list():
            return []
        return list(self._half_list())

    def _build_list(self, carry: DenseCarry) -> torch.Tensor:
        """The half list at rs of ``carry``'s last rebuild (its ``ref_pos``)
        into the engine's buffers. Returns the 0-d bool: it overflowed the
        list's capacity."""
        overflow = dense_force.build_half_list(
            carry.ref_pos, self.spec, self.config.rs, self._half_list())
        self._list_of = weakref.ref(carry.ref_pos)
        return overflow

    def _own_list(self, carry: DenseCarry) -> None:
        """Build the list for ``carry`` unless it holds it already (a carry
        this engine did not rebuild last: a restored, converted or another
        engine's carry). The list is read while no particle has moved
        skin/2 from ``ref_pos``; an overflow of it raises the carry's flag
        then, so ``run`` rolls the chunk back and grows the cells, and
        ``step_fn``'s caller sees the flag. A carry already past that votes
        for a rebuild at its first step, which builds its list anew (and
        flags that one's overflow): the list of its ``ref_pos``, which need
        not be a rebuilt state, is not read. Host reads, for such a carry
        only."""
        if not self._reads_list() or (self._list_of is not None
                                      and self._list_of() is carry.ref_pos):
            return
        if bool(self._build_list(carry)) and not bool(integrate.vote(
                carry.state.pos, carry.ref_pos, carry.state.pid,
                self.config.skin)):
            carry.overflow.fill_(True)

    def _step_forces(self, carry: DenseCarry) -> None:
        """The step's forces into ``carry.force``: over the half list, or
        by the half sweep."""
        if self._reads_list():
            dense_force.dense_forces_list(carry.state.pos, self._list,
                                          self.spec, self.config.rc,
                                          out=carry.force)
        else:
            force, _ = self._forces(carry.state)
            carry.force.copy_(force)

    def _forces(self, state: DenseState, want_pe: bool = False):
        """(force, pe_slots) with pe attributed once per pair."""
        return dense_force.dense_forces_half(state.pos, self.spec,
                                             self.config.rc, want_pe)

    def _rebuild(self, carry: DenseCarry, need, cond) -> None:
        """Rebuild ``carry`` in place where the 0-d bool ``need`` holds
        (``None``: always), branching through ``cond``: the rebuilt state is
        copied into the carry's tensors, and the step's half list is built
        for it."""
        n = self.config.n

        def take(new: DenseState) -> None:
            for dst, src in zip(carry.state, new):
                dst.copy_(src)
            carry.ref_pos.copy_(new.pos)  # state.pos is drifted in place
            carry.n_rebuilds.add_(1)
            carry.overflow.logical_or_(torch.sum(new.valid()) != n)
            if self._reads_list():
                with trace.device_span("halflist", carry.ref_pos.device):
                    carry.overflow.logical_or_(self._build_list(carry))

        self._rebuild_state(carry.state, need, cond, take)

    def _rebuild_state(self, state: DenseState, need, cond, take) -> None:
        """Rebuild ``state`` where ``need`` holds (``None``: always), branching
        through ``cond``, and hand the rebuilt state to ``take``: the full
        rebuild, or with ``incremental`` the incremental one unless its window
        predicate holds. Taking the full path is the reference's own
        algorithm, never a response to a kernel's failure. The branch on
        ``need`` is ``rebuilds``; the device span ``rebuild`` opens at its
        start and closes where the rebuild's last branch ends, and the
        incremental pass is the device span ``increment``."""
        spec = self.spec
        device = state.pos.device

        def full() -> None:
            take(rebuild_dense(state, spec)[0])

        if not self.incremental:
            if need is None:
                full()
                return

            def marked() -> None:
                with trace.device_span("rebuild", device):
                    full()

            cond(need, marked, "rebuilds")
            return
        merged = []

        def incremental() -> None:
            # its window predicate written into the flags and counts
            with trace.device_span("increment", device):
                merged.append(rebuild_dense_incremental(
                    state, spec, (self._window, self._taken, self._movers))[0])

        if need is None:
            # a build without a vote (the initial and the timed list build)
            # takes one branch: the full rebuild written over the merged
            # state where the window predicate holds; then the take
            def rewrite() -> None:
                for dst, src in zip(merged[0], rebuild_dense(state, spec)[0]):
                    dst.copy_(src)

            incremental()
            cond(self._window[0], rewrite)
            take(merged[0])
            return

        def opened() -> None:
            trace.device_mark("rebuild", "begin", device)
            incremental()

        def closing(body):
            def run() -> None:
                body()
                trace.device_mark("rebuild", "end", device)
            return run

        # the JAX engine's lax.cond on the window predicate, as two branches
        # on the flags the incremental branch sets; the span closes at the end
        # of whichever runs
        self._window.zero_()
        cond(need, opened, "rebuilds")
        cond(self._window[0], closing(full))
        cond(self._window[1], closing(lambda: take(merged[0])))

    def _step(self, carry: DenseCarry, cond) -> None:
        """One velocity-Verlet step, in place, branching through ``cond``."""
        cfg = self.config
        dt = float(np.float32(cfg.dt))
        state = carry.state
        # kick, then an UNWRAPPED drift (positions are wrapped only inside
        # the rebuild, so the stale-bin image shifts stay exact across the
        # periodic boundary), then the vote, on the card in ``self._flag``
        need = integrate.kick_drift_vote(
            state.vel, state.pos, carry.force, carry.ref_pos, state.pid, dt,
            None if cfg.rebuild_every_step else cfg.skin, self._flag)
        self._rebuild(carry, need, cond)

        self._step_forces(carry)
        if self._reads_list():
            trace.add("list_forces")
        # the closing kick lowers the card's vote flag for the next step
        integrate.kick(state.vel, carry.force, state.pid, dt,
                       lower=None if need is None else self._flag)

    def step_fn(self, carry: DenseCarry) -> DenseCarry:
        """One velocity-Verlet step, eager (the vote read on the host).
        Updates ``carry``'s tensors in place and returns it."""
        self._own_list(carry)
        self._step(carry, eager_cond)
        return carry

    def _run_chunk(self, carry: DenseCarry, nsteps: int) -> DenseCarry:
        """``nsteps`` steps in place: replays of one captured graph on the
        card, eager steps on the CPU."""
        self._launch_chunk(carry, nsteps)
        self._runner.settle()
        return carry

    def _launch_chunk(self, carry: DenseCarry, nsteps: int) -> None:
        """``_run_chunk`` up to its last replay (the host reads nothing)."""
        self._runner.launch(lambda cond: self._step(carry, cond), nsteps,
                            [*carry.state, carry.force, carry.ref_pos,
                             carry.n_rebuilds, carry.overflow, self._taken,
                             self._window, self._movers, self._flag,
                             *self._list_tensors()],
                            key=self.spec)

    def _initial_build(self, state: DenseState) -> DenseCarry:
        """The first rebuild and forces, into ``state``'s tensors and new
        ones: the carry whose storage the steps keep."""
        carry = DenseCarry(
            state=state,
            force=torch.zeros_like(state.pos),
            ref_pos=torch.empty_like(state.pos),
            n_rebuilds=torch.zeros((), dtype=torch.int32, device=self.device),
            overflow=torch.zeros((), dtype=torch.bool, device=self.device),
        )
        self._rebuild(carry, None, eager_cond)
        self._step_forces(carry)
        return carry

    def _rebuild_and_lists(self, state: DenseState):
        """The timed neighbour-list build: wrap + keys + sort + expand + the
        one-pass half-list kernel emitting the complete artifact — packed hit
        masks and half counts (total pairs = sum of counts over valid
        slots). Returns (new_state, counts, masks, total), ``total`` a 0-d
        tensor.

        ``state`` is copied into the engine's build buffers, then the build
        step runs once by the build's chunk runner: on the card one replay of
        a graph captured for the spec (again after the capacity grows), with
        no host read (the branch counters of the builds are read where the
        engine's counts are, or by the next chunk of ``run``); on the CPU the
        step eagerly, the incremental engine's window predicate read on the
        host. On either device the returned tensors are the engine's, and the
        next build overwrites them (clone what must outlive it; the masks are
        about 206 MB at N = 1M)."""
        spec = self.spec
        shape = (spec.rows, spec.mc, spec.cap)
        if self._build_in is None or self._build_in.pid.shape != shape:
            self._build_in = DenseState(
                pos=torch.empty((3,) + shape, dtype=torch.float32,
                                device=self.device),
                vel=torch.empty((3,) + shape, dtype=torch.float32,
                                device=self.device),
                pid=torch.empty(shape, dtype=torch.int32, device=self.device))
        buf = self._build_in
        for dst, src in zip(buf, state):
            dst.copy_(src)
        self._build_runner.launch(lambda cond: self._build_step(buf, cond),
                                  1, [*buf, self._taken, self._window,
                                      self._movers],
                                  key=(spec, self.incremental))
        return (buf, *self._lists)

    def _build_step(self, state: DenseState, cond) -> None:
        """The list build as a step: ``state`` rebuilt in place (the
        incremental engine's branches through ``cond``), then the list kernel;
        leaves (counts, masks, total) in ``self._lists``. Made during a
        capture, those are the graph's outputs."""
        def take(new: DenseState) -> None:
            for dst, src in zip(state, new):
                dst.copy_(src)

        self._rebuild_state(state, None, cond, take)
        counts, masks = dense_force.dense_lists_half(state.pos, self.spec,
                                                     self.config.rs)
        total = torch.sum(torch.where(state.valid(), counts, 0))
        self._lists = (counts, masks, total)

    @staticmethod
    def _kinetic(state: DenseState) -> torch.Tensor:
        return 0.5 * torch.sum(
            torch.where(state.valid()[None], state.vel, 0.0) ** 2)

    # ------------------------------------------------------------------ API
    def init(self, generator: torch.Generator | None = None,
             lattice: bool = True) -> DenseCarry:
        """The carry of a start: the configuration's lattice
        (``init_start``), or with ``lattice=False`` random positions."""
        cfg = self.config
        if lattice:
            system, _ = init_start(cfg, generator, self.device)
        else:
            system, _ = init_random(generator, cfg.n, cfg.rho,
                                    cfg.temperature, self.device)
        return self.build(system)

    def build(self, system: System) -> DenseCarry:
        """Dense carry from a packed system; grows ``cap`` until every
        particle has a slot."""
        while True:
            if system.n <= self.spec.slots:
                state = from_packed(system.pos, system.vel, system.pid,
                                    self.spec)
                carry = self._initial_build(state)
                if not bool(carry.overflow):
                    return carry
            self._grow()

    def run(self, carry: DenseCarry, nsteps: int,
            chunk: int = 100) -> DenseCarry:
        """Advance ``nsteps`` steps in chunks, in place. A chunk that
        overflowed a cell is undone: the state at its start is rebuilt with a
        larger ``cap`` (``n_rebuilds`` restarts there) and the chunk is
        redone. Returns the carry (the one given, unless a chunk was
        undone)."""
        done = 0
        while done < nsteps:
            this = min(chunk, nsteps - done)
            self._own_list(carry)
            with trace.span("chunk"):
                with trace.span("chunk.snapshot"):
                    snapshot = _clone(carry)
                with trace.span("chunk.launch"):
                    self._launch_chunk(carry, this)
                with trace.span("chunk.settle"):
                    self._runner.settle()
                    self._settle_counts()
                    overflow = bool(carry.overflow)
                if self.config.rebuild_every_step:
                    trace.add("rebuilds", this)
                if overflow:
                    with trace.span("chunk.redo"):
                        carry = self._redo(snapshot)
                    trace.add("redos")
                else:
                    done += this
                    trace.add("steps", this)
        return carry

    def _redo(self, snapshot: DenseCarry) -> DenseCarry:
        """The carry a chunk started from (``snapshot``), rebuilt with a
        larger ``cap`` (``n_rebuilds`` restarts there)."""
        pos, vel = to_packed(snapshot.state, self.config.n, self.spec.L)
        n = self.config.n
        system = System(
            pos=torch.from_numpy(pos).to(self.device),
            vel=torch.from_numpy(vel).to(self.device),
            force=torch.zeros((n, 3), dtype=torch.float32,
                              device=self.device),
            pid=torch.arange(n, dtype=torch.int32, device=self.device),
        )
        self._grow()
        return self.build(system)

    def energies(self, carry: DenseCarry):
        """(KE, PE) as 0-d tensors; PE is the shifted LJ potential."""
        v = carry.state.valid()
        _, pe_slots = self._forces(carry.state, want_pe=True)
        return self._kinetic(carry.state), torch.sum(
            torch.where(v, pe_slots, 0.0))

    def thermo(self, carry: DenseCarry):
        """(KE, PE, W): kinetic energy, shifted potential and total pair
        virial W = sum over pairs of dr . F_pair — the inputs of the
        instantaneous pressure P = (2*KE + W) / (3*V)."""
        v = carry.state.valid()
        pe_s, w_s = dense_force.dense_pe_virial(carry.state.pos, self.spec,
                                                self.config.rc)
        return (self._kinetic(carry.state),
                torch.sum(torch.where(v, pe_s, 0.0)),
                torch.sum(torch.where(v, w_s, 0.0)))

    def pressure(self, carry: DenseCarry) -> float:
        """Instantaneous virial pressure P = (2*KE + W) / (3*V) in reduced
        units (V = L^3)."""
        ke, _, w = self.thermo(carry)
        vol = float(self.spec.L) ** 3
        return float((2.0 * ke + w) / (3.0 * vol))

    def to_system(self, carry: DenseCarry):
        """numpy (pos, vel, force) packed in pid order — host-side."""
        pos, vel = to_packed(carry.state, self.config.n, self.spec.L)
        pid = carry.state.pid.reshape(-1).cpu().numpy()
        keep = pid >= 0
        f = carry.force.reshape(3, -1).cpu().numpy()[:, keep].T
        force = np.empty_like(f)
        force[pid[keep]] = f
        return pos, vel, force
