"""The ring of slab ranks on ``torch.distributed`` (PyTorch port of
``md_neighbor_list_tpu/parallel/mesh.py``).

The JAX package runs one SPMD program over a 1-D device mesh, with
``ppermute`` halo shifts and ``psum``/``pmax`` reductions under
``shard_map``. Here each process holds its own slab and talks to its ring
neighbours through a process group: a shift is one ``dist.batch_isend_irecv``
pair, a reduction one ``dist.all_reduce``. Backends: ``gloo`` for CPU tensors,
``nccl`` for CUDA tensors (one process per card, rank r on
``cuda:r % device_count``).

With no group (P = 1) a shift is the identity and a reduction returns its
input: the self-``ppermute`` of the JAX P = 1 mode. A group of one process
keeps the identity shifts and still sends its reductions through the group.

``capturable`` says whether a ring's exchanges may be captured into a CUDA
graph (``utils/graphs.py``), so that an engine can run a chunk of steps as one
device program: true with no group and on an NCCL group of any size (its
shifts and ``all_reduce`` calls are captured and replay as NCCL kernels; NCCL
asks only that the communicator exist before the capture, which an engine's
eager build makes sure of), false on gloo and on a ``LocalRing``, whose
exchanges are host barriers. It is a stated property of the ring, not
something tried. A captured step makes its exchanges outside its branches:
every rank makes them every step, and no conditional body holds one (the
rings raise when asked inside a body, ``graphs.refuse_in_body``).

``LocalRing`` has ``Ring``'s surface for P ranks that are P threads of one
process, on one device or several: the counterpart of the virtual-device mesh
on which the JAX package runs its slab engine on one host. NCCL takes one
process a card and gloo moves no CUDA tensor by send/recv, so this is how P
ranks run on one card. ``run_ranks`` starts them.
"""

from __future__ import annotations

import os
import threading

import torch
import torch.distributed as dist

from md_neighbor_list_tpu_torch.utils.graphs import refuse_in_body


def backend_for(device) -> str:
    """The process-group backend for tensors on ``device``."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device, rank: int) -> torch.device:
    """The device rank ``rank`` works on: ``cuda:rank % device_count`` for
    the card, else ``device`` itself."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for an nccl rank")
        return torch.device("cuda", rank % torch.cuda.device_count())
    return device


def init_ring(device, init_method: str | None = None,
              world_size: int | None = None, rank: int | None = None,
              store=None) -> "Ring":
    """Start this process's member of the ring: ``init_process_group`` with
    the backend for ``device`` and the ring over the default group. Under
    ``torchrun`` leave ``init_method``, ``world_size`` and ``rank`` out (the
    ``env://`` variables carry them); elsewhere give them with either an
    ``init_method`` (e.g. ``file:///tmp/store`` or ``tcp://localhost:29500``)
    or a ``store`` (e.g. ``dist.HashStore()`` for a group of one process,
    which needs no rendezvous). A failure to start is an error."""
    kwargs = {}
    if init_method is not None:
        kwargs = dict(init_method=init_method, world_size=world_size,
                      rank=rank)
    elif store is not None:
        kwargs = dict(store=store, world_size=world_size, rank=rank)
    backend = backend_for(device)
    if backend == "nccl":  # the card before the group: NCCL binds to it
        rank_id = rank if rank is not None else int(os.environ["RANK"])
        torch.cuda.set_device(rank_device(device, rank_id))
    dist.init_process_group(backend, **kwargs)
    return Ring(dist.group.WORLD)


class _Pending:
    """A shift in flight: ``wait()`` returns the received tensor."""

    def __init__(self, works, out: torch.Tensor):
        self._works = works
        self._out = out

    def wait(self) -> torch.Tensor:
        for w in self._works:
            w.wait()
        return self._out


class Ring:
    """The ring of P slab ranks: ``rank``, ``size``, neighbour shifts and
    global reductions. ``group`` is a process group, or None for P = 1."""

    def __init__(self, group=None):
        self.group = group
        if group is None:
            self.rank, self.size = 0, 1
            self.capturable = True
        else:
            self.rank = dist.get_rank(group)
            self.size = dist.get_world_size(group)
            self.capturable = dist.get_backend(group) == "nccl"

    def _peer(self, r: int) -> int:
        return dist.get_global_rank(self.group, r % self.size)

    def _shift(self, t: torch.Tensor, to: int, frm: int, async_op: bool):
        refuse_in_body("a ring shift")
        if self.size == 1:
            return _Pending([], t) if async_op else t
        t = t.contiguous()
        out = torch.empty_like(t)
        works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, t, self._peer(to), self.group),
            dist.P2POp(dist.irecv, out, self._peer(frm), self.group)])
        pending = _Pending(works, out)
        return pending if async_op else pending.wait()

    def shift_plus(self, t: torch.Tensor, async_op: bool = False):
        """Send ``t`` to rank + 1 and return what rank - 1 sent (receive from
        the LEFT neighbour; periodic). With ``async_op`` the result is a
        handle whose ``wait()`` returns the tensor."""
        return self._shift(t, self.rank + 1, self.rank - 1, async_op)

    def shift_minus(self, t: torch.Tensor, async_op: bool = False):
        """Send ``t`` to rank - 1 and return what rank + 1 sent (receive from
        the RIGHT neighbour; periodic)."""
        return self._shift(t, self.rank - 1, self.rank + 1, async_op)

    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        refuse_in_body("a ring reduction")
        if self.group is None:
            return t
        t = t.clone()
        dist.all_reduce(t, op=op, group=self.group)
        return t

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, on every rank."""
        return self._reduce(t, dist.ReduceOp.SUM)

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """The maximum of ``t`` over the ranks, on every rank."""
        return self._reduce(t, dist.ReduceOp.MAX)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """(P, *t.shape): every rank's ``t`` in rank order, on every rank
        (host-side gathers of a whole state; not on the step path)."""
        refuse_in_body("a ring gather")
        if self.group is None:
            return t[None]
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.stack(parts)


class _Hub:
    """What the P threads of a ``LocalRing`` share: two sets of slots (an
    exchange posts into one set, the next into the other) and a barrier."""

    def __init__(self, size: int, timeout: float):
        self.size = size
        self.barrier = threading.Barrier(size, timeout=timeout)
        self.slots = ([None] * size, [None] * size)


class LocalRing:
    """One rank of a ring of P threads in one process, with ``Ring``'s
    surface. Every exchange is a barrier of all P ranks, so every rank must
    make the same calls in the same order (as over a process group). Each
    rank posts a copy of its tensor: a shift hands over a copy, with the
    value semantics of ``ppermute``, and nothing a rank later updates in place
    is read by another. Reductions fold the posted tensors in rank order, so
    every rank gets the same bits. A rank that does not arrive within
    ``timeout`` seconds, or an ``abort``, breaks the barrier: every rank
    waiting in an exchange then raises ``threading.BrokenBarrierError``."""

    capturable = False  # every exchange is a host barrier

    def __init__(self, hub: _Hub, rank: int):
        self._hub = hub
        self._turn = 0
        self.rank, self.size = rank, hub.size

    @staticmethod
    def ring_of(size: int, timeout: float = 600.0) -> list["LocalRing"]:
        """The ``size`` ranks of one new ring, in rank order."""
        hub = _Hub(size, timeout)
        return [LocalRing(hub, r) for r in range(size)]

    def abort(self) -> None:
        """Break the barrier: every rank in or entering an exchange raises."""
        self._hub.barrier.abort()

    def _exchange(self, t: torch.Tensor) -> list:
        """Post a copy of ``t``; returns every rank's posted tensor, in rank
        order. A set of slots is posted into again only two exchanges later,
        after a barrier that every rank passes once it has read this one."""
        refuse_in_body("a ring exchange")
        slots = self._hub.slots[self._turn]
        self._turn ^= 1
        slots[self.rank] = t.clone()
        self._hub.barrier.wait()
        return list(slots)

    def _shift(self, t: torch.Tensor, frm: int, async_op: bool):
        out = self._exchange(t)[frm % self.size].to(t.device)
        return _Pending([], out) if async_op else out

    def shift_plus(self, t: torch.Tensor, async_op: bool = False):
        """Send ``t`` to rank + 1 and return what rank - 1 sent."""
        return self._shift(t, self.rank - 1, async_op)

    def shift_minus(self, t: torch.Tensor, async_op: bool = False):
        """Send ``t`` to rank - 1 and return what rank + 1 sent."""
        return self._shift(t, self.rank + 1, async_op)

    def _fold(self, t: torch.Tensor, op) -> torch.Tensor:
        parts = [q.to(t.device) for q in self._exchange(t)]
        out = parts[0]
        for q in parts[1:]:
            out = op(out, q)
        return out

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, on every rank."""
        return self._fold(t, torch.add)

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """The maximum of ``t`` over the ranks, on every rank."""
        return self._fold(t, torch.maximum)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """(P, *t.shape): every rank's ``t`` in rank order, on every rank."""
        return torch.stack([q.to(t.device) for q in self._exchange(t)])


def run_ranks(p: int, fn, device="cpu", timeout: float = 600.0) -> list:
    """Run ``fn(ring)`` for the P ranks of a new ``LocalRing``, each in a
    thread of its own (on ``rank_device(device, rank)`` for a card), and
    return their results in rank order. A rank that raises aborts the ring,
    so that every other rank raises too instead of waiting; then the first
    exception that is not the others' ``BrokenBarrierError`` is raised."""
    rings = LocalRing.ring_of(p, timeout)
    results = [None] * p
    errors = []
    lock = threading.Lock()
    cuda = torch.device(device).type == "cuda"

    def body(ring: LocalRing) -> None:
        try:
            if cuda:
                torch.cuda.set_device(rank_device(device, ring.rank))
            results[ring.rank] = fn(ring)
        except BaseException as e:  # re-raised below, in the caller
            with lock:
                errors.append(e)
            ring.abort()

    threads = [threading.Thread(target=body, args=(r,),
                                name=f"slab-rank-{r.rank}") for r in rings]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise next((e for e in errors
                    if not isinstance(e, threading.BrokenBarrierError)),
                   errors[0])
    return results
