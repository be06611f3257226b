"""Run a chunk of engine steps as one device program: the port's counterpart
of the JAX engines' ``jit(lax.scan(step))`` with the rebuild under
``lax.cond``. The JAX package has no module for this; XLA compiles it.

An engine writes its step once, as ``step(cond)``. The step updates tensors
that keep their storage (every new result is copied into them) and branches
only through ``cond(pred, body, name=None)``: ``pred`` a 0-d bool tensor on
the step's device, ``body`` a function of no arguments that writes only into
tensors that outlive it. A body calls no ``cond``: a branch that depends on
another is a second ``cond`` on a flag that the first body sets and the step
clears before it. A ``name`` names a counter of ``utils/trace.COUNTS`` that
counts the times the body runs.

``ChunkRunner.run(step, nsteps, carry, key, capturable)`` runs the step
``nsteps`` times (``launch``, then ``settle``):

- on the CPU, or where the engine says its step cannot be captured (a slab
  engine on a ring whose exchanges are host barriers), eagerly, each ``cond``
  reading ``pred`` on the host (``eager_cond``, which is also how one eager
  step runs on the card);
- else on the CUDA device, as ``nsteps`` replays of one ``StepGraph`` with no
  host read between them, then one read of the branch counters (none where
  the step has no branch). The graph is captured for the carry's tensors
  (their addresses, shapes and types) and the caller's ``key``, and captured
  again when any of them changes, as the JAX engine compiles again after its
  capacity grows. A capture is the host span ``graph.capture`` and counts in
  ``COUNTS["captures"]``.

A step may also make tensors of its own and hand them to its caller (the list
build's counts and masks): made during the capture, they are the graph's
outputs, which every replay writes again.

``StepGraph`` captures one step: first every body is run once, eagerly, on a
side stream, with the carry saved before and restored after (this builds the
kernel library, sizes the sort's scratch space and takes every branch); then
the step is captured into a ``torch.cuda.CUDAGraph``, each ``cond`` as a
conditional node (``ops/_cuda.graph_if``, ``csrc/graph_cond.cu``); then each
body is captured as a graph of its own and placed into its node. A capture
that fails raises: there is no host-branch loop on the card to fall back to.

A body does local work only: ``cudaGraphInstantiate`` refuses a conditional
body that holds NCCL's work of a group of more than one process (PERF.md), so
a step's collectives (``parallel/mesh.py``) run in the step itself, every
step, on every rank. While a body is captured ``capturing_body()`` is true in
the capturing thread; the rings check it and raise, as a ``cond`` inside a
body does.

Launches: ``ops/_cuda.launch`` counts a kernel when it is called, so a
captured kernel is counted once at capture and never at replay. The capture
notes the launches of the step outside its bodies and of each body, puts the
counters back as they were, and each chunk adds the step's launches times
the steps and each body's launches times the times it ran on the device
(``accrue``), and each named body's runs to its counter. The branch counters
are read once a chunk, with or without names. A counter of ``trace.COUNTS``
that the step raises outside its bodies (``trace.add``) is handled as the
launches are: the warm-up and the capture add nothing to it, and each chunk
adds what one step added times the steps.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Sequence

import torch

from md_neighbor_list_tpu_torch.ops import _cuda
from md_neighbor_list_tpu_torch.utils import trace

Cond = Callable[..., None]  # cond(pred, body, name=None)
Step = Callable[[Cond], None]


_capture = threading.local()


def capturing_body() -> bool:
    """True while this thread captures the body of a conditional node."""
    return getattr(_capture, "body", False)


@contextlib.contextmanager
def body_capture():
    """Mark this thread as capturing a conditional body for the block: a
    ``cond`` inside it, and a ring exchange, raise."""
    _capture.body = True
    try:
        yield
    finally:
        _capture.body = False


def refuse_in_body(what: str) -> None:
    """Raise if this thread is capturing a conditional body: ``what`` (a
    ring exchange) belongs to the step, outside every branch."""
    if capturing_body():
        raise RuntimeError(f"{what} inside a conditional body: a step's "
                           "collectives run outside its branches")


def eager_cond(pred: torch.Tensor, body: Callable[[], None],
               name: str | None = None) -> None:
    """The branch taken on the host: one read of ``pred``; a named branch
    taken adds one to its counter."""
    if bool(pred):
        if name is not None:
            trace.add(name)
        body()


def accrue(counts: dict, per_step: dict, per_body: Sequence[dict],
           taken: Sequence[int], steps: int,
           names: Sequence[str | None] = (), named: dict | None = None,
           step_named: dict | None = None) -> None:
    """Add to the launch counters ``counts`` what ``steps`` replays did: the
    step's own launches each step, and each body's each time it ran
    (``taken``, in the order of ``per_body``); to ``named[name]`` the
    runs of each body that ``names`` names (in the same order, None for a
    body without a name); and to ``named`` what ``step_named`` says one
    step adds to its counters, each step."""
    for name, n in per_step.items():
        counts[name] += steps * n
    for body, times in zip(per_body, taken):
        for name, n in body.items():
            counts[name] += times * n
    for name, times in zip(names, taken):
        if name is not None:
            named[name] += times
    for name, n in (step_named or {}).items():
        named[name] += steps * n


def _launched_since(before: dict) -> dict:
    return {k: v - before[k] for k, v in _cuda.LAUNCHES.items()
            if v != before[k]}


class StepGraph:
    """One step captured as a CUDA graph with its branches as conditional
    nodes. ``carry``: every tensor the step writes (saved and restored
    around the warm-up)."""

    def __init__(self, step: Step, carry: Sequence[torch.Tensor]):
        device = carry[0].device
        named = trace.counters()  # the warm-up and the capture are no steps
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            saved = [t.clone() for t in carry]
            step(lambda pred, body, name=None: body())  # every branch, once
            for t, s in zip(carry, saved):
                t.copy_(s)
        torch.cuda.current_stream(device).wait_stream(side)
        del saved

        counts = dict(_cuda.LAUNCHES)
        self._nodes: list[tuple[int, Callable[[], None]]] = []
        self.names: list[str | None] = []  # each body's counter, if named
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        try:
            trace.COUNTS.update(named)
            with torch.cuda.graph(self.graph):
                step(self._node)
            self.per_step = _launched_since(counts)
            # what one step adds to the counters outside its bodies
            self.step_named = {k: v - named[k]
                               for k, v in trace.counters().items()
                               if v != named[k]}
            # each body's count of runs, raised inside the body
            self.hits = torch.zeros(len(self._nodes), dtype=torch.int64,
                                    device=device)
            self.per_body: list[dict] = []
            self._bodies = []  # keep the body graphs and their pool alive
            pool = torch.cuda.graph_pool_handle()
            for i, (node, body) in enumerate(self._nodes):
                mark = dict(_cuda.LAUNCHES)
                graph = torch.cuda.CUDAGraph(keep_graph=True)
                side.wait_stream(torch.cuda.current_stream(device))
                with torch.cuda.stream(side):
                    graph.capture_begin(pool=pool)
                    try:
                        with body_capture():
                            body()
                        self.hits[i].add_(1)
                    finally:
                        graph.capture_end()
                self.per_body.append(_launched_since(mark))
                _cuda.graph_body(node, graph.raw_cuda_graph())
                self._bodies.append(graph)
            self.graph.instantiate()
        finally:
            _cuda.LAUNCHES.update(counts)  # nothing captured has run
            trace.COUNTS.update(named)
        self._nodes.clear()  # the bodies' closures are no longer needed

    def _node(self, pred: torch.Tensor, body: Callable[[], None],
              name: str | None = None) -> None:
        if capturing_body():
            raise RuntimeError("a branch inside a branch: conditional nodes "
                               "do not nest in a body graph")
        self._nodes.append((_cuda.graph_if(pred), body))
        self.names.append(name)

    def replay(self, nsteps: int) -> None:
        """``nsteps`` steps on the device; the host reads nothing."""
        self.hits.zero_()
        for _ in range(nsteps):
            self.graph.replay()

    def settle(self, nsteps: int) -> None:
        """After ``replay(nsteps)``: one read of the branch counters (none
        for a step without branches), the launches of the replays added to
        ``_cuda.LAUNCHES`` and the named branches' runs to their counters."""
        taken = self.hits.tolist() if self.per_body else []
        accrue(_cuda.LAUNCHES, self.per_step, self.per_body, taken, nsteps,
               self.names, trace.COUNTS, self.step_named)


class ChunkRunner:
    """An engine's chunk: ``step`` run ``nsteps`` times over ``carry``."""

    def __init__(self):
        self.graph: StepGraph | None = None
        self._key = None
        self._replayed = 0  # steps replayed that ``settle`` has not read
        self.captures = 0  # graphs captured so far
        self.capture_s = 0.0  # host seconds of the last capture, warm-up in

    def run(self, step: Step, nsteps: int, carry: Sequence[torch.Tensor],
            key=None, capturable: bool = True) -> None:
        """``capturable``: the engine's word that the step may be captured
        (false for a slab engine on a ring of host barriers); the step then
        runs eagerly on the card too."""
        self.launch(step, nsteps, carry, key, capturable)
        self.settle()

    def launch(self, step: Step, nsteps: int, carry: Sequence[torch.Tensor],
               key=None, capturable: bool = True) -> None:
        """``run`` up to its last replay: the steps eagerly, or the capture
        where one is due and ``nsteps`` replays, with no host read."""
        if not (carry[0].is_cuda and capturable):
            for _ in range(nsteps):
                step(eager_cond)
            return
        full_key = (key, tuple((t.data_ptr(), tuple(t.shape), t.dtype)
                               for t in carry))
        if self.graph is None or full_key != self._key:
            self.graph = None  # free the old graph's memory first
            with trace.span("graph.capture"):
                t0 = time.perf_counter()
                self.graph = StepGraph(step, carry)
                self.capture_s = time.perf_counter() - t0
            self._key = full_key
            self.captures += 1
            trace.add("captures")
        self.graph.replay(nsteps)
        self._replayed = nsteps

    def settle(self) -> None:
        """The rest of ``run`` after ``launch``: the replays' one read of
        the branch counters and their counts (nothing after eager steps)."""
        if self._replayed:
            self.graph.settle(self._replayed)
            self._replayed = 0
