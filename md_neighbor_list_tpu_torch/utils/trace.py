"""The port's counters and spans: what a profiler trace, the benchmark's
per-layer metrics and the CLI read of the program's own work.

``COUNTS`` holds every counter of the port:

  launches  kernel launches by kernel: ``ops/_cuda.LAUNCHES`` itself (the same
            dict), which ``_cuda.launch`` raises and
            ``utils/graphs.accrue`` adds the replays of a graph to
  steps     steps completed by the single-card engines' ``run``
            (``DenseSimulator``, ``Simulator``); a chunk redone counts once
  rebuilds  rebuilds taken in those steps: the branch their step names
            ``rebuilds`` (``cond(pred, body, "rebuilds")``), counted from
            the branch counters the chunk runner reads anyway, or every
            step where the configuration rebuilds every step
  redos     chunks of those engines undone by an overflow
  captures  graphs captured by any ``ChunkRunner``
  list_forces  steps of ``DenseSimulator`` whose force read the half list of
            the last rebuild (``dense_forces_list``): added by the step
            itself when it runs eagerly, and per replay of a captured step
            (``utils/graphs.accrue``); every step unless the configuration
            rebuilds every step (the step then sweeps). Like ``rebuilds`` it
            counts the steps of a chunk that is then undone.
  incremental_rebuilds, full_fallbacks
            rebuilds of ``DenseSimulator(incremental=True)`` by what followed
            the incremental pass: the merged state kept, or the full rebuild
            taken because the mover stream tripped the window predicate, in
            the step, the initial build and the timed list build alike. They
            are the engine's device counts (``_taken``), brought here where
            the engine reads them: once a chunk at its settle, and where its
            ``incremental_rebuilds`` or ``full_fallbacks`` is read. Like
            ``rebuilds`` they count the rebuilds of a chunk then undone.

Host spans. ``with span("chunk.launch"):`` marks a stretch of host work.
While a ``torch.profiler`` records, it emits an empty record function named
``mdnl.<name>.begin`` at entry and one named ``mdnl.<name>.end`` at exit:
zero-length host events on the profiler's clock, which the device trace
shares. A span is never a range around launches: under the profiler such a
range also gets a device-side range, which a reader of the trace would take
for a device operation. A mark is PyTorch's fast record function
(``torch._C._profiler._RecordFunctionFast``, about 1 us under the profiler,
against about 12 us for ``torch.profiler.record_function``): the device
idles while the host marks a chunk's boundary, so a slow mark would inflate
the idle it measures. With no profiler recording a span costs one check of
the profiler's state and no record function is entered.

Device spans. ``with device_span("rebuild", device):`` around work launched
on a card (in a captured graph too) launches the empty kernel
``mdnl::span_begin_<name>`` before it and ``mdnl::span_end_<name>`` after
(``csrc/span.cu``), uncounted: the work between the two on the device's
timeline is the span's. Nothing on the CPU. ``device_mark`` launches one
marker alone, for a span that opens in one branch of a step and closes in
another. Three: ``rebuild`` (the step's rebuild), ``halflist`` (the step's
half list, inside it) and ``increment`` (the incremental rebuild's own pass:
inside ``rebuild`` in the step, and also in the initial and the timed list
build, which carry no ``rebuild``). A reader finds a
span's markers by the substring ``span_begin_<name>``, so no span's name
contains another's (no ``rebuild_list``).
"""

from __future__ import annotations

import contextlib
import threading

import torch

from md_neighbor_list_tpu_torch.ops import _cuda

PREFIX = "mdnl."  # the host spans' event names in a trace

COUNTS = {"launches": _cuda.LAUNCHES, "steps": 0, "rebuilds": 0, "redos": 0,
          "captures": 0, "list_forces": 0, "incremental_rebuilds": 0,
          "full_fallbacks": 0}
_adding = threading.Lock()

_profiling = torch._C._autograd._profiler_enabled


def add(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of ``COUNTS`` (not ``launches``)."""
    with _adding:
        COUNTS[name] += n


def counters() -> dict:
    """The counters of ``COUNTS`` but ``launches``, as they are now."""
    return {k: v for k, v in COUNTS.items() if k != "launches"}


def _mark(label: str) -> None:
    with torch._C._profiler._RecordFunctionFast(PREFIX + label):
        pass


@contextlib.contextmanager
def span(name: str):
    """A host span named ``name``: its two marks while a profiler records,
    nothing else."""
    if not _profiling():
        yield
        return
    _mark(name + ".begin")
    try:
        yield
    finally:
        _mark(name + ".end")


@contextlib.contextmanager
def device_span(name: str, device: torch.device):
    """A device span named ``name`` (a kernel pair of ``csrc/span.cu``)
    around the work launched in the block on ``device``; nothing off a
    card."""
    device_mark(name, "begin", device)
    yield
    device_mark(name, "end", device)


def device_mark(name: str, edge: str, device: torch.device) -> None:
    """The ``edge`` ("begin" or "end") marker kernel of the device span
    ``name`` on ``device``; nothing off a card."""
    if device.type == "cuda":
        _cuda.launch(f"span_{edge}_{name}", device=device)
