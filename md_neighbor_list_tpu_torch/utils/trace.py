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
timeline is the span's. Nothing on the CPU. ``rebuild`` is the only one.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from md_neighbor_list_tpu_torch.ops import _cuda

PREFIX = "mdnl."  # the host spans' event names in a trace

COUNTS = {"launches": _cuda.LAUNCHES, "steps": 0, "rebuilds": 0, "redos": 0,
          "captures": 0, "list_forces": 0}
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
    if device.type != "cuda":
        yield
        return
    _cuda.launch("span_begin_" + name, device=device)
    yield
    _cuda.launch("span_end_" + name, device=device)
