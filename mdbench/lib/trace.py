"""Reduce a ``torch.profiler`` trace of the traced stretch to what the
per-layer metrics read: device time by kernel, the device's busy seconds, the
longest device operations and the idle gaps by what the host was doing.

The harness marks its own work with ``record_function("mdbench.<what>")``
(``annotate``); those ranges are not device operations of the program. An
idle share is never taken from the traced stretch's own wall time, which
tracing stretches: the metrics divide the traced device time a unit by the
untraced window's wall time a unit, both from the same run.
"""

from __future__ import annotations

import bisect
import re
import time

MARK = "mdbench."  # prefix of the harness's own annotated ranges


def annotate(what: str):
    """A range of the harness's own work, named ``mdbench.<what>`` in the
    trace (a no-op outside a profile)."""
    from torch.profiler import record_function
    return record_function(MARK + what)


def short(name: str, width: int = 120) -> str:
    """A kernel's name without its argument list, cut to ``width``."""
    cut = name.find("(")
    name = name[:cut] if cut > 0 else name
    return name[:width]


def union_s(intervals) -> float:
    """Seconds covered by the union of (start_us, end_us) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total * 1e-6


class Trace:
    """One traced stretch of ``units`` units of work (steps, builds,
    calls) that took ``wall_s`` host seconds under the tracer."""

    def __init__(self, device_ops, marks, host_ops, units: int,
                 wall_s: float, mark_device_us: dict | None = None):
        self.ops = device_ops  # [(name, start_us, end_us)] device operations
        self.marks = marks  # [(name, start_us, end_us)] device-side ranges
        self.host = host_ops  # [(name, start_us, end_us)] host operations
        self.units = units
        self.wall_s = wall_s
        # device microseconds the tracer attributes to each host-side range
        # of the harness
        self.mark_device_us = mark_device_us or {}

    @classmethod
    def from_profile(cls, prof, units: int, wall_s: float) -> "Trace":
        from torch.autograd import DeviceType
        ops, marks, host, attributed = [], [], [], {}
        for e in prof.events():
            row = (e.name, float(e.time_range.start), float(e.time_range.end))
            if e.device_type == DeviceType.CUDA:
                (marks if e.name.startswith(MARK) else ops).append(row)
            else:
                host.append(row)
                if e.name.startswith(MARK):
                    attributed[e.name] = (attributed.get(e.name, 0.0)
                                          + float(e.device_time_total))
        return cls(ops, marks, host, units, wall_s, attributed)

    # ------------------------------------------------------------ device
    @property
    def busy_s(self) -> float:
        """Seconds in which some device operation ran."""
        return union_s((s, e) for _, s, e in self.ops)

    def busy_ms_per_unit(self, outside=()) -> float | None:
        """Device ms a unit: the union of the device operations, leaving out
        those whose name matches any of the regular expressions
        ``outside``."""
        rx = [re.compile(p) for p in outside]
        busy = union_s((s, e) for n, s, e in self.ops
                       if not any(r.search(n) for r in rx))
        return busy * 1e3 / self.units if busy > 0 and self.units else None

    def kernel(self, patterns) -> tuple[int, float]:
        """(launches, device seconds) of the operations whose name matches
        any of the regular expressions ``patterns``."""
        rx = [re.compile(p) for p in patterns]
        hits = [(s, e) for n, s, e in self.ops if any(r.search(n) for r in rx)]
        return len(hits), sum(e - s for s, e in hits) * 1e-6

    def marked_s(self, what: str) -> float | None:
        """Device seconds of the operations inside the harness's ranges named
        ``mdbench.<what>``: the device operations under the device-side
        ranges where the tracer records them, else the device time it
        attributes to the host-side ranges. None where neither shows any."""
        name = MARK + what
        spans = [(s, e) for n, s, e in self.marks if n == name]
        inside = [(max(s, a), min(e, b)) for _, s, e in self.ops
                  for a, b in spans if s < b and e > a]
        got = union_s(inside) or self.mark_device_us.get(name, 0.0) * 1e-6
        return got if got > 0 else None

    def device_ops(self, top: int = 10) -> list:
        """[[name, seconds]] of the device operations that took most time,
        summed by name."""
        by = {}
        for n, s, e in self.ops:
            key = short(n)
            by[key] = by.get(key, 0.0) + (e - s) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:top]]

    def idle_gaps(self, top: int = 10, look_back: int = 256) -> list:
        """[[what the host was doing, seconds]]: the device's idle gaps
        inside the stretch, summed by the innermost host operation open at
        each gap's middle (``host idle`` where none was). The host operations
        open at a moment are looked for among the ``look_back`` that started
        last before it."""
        spans = sorted((s, e) for _, s, e in self.ops)
        gaps, end = [], None
        for s, e in spans:
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        by = {}
        for a, b in gaps:
            mid = 0.5 * (a + b)
            i = bisect.bisect_right(starts, mid)
            open_ = [(e - s, n) for n, s, e in host[max(0, i - look_back):i]
                     if e >= mid]
            what = short(min(open_)[1], 80) if open_ else "host idle"
            by[what] = by.get(what, 0.0) + (b - a) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:top]]

    def breakdown(self) -> dict:
        return {"device_ops": self.device_ops(), "idle_gaps": self.idle_gaps()}


def traced(advance, units: int, sync, warm_units: int = 1) -> Trace:
    """``advance(k)`` does k units. Trace ``warm_units`` first (the tracer's
    own set-up), then ``units`` under a fresh profile."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):
        advance(warm_units)
        sync()
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        advance(units)
        sync()
        wall = time.perf_counter() - t0
    return Trace.from_profile(prof, units, wall)
