"""The measured window's arithmetic: all the work over all the time.

A rate is the units completed in the window over the window's seconds, never
a median of chunks; a tail is the percentile over every unit of the window.
"""

from __future__ import annotations

import math
import time


def rate(units: int, seconds: float) -> float:
    """Units per second over the whole window."""
    if seconds <= 0 or units <= 0:
        raise ValueError(f"no work measured: {units} units in {seconds} s")
    return units / seconds


def per_unit_ms(units: int, seconds: float) -> float:
    """Milliseconds a unit over the whole window."""
    return 1e3 / rate(units, seconds)


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of every value, by the nearest rank:
    the smallest value with at least q % of them at or below it."""
    ordered = sorted(values)
    if not ordered:
        raise ValueError("percentile of no values")
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def run_window(seconds: float, unit, sync) -> tuple[int, float]:
    """Call ``unit()`` until ``seconds`` have passed on the host clock, the
    window bracketed by ``sync()`` on both sides. ``unit`` returns the units
    it completed (steps of a chunk, one build, one call). Returns (units,
    window seconds): the last unit started before the deadline and its time
    is counted whole."""
    sync()
    t0 = time.perf_counter()
    units = 0
    while time.perf_counter() - t0 < seconds:
        units += unit()
    sync()
    return units, time.perf_counter() - t0
