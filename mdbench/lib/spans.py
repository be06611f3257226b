"""The program's own spans in a traced stretch, rebuilt from a ``Trace`` as
``Trace.from_profile`` leaves it (the port's ``utils/trace.py`` writes them):

  host spans    a span named ``<name>`` is two zero-length host events,
                ``mdnl.<name>.begin`` and ``mdnl.<name>.end``: it runs from
                the begin mark's start to the end mark's end, spans nest by
                time, and a mark without its partner is left out
  device spans  the device operations strictly between a pair of the empty
                marker kernels ``mdnl::span_begin_<name>`` and
                ``mdnl::span_end_<name>`` (the markers themselves left out)

``idle_by_span`` names each idle gap of the device inside the stretch (as
``Trace.idle_gaps`` finds them) by the innermost host span open at the gap's
middle. Against a program that writes no spans every reader here finds
nothing (an empty list or dict), and the metrics that use them read None.
"""

from __future__ import annotations

import bisect

from mdbench.lib.trace import union_s

PREFIX = "mdnl."  # the program's host span marks
BEGIN, END = ".begin", ".end"


def host_spans(trace) -> list:
    """[(name, start_us, end_us)] of the program's host spans, by start."""
    marks = []
    for n, s, e in trace.host:
        if not n.startswith(PREFIX):
            continue
        body = n[len(PREFIX):]
        if body.endswith(BEGIN):
            marks.append((s, 1, body[:-len(BEGIN)], s))
        elif body.endswith(END):
            marks.append((e, 0, body[:-len(END)], e))
    # by time, an end before a begin of the same instant: a span of a name
    # closes before the next one of that name opens
    open_, out = {}, []
    for _, is_begin, name, at in sorted(marks):
        if is_begin:
            open_.setdefault(name, []).append(at)
        elif open_.get(name):
            out.append((name, open_[name].pop(), at))
    return sorted(out, key=lambda r: r[1])


def device_spans(trace, name: str) -> list:
    """[(start_us, end_us, busy_s)] of the device span ``name``: between
    the end of each begin marker and the start of the next end marker, and
    the union of the device operations that lie wholly inside."""
    begin, end = f"span_begin_{name}", f"span_end_{name}"
    marks, work = [], []
    for n, s, e in trace.ops:
        if begin in n:
            marks.append((s, e, True))
        elif end in n:
            marks.append((s, e, False))
        else:
            work.append((s, e))
    out, opened = [], None
    for s, e, is_begin in sorted(marks):
        if is_begin:
            opened = e
        elif opened is not None:
            out.append((opened, s))
            opened = None
    return [(a, b, union_s((s, e) for s, e in work if s >= a and e <= b))
            for a, b in out]


def gaps(trace) -> list:
    """[(start_us, end_us)] of the device's idle gaps between its first and
    last operation in the stretch."""
    out, end = [], None
    for s, e in sorted((s, e) for _, s, e in trace.ops):
        if end is not None and s > end:
            out.append((end, s))
        end = e if end is None else max(end, e)
    return out


def idle_by_span(trace) -> dict:
    """{span name: idle seconds} over the stretch's gaps, each by the
    innermost program span open at its middle ("" where none is); empty
    where the stretch holds no program span."""
    spans = host_spans(trace)
    if not spans:
        return {}
    starts = [s for _, s, _ in spans]
    by = {}
    for a, b in gaps(trace):
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid)
        # the latest-opened span still open at the middle is the innermost
        inner = next((n for n, s, e in reversed(spans[:i]) if e >= mid), "")
        by[inner] = by.get(inner, 0.0) + (b - a) * 1e-6
    return by


def idle_ms_per_chunk(ctx, names) -> float | None:
    """Device-idle ms a traced chunk in the gaps named by any span of
    ``names``; a traced chunk = the traced steps over the mix's ``chunk``.
    None without a trace or without program spans in it."""
    tr = ctx.trace
    if tr is None or not tr.units:
        return None
    by = idle_by_span(tr)
    if not by:
        return None
    chunks = tr.units / int(ctx.cell.traffic["chunk"])
    return sum(v for k, v in by.items() if k in names) * 1e3 / chunks
