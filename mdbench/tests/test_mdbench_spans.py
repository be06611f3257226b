"""The readers of the program's own spans and counters (``lib/spans.py`` and
the metrics that use it) on synthetic traces: spans paired and nested by
time, device spans between their marker kernels, each idle gap named by the
innermost span, and None from every reader where the program wrote no span
or counter (the parent of the change that added them)."""

import sys

import pytest

from mdbench.lib import harness, spans, spec, trace

# one chunk (times in us): the snapshot's copies, a gap in the launch, the
# replays with one rebuild between its markers, a gap in the settle
HOST = [("mdnl.chunk.begin", 0, 1), ("mdnl.chunk.snapshot.begin", 2, 3),
        ("aten::clone", 3, 9), ("mdnl.chunk.snapshot.end", 10, 11),
        ("mdnl.chunk.launch.begin", 12, 13), ("cudaGraphLaunch", 14, 16),
        ("mdnl.chunk.launch.end", 40, 41), ("mdnl.chunk.settle.begin", 42, 43),
        ("mdnl.chunk.settle.end", 100, 101), ("mdnl.chunk.end", 102, 103)]
OPS = [("Memcpy DtoD", 4, 6), ("Memcpy DtoD", 7, 9),
       ("void mdnl::force_half_kernel<0, true>()", 20, 30),
       ("mdnl::span_begin_rebuild()", 30, 31),
       ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel", 31, 35),
       ("void mdnl::expand_kernel<4>()", 36, 38),
       ("mdnl::span_end_rebuild()", 38, 39),
       ("void mdnl::force_half_kernel<0, true>()", 39, 60),
       ("Memcpy DtoH", 70, 80), ("Memcpy DtoH", 80.5, 81)]


def fake(host=HOST, ops=OPS, units=100):
    return trace.Trace(list(ops), [], list(host), units=units, wall_s=1e-3)


def context(tr):
    return harness.Context(spec.load_cell("c4_sorted.nve"), object(),
                           units=1000, window_s=1.0, trace=tr)


def test_host_spans_pair_and_nest_by_time():
    got = spans.host_spans(fake())
    assert got == [("chunk", 0, 103), ("chunk.snapshot", 2, 11),
                   ("chunk.launch", 12, 41), ("chunk.settle", 42, 101)]
    # a mark without its partner is left out; an end and the next begin of
    # one name at the same instant close and open in that order
    host = [("mdnl.chunk.end", 0, 0), ("mdnl.chunk.begin", 5, 5),
            ("mdnl.chunk.end", 9, 9), ("mdnl.chunk.begin", 9, 9),
            ("mdnl.chunk.end", 12, 12), ("mdnl.chunk.begin", 20, 20)]
    assert spans.host_spans(fake(host=host)) == [("chunk", 5, 9),
                                                 ("chunk", 9, 12)]


def test_device_span_is_the_work_between_its_markers():
    (a, b, busy), = spans.device_spans(fake(), "rebuild")
    assert (a, b) == (31, 38) and busy == pytest.approx(6e-6)
    assert spans.device_spans(fake(), "other") == []
    # an end marker with no begin before it pairs with nothing
    assert spans.device_spans(fake(ops=OPS[6:]), "rebuild") == []


def test_each_gap_is_named_by_the_innermost_span():
    by = spans.idle_by_span(fake())
    assert by == {"chunk.snapshot": pytest.approx(1e-6),
                  "chunk.launch": pytest.approx(12e-6),
                  "chunk.settle": pytest.approx(10.5e-6)}
    assert sum(by.values()) == pytest.approx(
        sum(b - a for a, b in spans.gaps(fake())) * 1e-6)
    # a gap outside every span is named ""
    late = OPS + [("Memcpy DtoH", 130, 131)]  # the gap's middle at 105.5
    assert spans.idle_by_span(fake(ops=late))[""] == pytest.approx(49e-6)


def test_metrics_read_the_spans():
    ctx = context(fake())
    read = lambda m: spec.metric_reader(m).read(ctx)  # noqa: E731
    assert read("rebuild_ms.steps") == pytest.approx(6e-3)
    # 100 traced steps = one chunk of the mix's 100
    assert read("launch_idle_ms.steps") == pytest.approx(12e-3)
    assert read("boundary_idle_ms.steps") == pytest.approx(11.5e-3)
    ctx.trace = fake(units=200)  # two chunks: the same gaps halved
    assert read("boundary_idle_ms.steps") == pytest.approx(5.75e-3)


def test_metrics_read_none_without_the_programs_spans():
    """The parent's trace: no marks, no marker kernels."""
    host = [h for h in HOST if not h[0].startswith("mdnl.")]
    ops = [o for o in OPS if "span_" not in o[0]]
    for tr in (fake(host=host, ops=ops), None):
        ctx = context(tr)
        for m in ("rebuild_ms.steps", "boundary_idle_ms.steps",
                  "launch_idle_ms.steps"):
            assert spec.metric_reader(m).read(ctx) is None, m


def test_steps_per_rebuild_reads_the_programs_counters(monkeypatch):
    from md_neighbor_list_tpu_torch.utils import trace as counters

    reader = spec.metric_reader("steps_per_rebuild")
    monkeypatch.setitem(counters.COUNTS, "steps", 13_410)
    monkeypatch.setitem(counters.COUNTS, "rebuilds", 447)
    assert reader.read(context(None)) == pytest.approx(30.0)
    monkeypatch.setitem(counters.COUNTS, "rebuilds", 0)
    assert reader.read(context(None)) is None
    # a program without the counters
    monkeypatch.setitem(sys.modules, "md_neighbor_list_tpu_torch.utils.trace",
                        None)
    assert reader.read(context(None)) is None
