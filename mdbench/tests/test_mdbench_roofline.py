"""Each roofline formula, the trace reductions and the idle share, at a tiny
size."""

import pytest

from mdbench.lib import harness, layer, peaks, spec, trace


def test_forces_half_work_counts_pairs_within_rc_and_n():
    flops, nbytes = spec.roofline("forces_half").work(
        {"n": 1000, "pairs_rc": 16_000})
    assert flops == 16_000 * 25 and nbytes == 1000 * 24
    assert spec.roofline("forces_half").work({"n": 1000}) is None


def test_lists_half_work_counts_a_minimal_index_list():
    flops, nbytes = spec.roofline("lists_half").work(
        {"n": 1000, "pairs_rs": 46_000})
    assert flops == 46_000 * 8
    assert nbytes == 1000 * 12 + 4 * 46_000 + 4 * 1000


def test_bound_is_the_larger_of_bytes_and_flops():
    t, by = peaks.bound_s(67e12, 0.0)
    assert t == pytest.approx(1.0) and by == "flops"
    t, by = peaks.bound_s(0.0, 3.35e12)
    assert t == pytest.approx(1.0) and by == "bytes"


def fake_trace(units=10):
    # two K3 launches of 100 us, a 20 us add, a 50 us idle gap in a copy_
    ops = [("void mdnl::force_half_kernel<0, true>(float const*)", 0, 100),
           ("void at::native::add_kernel(...)", 100, 120),
           ("void mdnl::force_half_kernel<0, true>(float const*)", 170, 270)]
    host = [("aten::copy_", 110, 180), ("cudaGraphLaunch", 0, 5)]
    marks = [("mdbench.harness", 100, 125)]
    return trace.Trace(ops, marks, host, units=units, wall_s=1e-3)


def test_trace_reductions():
    tr = fake_trace()
    assert tr.busy_s == pytest.approx(220e-6)
    assert tr.kernel([r"force_half_kernel<0, ?true>"]) == (2,
                                                          pytest.approx(2e-4))
    assert tr.marked_s("harness") == pytest.approx(20e-6)
    assert tr.marked_s("nothing") is None
    assert tr.device_ops()[0] == ["void mdnl::force_half_kernel<0, true>",
                                  pytest.approx(2e-4)]
    assert tr.idle_gaps() == [["aten::copy_", pytest.approx(50e-6)]]
    assert trace.union_s([(0, 10), (5, 20), (30, 40)]) == pytest.approx(3e-5)


class _Run:
    work = {"n": 1000, "pairs_rc": 16_000}


def test_roofline_share_and_idle_share():
    cell = spec.load_cell("c4_sorted.nve")
    ctx = harness.Context(cell, _Run(), units=100, window_s=0.0025,
                          trace=fake_trace(units=10))
    bound, _ = peaks.bound_s(16_000 * 25, 1000 * 24)
    assert layer.roofline_share(ctx, "forces_half") == pytest.approx(
        100 * bound / 1e-4)
    # 0.022 device ms a unit traced against 0.025 wall ms a unit untraced
    assert layer.idle_share(ctx) == pytest.approx(12.0)
    ctx.trace = trace.Trace([], [], [], 10, 1e-3)
    assert layer.roofline_share(ctx, "forces_half") is None
    assert layer.idle_share(ctx) is None


def test_metric_readers_return_none_without_a_trace():
    ctx = harness.Context(spec.load_cell("c4_sorted.build"), _Run(),
                          units=10, window_s=1.0, trace=None)
    for m in ("rebuild_ms.build", "lists_half_roofline", "device_idle.build"):
        assert spec.metric_reader(m).read(ctx) is None
