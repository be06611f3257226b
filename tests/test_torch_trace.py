"""The port's counters and spans (``utils/trace.py``) on the CPU: no profiler
call without a profiler, each chunk's host spans under a CPU profile, the
counts of steps, rebuilds, redos and captures, and the launch counters as
the registry's own. The device span needs a card: ``tests/test_torch_gpu.py``
(``-k trace``)."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from md_neighbor_list_tpu_torch import DenseSimulator, MDConfig, Simulator
from md_neighbor_list_tpu_torch.ops import _cuda
from md_neighbor_list_tpu_torch.utils import convert, trace
from torch_port_util import numpy_system

N = 1728
HOT = dict(dt=0.005, temperature=2.0)  # a rebuild every few steps
CHILDREN = ("chunk.snapshot", "chunk.launch", "chunk.settle")


def _dense(**cfg):
    pos, vel, pid = numpy_system(N, 5)
    sim = DenseSimulator(MDConfig(n=N, **cfg), cap=32, device="cpu")
    carry = sim.build(convert.system_from_numpy(
        pos, 1.4 * vel, np.zeros_like(pos), pid, device="cpu"))
    return sim, carry


def _since(before: dict) -> dict:
    """What each counter but ``launches`` rose by since ``before``."""
    return {k: v - before[k] for k, v in trace.counters().items()}


def _spans(prof) -> dict:
    """{name: [(begin, end)]} of the port's host spans in a profile: each
    begin mark's start paired with the next end mark's end."""
    marks = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.name.startswith(trace.PREFIX))
    open_, out = {}, {}
    for s, e, name in marks:
        name = name[len(trace.PREFIX):]
        if name.endswith(".begin"):
            open_.setdefault(name[:-len(".begin")], []).append(s)
        else:
            base = name[:-len(".end")]
            out.setdefault(base, []).append((open_[base].pop(), e))
    assert not any(open_.values()), open_
    return out


def test_no_record_function_without_a_profiler(monkeypatch):
    """Two chunks with no profiler recording: no record function is entered
    (``record_function`` costs microseconds even then)."""
    sim, carry = _dense(**HOT)

    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    before = trace.COUNTS["steps"]
    sim.run(carry, 20, chunk=10)
    assert trace.COUNTS["steps"] == before + 20


def test_chunk_spans_under_a_cpu_profile():
    """Each chunk's span, and each child's, begins and ends once a chunk;
    the children lie inside their chunk in order; no redo is marked."""
    sim, carry = _dense(**HOT)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sim.run(carry, 9, chunk=3)
    spans = _spans(prof)
    assert set(spans) == {"chunk", *CHILDREN}
    assert all(len(spans[name]) == 3 for name in spans)
    for k, (a, b) in enumerate(spans["chunk"]):
        at = a
        for name in CHILDREN:
            s, e = spans[name][k]
            assert at <= s <= e <= b, name
            at = e


@pytest.mark.parametrize("engine", ["dense", "xla", "dense_every_step"])
def test_steps_and_rebuilds_counted(engine):
    """Over a run with no redo: ``steps`` the steps run, ``rebuilds`` the
    rise in the carry's rebuild count (the step's branches, or every step
    where the configuration rebuilds every step), no redo, no capture on
    the CPU, ``list_forces`` every step of the dense engine that reads its
    list (none where it rebuilds every step, none of the xla engine)."""
    if engine == "xla":
        pos, vel, pid = numpy_system(N, 5)
        sim = Simulator(MDConfig(n=N, **HOT), device="cpu")
        carry = sim.build(convert.system_from_numpy(
            pos, 1.4 * vel, np.zeros_like(pos), pid, device="cpu"))
        rebuilds = lambda c: int(c.nbr.n_rebuilds)  # noqa: E731
    else:
        every = engine == "dense_every_step"
        sim, carry = _dense(**HOT, rebuild_every_step=every)
        rebuilds = lambda c: int(c.n_rebuilds)  # noqa: E731
    start, before = rebuilds(carry), trace.counters()
    carry = sim.run(carry, 25, chunk=10)
    assert _since(before) == {"steps": 25,
                              "rebuilds": rebuilds(carry) - start,
                              "redos": 0, "captures": 0,
                              "list_forces": 25 if engine == "dense" else 0}
    assert rebuilds(carry) - start >= 2


def test_forced_overflow_adds_a_redo():
    """cap too small for the melt (as ``test_torch_dense_lj``): the twelfth
    chunk of 10 steps overflows and is redone with a larger cap; it counts
    once in ``steps``, once in ``redos``, and is marked ``chunk.redo``
    (profiled alone: the profiler slows the CPU's many small operations)."""
    pos, vel, pid = numpy_system(N, 4)
    sim = DenseSimulator(MDConfig(n=N, temperature=1.0), cap=28, device="cpu")
    carry = sim.build(convert.system_from_numpy(
        pos, 3.0 * vel, np.zeros((N, 3), np.float32), pid, device="cpu"))
    before = trace.counters()
    carry = sim.run(carry, 110, chunk=10)
    assert sim.cap == 28 and _since(before)["redos"] == 0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        carry = sim.run(carry, 10, chunk=10)
    assert sim.cap > 28 and not bool(carry.overflow)
    got = _since(before)
    assert (got["steps"], got["redos"]) == (120, 1)
    spans = _spans(prof)
    assert len(spans["chunk.redo"]) == 1 and len(spans["chunk"]) == 2
    (a, b), = spans["chunk.redo"]
    assert any(s <= a <= b <= e for s, e in spans["chunk"])


def test_launches_counter_is_the_kernel_counter():
    """``COUNTS["launches"]`` is ``_cuda.LAUNCHES`` itself, which
    ``reset_launches`` zeroes in place; the span markers have no counter;
    ``counters`` is every other counter."""
    assert _cuda.LAUNCHES is trace.COUNTS["launches"]
    _cuda.reset_launches()
    assert trace.COUNTS["launches"] is _cuda.LAUNCHES
    assert set(trace.COUNTS["launches"].values()) == {0}
    assert not set(_cuda._SPANS) & set(_cuda.LAUNCHES)
    before = trace.counters()
    assert set(before) == {"steps", "rebuilds", "redos", "captures",
                           "list_forces"}
    trace.add("steps", 3)
    assert _since(before) == {"steps": 3, "rebuilds": 0, "redos": 0,
                              "captures": 0, "list_forces": 0}


def test_span_is_inert_without_a_profiler_and_marks_under_one():
    """The span's body runs either way; its two marks only under a
    profile, with the body's own events between them."""
    ran = []
    with trace.span("probe"):
        ran.append(1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("probe"):
            torch.ones(4).sum()
            ran.append(2)
    assert ran == [1, 2]
    (a, b), = _spans(prof)["probe"]
    inside = [e for e in prof.events() if e.name == "aten::sum"]
    assert inside and all(a <= e.time_range.start <= b for e in inside)
