"""The configuration ``c4_inc`` and its cells on the CPU at a small N: both
cells load from their files; the quick forms of ``nve_inc`` and ``build_inc``
run the incremental engine through ``run`` and ``_rebuild_and_lists`` and are
correct under the cells' own limits, while the control is not; a mover that
K8's plain version drops or puts in the wrong cell fails the build's check;
and the readers of the ``increment`` span and K8's roofline."""

import json

import pytest
import torch

from mdbench.drivers import build_inc
from mdbench.lib import harness, layer, peaks, spec, trace
from mdbench.reference import cells
from mdbench.tests import util

QUICK = {
    "nve_inc_quick": {**util.QUICK["nve_quick"], "driver": "nve_inc"},
    "build_inc_quick": {**util.QUICK["build_quick"], "driver": "build_inc"},
}
CELLS = {"c4_inc.nve": "nve_inc_quick", "c4_inc.build": "build_inc_quick"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    bodies = {}
    for cell, mix in CELLS.items():
        body = json.loads((util.HERE / "workloads" / f"{cell}.json")
                          .read_text())
        body.update(traffic=mix, reports_like=cell)
        bodies[cell + ".quick"] = body
    return util.bench_copy(tmp_path_factory.mktemp("bench"), traffic=QUICK,
                           cells=bodies)


def test_both_cells_load_from_their_files():
    for cell, driver, metrics in (
            ("c4_inc.nve", "nve_inc", {"increment_ms.steps",
                                       "rebuild_ms.steps",
                                       "halflist_ms.steps"}),
            ("c4_inc.build", "build_inc", {"increment_ms.build",
                                           "merge_roofline",
                                           "lists_half_roofline"})):
        c = spec.load_cell(cell)
        assert c.config["name"] == "c4_inc" and c.chips == 1
        assert c.config["rebuild"] == "incremental"
        assert c.driver == driver
        assert metrics <= {m["name"] for m in c.per_layer}
        sorted_ = spec.load_cell(cell.replace("c4_inc", "c4_sorted"))
        assert {k: v for k, v in c.config.items()
                if k not in ("name", "source", "rebuild", "assumed")} == \
            {k: v for k, v in sorted_.config.items()
             if k not in ("name", "source", "assumed")}
        assert {k: v for k, v in c.traffic.items()
                if k not in ("name", "driver")} == \
            {k: v for k, v in sorted_.traffic.items()
             if k not in ("name", "driver")}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_quick_cell_is_correct_and_the_control_is_not(root, cell):
    from md_neighbor_list_tpu_torch.models import dense_lj

    made = []
    init = dense_lj.DenseSimulator.__init__

    def spy(self, *args, **kwargs):
        init(self, *args, **kwargs)
        made.append(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dense_lj.DenseSimulator, "__init__", spy)
        r = util.run_small(root, cell + ".quick", control=True, trace=True)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["control"]["correct"] is False, r["control"]
    assert made and all(sim.incremental for sim in made)
    counters = r["window"]["counters"]
    assert counters["incremental_rebuilds"] > 0
    assert counters["full_fallbacks"] == 0
    assert counters["rebuilds"] == counters["incremental_rebuilds"]
    assert counters["movers_per_rebuild"] > 0
    if cell == "c4_inc.build":
        assert r["checks"]["cell_err"] == {"value": 0, "limit": 0}
        assert counters["builds"] == counters["rebuilds"]
    else:
        assert r["metrics"]["steps_per_rebuild"]["value"] == pytest.approx(
            counters["steps"] / counters["rebuilds"])
    assert list(r)[-2:] == ["window", "checks"]


def _first_mover(out, movers):
    """(flat slot in ``out``, pid) of the first particle of the mover
    stream."""
    m = movers.pid.reshape(-1)
    pid = m[m >= 0][0]
    return int(torch.nonzero(out.pid.reshape(-1) == pid)[0]), pid


def _dropping(real):
    def merge(state_w, spid, movers, spec_):
        out = real(state_w, spid, movers, spec_)
        slot, _ = _first_mover(out, movers)
        out.pid.view(-1)[slot] = -1
        out.vel.view(3, -1)[:, slot] = 0.0
        out.pos.view(3, -1)[:, slot] = 1.0e5 + slot  # parked, off the box
        return out
    return merge


def _misplacing(real):
    """Moves the first mover into a free slot of the cell after its own."""
    def merge(state_w, spid, movers, spec_):
        out = real(state_w, spid, movers, spec_)
        slot, _ = _first_mover(out, movers)
        cap = spec_.cap
        cell = (slot // cap + 1) % spec_.ncells
        free = cell * cap + int(torch.nonzero(
            out.pid.view(-1, cap)[cell] < 0)[0])
        for t in (out.pos.view(3, -1), out.vel.view(3, -1)):
            t[:, free] = t[:, slot]
        out.pid.view(-1)[free] = out.pid.view(-1)[slot]
        out.pid.view(-1)[slot] = -1
        out.vel.view(3, -1)[:, slot] = 0.0
        out.pos.view(3, -1)[:, slot] = 1.0e5 + slot
        return out
    return merge


@pytest.mark.parametrize("fault, caught_by", [
    (_dropping, ("pair_miss", "state_err")),
    (_misplacing, ("cell_err",))], ids=["dropped", "misplaced"])
def test_a_mover_broken_in_the_merge_fails_the_build(root, monkeypatch,
                                                     fault, caught_by):
    from md_neighbor_list_tpu_torch.ops import incremental

    monkeypatch.setattr(incremental, "merge_plain",
                        fault(incremental.merge_plain))
    r = util.run_small(root, "c4_inc.build.quick")
    assert r["correct"] is False
    for name in caught_by:
        assert r["checks"][name]["value"] > 0, r["checks"]


def test_binned_frame_puts_each_particle_in_its_reference_cell():
    from md_neighbor_list_tpu_torch.core.box import Box
    from md_neighbor_list_tpu_torch.ops.dense_cells import make_spec

    n = util.N_SMALL
    L = n ** (1.0 / 3.0)
    g = torch.Generator().manual_seed(3)
    pos = torch.rand((n, 3), generator=g) * L
    vel = torch.randn((n, 3), generator=g)
    pid = torch.randperm(n, generator=g).to(torch.int32)
    sp = make_spec(Box.from_density(n, 1.0), 2.8, 40)
    key = cells.cell_keys(pos, L, 2.8)
    state = build_inc.binned(pos, vel, pid, key, sp)
    flat = state.pid.reshape(-1).to(torch.int64)
    slots = torch.nonzero(flat >= 0).squeeze(1)
    assert slots.numel() == n
    assert torch.equal(torch.sort(flat[slots]).values,
                       torch.arange(n, dtype=torch.int64))
    by_pid = torch.argsort(flat[slots])
    pos_by_pid = state.pos.reshape(3, -1)[:, slots].T[by_pid]
    assert torch.equal(pos_by_pid, pos[torch.argsort(pid.to(torch.int64))])
    assert cells.misplaced((slots // sp.cap)[by_pid], pos_by_pid, L,
                           2.8) == 0
    # each cell's particles in its first slots
    occupied = (state.pid >= 0).reshape(-1, sp.cap).to(torch.int32)
    assert torch.all(occupied[:, :-1] >= occupied[:, 1:])


def test_misplaced_allows_the_band_and_nothing_more():
    L, r = 14.0, 2.8  # mc = 5, cells of side 2.8
    face = 2.8
    pos = torch.tensor([[face - 1e-6, 1.0, 1.0], [face + 1e-6, 1.0, 1.0],
                        [face + 1e-3, 1.0, 1.0], [-1e-7, 1.0, 1.0]],
                       dtype=torch.float64)
    key = torch.tensor([1, 0, 0, 4])
    # the first two within the band of the face x = 2.8, either side; the
    # third 1e-3 past it; the fourth wraps to the last cell
    assert cells.misplaced(key, pos, L, r) == 1
    assert cells.misplaced(key[:2], pos[:2], L, r) == 0
    assert cells.misplaced(torch.tensor([0]), pos[3:], L, r) == 1


def _span_trace(name, busy_us):
    ops = []
    t = 0.0
    for b in busy_us:
        ops += [(f"void mdnl::span_begin_{name}()", t, t + 1),
                ("void mdnl::merge_kernel(...)", t + 2, t + 2 + b),
                (f"void mdnl::span_end_{name}()", t + 3 + b, t + 4 + b)]
        t += 100.0
    ops.append(("void mdnl::lists_half_kernel<true, true>(...)", t, t + 50))
    return trace.Trace(ops, [], [], len(busy_us), 1e-3)


def test_increment_readers_and_merge_roofline():
    class _Run:
        work = {"n": 1000, "movers": 40, "cap": 40}

    for name, cell in (("increment_ms.steps", "c4_inc.nve"),
                       ("increment_ms.build", "c4_inc.build")):
        ctx = harness.Context(spec.load_cell(cell), _Run(), units=2,
                              window_s=1.0, trace=_span_trace("increment",
                                                              [20.0, 40.0]))
        assert spec.metric_reader(name).read(ctx) == pytest.approx(0.030)
        # a program without the markers, or no trace: nothing to read
        ctx.trace = _span_trace("rebuild", [20.0, 40.0])
        assert spec.metric_reader(name).read(ctx) is None
        ctx.trace = None
        assert spec.metric_reader(name).read(ctx) is None
    ctx = harness.Context(spec.load_cell("c4_inc.build"), _Run(), units=2,
                          window_s=1.0, trace=_span_trace("increment",
                                                          [20.0, 40.0]))
    bound, by = peaks.bound_s(0, 1000 * 56 + 40 * 4)
    assert by == "bytes"
    assert spec.metric_reader("merge_roofline").read(ctx) == \
        pytest.approx(100 * bound / 30e-6)
    assert layer.roofline_share(ctx, "merge") == pytest.approx(
        100 * bound / 30e-6)
    _Run.work = {"n": 1000, "cap": 40}  # the reference counted no movers
    assert spec.metric_reader("merge_roofline").read(ctx) is None
