"""The dense engine's step over the half list of its last rebuild, on the
CPU (plain versions): the list is built where every rebuild ends, the step's
force reads it, and the trajectory follows the step that sweeps the cells
(the configuration that rebuilds every step keeps the sweep). The kernels on
the card: ``tests/test_torch_gpu.py`` (``-k list``)."""

import numpy as np
import pytest
import torch

from md_neighbor_list_tpu_torch import DenseSimulator, MDConfig
from md_neighbor_list_tpu_torch.models import dense_lj
from md_neighbor_list_tpu_torch.ops import dense_force
from md_neighbor_list_tpu_torch.utils import convert, trace
from torch_port_util import numpy_system

N = 1728
HOT = dict(dt=0.005, temperature=2.0)  # a rebuild every few steps


def _system(seed: int = 5, heat: float = 1.4):
    pos, vel, pid = numpy_system(N, seed)
    return convert.system_from_numpy(pos, heat * vel, np.zeros_like(pos),
                                     pid, device="cpu")


def _sweeping(sim: DenseSimulator) -> DenseSimulator:
    """``sim`` made to take the half sweep in its step (the reference)."""
    sim._reads_list = lambda: False
    return sim


def _fresh_list(sim: DenseSimulator, carry) -> dense_force.HalfList:
    lst = dense_force.half_list_buffers(sim.spec, N, sim.config.rs, "cpu")
    assert not bool(dense_force.build_half_list(carry.ref_pos, sim.spec,
                                                sim.config.rs, lst))
    return lst


def _assert_list_is(sim: DenseSimulator, carry) -> None:
    """The engine's list is the one of ``carry``'s last rebuild."""
    want = _fresh_list(sim, carry)
    for name in ("start", "nsparse"):
        assert torch.equal(getattr(sim._list, name), getattr(want, name))
    n = int(want.start.reshape(-1)[-1] + want.nsparse.reshape(-1)[-1])
    own, part, _ = dense_force.list_pairs(sim._list, sim.spec)
    own_w, part_w, _ = dense_force.list_pairs(want, sim.spec)
    assert torch.equal(own, own_w) and torch.equal(part, part_w) and n > 0


@pytest.mark.parametrize("incremental", [False, True],
                         ids=["dense", "incremental"])
def test_list_steps_follow_the_sweep_steps(incremental):
    """60 steps over several rebuilds, the step's force over the list and
    over the sweep, from one carry: the same rebuilds (and branches of the
    incremental engine), positions within 1e-4 and forces within the force
    gate (f32 sums in another order)."""
    runs = []
    for sweep in (False, True):
        sim = DenseSimulator(MDConfig(n=N, **HOT), cap=32, device="cpu",
                             incremental=incremental)
        if sweep:
            _sweeping(sim)
        carry = sim.run(sim.build(_system()), 60, chunk=20)
        runs.append((sim, carry))
    (sl, cl), (ss, cs) = runs
    assert int(cl.n_rebuilds) == int(cs.n_rebuilds) >= 4
    if incremental:
        assert sl._taken.tolist() == ss._taken.tolist()
    assert torch.equal(cl.state.pid, cs.state.pid)
    np.testing.assert_allclose(cl.state.pos.numpy(), cs.state.pos.numpy(),
                               atol=1e-4)
    scale = max(float(cs.force.abs().max()), 1.0)
    np.testing.assert_allclose(cl.force.numpy(), cs.force.numpy(),
                               atol=2e-4 * scale)
    _assert_list_is(sl, cl)


def test_every_step_configuration_keeps_the_sweep():
    """Rebuilding every step, a list would serve one step: the step sweeps,
    builds no list and counts no list force."""
    sim = DenseSimulator(MDConfig(n=N, rebuild_every_step=True, **HOT),
                         cap=32, device="cpu")
    carry = sim.build(_system())
    before = trace.counters()
    carry = sim.run(carry, 5, chunk=5)
    assert sim._list is None and not sim._reads_list()
    assert trace.counters()["list_forces"] == before["list_forces"]
    assert trace.counters()["steps"] == before["steps"] + 5


def test_list_forces_counts_every_list_step():
    """``COUNTS["list_forces"]`` rises by the steps run (``run`` and
    ``step_fn``), ``rebuilds`` by the list builds of the steps."""
    sim = DenseSimulator(MDConfig(n=N, **HOT), cap=32, device="cpu")
    carry = sim.build(_system())
    before, start = trace.counters(), int(carry.n_rebuilds)
    carry = sim.run(carry, 25, chunk=10)
    carry = sim.step_fn(carry)
    got = {k: v - before[k] for k, v in trace.counters().items()}
    assert got["list_forces"] == 26 and got["steps"] == 25
    assert got["rebuilds"] == int(carry.n_rebuilds) - start >= 2


def test_redo_builds_the_list_for_the_restored_state():
    """cap too small for the melt (as ``test_torch_dense_lj``): a chunk
    overflows and is redone from its start with a larger cap; the list the
    steps then read is the one of the redone carry's last rebuild, and the
    run follows the sweeping engine's."""
    pos, vel, pid = numpy_system(N, 4)

    def system():
        return convert.system_from_numpy(pos, 3.0 * vel, np.zeros_like(pos),
                                         pid, device="cpu")

    sims = [DenseSimulator(MDConfig(n=N, temperature=1.0), cap=28,
                           device="cpu") for _ in range(2)]
    _sweeping(sims[1])
    carries = [sim.run(sim.build(system()), 120, chunk=40) for sim in sims]
    assert sims[0].cap == sims[1].cap > 28
    assert not bool(carries[0].overflow)
    _assert_list_is(sims[0], carries[0])
    np.testing.assert_allclose(carries[0].state.pos.numpy(),
                               carries[1].state.pos.numpy(), atol=1e-4)


def test_stepping_another_carry_builds_its_list():
    """Two carries on one engine, stepped in turns: each step reads the
    list of its own carry's last rebuild (built again from its ``ref_pos``
    when the other carry was stepped last), so each follows its own
    sweeping twin."""
    sim = DenseSimulator(MDConfig(n=N, **HOT), cap=32, device="cpu")
    ref = _sweeping(DenseSimulator(MDConfig(n=N, **HOT), cap=32,
                                   device="cpu"))
    a, b = sim.build(_system(5)), sim.build(_system(6, heat=1.0))
    ra, rb = ref.build(_system(5)), ref.build(_system(6, heat=1.0))
    for _ in range(3):
        a = sim.run(a, 7, chunk=7)
        b = sim.step_fn(b)
        ra = ref.run(ra, 7, chunk=7)
        rb = ref.step_fn(rb)
    for got, want in ((a, ra), (b, rb)):
        np.testing.assert_allclose(got.state.pos.numpy(),
                                   want.state.pos.numpy(), atol=1e-4)
    _assert_list_is(sim, b)
    b2 = dense_lj._clone(b)
    b2 = sim.step_fn(b2)
    _assert_list_is(sim, b2)


def test_list_overflow_rolls_back_and_grows():
    """A list buffer too small for the pairs raises the carry's overflow
    flag: the chunk is undone and redone with a larger cap (and list)."""
    sim = DenseSimulator(MDConfig(n=N, **HOT), cap=32, device="cpu")
    carry = sim.build(_system())
    lst = sim._list
    sim._list = lst._replace(lanes=lst.lanes[:int(lst.nsparse.sum()) // 2])
    before = trace.counters()
    carry = sim.run(carry, 10, chunk=10)
    assert trace.counters()["redos"] == before["redos"] + 1
    assert sim.cap > 32 and not bool(carry.overflow)
    _assert_list_is(sim, carry)


def test_a_converted_carry_whose_list_overflows_is_redone(monkeypatch):
    """A carry taken across as numpy arrays, stepped by an engine that never
    rebuilt it, gets its list built from its ``ref_pos`` before its first
    step. A list too small for it raises the carry's flag there (``step_fn``
    returns the flag), and ``run`` undoes the chunk and redoes it with a
    larger cap and list, following the sweeping engine. The flag is not
    raised for a carry whose first step rebuilds."""
    src = DenseSimulator(MDConfig(n=N, **HOT), cap=32, device="cpu")
    arrays = convert.carry_to_numpy(src.run(src.build(_system()), 5,
                                            chunk=5))
    real = dense_force.list_capacity
    monkeypatch.setattr(  # 64 entries at cap 32: far fewer than the pairs
        dense_force, "list_capacity",
        lambda spec, n, rs: real(spec, n, rs) if spec.cap > 32 else 64)
    sim = DenseSimulator(MDConfig(n=N, **HOT), cap=32, device="cpu")
    carry = sim.step_fn(convert.carry_from_numpy(*arrays, device="cpu"))
    assert bool(carry.overflow) and sim._list.lanes.numel() == 64
    before = trace.counters()
    carry = sim.run(convert.carry_from_numpy(*arrays, device="cpu"), 10,
                    chunk=10)
    assert trace.counters()["redos"] == before["redos"] + 1
    assert sim.cap > 32 and not bool(carry.overflow)
    _assert_list_is(sim, carry)
    ref = _sweeping(DenseSimulator(MDConfig(n=N, **HOT), cap=32,
                                   device="cpu"))
    want = ref.run(convert.carry_from_numpy(*arrays, device="cpu"), 10,
                   chunk=10)
    (p, _, f), (pw, _, fw) = sim.to_system(carry), ref.to_system(want)
    d = np.abs(p - pw)
    assert np.minimum(d, sim.box.L - d).max() < 1e-4
    np.testing.assert_allclose(f, fw, atol=2e-4 * max(np.abs(fw).max(), 1.0))
    # a carry already past the trigger (its ref_pos no rebuilt state, whose
    # list overflows) rebuilds at its first step: its list is not read, its
    # flag stays down, and the rebuild builds the list it then reads
    far = list(arrays)
    far[4] = np.full_like(far[4], -1e3)  # ref_pos
    monkeypatch.undo()
    sim = DenseSimulator(MDConfig(n=N, **HOT), cap=32, device="cpu")
    carry = sim.step_fn(convert.carry_from_numpy(*far, device="cpu"))
    assert not bool(carry.overflow) and int(carry.n_rebuilds) == far[5] + 1
    _assert_list_is(sim, carry)
