"""The incremental rebuild: the port on the CPU (plain merge and expand)
against the JAX package (Pallas merge and expand in interpret mode, and its
numpy twin) on the same numpy state; the same partition per cell as the full
rebuild; the window-overflow predicate and the engine's fall-back to the full
rebuild; cell overflow; and the engine with the incremental rebuild against
the engine with the full one."""

import functools

import numpy as np
import pytest
import torch

from md_neighbor_list_tpu.ops import dense_ref as jref
from md_neighbor_list_tpu.ops import incremental as jinc
from md_neighbor_list_tpu_torch import DenseSimulator, MDConfig
from md_neighbor_list_tpu_torch.ops import dense_cells as tdc
from md_neighbor_list_tpu_torch.ops import dense_ref as tref
from md_neighbor_list_tpu_torch.ops import incremental as tinc
from md_neighbor_list_tpu_torch.utils import convert
from torch_port_util import jax_state, numpy_system, torch_state

N = 1728  # L = 12, mc = 4


@functools.lru_cache(maxsize=None)
def drifted(cap: int, sigma: float = 0.3, seed: int = 3):
    """(jax state, jax spec, port state, port spec): a binned state whose
    valid slots then drift by ~sigma (far beyond the skin bound, so a good
    share of the particles changes cell); empty slots stay parked."""
    pos, vel, pid = numpy_system(N, seed)
    js, jspec, _ = jax_state(pos, vel, pid, cap)
    ts, tspec, _ = torch_state(pos, vel, pid, cap)
    js, ts = jref.rebuild_reference(js, jspec), tref.rebuild_reference(ts, tspec)
    rng = np.random.default_rng(seed)
    dr = rng.normal(0.0, sigma, ts.pos.shape).astype(np.float32)
    dr = np.where(ts.valid().numpy()[None], dr, np.float32(0.0))
    return (js._replace(pos=js.pos + dr), jspec,
            ts._replace(pos=ts.pos + torch.from_numpy(dr)), tspec)


@functools.lru_cache(maxsize=None)
def jax_incremental(cap: int):
    js, jspec, _, _ = drifted(cap)
    new, inc_of = jinc.rebuild_dense_incremental(js, jspec, True)
    return [np.asarray(a) for a in new], bool(inc_of)


def _cell_sets(pid: np.ndarray, spec):
    rows = pid.reshape(spec.ncells, spec.cap)
    return [frozenset(int(p) for p in row if p >= 0) for row in rows]


def _assert_parked(state, spec):
    empty = ~state.valid()
    park = tdc.park_lattice(spec, "cpu")
    assert torch.equal(state.pos[:, empty], park[:, empty])
    assert float(state.vel[:, empty].abs().sum()) == 0.0


@pytest.mark.parametrize("cap", [32, 40])
def test_rebuild_incremental_matches_jax(cap):
    """pid bitwise on every slot, pos/vel bitwise on valid slots, the same
    window verdict; empty slots on the park lattice with zero velocity (the
    JAX kernel zero-fills them and parks afterwards)."""
    _, _, ts, tspec = drifted(cap)
    (jpos, jvel, jpid), j_of = jax_incremental(cap)
    new, t_of = tinc.rebuild_dense_incremental(ts, tspec)
    assert not j_of and not bool(t_of)
    np.testing.assert_array_equal(new.pid.numpy(), jpid)
    valid = jpid >= 0
    assert int(valid.sum()) == N
    np.testing.assert_array_equal(new.pos.numpy()[:, valid], jpos[:, valid])
    np.testing.assert_array_equal(new.vel.numpy()[:, valid], jvel[:, valid])
    _assert_parked(new, tspec)


@pytest.mark.parametrize("cap", [32, 40])
def test_merge_plain_matches_numpy_twins(cap):
    """``merge_plain`` (through the rebuild on the CPU) against the JAX
    package's numpy twin, and against the port's own twin, which gets the
    same result by one global sort instead of a per-cell merge."""
    js, jspec, ts, tspec = drifted(cap)
    new, _ = tinc.rebuild_dense_incremental(ts, tspec)
    want = jinc.rebuild_reference_incremental(js, jspec)
    wpid = np.asarray(want.pid)
    np.testing.assert_array_equal(new.pid.numpy(), wpid)
    valid = wpid >= 0
    for got, w in ((new.pos, want.pos), (new.vel, want.vel)):
        np.testing.assert_array_equal(got.numpy()[:, valid],
                                      np.asarray(w)[:, valid])
    twin = tinc.rebuild_reference_incremental(ts, tspec)
    for a, b in zip(new, twin):
        assert torch.equal(a, b)


def test_merge_wrapper_takes_plain_version_on_cpu():
    _, _, ts, tspec = drifted(32)
    (state_w, spid, movers), _ = tinc.merge_inputs(ts, tspec)
    a = tinc.merge(state_w, spid, movers, tspec)
    b = tinc.merge_plain(state_w, spid, movers, tspec)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    # the stayers: valid slots keyed to the cell they sit in
    stay = spid >= 0
    assert 0 < int(stay.sum()) < N
    assert torch.equal(spid[stay], ts.pid[stay])
    assert int((movers.pid >= 0).sum()) == N - int(stay.sum())
    own = tinc.own_cell_keys(tspec, "cpu")
    assert own.shape == (tspec.rows, tspec.mc, tspec.cap)
    assert int(own[3, 2, 5]) == 3 * tspec.mc + 2


def test_same_partition_per_cell_as_full_rebuild():
    _, _, ts, tspec = drifted(32)
    inc, inc_of = tinc.rebuild_dense_incremental(ts, tspec)
    full, _ = tdc.rebuild_dense(ts, tspec)
    assert not bool(inc_of)
    assert int(inc.valid().sum()) == N
    assert _cell_sets(inc.pid.numpy(), tspec) == \
        _cell_sets(full.pid.numpy(), tspec)
    # the drift moved a good share of the particles, not all of them
    same_slot = (ts.pid == inc.pid)[ts.valid()].float().mean()
    assert 0.2 < float(same_slot) < 1.0


def _overflow_by_loop(row_start: np.ndarray, g: int, window: int) -> bool:
    """The JAX predicate written out group by group."""
    rows = row_start.shape[0] - 1
    for r0 in range(0, rows, g):
        end = row_start[min(r0 + g, rows)]
        if end - (row_start[r0] // 128) * 128 > window:
            return True
    return False


@pytest.mark.parametrize("rows", [4, 5, 9, 1225])
def test_window_overflow_predicate(rows):
    """Even and odd R (the tail group of one row at R = 1225, mc = 35),
    spans from a 128-aligned start, against the rule written out."""
    rng = np.random.default_rng(rows)
    for trial in range(40):
        step = rng.integers(0, 300 if trial % 2 else 200, rows)
        row_start = np.concatenate([[0], np.cumsum(step)]).astype(np.int32)
        got = bool(tinc.window_overflow(torch.from_numpy(row_start)))
        assert got == _overflow_by_loop(row_start, tinc.MOVER_G,
                                        tinc.MOVER_WINDOW)
    # only the tail group (or the last even group) over the window
    row_start = np.zeros(rows + 1, np.int32)
    row_start[-1] = 513
    assert bool(tinc.window_overflow(torch.from_numpy(row_start)))
    row_start[-1] = 512
    assert not bool(tinc.window_overflow(torch.from_numpy(row_start)))
    # a start just past a 128 boundary widens the span by the offset
    row_start = np.zeros(rows + 1, np.int32)
    row_start[1:] = 130
    row_start[-1] = 130 + 511
    assert bool(tinc.window_overflow(torch.from_numpy(row_start))) == \
        _overflow_by_loop(row_start, tinc.MOVER_G, tinc.MOVER_WINDOW)


def test_window_overflow_flags_and_engine_falls_back():
    """A from_packed seed parks every particle in arbitrary slots, so nearly
    all are movers: at mc = 8 a group of two rows holds about 432 of them,
    over the window's usable span. Both packages flag it; the port's engine
    then takes the full rebuild and keeps all N."""
    n = 13824  # 24^3: L = 24, mc = 8
    pos, vel, pid = numpy_system(n, 21)
    js, jspec, _ = jax_state(pos, vel, pid, 32)
    ts, tspec, _ = torch_state(pos, vel, pid, 32)
    _, j_of = jinc.rebuild_dense_incremental(js, jspec, True)
    new, t_of = tinc.rebuild_dense_incremental(ts, tspec)
    assert bool(j_of) and bool(t_of)
    # the port's expand drops nothing, but the engine does not use it
    assert int(new.valid().sum()) == n

    sim = DenseSimulator(MDConfig(n=n), cap=32, device="cpu",
                         incremental=True)
    carry = sim.build(convert.system_from_numpy(
        pos, vel, np.zeros((n, 3), np.float32), pid, device="cpu"))
    assert (sim.full_fallbacks, sim.incremental_rebuilds) == (1, 0)
    assert int(carry.state.valid().sum()) == n
    full, _ = tdc.rebuild_dense(ts, tspec)
    for a, b in zip(carry.state, full):
        assert torch.equal(a, b)


@pytest.mark.parametrize("trips", [False, True], ids=["drifted", "seed"])
def test_rebuild_writes_the_engines_flags_and_counts(trips):
    """With an engine's ``(window, taken, movers)`` the rebuild writes its
    window predicate there, on top of counts that are not zero, as the
    engine's step takes it: the same state and flag as without them, the
    flags (predicate, not predicate), the branch's count raised by one and
    the movers by the mover stream's length."""
    if trips:
        n = 13824  # a from_packed seed at mc = 8
        pos, vel, pid = numpy_system(n, 21)
        ts, tspec, _ = torch_state(pos, vel, pid, 32)
    else:
        _, _, ts, tspec = drifted(32)
    want, want_of = tinc.rebuild_dense_incremental(ts, tspec)
    counts = (torch.tensor([True, True]), torch.tensor([5, 7]),
              torch.tensor(11))
    new, of = tinc.rebuild_dense_incremental(ts, tspec, counts)
    for a, b in zip(new, want):
        assert torch.equal(a, b)
    assert bool(of) == bool(want_of) == trips
    assert counts[0].tolist() == [trips, not trips]
    assert counts[1].tolist() == ([5, 8] if trips else [6, 7])
    movers = int(tinc.merge_inputs(ts, tspec)[1][-1])
    assert movers > 0 and int(counts[2]) == 11 + movers


def test_cell_overflow_detected_as_lost_particles():
    """Movers into a cell already full are dropped by the merge and show as
    lost particles (the engine then grows cap), in both packages alike."""
    js, jspec, ts, tspec = drifted(32)
    pos = ts.pos.clone()
    valid = ts.valid()
    sel = valid & torch.from_numpy(
        np.random.default_rng(0).random(tuple(valid.shape)) < 0.05)
    pos[:, sel] = 0.5  # all keyed to cell (0, 0, 0)
    ts = ts._replace(pos=pos)
    js = js._replace(pos=pos.numpy())
    new, t_of = tinc.rebuild_dense_incremental(ts, tspec)
    kept = int(new.valid().sum())
    assert not bool(t_of) and kept < N
    assert int(new.valid()[0, 0].sum()) == tspec.cap
    want = jinc.rebuild_reference_incremental(js, jspec)
    np.testing.assert_array_equal(new.pid.numpy(), np.asarray(want.pid))


def test_engine_incremental_against_full():
    """The same trajectory, within f32 summation-order noise, with the
    incremental rebuild as with the full one, over several rebuilds; the
    incremental engine takes the incremental branch after its first build."""
    cfg = MDConfig(n=N, dt=0.002, temperature=0.8)
    sims = [DenseSimulator(cfg, cap=32, device="cpu", incremental=b)
            for b in (False, True)]
    carries = [s.init(torch.Generator().manual_seed(0)) for s in sims]
    for _ in range(3):
        carries = [s.run(c, 40, chunk=40) for s, c in zip(sims, carries)]
        r_full, r_inc = (int(c.n_rebuilds) for c in carries)
        assert abs(r_full - r_inc) <= 1  # f32 noise can move one trigger
    assert sims[1].incremental_rebuilds >= 2
    assert sims[1].full_fallbacks <= 1  # the lattice seed may trip it
    assert sims[0].incremental_rebuilds == sims[0].full_fallbacks == 0
    outs = [s.to_system(c) for s, c in zip(sims, carries)]
    dp = np.abs(outs[0][0] - outs[1][0])
    dp = np.minimum(dp, sims[0].box.L - dp)  # wrap-around distance
    assert dp.max() < 5e-3, dp.max()
    e_full, e_inc = (sum(float(x) for x in s.energies(c))
                     for s, c in zip(sims, carries))
    np.testing.assert_allclose(e_inc, e_full, rtol=1e-4)
    for c in carries:
        _assert_parked(c.state, sims[0].spec)
