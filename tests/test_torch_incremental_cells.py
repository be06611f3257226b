"""``DenseSimulator(incremental=True)`` on the CPU as the benchmark's cells of
the configuration ``c4_inc`` drive it, against the benchmark's plain
reference (``mdbench/reference/``: float64, its own cell list, nothing of the
port): the NVE run's forces and energy, the timed list build's pairs with
every particle in the cell of its position, and the counters
``COUNTS["incremental_rebuilds"]`` and ``["full_fallbacks"]`` equal to the
engine's device counts over a run that also falls back."""

import numpy as np
import torch

from md_neighbor_list_tpu_torch import DenseSimulator, MDConfig
from md_neighbor_list_tpu_torch.models.dense_lj import DenseCarry
from md_neighbor_list_tpu_torch.ops import dense_cells as tdc
from md_neighbor_list_tpu_torch.utils import convert, trace
from mdbench.drivers import nve
from mdbench.reference import cells, lj, pairsets
from torch_port_util import numpy_system

N = 1728  # L = 12, mc = 4
HOT = dict(dt=0.005, temperature=2.0)  # a rebuild every few steps


def _engine(n=N, cap=32, seed=5, **cfg):
    pos, vel, pid = numpy_system(n, seed)
    sim = DenseSimulator(MDConfig(n=n, **cfg), cap=cap, device="cpu",
                         incremental=True)
    carry = sim.build(convert.system_from_numpy(
        pos, 1.4 * vel, np.zeros_like(pos), pid, device="cpu"))
    return sim, carry


def _energy(sim, carry) -> float:
    """KE + PE by the reference, on the carry's particles."""
    (pos, vel), lost = nve.packed(carry.state.pid,
                                  [carry.state.pos, carry.state.vel], N)
    assert lost == 0
    ref = lj.forces(pos, sim.spec.L, sim.config.rc)
    return float(0.5 * torch.sum(vel.to(torch.float64)**2) + ref.pe)


def test_incremental_nve_follows_the_reference():
    """60 hot steps, every rebuild incremental: the forces after the run
    within 2e-3 of the reference's (as the cell's ``force_err``), the energy
    conserved to 1e-3 (its ``energy_drift`` limit), no particle lost."""
    sim, carry = _engine(**HOT)
    e0 = _energy(sim, carry)
    kept = sim.incremental_rebuilds
    carry = sim.run(carry, 60, chunk=20)
    assert sim.incremental_rebuilds - kept >= 3
    (pos, force), lost = nve.packed(carry.state.pid,
                                    [carry.state.pos, carry.force], N)
    assert lost == 0 and not bool(carry.overflow)
    ref = lj.forces(pos, sim.spec.L, sim.config.rc)
    assert nve.force_error(force, ref) < 2e-3
    assert abs(_energy(sim, carry) - e0) / abs(e0) < 1e-3


def test_incremental_list_build_gives_the_reference_pairs_and_cells():
    """``_rebuild_and_lists`` on drifted states of a built carry: the masks
    read as pairs are the reference's pairs within rs of the input (beyond
    the band), the total its count, and every particle sits in the cell of
    its position by the reference's binning; each build keeps the merged
    state."""
    sim, carry = _engine(cap=40)
    spec, rs, L = sim.spec, sim.config.rs, sim.spec.L
    rng = np.random.default_rng(7)
    for sigma in (0.3, 0.4):  # lattice sites lie 0.5 or more from a face
        dr = rng.normal(0.0, sigma, carry.state.pos.shape).astype(np.float32)
        dr = np.where(carry.state.valid().numpy()[None], dr, np.float32(0))
        state = carry.state._replace(pos=carry.state.pos
                                     + torch.from_numpy(dr))
        (want,), _ = nve.packed(state.pid, [state.pos], N)
        kept, movers = sim.incremental_rebuilds, sim.movers
        new, _, masks, total = sim._rebuild_and_lists(state)
        assert sim.incremental_rebuilds == kept + 1
        moved = cells.cell_keys(want, L, rs) != \
            cells.cell_keys(nve.packed(carry.state.pid, [carry.state.pos],
                                       N)[0][0], L, rs)
        assert 0 < int(moved.sum()) == sim.movers - movers
        keys, bad = pairsets.mask_pair_keys(masks, new.pid, spec.mc,
                                            spec.cap, N)
        ref, band = lj.half_pairs(want, L, rs)
        assert pairsets.mismatches(keys, ref, band)[0] + bad == 0
        assert abs(int(total) - ref.numel()) <= band.numel()
        flat = new.pid.reshape(-1).to(torch.int64)
        slots = torch.nonzero(flat >= 0).squeeze(1)
        assert slots.numel() == N
        assert cells.misplaced(slots // spec.cap, want[flat[slots]], L,
                               rs) == 0


def _seeded(sim, n, seed=21):
    """A carry whose state is the ``from_packed`` seed (nearly every particle
    away from its cell: the mover stream trips the window predicate at
    mc = 8) and whose reference positions are far off, so that its first
    step votes for a rebuild."""
    pos, vel, pid = numpy_system(n, seed)
    st = tdc.from_packed(torch.from_numpy(pos), torch.from_numpy(1.4 * vel),
                         torch.from_numpy(pid), sim.spec)
    return DenseCarry(state=st, force=torch.zeros_like(st.pos),
                      ref_pos=torch.full_like(st.pos, -1e3),
                      n_rebuilds=torch.zeros((), dtype=torch.int32),
                      overflow=torch.zeros((), dtype=torch.bool))


def test_fallback_counters_equal_the_engine_counts():
    """At mc = 8, where a state far from its cells trips the window
    predicate: the initial build, 10 hot steps, a timed build, then 4 steps
    from a carry whose first step rebuilds the ``from_packed`` seed. At every
    stage the counters have risen by the engine's own device counts, as the
    engine reads them (each read brings the counters up to date), and the
    seeded step falls back."""
    n = 13824
    names = ("incremental_rebuilds", "full_fallbacks")
    before = dict(trace.counters())

    def same(sim):
        counts = [sim.incremental_rebuilds, sim.full_fallbacks]
        assert [trace.COUNTS[k] - before[k] for k in names] == counts
        return counts

    sim, carry = _engine(n=n, **HOT)  # the lattice seed falls back
    assert same(sim) == [0, 1]
    carry = sim.run(carry, 10, chunk=10)
    sim._rebuild_and_lists(carry.state)
    kept, full = same(sim)
    assert kept >= 2 and full == 1
    sim.run(_seeded(sim, n), 4, chunk=4)
    assert same(sim)[1] == 2
    # the chunk's settle reads them too: no read of the engine's in between
    sim.run(carry, 3, chunk=3)
    assert [trace.COUNTS[k] - before[k] for k in names] == \
        sim._taken.tolist()
