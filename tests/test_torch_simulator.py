"""The port's padded-row engine (``models/lj_nve.py::Simulator``) against the
JAX package's ``Simulator`` on the CPU, from one numpy state handed to both
(``utils/convert.py``), and against the oracle and itself.

Tolerances over 20 steps with rebuilds (dt = 0.002, skin = 0.1: three list
builds each), compared in pid order: positions within 1e-5 (about ten ulp of
L = 12), velocities within 1e-4, forces within 2e-4 of the largest component
(the repo's fp32 force gate; the row and Newton-3 sums run in another order,
so the trajectories part at the ulp level and grow slowly); the rebuild
counts, pids and rows are equal."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from md_neighbor_list_tpu.core.config import MDConfig as JConfig
from md_neighbor_list_tpu.core.system import System as JSystem
from md_neighbor_list_tpu.models.lj_nve import Simulator as JSimulator
from md_neighbor_list_tpu_torch.core.capacity import Capacity
from md_neighbor_list_tpu_torch.core.config import MDConfig
from md_neighbor_list_tpu_torch.models.lj_nve import Simulator
from md_neighbor_list_tpu_torch.ops import oracle
from md_neighbor_list_tpu_torch.utils import convert
from torch_port_util import numpy_system

N = 1728  # L = 12, mc = 4
STEPS = 20
POS_ATOL, VEL_ATOL, FORCE_GATE = 1e-5, 1e-4, 2e-4


def _kw(**over):
    kw = dict(n=N, rho=1.0, dt=0.002, skin=0.1, temperature=1.0)
    kw.update(over)
    return kw


def _by_pid(a, pid):
    out = np.empty_like(a)
    out[pid] = a
    return out


def _within_gate(got, want):
    scale = max(float(np.abs(want).max()), 1.0)
    return float(np.abs(got - want).max()) <= FORCE_GATE * scale


@functools.lru_cache(maxsize=None)
def _state(seed=3):
    return numpy_system(N, seed, jitter=0.05)


def _port_system(seed=3):
    pos, vel, pid = _state(seed)
    return convert.system_from_numpy(pos, vel, np.zeros_like(pos), pid,
                                     device="cpu")


@pytest.mark.parametrize("layout", ["morton", "rowmajor"])
@pytest.mark.parametrize("half", [True, False], ids=["half", "full"])
def test_twenty_steps_match_the_jax_engine(half, layout):
    kw = _kw(half_list=half, layout=layout)
    jsim, tsim = JSimulator(JConfig(**kw)), Simulator(MDConfig(**kw),
                                                      device="cpu")
    pos, vel, pid = _state()
    jc = jsim.build(JSystem(jnp.asarray(pos), jnp.asarray(vel),
                            jnp.zeros((N, 3), jnp.float32), jnp.asarray(pid)))
    start = [np.asarray(a) for a in (*jc.system, *jc.nbr)]
    tc = convert.sim_carry_from_numpy(*start, device="cpu")
    assert all(np.array_equal(a, b)
               for a, b in zip(convert.sim_carry_to_numpy(tc), start))
    # the port's own build of the same state: the same order and rows
    own = tsim.build(_port_system())
    assert torch.equal(own.system.pid, tc.system.pid)
    assert torch.equal(own.nbr.idx, tc.nbr.idx)
    assert _within_gate(own.system.force.numpy(), start[2])

    j = [np.asarray(a) for a in jax.tree_util.tree_leaves(jsim.run(jc, STEPS))]
    t = convert.sim_carry_to_numpy(tsim.run(tc, STEPS))
    assert int(t[9]) == int(j[9]) >= 2  # n_rebuilds, the build included
    np.testing.assert_array_equal(t[3], j[3])  # pid: the same sorted order
    np.testing.assert_array_equal(t[4], j[4])  # the rows
    pj, pt = j[3], t[3]
    np.testing.assert_allclose(_by_pid(t[0], pt), _by_pid(j[0], pj), rtol=0,
                               atol=POS_ATOL)
    np.testing.assert_allclose(_by_pid(t[1], pt), _by_pid(j[1], pj), rtol=0,
                               atol=VEL_ATOL)
    assert _within_gate(_by_pid(t[2], pt), _by_pid(j[2], pj))
    assert not t[8]  # overflow


@pytest.mark.parametrize("half", [True, False], ids=["half", "full"])
def test_build_forces_and_energy_match_the_oracle(half):
    sim = Simulator(MDConfig(**_kw(half_list=half)), device="cpu")
    carry = sim.build(_port_system(seed=7))
    f_o, u_o = oracle.forces_energy(carry.system.pos, sim.box, sim.config.rc)
    assert _within_gate(carry.system.force.numpy(), f_o.numpy())
    _, pe = sim.energies(carry)
    assert abs(float(pe) - float(u_o)) <= 1e-5 * abs(float(u_o))


def test_step_fn_leaves_its_carry_untouched():
    """The rollback restores the carry a chunk started from, so a step must
    not write into it."""
    sim = Simulator(MDConfig(**_kw(rebuild_every_step=True)), device="cpu")
    carry = sim.build(_port_system())
    before = [t.clone() for t in (*carry.system, *carry.nbr)]
    after = sim.step_fn(carry)
    for a, b in zip(before, (*carry.system, *carry.nbr)):
        assert torch.equal(a, b)
    assert int(after.nbr.n_rebuilds) == 2
    assert not torch.equal(after.system.pos, carry.system.pos)


def test_overflow_rolls_back_and_grows():
    """Rows that fit the start exactly overflow within the run (rs = 1.42
    sits next to the lattice's second shell at 1.414, so rows gain a
    neighbour at the second build): the chunk is redone from its first carry
    with grown rows, which then match the oracle; the trajectory is the one
    with ample rows."""
    cfg = MDConfig(**_kw(rc=1.3, skin=0.12))
    ample = Simulator(cfg, device="cpu")
    start = ample.build(_port_system())
    tight = Capacity(neighbors=int(start.nbr.max_count),
                     cell=ample.capacity.cell)
    sim = Simulator(cfg, capacity=tight, device="cpu")
    carry = sim.build(_port_system())
    assert sim.capacity == tight  # the start fits
    carry = sim.run(carry, STEPS, chunk=10)
    assert sim.capacity.neighbors > tight.neighbors  # grew
    assert not bool(carry.nbr.overflow)
    f_o, _ = oracle.forces_energy(carry.system.pos, sim.box, cfg.rc)
    assert _within_gate(carry.system.force.numpy(), f_o.numpy())
    want = ample.run(start, STEPS, chunk=10)
    assert int(carry.nbr.n_rebuilds) == int(want.nbr.n_rebuilds)
    np.testing.assert_allclose(
        _by_pid(carry.system.pos.numpy(), carry.system.pid.numpy()),
        _by_pid(want.system.pos.numpy(), want.system.pid.numpy()),
        rtol=0, atol=POS_ATOL)


def test_tiny_capacity_grows_at_init():
    sim = Simulator(MDConfig(**_kw(neighbor_capacity=8)), device="cpu")
    carry = sim.build(_port_system())
    assert sim.capacity.neighbors > 8 and not bool(carry.nbr.overflow)
    f_o, _ = oracle.forces_energy(carry.system.pos, sim.box, 2.5)
    assert _within_gate(carry.system.force.numpy(), f_o.numpy())


def test_verlet_reuse_matches_rebuild_every_step():
    cfg = MDConfig(**_kw())
    a = Simulator(cfg, device="cpu")
    b = Simulator(dataclasses.replace(cfg, rebuild_every_step=True),
                  device="cpu")
    ca = a.run(a.build(_port_system()), STEPS)
    cb = b.run(b.build(_port_system()), STEPS)
    assert int(cb.nbr.n_rebuilds) == STEPS + 1 > int(ca.nbr.n_rebuilds)
    np.testing.assert_allclose(
        _by_pid(ca.system.pos.numpy(), ca.system.pid.numpy()),
        _by_pid(cb.system.pos.numpy(), cb.system.pid.numpy()), atol=5e-4)


def test_half_and_full_lists_agree():
    h = Simulator(MDConfig(**_kw(half_list=True)), device="cpu")
    f = Simulator(MDConfig(**_kw(half_list=False)), device="cpu")
    ch = h.run(h.build(_port_system()), STEPS)
    cf = f.run(f.build(_port_system()), STEPS)
    np.testing.assert_allclose(
        _by_pid(ch.system.pos.numpy(), ch.system.pid.numpy()),
        _by_pid(cf.system.pos.numpy(), cf.system.pid.numpy()), atol=5e-4)


def test_nve_energy_drift_and_momentum():
    """512 particles (L = 8, mc = 4 at rs = 1.7), 500 steps: |dE/E| under
    1e-4, zero net momentum kept, and the skin reuse engaged."""
    sim = Simulator(MDConfig(n=512, rc=1.5, skin=0.2, dt=0.001,
                             temperature=0.7), device="cpu")
    gen = torch.Generator().manual_seed(11)
    carry = sim.init(gen)
    ke0, pe0 = (float(x) for x in sim.energies(carry))
    p0 = carry.system.vel.sum(dim=0)
    carry = sim.run(carry, 500)
    ke1, pe1 = (float(x) for x in sim.energies(carry))
    e0, e1 = ke0 + pe0, ke1 + pe1
    assert abs(e1 - e0) / abs(e0) < 1e-4, (e0, e1)
    assert float((carry.system.vel.sum(dim=0) - p0).abs().max()) < 5e-2
    assert int(carry.nbr.n_rebuilds) >= 2


def _np_pe_virial(pos, L, rc):
    """fp64 pairwise reference: (shifted PE, virial W) over unordered
    min-image pairs."""
    pos = np.asarray(pos, np.float64)
    d = pos[:, None, :] - pos[None, :, :]
    d -= L * np.round(d / L)
    r2 = (d * d).sum(-1)[np.triu_indices(pos.shape[0], 1)]
    r2 = r2[r2 < rc * rc]
    s6 = (1.0 / r2) ** 3
    s6c = (1.0 / rc**2) ** 3
    pe = (4.0 * (s6 * s6 - s6)).sum() - r2.size * 4.0 * (s6c * s6c - s6c)
    return pe, (24.0 * s6 * (2.0 * s6 - 1.0)).sum()


@pytest.mark.parametrize("half", [True, False], ids=["half", "full"])
def test_thermo_matches_numpy_reference_and_the_jax_engine(half):
    kw = dict(n=N, rc=2.5, half_list=half)
    sim = Simulator(MDConfig(**kw), device="cpu")
    carry = sim.build(_port_system(seed=2))
    pe_ref, w_ref = _np_pe_virial(carry.system.pos.numpy(), sim.box.L, 2.5)
    ke, pe, w = (float(x) for x in sim.thermo(carry))
    assert abs(pe - pe_ref) <= 5e-5 * abs(pe_ref)
    assert abs(w - w_ref) <= 5e-5 * max(abs(w_ref), 1.0)
    p = sim.pressure(carry)
    assert abs(p - (2.0 * ke + w) / (3.0 * sim.box.L**3)) <= 1e-6 * abs(p)
    jsim = JSimulator(JConfig(**kw))
    pos, vel, pid = _state(2)
    jc = jsim.build(JSystem(jnp.asarray(pos), jnp.asarray(vel),
                            jnp.zeros((N, 3), jnp.float32), jnp.asarray(pid)))
    jke, jpe, jw = (float(x) for x in jsim.thermo(jc))
    assert abs(ke - jke) <= 1e-6 * jke and abs(pe - jpe) <= 1e-5 * abs(jpe)
    assert abs(w - jw) <= 1e-5 * abs(jw)
    assert abs(p - jsim.pressure(jc)) <= 1e-5 * abs(p)


def test_rebuild_only_and_random_start():
    sim = Simulator(MDConfig(**_kw()), device="cpu")
    system = _port_system()
    built = sim.rebuild_only(system)
    carry = sim.build(system)
    assert int(built.nbr.n_rebuilds) == 1
    assert torch.equal(built.nbr.idx, carry.nbr.idx)
    assert torch.equal(built.system.pid, carry.system.pid)
    with pytest.raises(ValueError, match="generator"):
        sim.init(lattice=False)
    carry = Simulator(MDConfig(n=2000), device="cpu").init(
        torch.Generator().manual_seed(0), lattice=False)
    assert carry.system.pos.shape == (2000, 3)


def test_pallas_backend_raises():
    with pytest.raises(ValueError, match="dense engine"):
        Simulator(MDConfig(n=N, backend="pallas"), device="cpu")


def test_energy_trace_matches_the_dense_engine():
    """The two engines of the port from one lattice start: the same total
    energy every 10 steps, through the start's transient, where |E - E0|
    passes 1e-4 of E0 in both within 40 steps."""
    from md_neighbor_list_tpu_torch.models.dense_lj import DenseSimulator

    cfg = MDConfig(n=N)
    traces = []
    for sim in (Simulator(cfg, device="cpu"),
                DenseSimulator(cfg, device="cpu")):
        carry = sim.init(torch.Generator().manual_seed(0))
        trace = []
        for _ in range(4):
            trace.append(sum(float(x) for x in sim.energies(carry)))
            carry = sim.run(carry, 10)
        traces.append(trace + [sum(float(x) for x in sim.energies(carry))])
    xla, dense = np.array(traces)
    np.testing.assert_allclose(xla, dense, rtol=2e-6)
    assert np.abs(xla - xla[0]).max() > 1e-6 * abs(xla[0])  # it moves
