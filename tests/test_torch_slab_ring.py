"""The XLA slab engine's ring and host loop on the CPU: ``LocalRing`` (P ranks
as threads of one process) against ``Ring`` over two gloo processes
(``tests/torch_slab_ranks.py``), a failing rank, capacity growth with its
rollback, and the ``DDState`` carried across from the JAX package."""

import dataclasses
import functools
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from md_neighbor_list_tpu.core.config import MDConfig as JConfig
from md_neighbor_list_tpu.core.system import System as JSystem
from md_neighbor_list_tpu.parallel.slab import SlabSimulator as JSlab
from md_neighbor_list_tpu_torch import MDConfig
from md_neighbor_list_tpu_torch.parallel.mesh import LocalRing, run_ranks
from md_neighbor_list_tpu_torch.parallel.slab import (DDCapacity, DDState,
                                                      SlabSimulator)
from md_neighbor_list_tpu_torch.utils import convert
from torch_port_util import numpy_system
from torch_slab_ranks import ring_ops, slab_states, spawn_ranks

CFG = dict(n=4096, rho=1.0, rc=1.5, skin=0.2, dt=0.001, temperature=0.8)


def _start(seed=0):
    """A jittered lattice (L = 16) moved up in x so that a layer of sites sits
    0.05 below every slab face of P = 2 and 4, and hot: particles cross
    faces at the first rebuilds."""
    n = CFG["n"]
    pos, _, _ = numpy_system(n, seed, jitter=0.03)
    pos[:, 0] = (pos[:, 0] + 0.45) % np.float32(16.0)
    vel = np.random.default_rng(seed).standard_normal((n, 3)) * np.sqrt(1.2)
    vel -= vel.mean(axis=0)
    return pos.astype(np.float32), vel.astype(np.float32)


def _system(pos, vel):
    n = pos.shape[0]
    return convert.system_from_numpy(pos, vel, np.zeros((n, 3), np.float32),
                                     np.arange(n, dtype=np.int32),
                                     device="cpu")


# --------------------------------------------------- LocalRing against gloo
def test_local_ring_ops_equal_the_gloo_ring(tmp_path):
    """Shifts (sync and async), sums, maxima and gathers of f32 and i32
    tensors: two threads give two gloo processes' bits."""
    gloo = spawn_ranks(tmp_path, 2, dict(engine="ring"))
    local = run_ranks(2, ring_ops)
    for r in range(2):
        assert set(local[r]) == set(gloo[r])
        for name, t in local[r].items():
            assert t.dtype == torch.from_numpy(gloo[r][name]).dtype, name
            np.testing.assert_array_equal(t.numpy(), gloo[r][name],
                                          err_msg=f"rank {r}: {name}")


def test_local_ring_shift_hands_over_a_copy():
    def fn(ring):
        t = torch.full((3,), float(ring.rank))
        got = ring.shift_plus(t)
        t += 10.0  # the sender's update must not reach the receiver
        ring.sum(torch.zeros(()))  # every rank has updated its tensor
        return got

    assert [g.tolist() for g in run_ranks(2, fn)] == [[1.0] * 3, [0.0] * 3]


def test_local_ring_stress_many_ranks_short_switch_interval():
    """More ranks than cores, the interpreter switching threads every
    microsecond, many exchanges back to back: every shift delivers the left
    neighbour's value of the same round, every sum the round's total (a slot
    set overwritten before it was read would break both)."""
    p, rounds = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def fn(ring):
            got = []  # exchanges back to back, checked afterwards
            for k in range(rounds):
                t = torch.tensor([float(1000 * k + ring.rank)])
                got.append((ring.shift_plus(t), ring.sum(t)))
            return sum(
                int(g.item() != 1000 * k + (ring.rank - 1) % p)
                + int(s.item() != 1000 * k * p + p * (p - 1) // 2)
                for k, (g, s) in enumerate(got))

        t0 = time.perf_counter()
        assert run_ranks(p, fn, timeout=60.0) == [0] * p
        assert time.perf_counter() - t0 < 60.0
    finally:
        sys.setswitchinterval(old)


def test_slab_engine_p2_gloo_equals_local_ring_bitwise(tmp_path):
    """P = 2 as two gloo processes and as two threads: every field of each
    rank's state after the build and after 20 steps (dt = 0.004: a rebuild
    among them), bit for bit."""
    pos, vel = _start(1)
    np.savez(tmp_path / "system.npz", pos=pos, vel=vel)
    job = dict(engine="slab", config=dict(CFG, dt=0.004), steps=20,
               system=str(tmp_path / "system.npz"))
    gloo = spawn_ranks(tmp_path, 2, job)
    local = run_ranks(2, lambda ring: slab_states(ring, job))
    for r in range(2):
        assert set(local[r]) == set(gloo[r])
        for name, t in local[r].items():
            np.testing.assert_array_equal(t.numpy(), gloo[r][name],
                                          err_msg=f"rank {r}: {name}")
    assert int(gloo[0]["last_n_rebuilds"]) >= 2


def test_a_failing_rank_raises_on_every_rank():
    """One rank raises before its first exchange: the others, waiting in a
    shift, raise at once (the ring is aborted), and the caller gets the
    first rank's exception. A rank that never comes breaks the barrier
    after its timeout."""
    raised = []

    def fn(ring):
        try:
            if ring.rank == 2:
                raise ValueError("rank 2 fails")
            ring.shift_plus(torch.zeros(3))
            ring.sum(torch.zeros(()))
        except BaseException as e:
            raised.append((ring.rank, type(e).__name__))
            raise

    t0 = time.perf_counter()
    with pytest.raises(ValueError, match="rank 2 fails"):
        run_ranks(4, fn, timeout=60.0)
    assert time.perf_counter() - t0 < 30.0  # aborted, not timed out
    assert sorted(raised) == [(0, "BrokenBarrierError"),
                              (1, "BrokenBarrierError"),
                              (2, "ValueError"), (3, "BrokenBarrierError")]

    def absent(ring):
        if ring.rank != 1:
            ring.max(torch.ones(()))

    t0 = time.perf_counter()
    with pytest.raises(threading.BrokenBarrierError):
        run_ranks(3, absent, timeout=0.5)
    assert time.perf_counter() - t0 < 30.0
    with pytest.raises(ValueError, match="ranks"):
        SlabSimulator(MDConfig(**CFG, mesh_devices=4), device="cpu",
                      ring=LocalRing.ring_of(2)[0])


# ---------------------------------------------------------- capacity growth
P_GROW, STEPS_GROW = 4, 50


def _grow_run(capacity):
    """P = 4 from ``_start``, 50 steps in one chunk: each rank's pid set,
    capacity and the gathered positions."""
    pos, vel = _start(2)
    cfg = MDConfig(**CFG, mesh_devices=P_GROW, half_list=False)

    def fn(ring):
        sim = SlabSimulator(cfg, capacity=capacity, device="cpu", ring=ring)
        st = sim.run(sim.build(_system(pos, vel)), STEPS_GROW,
                     chunk=STEPS_GROW)
        pid = st.pid.numpy()
        return set(pid[pid >= 0].tolist()), sim.capacity, sim.gather(st).pos

    return run_ranks(P_GROW, fn)


@functools.lru_cache(maxsize=None)
def _default_run():
    return _grow_run(None)


# each too small: local holds the start's 1,024 particles a slab but not a
# rebuild's immigrants; one emigrant a direction; half the face band; K and
# the cell depth below the lattice's needs
SMALL = {"local": 1024, "mig": 1, "ghost": 256, "neighbors": 16, "cell": 2}


@pytest.mark.parametrize("field", list(SMALL))
def test_too_small_capacity_grows_on_every_rank(field):
    default = _default_run()
    cap0 = default[0][1]
    small = DDCapacity(**{**{f: getattr(cap0, f) for f in SMALL},
                          field: SMALL[field]})
    grown = _grow_run(small)
    caps = {c for _, c, _ in grown}
    assert len(caps) == 1  # every rank grew alike
    cap = caps.pop()
    assert getattr(cap, field) > SMALL[field] and cap != small
    for (pids, _, pos), (want, _, want_pos) in zip(grown, default):
        assert pids == want
        np.testing.assert_allclose(pos.numpy(), want_pos.numpy(), atol=5e-4)


@pytest.mark.parametrize("field", ["local", "mig"])
def test_rollback_of_a_later_chunk_grows_on_every_rank(field):
    """The same run in chunks of 10 steps with one capacity too small for a
    rebuild's immigrants: a chunk that overflows is rolled back to the clone
    taken before it and redone with every rank's capacity grown alike; every
    particle is held by one rank, the gathered positions end where the
    default one-chunk run's do (the rebuild at the rollback moves the later
    rebuilds, and with them which rank holds a particle near a face), and
    the state ``run`` was given stays as it was."""
    default = _default_run()
    cap0 = default[0][1]
    small = dataclasses.replace(cap0, **{field: SMALL[field]})
    pos, vel = _start(2)
    cfg = MDConfig(**CFG, mesh_devices=P_GROW, half_list=False)

    def fn(ring):
        sim = SlabSimulator(cfg, capacity=small, device="cpu", ring=ring)
        start = sim.build(_system(pos, vel))
        built = sim.capacity
        given = [t.clone() for t in start]
        st = sim.run(start, STEPS_GROW, chunk=10)
        assert all(torch.equal(a, b) for a, b in zip(given, start))
        pid = st.pid.numpy()
        return (set(pid[pid >= 0].tolist()), built, sim.capacity,
                sim.gather(st).pos)

    out = run_ranks(P_GROW, fn)
    caps = {c for _, _, c, _ in out}
    assert len(caps) == 1
    cap = caps.pop()
    assert getattr(cap, field) > getattr(out[0][1], field)  # grown in the run
    held = [pid for pids, _, _, _ in out for pid in pids]
    assert sorted(held) == list(range(CFG["n"]))
    for (_, _, _, pos1), (_, _, want_pos) in zip(out, default):
        np.testing.assert_allclose(pos1.numpy(), want_pos.numpy(), atol=5e-4)


# ------------------------------------------------- state across the packages
def _jax_p2(seed):
    pos, vel = _start(seed)
    n = CFG["n"]
    jdd = JSlab(JConfig(**CFG, mesh_devices=2, half_list=False))
    jstate = jdd.build(JSystem(jnp.asarray(pos), jnp.asarray(vel),
                               jnp.zeros((n, 3), jnp.float32),
                               jnp.arange(n, dtype=jnp.int32)))
    return jdd, jstate


def test_dd_states_round_trip_bitwise():
    jdd, jstate = _jax_p2(3)
    arrays = tuple(np.asarray(a) for a in jstate)
    states = convert.dd_states_from_numpy(*arrays, device="cpu")
    assert len(states) == 2 and all(isinstance(s, DDState) for s in states)
    assert tuple(states[0].idx.shape) == arrays[7].shape[1:]
    back = convert.dd_states_to_numpy(states)
    for got, want in zip(back, arrays):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        convert.dd_states_from_numpy(*arrays[:-1], device="cpu")


def test_jax_state_continued_by_the_port():
    """A JAX-built P = 2 state crosses to the port's two ranks; 20 steps
    there match 20 steps of the JAX engine within 5e-4."""
    steps = 20
    jdd, jstate = _jax_p2(4)
    states = convert.dd_states_from_numpy(
        *(np.asarray(a) for a in jstate), device="cpu")
    cap = DDCapacity(**{f: getattr(jdd.capacity, f) for f in
                        ("local", "ghost", "mig", "neighbors", "cell")})
    cfg = MDConfig(**CFG, mesh_devices=2, half_list=False)

    def fn(ring):
        sim = SlabSimulator(cfg, capacity=cap, device="cpu", ring=ring)
        st = sim.run(states[ring.rank], steps)
        return sim.gather(st), int(st.n_rebuilds)

    (got, rebuilds), _ = run_ranks(2, fn)
    jlast = jdd.run(jstate, steps)
    want = np.asarray(jdd.gather(jlast).pos)
    d = np.abs(got.pos.numpy() - want)
    assert np.minimum(d, jdd.box.L - d).max() < 5e-4
    assert rebuilds == int(np.asarray(jlast.n_rebuilds)[0])
