"""The XLA slab engine end to end: the port's ``SlabSimulator`` on the CPU,
its P ranks threads of one process (``parallel.mesh.LocalRing``), against the
port's own ``Simulator`` (the six tests of ``tests/test_slab.py`` with its
configuration and gates) and against the JAX package's ``SlabSimulator`` on
conftest's 8 virtual CPU devices, from one numpy start: after the build the
slot state, ghost sets, send lists and rows are JAX's bit for bit at P = 2, 4
and 8, also with particles on and one ulp either side of every slab face and
face band."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from md_neighbor_list_tpu.core.config import MDConfig as JConfig
from md_neighbor_list_tpu.core.system import System as JSystem
from md_neighbor_list_tpu.parallel.slab import SlabSimulator as JSlab
from md_neighbor_list_tpu_torch import MDConfig, Simulator
from md_neighbor_list_tpu_torch.parallel.mesh import run_ranks
from md_neighbor_list_tpu_torch.parallel.slab import SlabSimulator
from md_neighbor_list_tpu_torch.utils import convert
from torch_port_util import numpy_system

# tests/test_slab.py's configuration: rc = 1.5 keeps slabs wider than rs on
# a CPU-sized box (L = 16; P = 8 gives w = 2 > rs = 1.7)
CFG = dict(n=4096, rho=1.0, rc=1.5, skin=0.2, dt=0.001, temperature=0.8)
STATE_FIELDS = ("pid", "pos", "vel", "ghost_pid", "ghost_pos", "send_idx",
                "idx")


def _dd_cfg(**kw):
    base = dict(CFG, mesh_devices=8, half_list=False)
    base.update(kw)
    return MDConfig(**base)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _on_ranks(cfg, fn, **kw):
    """``fn(sim)`` on each rank of a ``LocalRing`` of ``cfg.mesh_devices``
    CPU ranks, in rank order."""
    return run_ranks(cfg.mesh_devices, lambda ring: fn(SlabSimulator(
        cfg, device="cpu", ring=ring, **kw)))


def _wrapped_gap(a, b, L):
    d = np.abs(a - b)
    return np.minimum(d, L - d).max()


# ------------------------------------------- tests/test_slab.py, mirrored
def test_requires_wide_slabs():
    with pytest.raises(ValueError, match="slab width"):
        SlabSimulator(MDConfig(n=8192, rc=2.5, skin=0.3, mesh_devices=8))


def test_dd_initial_forces_match_single_chip():
    sys_dd = _on_ranks(_dd_cfg(), lambda dd: dd.gather(dd.init(_gen(0))))[0]
    single = Simulator(MDConfig(**CFG, half_list=False), device="cpu")
    carry = single.init(_gen(0))
    f_single = np.empty((CFG["n"], 3), np.float32)
    f_single[carry.system.pid.numpy()] = carry.system.force.numpy()
    scale = max(np.abs(f_single).max(), 1.0)
    np.testing.assert_allclose(sys_dd.force.numpy(), f_single,
                               atol=1e-4 * scale)


def test_dd_trajectory_matches_single_chip():
    """P = 8 slab run == the one-rank engine (the distributed parity gate)."""
    steps = 50

    def fn(dd):
        sd = dd.run(dd.init(_gen(1)), steps)
        return dd.gather(sd), int(sd.n_rebuilds)

    sys_dd, rebuilds = _on_ranks(_dd_cfg(), fn)[0]
    single = Simulator(MDConfig(**CFG, half_list=False), device="cpu")
    cs = single.run(single.init(_gen(1)), steps)
    p_s = np.empty((CFG["n"], 3), np.float32)
    p_s[cs.system.pid.numpy()] = cs.system.pos.numpy()
    np.testing.assert_allclose(sys_dd.pos.numpy(), p_s, atol=5e-4)
    assert rebuilds >= 1


def test_dd_particle_conservation_and_migration():
    """Run long enough that particles cross slab boundaries; gather()
    raises if any is lost or duplicated."""
    def fn(dd):
        state = dd.run(dd.init(_gen(2)), 150)
        dd.gather(state)  # internal check: count == N
        return state.pid.numpy(), int(state.n_rebuilds)

    out = _on_ranks(_dd_cfg(temperature=1.2), fn)
    pid = np.concatenate([p for p, _ in out])
    pid = pid[pid >= 0]
    assert len(pid) == CFG["n"]
    # rebuilds happened on every rank in lockstep (global vote)
    rebuilds = np.array([r for _, r in out])
    assert (rebuilds == rebuilds[0]).all() and rebuilds[0] >= 2
    assert len(np.unique(pid)) == CFG["n"]  # pids unique


def test_dd_energy_conservation():
    def fn(dd):
        state = dd.init(_gen(3))
        e0 = sum(float(x) for x in dd.energies(state))
        state = dd.run(state, 300)
        return e0, sum(float(x) for x in dd.energies(state))

    for e0, e1 in _on_ranks(_dd_cfg(temperature=0.7), fn):
        assert abs(e1 - e0) / abs(e0) < 1e-4, (e0, e1)


def test_dd_momentum_conservation():
    sys_dd = _on_ranks(_dd_cfg(), lambda dd: dd.gather(
        dd.run(dd.init(_gen(4)), 100)))[0]
    p = sys_dd.vel.numpy().sum(axis=0)
    assert np.abs(p).max() < 5e-2


# ------------------------------------------- against the JAX SlabSimulator
def _face_start(seed=0):
    """A jittered lattice with its layer of x-sites moved up to 0.05 below
    the slab faces of P = 2, 4 and 8 (L = 16: faces at multiples of 2), hot:
    particles cross faces within the first rebuilds."""
    n = CFG["n"]
    pos, _, _ = numpy_system(n, seed, jitter=0.03)
    pos[:, 0] = (pos[:, 0] + 0.45) % np.float32(16.0)
    vel = np.random.default_rng(seed).standard_normal((n, 3)) * np.sqrt(1.2)
    vel -= vel.mean(axis=0)
    return pos.astype(np.float32), vel.astype(np.float32)


def _jax_state(cfg_kw, pos, vel):
    """The JAX engine and its state after ``build`` from numpy arrays."""
    n = pos.shape[0]
    jdd = JSlab(JConfig(**cfg_kw))
    jstate = jdd.build(JSystem(jnp.asarray(pos), jnp.asarray(vel),
                               jnp.zeros((n, 3), jnp.float32),
                               jnp.arange(n, dtype=jnp.int32)))
    return jdd, jstate


def _system(pos, vel):
    n = pos.shape[0]
    return convert.system_from_numpy(pos, vel, np.zeros((n, 3), np.float32),
                                     np.arange(n, dtype=np.int32),
                                     device="cpu")


def _assert_build_equal(states, jstate):
    """Each rank's state after build: the slot fields bitwise JAX's slice,
    forces within 2e-4 of the largest."""
    arrays = {f: np.asarray(getattr(jstate, f)) for f in jstate._fields}
    for r, st in enumerate(states):
        for name in STATE_FIELDS:
            np.testing.assert_array_equal(
                getattr(st, name).numpy(), arrays[name][r],
                err_msg=f"rank {r}: {name}")
        scale = max(np.abs(arrays["force"]).max(), 1.0)
        np.testing.assert_allclose(st.force.numpy(), arrays["force"][r],
                                   atol=2e-4 * scale)
        assert int(st.n_rebuilds) == int(arrays["n_rebuilds"][r]) == 1


@pytest.mark.parametrize("p", [2, 4, 8])
def test_build_bitwise_and_50_steps_match_jax(p):
    steps = 50
    pos, vel = _face_start()
    cfg_kw = dict(CFG, mesh_devices=p, half_list=False)
    jdd, jstate = _jax_state(cfg_kw, pos, vel)
    jlast = jdd.run(jstate, steps)

    def fn(dd):
        first = dd.build(_system(pos, vel))
        last = dd.run(first, steps)
        return first, last, dd.gather(last)

    out = _on_ranks(MDConfig(**cfg_kw), fn)
    _assert_build_equal([o[0] for o in out], jstate)

    L = jdd.box.L
    gathered = out[0][2]
    assert _wrapped_gap(gathered.pos.numpy(), np.asarray(jdd.gather(
        jlast).pos), L) < 5e-4
    rebuilds = {int(o[1].n_rebuilds) for o in out}
    assert rebuilds == {int(np.asarray(jlast.n_rebuilds)[0])}
    assert min(rebuilds) >= 2  # the build and >= 1 in the run
    # particles re-homed: some pid is held by another rank than at the build
    home0, home1 = (np.full(CFG["n"], -1), np.full(CFG["n"], -1))
    for r, (first, last, _) in enumerate(out):
        for home, st in ((home0, first), (home1, last)):
            pid = st.pid.numpy()
            home[pid[pid >= 0]] = r
    assert (home0 >= 0).all() and (home1 >= 0).all()
    assert (home0 != home1).sum() >= 1


# n = 3500 (L = 15.18): at P = 2, 4 and 8 some values x within 3 ulps of a
# face give floor(x / w) != floor(x * f32(1 / w)), the JAX host's division
# against the product XLA makes of the engine's division (found by search)
FACE_N = 3500


def _ulps(x, k):
    """f32 values from k ulps below x to k ulps above."""
    x = np.float32(x)
    lo = x
    for _ in range(k):
        lo = np.nextafter(lo, np.float32(-np.inf))
    out = [lo]
    for _ in range(2 * k):
        out.append(np.nextafter(out[-1], np.float32(np.inf)))
    return out


@pytest.mark.parametrize("p", [2, 4, 8])
def test_faces_and_face_bands_bitwise_jax(p):
    """Particles on every slab face, on every rank's lo + rs and hi - rs
    bands, and up to 3 ulps either side: the slab each lands in (through the
    host's scatter and the build's migration), the emigrants and the ghost
    send lists are JAX's bit for bit."""
    cfg = MDConfig(**dict(CFG, n=FACE_N, mesh_devices=p, half_list=False))
    L = np.float32(cfg.n ** (1.0 / 3.0))
    w = np.float32(float(cfg.n ** (1.0 / 3.0)) / p)
    rs = np.float32(cfg.rs)
    xs = []
    for k in range(p + 1):
        xs += _ulps(np.float32(k) * w, 3)
    for r in range(p):
        lo = np.float32(r) * w
        xs += _ulps(lo + rs, 3) + _ulps((lo + w) - rs, 3)
    xs = np.array([x for x in xs if 0 <= x < L], np.float32)
    pos, vel, _ = numpy_system(cfg.n, seed=5)
    movers = np.random.default_rng(5).choice(cfg.n, len(xs), replace=False)
    pos[movers, 0] = xs
    # the host's division and the engine's product disagree on some: they
    # are emigrants of the build's first migration
    host = np.clip((pos[:, 0] / np.float32(w)).astype(np.int64), 0, p - 1)
    engine = np.clip(np.floor(pos[:, 0] * (np.float32(1) / w)).astype(
        np.int64), 0, p - 1)
    assert (host != engine).sum() >= 1

    _, jstate = _jax_state(dict(CFG, n=FACE_N, mesh_devices=p,
                                half_list=False), pos, vel)
    states = _on_ranks(cfg, lambda dd: dd.build(_system(pos, vel)))
    _assert_build_equal(states, jstate)
    for r, st in enumerate(states):
        pid = st.pid.numpy()
        assert (engine[pid[pid >= 0]] == r).all()
