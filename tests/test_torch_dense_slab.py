"""The slab domain decomposition end to end: the port's ``DenseSlabSimulator``
on the CPU (plain versions) against the port's own cube engine at P = 1 and
against the JAX package's ``DenseSlabSimulator`` (Pallas interpret mode, on
conftest's 8-device CPU mesh) at P = 2, whose ranks here are two processes on
a gloo group (``tests/torch_slab_ranks.py``, a ``FileStore`` under the test's
temporary directory)."""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from md_neighbor_list_tpu.core.config import MDConfig as JConfig
from md_neighbor_list_tpu.core.system import init_lattice as j_init_lattice
from md_neighbor_list_tpu.parallel.dense_slab import \
    DenseSlabSimulator as JSlab
from md_neighbor_list_tpu_torch import DenseSimulator, MDConfig
from md_neighbor_list_tpu_torch.core.box import Box
from md_neighbor_list_tpu_torch.ops import dense_force, oracle
from md_neighbor_list_tpu_torch.parallel.dense_slab import DenseSlabSimulator
from md_neighbor_list_tpu_torch.parallel.mesh import LocalRing, Ring, run_ranks
from md_neighbor_list_tpu_torch.utils import convert
from torch_slab_ranks import dense_slab_run, spawn_ranks

# tests/test_dense_slab.py's configuration: L = 16, mc = 9; at P = 2
# mc_z = 8, nz = 4 (anisotropic cells)
CFG = dict(n=4096, rho=1.0, rc=1.5, skin=0.2, dt=0.001, temperature=0.8)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _wrapped_gap(a, b, L):
    d = np.abs(a - b)
    return np.minimum(d, L - d).max()


# ------------------------------------------------------------------ P = 1
def test_p1_self_halo_matches_cube_engine():
    """P = 1 self-halo mode (no process group): the whole distributed
    program on one rank reproduces the port's cube engine."""
    steps = 20
    dd = DenseSlabSimulator(MDConfig(**CFG), cap=16, device="cpu")
    sd = dd.run(dd.init(_gen(4)), steps, chunk=20)
    system = dd.gather(sd)
    _, total = dd.lists(sd)
    assert total == int(oracle.pair_count(system.pos, dd.box,
                                          dd.config.rs))
    cube = DenseSimulator(MDConfig(**CFG), cap=16, device="cpu")
    cc = cube.run(cube.init(_gen(4)), steps, chunk=20)
    pos, _, _ = cube.to_system(cc)
    assert _wrapped_gap(system.pos.numpy(), pos, dd.box.L) < 2e-4
    assert int(sd.n_rebuilds) == int(cc.n_rebuilds) >= 1
    assert int(sd.n_migrated) == 0  # nowhere to migrate
    assert not bool(sd.overflow)


def test_p1_state_and_lists_equal_the_cube_bitwise():
    """At P = 1 the slab geometry is the cube's (mc_z = mc) and the slab
    keys are the cube's shifted by mc^2: the same stable sort gives the
    same slots, and the seam-shifted ghost gives the cube's counts and
    masks."""
    dd = DenseSlabSimulator(MDConfig(**CFG), cap=16, device="cpu")
    sd = dd.init(_gen(5))
    cube = DenseSimulator(MDConfig(**CFG), cap=16, device="cpu")
    cc = cube.init(_gen(5))
    for got, want in ((sd.pos, cc.state.pos), (sd.vel, cc.state.vel),
                      (sd.pid, cc.state.pid)):
        assert torch.equal(got, want)
    assert torch.equal(sd.gpid, sd.pid[:dd.spec.mc])
    counts, _ = dd.lists(sd)
    want, _ = dense_force.dense_lists_half(cc.state.pos, cube.spec,
                                           cube.config.rs)
    assert torch.equal(counts, want)
    scale = max(float(cc.force.abs().max()), 1.0)
    assert float((sd.force - cc.force).abs().max()) <= 1e-5 * scale
    for got, want in zip(dd.energies(sd), cube.energies(cc)):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_build_grows_cap_and_keeps_every_particle():
    dd = DenseSlabSimulator(MDConfig(**CFG), cap=4, device="cpu")
    sd = dd.init(_gen(6))  # lattice cells hold up to 8
    assert dd.cap > 4 and dd.spec.cap == dd.cap
    assert int((sd.pid >= 0).sum()) == CFG["n"]
    sd = dd.run(sd, 5, chunk=5)
    system = dd.gather(sd)
    _, total = dd.lists(sd)
    assert total == int(oracle.pair_count(system.pos, dd.box, dd.config.rs))


def test_ring_without_a_group_is_the_identity():
    ring = Ring()
    t = torch.arange(6.0).reshape(2, 3)
    assert (ring.rank, ring.size) == (0, 1)
    assert ring.shift_plus(t) is t and ring.shift_minus(t) is t
    assert ring.shift_minus(t, async_op=True).wait() is t
    assert ring.sum(t) is t and ring.max(t) is t
    assert tuple(ring.gather(t).shape) == (1, 2, 3)


def test_slab_simulator_checks_its_ring_and_device():
    with pytest.raises(ValueError):
        DenseSlabSimulator(MDConfig(**CFG, mesh_devices=2), device="cpu")
    with pytest.raises(ValueError):
        DenseSlabSimulator(MDConfig(**CFG, mesh_devices=0), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            DenseSlabSimulator(MDConfig(**CFG))


# ------------------------------------------------- P = 2 on a gloo group
def _jax_p2(key, steps):
    """JAX P = 2 from its lattice start: the numpy system, the gathered
    initial system, the global pair count, the gathered system after
    ``steps``."""
    n = CFG["n"]
    system, _ = j_init_lattice(n, CFG["rho"], key, CFG["temperature"])
    dd = JSlab(JConfig(**CFG, mesh_devices=2), cap=16)
    state = dd.build(system)
    first = dd.gather(state)
    _, total = dd.lists(state)
    last = dd.gather(dd.run(state, steps, chunk=steps))
    return (np.asarray(system.pos), np.asarray(system.vel)), first, total, \
        last, dd.box.L


def test_p2_gloo_matches_jax_p2(tmp_path):
    """Initial forces within 2e-4 of the largest, the exact global pair
    count equal to JAX's and to the oracle's, and the 20-step trajectory
    within 5e-4 of JAX's."""
    steps = 20
    (pos, vel), first, total, last, L = _jax_p2(jax.random.PRNGKey(3), steps)
    np.savez(tmp_path / "system.npz", pos=pos, vel=vel)
    job = dict(config=CFG, cap=16, steps=steps, chunk=steps,
               system=str(tmp_path / "system.npz"))
    ranks = spawn_ranks(tmp_path, 2, job)
    out = ranks[0]
    for other in ranks[1:]:  # every rank gathers the same global state
        np.testing.assert_array_equal(other["pos1"], out["pos1"])
        assert int(other["pairs0"]) == int(out["pairs0"])

    f_j = np.asarray(first.force)
    scale = max(np.abs(f_j).max(), 1.0)
    np.testing.assert_allclose(out["force0"], f_j, atol=2e-4 * scale)
    want = int(oracle.pair_count(torch.from_numpy(out["pos0"]),
                                 Box(L=float(L)), MDConfig(**CFG).rs))
    assert int(out["pairs0"]) == total == want
    assert _wrapped_gap(out["pos1"], np.asarray(last.pos), L) < 5e-4
    assert not out["overflow"]
    assert int(out["mc"]) == 9 and int(out["nz"]) == 4


def _migration_job(tmp_path) -> dict:
    """Hot, with the lattice moved up in z so that a layer sits 0.05 below
    each slab face: particles cross the faces within a few rebuilds."""
    n = CFG["n"]
    L = Box.from_density(n, 1.0).L
    m = round(n ** (1 / 3))
    idx = np.arange(n)
    lattice = np.stack([idx % m, (idx // m) % m, idx // (m * m)], -1)
    pos = ((lattice + [0.5, 0.5, 0.95]) * (L / m)) % L
    vel = np.random.default_rng(2).standard_normal((n, 3)) * np.sqrt(1.5)
    vel -= vel.mean(axis=0)
    np.savez(tmp_path / "system.npz", pos=pos.astype(np.float32),
             vel=vel.astype(np.float32))
    return dict(config=dict(CFG, temperature=1.5, dt=0.002), cap=16,
                steps=60, chunk=20, system=str(tmp_path / "system.npz"))


def test_p2_gloo_migration_conserves_every_particle(tmp_path):
    """A run with migration (``_migration_job``): nothing is lost or
    duplicated, both ranks rebuild in lockstep, energy holds."""
    n = CFG["n"]
    L = Box.from_density(n, 1.0).L
    ranks = spawn_ranks(tmp_path, 2, _migration_job(tmp_path))
    for out in ranks:
        assert np.array_equal(np.sort(out["pids"]), np.arange(n))
        assert int(out["n_migrated"]) > 0, "no migration exercised"
        assert not out["overflow"]
        assert abs(float(out["e1"]) - float(out["e0"])) <= \
            1e-3 * abs(float(out["e0"]))
        want = int(oracle.pair_count(torch.from_numpy(out["pos1"]),
                                     Box(L=L), MDConfig(**CFG).rs))
        assert int(out["pairs1"]) == want
    assert int(ranks[0]["n_rebuilds"]) == int(ranks[1]["n_rebuilds"]) >= 2
    assert int(ranks[0]["n_migrated"]) == int(ranks[1]["n_migrated"])


def test_p2_local_ring_equals_gloo_bitwise(tmp_path):
    """The engine's ranks as two threads of a ``LocalRing`` (where its step
    runs eagerly, as on the card) and as two gloo processes, through the
    migration run: every output bit for bit, on both ranks."""
    job = _migration_job(tmp_path)
    gloo = spawn_ranks(tmp_path, 2, job)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as each gloo rank: the same reduction order
    try:
        local = run_ranks(2, lambda ring: dense_slab_run(ring, job))
    finally:
        torch.set_num_threads(threads)
    assert int(local[0]["n_migrated"]) > 0
    for r in range(2):
        assert set(local[r]) == set(gloo[r])
        for name, want in gloo[r].items():
            np.testing.assert_array_equal(np.asarray(local[r][name]), want,
                                          err_msg=f"rank {r}: {name}")


def test_rings_say_whether_a_step_can_be_captured(monkeypatch):
    """No group: capturable; an NCCL group of any size: capturable (its
    shifts and reductions replay as NCCL's kernels; the ring is told the
    backend and size here, as no NCCL group runs on the CPU); a gloo group,
    even of one process, and a ``LocalRing``: not (host exchanges), so the
    engine steps eagerly."""
    assert Ring().capturable
    assert not any(r.capturable for r in LocalRing.ring_of(2))
    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1,
                            rank=0)
    try:
        ring = Ring(dist.group.WORLD)
        assert (ring.size, ring.capturable) == (1, False)
        sim = DenseSlabSimulator(MDConfig(**CFG), cap=16, device="cpu",
                                 ring=ring)
        carry = sim.run(sim.init(_gen(7)), 5, chunk=5)
        assert sim._runner.captures == 0 and not bool(carry.overflow)
        monkeypatch.setattr(dist, "get_backend", lambda group: "nccl")
        for size in (1, 2, 4, 8):
            monkeypatch.setattr(dist, "get_world_size", lambda group: size)
            ring = Ring(dist.group.WORLD)
            assert (ring.size, ring.capturable) == (size, True)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------ conversion
def test_slab_carry_round_trip_and_p1_from_jax():
    """A JAX P = 1 carry crosses to the port and back unchanged; the port
    then gives the JAX energies and pair count from it."""
    key = jax.random.PRNGKey(5)
    jdd = JSlab(JConfig(**CFG, mesh_devices=1), cap=16)
    jstate = jdd.init(key)
    arrays = tuple(np.asarray(a) for a in jstate)
    carries = convert.slab_carries_from_numpy(*arrays, device="cpu")
    assert len(carries) == 1
    back = convert.slab_carries_to_numpy(carries)
    for got, want in zip(back, arrays):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)

    dd = DenseSlabSimulator(MDConfig(**CFG), cap=16, device="cpu")
    carry = carries[0]
    _, total = dd.lists(carry)
    assert total == jdd.lists(jstate)[1]
    for got, want in zip(dd.energies(carry), jdd.energies(jstate)):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-4)


def test_slab_carries_split_the_leading_axis():
    """A P = 2 JAX carry gives one port carry per rank, in rank order."""
    jdd = JSlab(JConfig(**CFG, mesh_devices=2), cap=16)
    jstate = jdd.init(jax.random.PRNGKey(1))
    arrays = tuple(np.asarray(a) for a in jstate)
    carries = convert.slab_carries_from_numpy(*arrays, device="cpu")
    assert len(carries) == 2
    for r, c in enumerate(carries):
        np.testing.assert_array_equal(c.pid.numpy(), arrays[2][r])
        assert tuple(c.pos.shape) == (3, 4 * 9, 9, 16)
    with pytest.raises(ValueError):
        convert.slab_carries_from_numpy(*arrays[:-1], device="cpu")
