"""Core modules of the port against the JAX package on the same numpy
inputs: box, config, initializers, LJ formulas, the O(N^2) oracle."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from md_neighbor_list_tpu.core import box as jbox
from md_neighbor_list_tpu.core import config as jconfig
from md_neighbor_list_tpu.core import system as jsystem
from md_neighbor_list_tpu.ops import common as jcommon
from md_neighbor_list_tpu.ops import oracle as joracle
from md_neighbor_list_tpu_torch.core import box as tbox
from md_neighbor_list_tpu_torch.core import config as tconfig
from md_neighbor_list_tpu_torch.core import system as tsystem
from md_neighbor_list_tpu_torch.ops import common as tcommon
from md_neighbor_list_tpu_torch.ops import oracle as toracle
from torch_port_util import numpy_system


@pytest.mark.parametrize("n,rho", [(1728, 1.0), (1000, 0.8), (16384, 1.2)])
def test_box_matches(n, rho):
    jb, tb = jbox.Box.from_density(n, rho), tbox.Box.from_density(n, rho)
    assert jb.L == tb.L and jb.volume() == tb.volume()
    rng = np.random.default_rng(n)
    x = rng.uniform(-3 * jb.L, 3 * jb.L, (500, 3)).astype(np.float32)
    # wrap and min_image: the same f32 operations, so bitwise
    np.testing.assert_array_equal(tb.wrap(torch.from_numpy(x)).numpy(),
                                  np.asarray(jb.wrap(jnp.asarray(x))))
    np.testing.assert_array_equal(tb.min_image(torch.from_numpy(x)).numpy(),
                                  np.asarray(jb.min_image(jnp.asarray(x))))


def _shared_fields(config) -> dict:
    """The fields of a port configuration that the JAX package's has: all
    but the port's own ``lattice`` (the start's lattice; ``"sc"``, the JAX
    package's simple-cubic start, by default)."""
    fields = dataclasses.asdict(config)
    fields.pop("lattice")
    return fields


@pytest.mark.parametrize("name", sorted(jconfig.PRESETS))
def test_presets_equal_field_by_field(name):
    j, t = jconfig.PRESETS[name], tconfig.PRESETS[name]
    assert dataclasses.asdict(j) == _shared_fields(t)
    assert t.lattice == "sc"
    assert j.rs == t.rs
    # the port's own preset: LAMMPS bench/in.lj (tests/test_torch_fcc.py)
    assert sorted(tconfig.PRESETS) == sorted([*jconfig.PRESETS, "lammps_lj"])


def test_config_defaults_and_validation():
    assert dataclasses.asdict(jconfig.MDConfig()) == \
        _shared_fields(tconfig.MDConfig())
    assert tconfig.MDConfig().lattice == "sc"
    for bad in (dict(layout="x"), dict(backend="cuda"), dict(n=0),
                dict(skin=-0.1), dict(lattice="hcp")):
        with pytest.raises(ValueError):
            tconfig.MDConfig(**bad)


@pytest.mark.parametrize("n", [1728, 1000, 700])
def test_init_lattice_positions_bitwise(n):
    js, jb = jsystem.init_lattice(n, 1.0)
    ts, tb = tsystem.init_lattice(n, 1.0, device="cpu")
    assert jb.L == tb.L
    np.testing.assert_array_equal(ts.pos.numpy(), np.asarray(js.pos))
    np.testing.assert_array_equal(ts.pid.numpy(), np.asarray(js.pid))
    assert ts.vel.dtype == torch.float32 and ts.force.abs().sum() == 0
    # Maxwell velocities: zero net momentum, variance ~ temperature
    assert ts.vel.mean(dim=0).abs().max() < 1e-5
    assert abs(float(ts.vel.var()) - 1.0) < 0.15


def test_initializers_take_a_generator():
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    a, _ = tsystem.init_lattice(512, 1.0, g1, 0.7, device="cpu")
    b, _ = tsystem.init_lattice(512, 1.0, g2, 0.7, device="cpu")
    assert torch.equal(a.vel, b.vel)
    assert abs(float(a.vel.var()) - 0.7) < 0.15
    r, box = tsystem.init_random(torch.Generator().manual_seed(1), 512, 1.0,
                                 device="cpu")
    assert float(r.pos.min()) >= 0.0 and float(r.pos.max()) < box.L
    assert r.n == 512


@pytest.mark.parametrize("fn", ["lj_force_scalar", "lj_pair_virial",
                                "lj_potential"])
def test_lj_formulas(fn):
    rng = np.random.default_rng(0)
    r2 = rng.uniform(0.7, 7.0, 4000).astype(np.float32)
    r2[::50] = 0.0  # padding lanes
    mask = (r2 > 0) & (r2 < 6.25)
    extra = (2.5,) if fn == "lj_potential" else ()
    want = np.asarray(getattr(jcommon, fn)(jnp.asarray(r2), jnp.asarray(mask),
                                           *extra))
    got = getattr(tcommon, fn)(torch.from_numpy(r2), torch.from_numpy(mask),
                               *extra).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert (got[~mask] == 0).all()


def test_run_first_index_and_compact_rows():
    rng = np.random.default_rng(1)
    keys = np.sort(rng.integers(0, 40, 500)).astype(np.int32)
    np.testing.assert_array_equal(
        tcommon.run_first_index(torch.from_numpy(keys)).numpy(),
        np.asarray(jcommon.run_first_index(jnp.asarray(keys))))
    cand = rng.integers(0, 1000, (7, 64)).astype(np.int32)
    mask = rng.random((7, 64)) < 0.3
    j_idx, j_cnt = jcommon.compact_rows(jnp.asarray(cand), jnp.asarray(mask),
                                        16, 1000)
    t_idx, t_cnt = tcommon.compact_rows(torch.from_numpy(cand),
                                        torch.from_numpy(mask), 16, 1000)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_cnt.numpy(), np.asarray(j_cnt))


@pytest.mark.parametrize("n,seed", [(1000, 0), (700, 1)])
def test_oracle_matches(n, seed):
    pos, _, _ = numpy_system(n, seed, jitter=0.15)
    jb, tb = jbox.Box.from_density(n, 1.0), tbox.Box.from_density(n, 1.0)
    jp, tp = jnp.asarray(pos), torch.from_numpy(pos)
    # pair counts are exact
    assert int(toracle.pair_count(tp, tb, 2.8)) == \
        int(joracle.pair_count(jp, jb, 2.8))
    f_j, u_j = joracle.forces_energy(jp, jb, 2.5)
    f_t, u_t = toracle.forces_energy(tp, tb, 2.5)
    # summation order differs: fp32 tolerance scaled by the largest force
    scale = max(float(np.abs(np.asarray(f_j)).max()), 1.0)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j),
                               atol=2e-4 * scale)
    np.testing.assert_allclose(float(u_t), float(u_j), rtol=1e-4)


@pytest.mark.parametrize("half", [True, False])
def test_oracle_neighbors_match(half):
    pos, _, _ = numpy_system(700, 2, jitter=0.15)
    jb, tb = jbox.Box.from_density(700, 1.0), tbox.Box.from_density(700, 1.0)
    k = 64 if half else 128
    j_idx, j_cnt = joracle.neighbors(jnp.asarray(pos), jb, 2.8, k, half)
    t_idx, t_cnt = toracle.neighbors(torch.from_numpy(pos), tb, 2.8, k, half)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_cnt.numpy(), np.asarray(j_cnt))
