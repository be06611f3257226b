"""The port's binning (``ops/binning.py``) and capacity policy
(``core/capacity.py``) against the JAX package's on the same numpy inputs, on
the CPU: keys, the Morton round trip, and the sort's permutation, the cell
table, ``cell_max`` and the overflow flag bit for bit, for both layouts, with
an ``active`` mask and with a cell that overflows the table."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from md_neighbor_list_tpu.core import capacity as jcap
from md_neighbor_list_tpu.core.box import Box as JBox
from md_neighbor_list_tpu.ops import binning as jb
from md_neighbor_list_tpu_torch.core import capacity as tcap
from md_neighbor_list_tpu_torch.core.box import Box as TBox
from md_neighbor_list_tpu_torch.ops import binning as tb
from torch_port_util import RS, numpy_system

FIELDS = ("perm", "coords", "table", "cell_max", "overflow")
# one compile per shape (op-by-op dispatch compiles every op of every shape)
jax_bin = jax.jit(jb.bin_particles, static_argnums=(1, 2, 3))


def _uniform(n, seed, rho=1.0):
    L = (n / rho) ** (1.0 / 3.0)
    pos = np.random.default_rng(seed).uniform(0.0, L, (n, 3))
    return pos.astype(np.float32), L


def _both(pos, L, cell_cap, layout, active=None, rs=RS):
    jbins = jax_bin(
        jnp.asarray(pos), jb.make_grid(JBox(L=L), rs), cell_cap, layout,
        None if active is None else jnp.asarray(active))
    tbins = tb.bin_particles(
        torch.from_numpy(pos), tb.make_grid(TBox(L=L), rs), cell_cap, layout,
        None if active is None else torch.from_numpy(active))
    return jbins, tbins


def _assert_bins_equal(jbins, tbins, fields=FIELDS):
    for name in fields:
        want = np.asarray(getattr(jbins, name))
        got = getattr(tbins, name).numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_grid_and_offsets_equal_the_jax_package():
    for L in (6.0, 8.4, 12.6, 46.4):
        jg, tg = jb.make_grid(JBox(L=L), RS), tb.make_grid(TBox(L=L), RS)
        assert (tg.mc, tg.cell_size, tg.L, tg.ncells, tg.usable) == (
            jg.mc, jg.cell_size, jg.L, jg.ncells, jg.usable)
    np.testing.assert_array_equal(tb.NEIGHBOR_OFFSETS, jb.NEIGHBOR_OFFSETS)
    assert tb.NEIGHBOR_OFFSETS.dtype == jb.NEIGHBOR_OFFSETS.dtype


def test_keys_equal_the_jax_package():
    coords = np.random.default_rng(3).integers(0, 1024, (5000, 3),
                                               dtype=np.int32)
    tc, jc = torch.from_numpy(coords), jnp.asarray(coords)
    np.testing.assert_array_equal(tb.morton_key(tc).numpy(),
                                  np.asarray(jb.morton_key(jc)))
    np.testing.assert_array_equal(tb.rowmajor_key(tc, 37).numpy(),
                                  np.asarray(jb.rowmajor_key(jc, 37)))
    assert tb.morton_key(tc).dtype == torch.int32


def test_morton_round_trip():
    coords = np.random.default_rng(1234).integers(0, 1024, (5000, 3),
                                                  dtype=np.int32)
    keys = tb.morton_key(torch.from_numpy(coords))
    np.testing.assert_array_equal(tb.morton_decode(keys).numpy(), coords)
    np.testing.assert_array_equal(
        tb.morton_decode(keys).numpy(),
        np.asarray(jb.morton_decode(jnp.asarray(keys.numpy()))))


def test_cell_coords_at_cell_edges_equal_the_jax_package():
    """Positions on and next to every cell edge, and at L itself: the f32
    scale 1/cell_size decides the cell, and the clip keeps L inside."""
    L = 12.6
    grid = tb.make_grid(TBox(L=L), RS)
    edges = np.arange(grid.mc + 1, dtype=np.float64) * grid.cell_size
    near = np.concatenate([np.nextafter(edges.astype(np.float32), -1),
                           edges.astype(np.float32),
                           np.nextafter(edges.astype(np.float32), 1)])
    pos = np.stack([near, near[::-1], np.roll(near, 5)], -1)
    pos = np.clip(pos, 0.0, np.float32(L)).astype(np.float32)
    got = tb.cell_coords(torch.from_numpy(pos), grid).numpy()
    want = np.asarray(jb.cell_coords(jnp.asarray(pos),
                                     jb.make_grid(JBox(L=L), RS)))
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() == grid.mc - 1


@pytest.mark.parametrize("layout", ["rowmajor", "morton"])
@pytest.mark.parametrize("n,seed", [(2000, 0), (700, 5), (4096, 2)],
                         ids=["mc4", "mc3", "mc5"])
def test_bins_bitwise_equal_the_jax_package(layout, n, seed):
    pos, L = _uniform(n, seed)
    jbins, tbins = _both(pos, L, 64, layout)
    _assert_bins_equal(jbins, tbins)
    assert tbins.active is None and not bool(tbins.overflow)


@pytest.mark.parametrize("layout", ["rowmajor", "morton"])
def test_lattice_ties_bitwise_equal_the_jax_package(layout):
    """Many equal keys on a jittered lattice: the stable sort's tie order."""
    pos, _, _ = numpy_system(1728, seed=6, jitter=0.01)
    _assert_bins_equal(*_both(pos, 12.0, 40, layout))


@pytest.mark.parametrize("layout", ["rowmajor", "morton"])
def test_active_mask_bitwise_equal_the_jax_package(layout):
    pos, L = _uniform(2000, 7)
    active = np.random.default_rng(8).uniform(size=2000) < 0.7
    jbins, tbins = _both(pos, L, 64, layout, active)
    _assert_bins_equal(jbins, tbins, FIELDS + ("active",))
    # inactive particles sort last and never enter the table
    n_act = int(active.sum())
    assert bool(tbins.active[:n_act].all()) and not bool(
        tbins.active[n_act:].any())
    table = tbins.table.numpy()
    assert sorted(table[table < 2000].tolist()) == list(range(n_act))


@pytest.mark.parametrize("layout", ["rowmajor", "morton"])
def test_cell_overflow_is_reported_and_dropped_like_the_jax_package(layout):
    """One cell holding far more than the table's capacity: the extra ranks
    are dropped from the table, and ``cell_max`` still counts them."""
    pos, L = _uniform(700, 9)
    pos[:200] = np.float32(0.1) + np.random.default_rng(10).uniform(
        0.0, 1.0, (200, 3)).astype(np.float32)
    jbins, tbins = _both(pos, L, 32, layout)
    _assert_bins_equal(jbins, tbins)
    assert bool(tbins.overflow) and int(tbins.cell_max) >= 200
    table = tbins.table.numpy()
    assert (table < 700).sum() < 700  # dropped, not written past the row


def test_active_overflow_counts_only_active_ranks():
    pos = np.full((200, 3), 0.1, np.float32)
    active = np.arange(200) % 2 == 0
    jbins, tbins = _both(pos, 8.4, 32, "rowmajor", active)
    _assert_bins_equal(jbins, tbins, FIELDS + ("active",))
    assert int(tbins.cell_max) == 100 and bool(tbins.overflow)


def test_bin_invariants():
    """Each table row's particles live in that cell, every sorted particle
    appears once, and the stored coordinates are the recomputed ones."""
    pos, L = _uniform(2000, 11)
    grid = tb.make_grid(TBox(L=L), RS)
    bins = tb.bin_particles(torch.from_numpy(pos), grid, 64, "morton")
    perm = bins.perm.numpy()
    assert sorted(perm.tolist()) == list(range(2000))
    table = bins.table.numpy()
    assert sorted(table[table < 2000].tolist()) == list(range(2000))
    coords = tb.cell_coords(torch.from_numpy(pos[perm]), grid)
    cells = tb.rowmajor_key(coords, grid.mc).numpy()
    for c in range(table.shape[0]):
        assert (cells[table[c][table[c] < 2000]] == c).all()
    np.testing.assert_array_equal(bins.coords.numpy(), coords.numpy())


def test_unknown_layout_raises():
    with pytest.raises(ValueError, match="layout"):
        tb.bin_particles(torch.zeros((4, 3)), tb.make_grid(TBox(L=9.0), RS),
                         8, "hilbert")


def test_capacity_policy_equals_the_jax_package():
    for rho, rs, cell, half in ((1.0, 2.8, 2.9, True), (0.8, 2.5, 3.1, False),
                                (1.2, 3.0, 3.0, True),
                                (1e-3, 2.8, 9.0, False)):
        t, j = tcap.estimate(rho, rs, cell, half), jcap.estimate(rho, rs,
                                                                 cell, half)
        assert (t.neighbors, t.cell, t.growth) == (j.neighbors, j.cell,
                                                   j.growth)
        tg, jg = t.grown(), j.grown()
        assert (tg.neighbors, tg.cell) == (jg.neighbors, jg.cell)
        assert tcap.estimate_neighbors(rho, rs, half) == t.neighbors
    for x, m in ((0, 8), (1, 8), (8, 8), (9, 8), (77, 8), (100, 16)):
        assert tcap.round_up(x, m) == jcap.round_up(x, m)
    for mean in (0.1, 1.0, 23.4, 91.9):
        assert tcap._poisson_upper(mean, 8.0) == jcap._poisson_upper(mean,
                                                                       8.0)


def test_capacity_estimate_covers_measured():
    pos, L = _uniform(4096, 12)
    grid = tb.make_grid(TBox(L=L), RS)
    cap = tcap.estimate(1.0, RS, grid.cell_size, half_list=True)
    bins = tb.bin_particles(torch.from_numpy(pos), grid, cap.cell, "morton")
    assert int(bins.cell_max) <= cap.cell
