"""The port's 27-cell pair sweep (``ops/pairlist.py``) against the JAX
package's on the same numpy positions, on the CPU: ``idx``, ``count``,
``perm``, ``max_count``, ``cell_max`` and the overflow flag bit for bit, for
half and full rows, both layouts, mc = 3 and 4, the mc < 3 oracle route, the
stable build with an ``active`` mask, and row overflow; the shared row
primitives bit for bit."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from md_neighbor_list_tpu.core.box import Box as JBox
from md_neighbor_list_tpu.ops import binning as jb
from md_neighbor_list_tpu.ops import common as jcommon
from md_neighbor_list_tpu.ops import pairlist as jp
from md_neighbor_list_tpu_torch.core.box import Box as TBox
from md_neighbor_list_tpu_torch.ops import binning as tb
from md_neighbor_list_tpu_torch.ops import common as tcommon
from md_neighbor_list_tpu_torch.ops import oracle as toracle
from md_neighbor_list_tpu_torch.ops import pairlist as tp
from torch_port_util import RS, numpy_system

FIELDS = ("idx", "count", "perm", "max_count", "cell_max", "overflow")


@functools.lru_cache(maxsize=None)
def _jax_build(stable: bool):
    """The JAX build, jitted (static: box, grid, radius, capacities, half,
    layout): one compile per shape instead of one per op."""
    if stable:
        return jax.jit(jp.build_neighbor_lists_stable,
                       static_argnums=(1, 2, 3, 4, 5, 6, 7))
    return jax.jit(jp.build_neighbor_lists,
                   static_argnums=(1, 2, 3, 4, 5, 6, 7))


def _uniform(n, seed, rho=1.0):
    L = (n / rho) ** (1.0 / 3.0)
    pos = np.random.default_rng(seed).uniform(0.0, L, (n, 3))
    return pos.astype(np.float32), L


def _build_both(pos, L, half, layout, k_cap=192, cell_cap=64):
    jbox, tbox = JBox(L=L), TBox(L=L)
    jps, jnl = _jax_build(False)(jnp.asarray(pos), jbox,
                                 jb.make_grid(jbox, RS), RS, k_cap, cell_cap,
                                 half, layout)
    tps, tnl = tp.build_neighbor_lists(torch.from_numpy(pos), tbox,
                                       tb.make_grid(tbox, RS), RS, k_cap,
                                       cell_cap, half, layout)
    return (jps, jnl), (tps, tnl)


def _assert_lists_equal(jnl, tnl):
    for name in FIELDS:
        want = np.asarray(getattr(jnl, name))
        got = getattr(tnl, name).numpy()
        assert got.dtype == want.dtype, name
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def _pairs(idx, pid, half):
    n = idx.shape[0]
    rows, cols = np.nonzero(idx < n)
    i, j = pid[rows], pid[idx[rows, cols]]
    pairs = set(zip(np.minimum(i, j).tolist(), np.maximum(i, j).tolist()))
    if half:
        assert len(pairs) == len(rows), "half rows repeat a pair"
    return pairs


@pytest.mark.parametrize("layout", ["rowmajor", "morton"])
@pytest.mark.parametrize("half", [True, False], ids=["half", "full"])
@pytest.mark.parametrize("n,seed", [(2000, 1), (700, 4)], ids=["mc4", "mc3"])
def test_sweep_bitwise_equals_the_jax_package(layout, half, n, seed):
    pos, L = _uniform(n, seed)
    (jps, jnl), (tps, tnl) = _build_both(pos, L, half, layout)
    _assert_lists_equal(jnl, tnl)
    np.testing.assert_array_equal(tps.numpy(), np.asarray(jps))
    assert not bool(tnl.overflow)
    # and the rows are the oracle's pair set
    want, _ = toracle.neighbors(torch.from_numpy(pos), TBox(L=L), RS, 192,
                                half=True)
    assert _pairs(tnl.idx.numpy(), tnl.perm.numpy(), half) == _pairs(
        want.numpy(), np.arange(n), True)


@pytest.mark.parametrize("half", [True, False], ids=["half", "full"])
def test_lattice_sweep_bitwise_equals_the_jax_package(half):
    """A jittered lattice: many ties in the sort and near-equal distances."""
    pos, _, _ = numpy_system(1728, seed=2, jitter=0.02)
    (_, jnl), (_, tnl) = _build_both(pos, 12.0, half, "morton", k_cap=208,
                                     cell_cap=40)
    _assert_lists_equal(jnl, tnl)


@pytest.mark.parametrize("half", [True, False], ids=["half", "full"])
def test_small_box_takes_the_oracle_like_the_jax_package(half):
    pos, L = _uniform(256, 3)  # L = 6.35 -> mc = 2
    assert not tb.make_grid(TBox(L=L), RS).usable
    (jps, jnl), (tps, tnl) = _build_both(pos, L, half, "morton", k_cap=256)
    _assert_lists_equal(jnl, tnl)
    np.testing.assert_array_equal(tnl.perm.numpy(), np.arange(256))
    assert torch.equal(tps, torch.from_numpy(pos))


@pytest.mark.parametrize("half", [True, False], ids=["half", "full"])
def test_row_overflow_is_detected_like_the_jax_package(half):
    """A tiny K: the flag is set, counts stay the true counts, and the rows
    hold the first K hits."""
    pos, L = _uniform(2000, 5)
    (_, jnl), (_, tnl) = _build_both(pos, L, half, "morton", k_cap=4)
    _assert_lists_equal(jnl, tnl)
    assert bool(tnl.overflow) and int(tnl.max_count) > 4


def test_cell_overflow_sets_the_flag_like_the_jax_package():
    pos, L = _uniform(700, 6)
    pos[:100] = np.float32(0.2) + np.random.default_rng(6).uniform(
        0.0, 0.5, (100, 3)).astype(np.float32)
    (_, jnl), (_, tnl) = _build_both(pos, L, True, "rowmajor", cell_cap=32)
    _assert_lists_equal(jnl, tnl)
    assert bool(tnl.overflow) and int(tnl.cell_max) > 32


@pytest.mark.parametrize("layout", ["rowmajor", "morton"])
@pytest.mark.parametrize("half", [True, False], ids=["half", "full"])
def test_stable_build_with_active_bitwise_equals_the_jax_package(layout,
                                                                 half):
    pos, L = _uniform(2000, 7)
    active = np.random.default_rng(7).uniform(size=2000) < 0.8
    jbox, tbox = JBox(L=L), TBox(L=L)
    jnl = _jax_build(True)(jnp.asarray(pos), jbox, jb.make_grid(jbox, RS),
                           RS, 192, 64, half, layout, jnp.asarray(active))
    tnl = tp.build_neighbor_lists_stable(
        torch.from_numpy(pos), tbox, tb.make_grid(tbox, RS), RS, 192, 64,
        half, layout, torch.from_numpy(active))
    _assert_lists_equal(jnl, tnl)
    # rows in the caller's order; inactive rows empty, never a candidate
    idx = tnl.idx.numpy()
    assert (tnl.count.numpy()[~active] == 0).all()
    assert not np.isin(idx[idx < 2000], np.nonzero(~active)[0]).any()


def test_stable_build_translates_rows_in_blocks(monkeypatch):
    """The entry translation a block of rows at a time (blocks of 300 rows
    here, the last one short) gives the JAX stable build's rows."""
    pos, L = _uniform(2000, 10)
    jbox, tbox = JBox(L=L), TBox(L=L)
    jnl = _jax_build(True)(jnp.asarray(pos), jbox, jb.make_grid(jbox, RS),
                           RS, 192, 64, False, "morton", None)
    monkeypatch.setattr(tp, "TRANSLATE_ROWS", 300)
    tnl = tp.build_neighbor_lists_stable(
        torch.from_numpy(pos), tbox, tb.make_grid(tbox, RS), RS, 192, 64,
        False, "morton")
    _assert_lists_equal(jnl, tnl)


def test_stable_build_refuses_a_small_box():
    pos, L = _uniform(256, 8)
    tbox = TBox(L=L)
    with pytest.raises(ValueError, match="mc < 3"):
        tp.build_neighbor_lists_stable(torch.from_numpy(pos), tbox,
                                       tb.make_grid(tbox, RS), RS, 64, 64,
                                       True)


def test_chunk_size_changes_nothing():
    pos, L = _uniform(2000, 9)
    tbox = TBox(L=L)
    grid = tb.make_grid(tbox, RS)
    _, a = tp.build_neighbor_lists(torch.from_numpy(pos), tbox, grid, RS,
                                   128, 64, True, chunk=2048)
    _, b = tp.build_neighbor_lists(torch.from_numpy(pos), tbox, grid, RS,
                                   128, 64, True, chunk=300)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_row_primitives_bitwise_equal_the_jax_package():
    """``compact_rows`` and ``run_first_index``, shared by the sweep and the
    oracle, against ``md_neighbor_list_tpu/ops/common.py``."""
    rng = np.random.default_rng(10)
    cand = rng.integers(0, 500, (64, 300), dtype=np.int32)
    mask = rng.uniform(size=(64, 300)) < 0.2
    compact = jax.jit(jcommon.compact_rows, static_argnums=(2, 3))
    for k in (4, 64, 128):
        ti, tc = tcommon.compact_rows(torch.from_numpy(cand),
                                      torch.from_numpy(mask), k, fill=500)
        ji, jc = compact(jnp.asarray(cand), jnp.asarray(mask), k, 500)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    keys = np.sort(rng.integers(0, 50, 1000).astype(np.int32))
    np.testing.assert_array_equal(
        tcommon.run_first_index(torch.from_numpy(keys)).numpy(),
        np.asarray(jax.jit(jcommon.run_first_index)(jnp.asarray(keys))))
