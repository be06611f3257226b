"""The dense layout and its rebuild: the port on the CPU (plain expand)
against the JAX package (Pallas expand in interpret mode, and the scatter
reference) on the same numpy inputs. State comparisons are bitwise: both sides
do the same f32 operations and sort stably."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from md_neighbor_list_tpu.ops import dense_cells as jdc
from md_neighbor_list_tpu.ops import dense_ref as jref
from md_neighbor_list_tpu_torch.ops import dense_cells as tdc
from md_neighbor_list_tpu_torch.ops import dense_ref as tref
from md_neighbor_list_tpu_torch.utils import convert
from torch_port_util import (CASES, assert_state_equal, jax_state,
                                   numpy_system, torch_state)


@pytest.mark.parametrize("n,rs,cap", [(1728, 2.8, 32), (700, 2.8, 48),
                                      (100_000, 2.8, 40),
                                      (1_000_000, 2.8, 40)])
def test_make_spec_matches(n, rs, cap):
    from md_neighbor_list_tpu.core.box import Box as JBox
    from md_neighbor_list_tpu_torch.core.box import Box as TBox

    j = jdc.make_spec(JBox.from_density(n, 1.0), rs, cap)
    t = tdc.make_spec(TBox.from_density(n, 1.0), rs, cap)
    assert (j.mc, j.cap, j.L, j.cell_size) == (t.mc, t.cap, t.L, t.cell_size)
    assert (j.rows, j.ncells, j.slots) == (t.rows, t.ncells, t.slots)


def test_make_spec_rejects_tiny_box():
    from md_neighbor_list_tpu_torch.core.box import Box as TBox

    with pytest.raises(ValueError):
        tdc.make_spec(TBox(L=8.0), 2.8)


@pytest.mark.parametrize("cap", [8, 16, 24, 32, 40, 56, 72, 128])
def test_grow_cap_matches(cap):
    assert tdc.grow_cap(cap) == jdc.grow_cap(cap) > cap


@pytest.mark.parametrize("case", sorted(CASES))
def test_park_lattice_bitwise(case):
    n, cap = CASES[case]
    pos, vel, pid = numpy_system(n, 0)
    _, jspec, _ = jax_state(pos, vel, pid, cap)
    _, tspec, _ = torch_state(pos, vel, pid, cap)
    park = tdc.park_lattice(tspec, "cpu")
    np.testing.assert_array_equal(park.numpy(),
                                  np.asarray(jdc.park_lattice(jspec)))
    # park_positions restores it on invalid slots only
    valid = torch.zeros(park.shape[1:], dtype=torch.bool)
    valid[::2] = True
    restored = tdc.park_positions(torch.zeros_like(park), valid, tspec)
    assert torch.equal(restored[:, ~valid], park[:, ~valid])
    assert restored[:, valid].abs().sum() == 0


def _wild_system(n, seed):
    """Coordinates that need the wrap: a third below 0, a third above L."""
    pos, vel, pid = numpy_system(n, seed, jitter=0.3)
    L = np.float32(n ** (1.0 / 3.0))
    pos = pos.copy()
    pos[pid % 3 == 0] -= L
    pos[pid % 3 == 1] += L
    return pos, vel, pid


@pytest.mark.parametrize("case", sorted(CASES))
def test_cell_keys_and_row_starts_bitwise(case):
    n, cap = CASES[case]
    pos, vel, pid = numpy_system(n, 5, jitter=0.3)
    js, jspec, _ = jax_state(pos, vel, pid, cap)
    ts, tspec, _ = torch_state(pos, vel, pid, cap)
    jk = jdc.cell_keys(js, jspec)
    tk = tdc.cell_keys(ts, tspec)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    jks = jnp.sort(jk.reshape(-1))
    tks = torch.sort(tk.reshape(-1), stable=True).values
    np.testing.assert_array_equal(
        tdc.row_starts(tks, tspec).numpy(),
        np.asarray(jdc._row_starts(jks, jspec)))


@pytest.mark.parametrize("case,wild", [("mc4_cap32", False),
                                       ("mc4_cap32", True),
                                       ("mc4_cap40", True),
                                       ("mc3_cap48", True)])
def test_rebuild_dense_bitwise(case, wild):
    """Port rebuild == JAX sort + Pallas expand (interpret) == scatter
    references of both packages, on pid, pos and vel of every slot."""
    n, cap = CASES[case]
    pos, vel, pid = _wild_system(n, 6) if wild else numpy_system(n, 6)
    js, jspec, _ = jax_state(pos, vel, pid, cap)
    ts, tspec, _ = torch_state(pos, vel, pid, cap)
    j_new, j_rs = jdc.rebuild_dense(js, jspec, True)
    t_new, t_rs = tdc.rebuild_dense(ts, tspec)
    assert int(t_new.valid().sum()) == n
    assert_state_equal(t_new, j_new, parked_pos=False)
    np.testing.assert_array_equal(t_rs.numpy(), np.asarray(j_rs))
    assert_state_equal(tref.rebuild_reference(ts, tspec), t_new)
    assert_state_equal(t_new, jref.rebuild_reference(js, jspec))
    # a second rebuild from a drifted, already dense state
    js2 = j_new._replace(pos=j_new.pos + 0.05 * j_new.vel)
    ts2 = t_new._replace(pos=t_new.pos + 0.05 * t_new.vel)
    assert_state_equal(tdc.rebuild_dense(ts2, tspec)[0],
                       jdc.rebuild_dense(js2, jspec, True)[0],
                       parked_pos=False)


def test_rebuild_overflow_truncates_and_signals():
    """A cell holding more than cap particles keeps its first cap records in
    stable order; the loss shows as kept != n, the caller's overflow signal."""
    n, cap = 1728, 32
    pos, vel, pid = numpy_system(n, 7)
    pos = pos.copy()
    pos[:60] = pos[0] + np.random.default_rng(0).uniform(0, 0.3, (60, 3)) \
        .astype(np.float32)
    js, jspec, _ = jax_state(pos, vel, pid, cap)
    ts, tspec, _ = torch_state(pos, vel, pid, cap)
    t_new, _ = tdc.rebuild_dense(ts, tspec)
    kept = int(t_new.valid().sum())
    assert kept < n
    assert_state_equal(t_new, jref.rebuild_reference(js, jspec))
    assert_state_equal(tref.rebuild_reference(ts, tspec),
                       jref.rebuild_reference(js, jspec))
    assert int(np.asarray(jref.rebuild_reference(js, jspec).valid()).sum()) \
        == kept


def test_expand_plain_is_what_the_wrapper_runs_on_cpu():
    pos, vel, pid = numpy_system(1728, 8)
    ts, tspec, _ = torch_state(pos, vel, pid, 32)
    keys = tdc.cell_keys(ts, tspec).reshape(-1)
    keys_s, order = torch.sort(keys, stable=True)
    args = (ts.pos.reshape(3, -1), ts.vel.reshape(3, -1), ts.pid.reshape(-1),
            order, keys_s, tdc.row_starts(keys_s, tspec), tspec)
    a, b = tdc.expand(*args), tdc.expand_plain(*args)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert a[0].shape == (6, tspec.rows, tspec.mc, tspec.cap)
    assert a[1].dtype == torch.int32


def _record_stream(case):
    """(keys, pos, vel, pid, port spec, JAX spec, key_base, reference) of one
    record stream, numpy-seeded: the records as a rebuild hands them to
    ``sort_expand``, unsorted. ``reference`` is the whole expected state where
    ``dense_ref.rebuild_reference`` gives one, else None."""
    kind, cap = case.rsplit("-cap", 1)
    cap = int(cap)
    if kind == "slab":  # the slab tests' P = 2 geometry: mc = 9, nz = 4
        from md_neighbor_list_tpu.core.box import Box as JBox
        from md_neighbor_list_tpu.parallel import dense_slab as jds
        from md_neighbor_list_tpu_torch.core.box import Box as TBox
        from md_neighbor_list_tpu_torch.parallel import dense_slab as tds

        jspec = jds.make_slab_spec(JBox.from_density(4096, 1.0), 1.7, 2, cap)
        tspec = tds.make_slab_spec(TBox.from_density(4096, 1.0), 1.7, 2, cap)
        base = tspec.mc * tspec.mc
        rng = np.random.default_rng(1)
        M = 2000  # keys below base (emigrants) and beyond the owned rows
        keys = torch.from_numpy(rng.integers(0, base * (tspec.nz + 3), M)
                                .astype(np.int32))
        chans = torch.from_numpy(rng.standard_normal((6, M))
                                 .astype(np.float32))
        return (keys, chans[:3].contiguous(), chans[3:].contiguous(),
                torch.arange(M, dtype=torch.int32), tspec, jspec, base, None)
    pos, vel, pid = numpy_system(1728, 8, jitter=0.2)
    if kind == "overflow":  # 60 particles in one cell
        pos = pos.copy()
        pos[:60] = pos[0] + np.random.default_rng(0).uniform(
            0, 0.3, (60, 3)).astype(np.float32)
    ts, tspec, _ = torch_state(pos, vel, pid, cap)
    _, jspec, _ = jax_state(pos, vel, pid, cap)
    reference = tref.rebuild_reference(ts, tspec)
    if kind == "movers":  # a binned state drifted off its cells
        from md_neighbor_list_tpu_torch.ops import incremental as tinc

        drift = np.random.default_rng(3).normal(0.0, 0.3, ts.pos.shape)
        valid = reference.valid()
        ts = reference._replace(pos=reference.pos + torch.where(
            valid[None], torch.from_numpy(drift.astype(np.float32)), 0.0))
        keys, _ = tinc.mover_keys(
            ts._replace(pos=torch.remainder(ts.pos, tspec.L)), tspec)
        reference = None
    else:
        keys = tdc.cell_keys(ts, tspec)
    return (keys.reshape(-1), torch.remainder(ts.pos, tspec.L).reshape(3, -1),
            ts.vel.reshape(3, -1), ts.pid.reshape(-1), tspec, jspec, 0,
            reference)


@pytest.mark.parametrize("case", ["cube-cap28", "cube-cap40", "cube-cap41",
                                  "slab-cap16", "movers-cap40",
                                  "overflow-cap32"])
def test_expand_through_the_permutation(case):
    """``expand_plain`` reading the records through the sort's permutation ==
    the old composition (the records gathered into sorted order, then
    expanded) bitwise, and == the JAX ``sort_expand`` (Pallas in interpret
    mode) on pid, row starts and valid slots; parked slots against
    ``rebuild_reference`` (or its park lattice, zero velocity). Cases: the
    cube; a slab ``key_base`` with emigrant and foreign records; a mover
    stream, most keys the sentinel; a cell with more records than cap."""
    keys, pos, vel, pid, tspec, jspec, base, reference = _record_stream(case)
    keys_s, order = torch.sort(keys, stable=True)
    rs = tdc.row_starts(keys_s, tspec, base)
    posvel, pid4 = tdc.expand_plain(pos, vel, pid, order, keys_s, rs, tspec,
                                    base)
    ident = torch.arange(keys.shape[0])
    old = tdc.expand_plain(pos[:, order], vel[:, order], pid[order], ident,
                           keys_s, rs, tspec, base)
    assert torch.equal(posvel, old[0]) and torch.equal(pid4, old[1])
    new, new_rs = tdc.sort_expand(keys, pos, vel, pid, tspec, base)
    assert torch.equal(new.pid, pid4) and torch.equal(new_rs, rs)
    assert torch.equal(torch.cat([new.pos, new.vel]), posvel)

    chans = tuple(jnp.asarray(c) for c in (*pos.numpy(), *vel.numpy())) + (
        jnp.asarray(pid.numpy().astype(np.float32)),)
    j_new, j_rs = jdc.sort_expand(jnp.asarray(keys.numpy()), chans, jspec,
                                  True, key_base=base)
    np.testing.assert_array_equal(rs.numpy(), np.asarray(j_rs))
    assert_state_equal(new, j_new, parked_pos=False)
    kept = int(new.valid().sum())
    if case.startswith("overflow"):
        assert kept < keys.shape[0] - int((keys == tspec.ncells).sum())
    if reference is not None:
        assert_state_equal(new, reference)
    else:
        empty = ~new.valid()
        park = tdc.park_lattice(tspec, "cpu")
        assert torch.equal(new.pos[:, empty], park[:, empty])
        assert float(new.vel[:, empty].abs().sum()) == 0.0
    if case.startswith("movers"):
        assert 0 < kept < keys.shape[0] // 4


def test_packed_round_trip_and_convert():
    n, cap = 1728, 32
    pos, vel, pid = numpy_system(n, 9)
    ts, tspec, _ = torch_state(pos, vel, pid, cap)
    p, v = tdc.to_packed(ts, n)
    np.testing.assert_array_equal(p, pos)
    np.testing.assert_array_equal(v, vel)
    with pytest.raises(ValueError):
        tdc.from_packed(torch.zeros(tspec.slots + 1, 3),
                        torch.zeros(tspec.slots + 1, 3),
                        torch.zeros(tspec.slots + 1, dtype=torch.int32), tspec)
    # the arrays np.asarray gives from the JAX state load into the port
    js, jspec, _ = jax_state(pos, vel, pid, cap)
    j_new, _ = jdc.rebuild_dense(js, jspec, True)
    state = convert.dense_state_from_numpy(*(np.asarray(a) for a in j_new),
                                           device="cpu")
    spec = convert.spec_from(jspec.mc, jspec.cap, jspec.L, jspec.cell_size)
    assert spec == tspec
    assert_state_equal(state, j_new)
    for back, want in zip(convert.dense_state_to_numpy(state), j_new):
        np.testing.assert_array_equal(back, np.asarray(want))
    p2, _ = tdc.to_packed(state, n, spec.L)
    np.testing.assert_array_equal(p2, np.mod(pos, np.float32(spec.L)))


# K1b: the JAX expand variants are TPU layouts of one function; the port maps
# them all onto its one expand kernel, whose plain version runs here
K1B_VARIANTS = [(fuse, split, False) for fuse in (False, True)
                for split in (0, 2, 4)] + [(False, 0, True)]


@functools.lru_cache(maxsize=None)
def _drifted_dense():
    """A state rebuilt once and drifted by 0.05 * vel off the lattice, as
    ``tests/test_dense.py::test_expand_variants_bitwise`` takes it."""
    n, cap = CASES["mc4_cap32"]
    pos, vel, pid = numpy_system(n, 3)
    js, jspec, _ = jax_state(pos, vel, pid, cap)
    ts, tspec, _ = torch_state(pos, vel, pid, cap)
    js, ts = jdc.rebuild_dense(js, jspec, True)[0], tdc.rebuild_dense(ts,
                                                                     tspec)[0]
    return (js._replace(pos=js.pos + 0.05 * js.vel), jspec,
            ts._replace(pos=ts.pos + 0.05 * ts.vel), tspec)


@pytest.mark.parametrize("fuse,split,blocked", K1B_VARIANTS,
                         ids=[f"fuse{int(f)}-split{s}-blocked{int(b)}"
                              for f, s, b in K1B_VARIANTS])
def test_expand_variants_map_to_one_kernel(fuse, split, blocked):
    """Every JAX expand variant (``fuse_keys`` x ``split_dma``, and the
    blocked layout), run in interpret mode, against the port's
    ``rebuild_dense``, which takes no such flag: pid bitwise, pos/vel of valid
    slots bitwise; parked slots on ``park_lattice`` with zero velocity on the
    port's side (the JAX expand in interpret mode may park a slot one ulp off,
    see ``assert_state_equal``)."""
    js, jspec, ts, tspec = _drifted_dense()
    j_new, j_rs = jdc.rebuild_dense(js, jspec, True, fuse, split, blocked)
    t_new, t_rs = tdc.rebuild_dense(ts, tspec)
    assert_state_equal(t_new, j_new, parked_pos=False)
    np.testing.assert_array_equal(t_rs.numpy(), np.asarray(j_rs))
    empty = ~t_new.valid()
    assert torch.equal(t_new.pos[:, empty],
                       tdc.park_lattice(tspec, "cpu")[:, empty])
    assert float(t_new.vel[:, empty].abs().sum()) == 0.0
    assert float(np.abs(np.asarray(j_new.vel)[:, empty.numpy()]).sum()) == 0.0
