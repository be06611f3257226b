"""The half-sweep functions of the port (plain versions, on the CPU) against
the JAX package's Pallas kernels in interpret mode, on the same rebuilt
state. Masks and counts are bitwise; forces, PE and virial agree to fp32
rounding (summation order, and the exact divide the port uses on the hot
force path where the TPU kernel takes a reciprocal with two Newton steps)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from md_neighbor_list_tpu.core.box import Box as JBox
from md_neighbor_list_tpu.ops import oracle as joracle
from md_neighbor_list_tpu.ops import pallas_force as jpf
from md_neighbor_list_tpu_torch.ops import dense_cells as tdc
from md_neighbor_list_tpu_torch.ops import dense_force as tdf
from torch_port_util import CASES, RC, RS, rebuilt_pair, torch_state

ALL = sorted(CASES)


@functools.lru_cache(maxsize=None)
def _lists(case):
    js, jspec, ts, tspec, _ = rebuilt_pair(case)
    jv = js.valid().astype(jnp.float32)
    j_counts, j_masks = jpf.dense_lists_half(js.pos, jv, jspec, RS, True)
    t_counts, t_masks = tdf.dense_lists_half(ts.pos, tspec, RS)
    return j_counts, j_masks, t_counts, t_masks


def test_constants_match():
    assert tdf.HALF_OFFSETS5 == jpf.HALF_OFFSETS5
    assert tdf.MASK_BITS == jpf.MASK_BITS
    for cap in (8, 32, 33, 40, 64, 65, 128):
        assert tdf.mask_words(cap) == jpf.mask_words(cap)


@pytest.mark.parametrize("case", ALL)
def test_masks_and_counts_bitwise(case):
    j_counts, j_masks, t_counts, t_masks = _lists(case)
    assert t_masks.dtype == torch.int32 and t_counts.dtype == torch.int32
    assert tuple(t_masks.shape) == tuple(j_masks.shape)
    np.testing.assert_array_equal(t_counts.numpy(), np.asarray(j_counts))
    np.testing.assert_array_equal(t_masks.numpy(), np.asarray(j_masks))


@pytest.mark.parametrize("case", ALL)
def test_mask_slot_counts_equal_counts(case):
    _, _, t_counts, t_masks = _lists(case)
    cap = CASES[case][1]
    pop = tdf.mask_slot_counts(t_masks, cap)
    assert torch.equal(pop, t_counts)
    j_pop = jpf.mask_slot_counts(jnp.asarray(t_masks.numpy()), cap)
    np.testing.assert_array_equal(pop.numpy(), np.asarray(j_pop))


@pytest.mark.parametrize("case", ALL)
def test_total_pairs_equal_oracle_and_invalid_slots_empty(case):
    _, _, ts, tspec, pos = rebuilt_pair(case)
    _, _, t_counts, t_masks = _lists(case)
    valid = ts.valid()
    total = int(t_counts[valid].sum())
    box = JBox.from_density(pos.shape[0], 1.0)
    assert total == int(joracle.pair_count(jnp.asarray(pos), box, RS))
    # empty slots: zero count, and no mask bit set for them as own slot
    assert int(t_counts[~valid].abs().sum()) == 0
    pop = tdf.mask_slot_counts(t_masks, tspec.cap)
    assert int(pop[~valid].sum()) == 0


@pytest.mark.parametrize("case", ALL)
@pytest.mark.parametrize("want_pe", [True, False], ids=["pe", "hot"])
def test_forces_half_match(case, want_pe):
    js, jspec, ts, tspec, _ = rebuilt_pair(case)
    jv = js.valid().astype(jnp.float32)
    f_j, pe_j = jpf.dense_forces_half(js.pos, jv, jspec, RC, True, want_pe)
    f_t, pe_t = tdf.dense_forces_half(ts.pos, tspec, RC, want_pe)
    valid = ts.valid().numpy()
    # the tolerances of tests/test_dense.py for the same two forms: the
    # want_pe form divides exactly on both sides; the hot form differs by
    # the TPU kernel's reciprocal + Newton steps as well
    rtol, atol = (1e-5, 1e-4) if want_pe else (1e-4, 5e-3)
    np.testing.assert_allclose(f_t.numpy()[:, valid],
                               np.asarray(f_j)[:, valid], rtol=rtol, atol=atol)
    # parked slots receive exactly zero force
    assert float(f_t[:, ~ts.valid()].abs().sum()) == 0.0
    if want_pe:
        np.testing.assert_allclose(pe_t.numpy()[valid],
                                   np.asarray(pe_j)[valid], rtol=1e-5,
                                   atol=1e-5)
        assert float(pe_t[~ts.valid()].abs().sum()) == 0.0
    else:
        assert pe_t is None and pe_j is None


@pytest.mark.parametrize("case", ALL)
def test_pe_virial_match(case):
    js, jspec, ts, tspec, _ = rebuilt_pair(case)
    jv = js.valid().astype(jnp.float32)
    pe_j, w_j = jpf.dense_pe_virial(js.pos, jv, jspec, RC, True)
    pe_t, w_t = tdf.dense_pe_virial(ts.pos, tspec, RC)
    valid = ts.valid().numpy()
    np.testing.assert_allclose(pe_t.numpy()[valid], np.asarray(pe_j)[valid],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(w_t.numpy()[valid], np.asarray(w_j)[valid],
                               rtol=1e-5, atol=1e-4)
    assert float(pe_t[~ts.valid()].abs().sum()) == 0.0
    assert float(w_t[~ts.valid()].abs().sum()) == 0.0
    # pe of the observable pass == pe of the force pass (same pairs)
    _, pe_f = tdf.dense_forces_half(ts.pos, tspec, RC, True)
    np.testing.assert_allclose(pe_t.numpy(), pe_f.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_forces_match_oracle_in_pid_order():
    from md_neighbor_list_tpu_torch.core.box import Box as TBox
    from md_neighbor_list_tpu_torch.ops import oracle as toracle

    _, _, ts, tspec, pos = rebuilt_pair("mc3_cap48")
    n = pos.shape[0]
    f, pe = tdf.dense_forces_half(ts.pos, tspec, RC, True)
    keep = ts.valid().reshape(-1)
    packed = torch.empty((n, 3))
    packed[ts.pid.reshape(-1)[keep].long()] = f.reshape(3, -1)[:, keep].T
    p, _ = tdc.to_packed(ts, n)
    f_o, u_o = toracle.forces_energy(torch.from_numpy(p),
                                     TBox.from_density(n, 1.0), RC)
    scale = max(float(f_o.abs().max()), 1.0)
    np.testing.assert_allclose(packed.numpy(), f_o.numpy(), atol=2e-4 * scale)
    np.testing.assert_allclose(float(pe[ts.valid()].sum()), float(u_o),
                               rtol=1e-4, atol=1e-2)


def test_wrappers_reject_wrong_inputs():
    _, _, ts, tspec, _ = rebuilt_pair("mc4_cap32")
    with pytest.raises(ValueError):
        tdf.dense_lists_half(ts.pos[:, :-1], tspec, RS)
    with pytest.raises(ValueError):
        tdf.dense_forces_half(ts.pos.double(), tspec, RC)


# ------------------------------------------------------ K3 on the half list
SKIN = RS - RC


def _list_of(ts, tspec):
    """The half list at RS of the rebuilt state ``ts`` (the plain
    versions: K2, the starts, the pack)."""
    lst = tdf.half_list_buffers(tspec, int(ts.valid().sum()), RS, "cpu")
    assert not bool(tdf.build_half_list(ts.pos, tspec, RS, lst))
    return lst


def _drifted(ts, frac: float, seed: int):
    """``ts`` with every particle moved ``frac`` * skin/2 in its own random
    direction (parked slots stay on the park lattice): the largest drift the
    displacement vote lets through is skin/2."""
    g = torch.Generator().manual_seed(seed)
    u = torch.randn(ts.pos.shape, generator=g)
    u = u / torch.sqrt(torch.sum(u * u, dim=0, keepdim=True))
    step = torch.where(ts.valid()[None], frac * SKIN / 2 * u, 0.0)
    return ts._replace(pos=ts.pos + step.to(torch.float32))


def _pairs_within_rc(pos4, lst, tspec) -> int:
    """The step's pairs within RC: the dense cells' slot pairs and the
    listed sparse ones."""
    p = pos4.reshape(3, -1)
    total = 0
    for own, part, shift in (tdf.dense_pairs(pos4, tspec),
                             tdf.list_pairs(lst, tspec)):
        d = p[:, own] - (p[:, part] + shift)
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        total += int((r2 < np.float32(RC * RC)).sum())
    return total


@pytest.mark.parametrize("case", ALL)
def test_pack_lists_exactly_k2s_bits_in_the_sparse_cells(case):
    """Each slot's listed partners are its K2 bits in the ten sparse cells,
    in list order, and with its bits in the four dense cells they are all of
    K2's: the listed ones are the pairs within RS there."""
    _, _, ts, tspec, _ = rebuilt_pair(case)
    lst = _list_of(ts, tspec)
    counts, masks = tdf.dense_lists_half(ts.pos, tspec, RS)
    cap = tspec.cap
    dense = torch.zeros(ts.pid.shape, dtype=torch.int32)
    for pc in tdf.DENSE_CELLS:
        k = 0 if pc < 2 else 1 + (pc - 2) // 3
        l0 = (pc + 1) * cap if pc < 2 else (pc - 2 - 3 * (k - 1)) * cap
        for w in range(tdf.mask_words(cap)):
            for b in range(min(tdf.MASK_BITS, cap - w * tdf.MASK_BITS)):
                dense[..., w * tdf.MASK_BITS + b] += torch.sum(
                    (masks[k, w, :, :, l0:l0 + cap] >> b) & 1, dim=-1,
                    dtype=torch.int32)
    assert torch.equal(lst.nsparse + dense, counts)
    # the starts: each slot's entries follow the last one's, from 0
    n = lst.nsparse.reshape(-1)
    assert torch.equal(lst.start.reshape(-1),
                       (torch.cumsum(n, 0) - n).to(torch.int32))
    own, part, shift = tdf.list_pairs(lst, tspec)
    p = ts.pos.reshape(3, -1)
    d = p[:, own] - (p[:, part] + shift)
    r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    assert bool((r2 < np.float32(RS * RS)).all())
    assert own.numel() == int(lst.nsparse.sum()) > 0
    # within a slot, cell by cell of SPARSE_CELLS and slot by slot
    n = n.long()
    before = torch.cumsum(n, 0) - n
    entry = lst.start.reshape(-1).long()[own] + torch.arange(own.numel()) \
        - before[own]
    v = lst.lanes[entry].long()
    place = torch.full((14,), -1)
    place[list(tdf.SPARSE_CELLS)] = torch.arange(len(tdf.SPARSE_CELLS))
    rank = place[v // cap] * cap + v % cap
    assert bool((rank >= 0).all())
    same = own[1:] == own[:-1]
    assert bool((rank[1:][same] > rank[:-1][same]).all())


@pytest.mark.parametrize("frac", [0.0, 0.5, 0.999],
                         ids=["rebuilt", "half_skin", "at_the_trigger"])
@pytest.mark.parametrize("case", ALL)
def test_list_force_equals_the_sweep_on_drifted_states(case, frac):
    """The list of the rebuilt state, read on states drifted up to just under
    the vote's trigger (every particle skin/2 from where the list was
    built): the same pairs within RC as the half sweep of the drifted state
    and the same forces to summation order (both divide exactly)."""
    _, _, ts, tspec, _ = rebuilt_pair(case)
    lst = _list_of(ts, tspec)
    st = _drifted(ts, frac, seed=len(case))
    f_list = tdf.dense_forces_list(st.pos, lst, tspec, RC)
    f_sweep, _ = tdf.dense_forces_half(st.pos, tspec, RC)
    scale = max(float(f_sweep.abs().max()), 1.0)
    np.testing.assert_allclose(f_list.numpy(), f_sweep.numpy(), rtol=1e-5,
                               atol=1e-5 * scale)
    assert float(f_list[:, ~st.valid()].abs().sum()) == 0.0
    counts = tdf.dense_counts_half(st.pos, tspec, RC)
    assert _pairs_within_rc(st.pos, lst, tspec) == \
        int(counts[st.valid()].sum())


@pytest.mark.parametrize("axis", ["face", "edge", "corner"])
def test_pair_just_inside_rs_closing_by_skin_is_felt(axis):
    """Two particles r0 = RS - 1e-3 apart across the periodic boundary (the
    second one across a face, an edge or a corner of the first's cell: a
    dense cell, then sparse ones) are in the list of that state; each then
    moves skin/2 - 1e-4 toward the other, so they end within RC, 8e-4 inside
    it, with no particle past the trigger. The step's pairs within RC are
    then the sweep's, that one with them, and so are the forces; with
    r0 = RS + 1e-3 the pair ends outside RC for both."""
    n, cap = 1728, 32
    L = 12.0
    m = 12
    idx = np.arange(n)
    lattice = np.stack([idx % m, (idx // m) % m, idx // (m * m)], -1)
    base = ((lattice + 0.5) * (L / m)).astype(np.float64)
    u = {"face": [-1, 0, 0], "edge": [-1, -1, 0],
         "corner": [-1, -1, -1]}[axis]
    u = np.asarray(u, np.float64) / np.linalg.norm(u)
    delta = SKIN / 2 - 1e-4
    a = 0  # the site at (0.5, 0.5, 0.5)
    for r0, felt in ((RS - 1e-3, True), (RS + 1e-3, False)):
        pos = base.copy()
        target = (base[a] + r0 * u) % L
        b = int(np.argmin(np.sum((base - target) ** 2, axis=1)))
        pos[b] = target
        vel = np.zeros((n, 3), np.float32)
        ts, tspec, _ = torch_state((pos % L).astype(np.float32), vel,
                                   np.arange(n, dtype=np.int32), cap)
        ts, _ = tdc.rebuild_dense(ts, tspec)
        lst = _list_of(ts, tspec)
        flat = ts.pid.reshape(-1)
        sa, sb = (int(torch.nonzero(flat == i)[0]) for i in (a, b))
        pos4 = ts.pos.reshape(3, -1).clone()
        pos4[:, sa] += torch.tensor(delta * u, dtype=torch.float32)
        pos4[:, sb] -= torch.tensor(delta * u, dtype=torch.float32)
        st = ts._replace(pos=pos4.reshape(ts.pos.shape))
        d = (pos4[:, sa] - pos4[:, sb]).double()
        d = d - L * torch.round(d / L)
        assert (float(torch.sqrt(torch.sum(d * d))) < RC) == felt
        f_list = tdf.dense_forces_list(st.pos, lst, tspec, RC)
        f_sweep, _ = tdf.dense_forces_half(st.pos, tspec, RC)
        scale = max(float(f_sweep.abs().max()), 1.0)
        np.testing.assert_allclose(f_list.numpy(), f_sweep.numpy(),
                                   rtol=1e-5, atol=1e-5 * scale)
        counts = tdf.dense_counts_half(st.pos, tspec, RC)
        assert _pairs_within_rc(st.pos, lst, tspec) == \
            int(counts[st.valid()].sum())


def test_list_overflow_is_reported_and_drops_nothing_silently():
    """A list with fewer entries than its pairs in the sparse cells says so;
    every slot's start and stored count stay within it. One with exactly as
    many does not: the overflow test counts the entries stored, not K2's
    pairs."""
    _, _, ts, tspec, _ = rebuilt_pair("mc4_cap32")
    full = _list_of(ts, tspec)
    small = full._replace(lanes=torch.zeros(
        int(full.nsparse.sum()) // 2 // 8 * 8, dtype=torch.int16),
        start=torch.zeros_like(full.start), nsparse=torch.zeros_like(
            full.nsparse))
    assert bool(tdf.build_half_list(ts.pos, tspec, RS, small))
    assert int(small.start.max()) <= small.lanes.numel()
    assert not bool(tdf.build_half_list(ts.pos, tspec, RS, full))
    exact = full._replace(lanes=torch.zeros(-(-int(full.nsparse.sum()) // 8)
                                            * 8, dtype=torch.int16))
    assert not bool(tdf.build_half_list(ts.pos, tspec, RS, exact))
    assert torch.equal(tdf.list_pairs(exact, tspec)[1],
                       tdf.list_pairs(full, tspec)[1])


@pytest.mark.parametrize("case", ALL)
def test_list_capacity_holds_the_sparse_cells_pairs(case):
    """The list's capacity (the sparse cells' share of a ball of radius rs
    at cap particles a cell) is above the entries of each rebuilt case and
    below K2's pairs within rs at that density (the half sphere's)."""
    _, _, ts, tspec, _ = rebuilt_pair(case)
    n = int(ts.valid().sum())
    lst = _list_of(ts, tspec)
    capacity = tdf.list_capacity(tspec, n, RS)
    assert int(lst.nsparse.sum()) <= capacity
    half_ball = 2 * np.pi / 3 * (RS / tspec.cell_size) ** 3 * tspec.cap
    assert capacity < n * half_ball


def test_list_force_refuses_a_cap_past_its_limit():
    _, _, ts, tspec, _ = rebuilt_pair("mc4_cap32")
    import dataclasses
    big = dataclasses.replace(tspec, cap=tdf.LIST_MAX_CAP + 8)
    with pytest.raises(ValueError):
        tdf.dense_forces_list(ts.pos, _list_of(ts, tspec), big, RC)
