"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: skipped where no CUDA device exists (the kernels have no
interpret mode). Run on a machine with an NVIDIA GPU and ``nvcc``:

    python -m pytest tests/test_torch_gpu.py -m gpu -q

``chip_smoke.py`` makes the same comparisons at N = 1,000,000.
"""

import numpy as np
import pytest
import torch

from md_neighbor_list_tpu_torch.ops import (_cuda, dense_cells, dense_force,
                                            incremental, slab_kernels)
from torch_port_util import (CASES, RC, RS, clustered_system, numpy_system,
                             scatter_slots, torch_state)

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card only")
    return torch.device("cuda")


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernels_match_plain_versions(card, case):
    n, cap = CASES[case]
    pos, vel, pid = numpy_system(n, seed=11, jitter=0.2)
    state, spec, _ = torch_state(pos, vel, pid, cap)
    state = dense_cells.DenseState(*(t.to(card) for t in state))
    before = dict(_cuda.LAUNCHES)

    # K1: rebuild through the kernel == rebuild through the plain version
    new, _ = dense_cells.rebuild_dense(state, spec)
    cpu, _ = dense_cells.rebuild_dense(
        dense_cells.DenseState(*(t.cpu() for t in state)), spec)
    for a, b in zip(new, cpu):
        assert torch.equal(a.cpu(), b)

    # K2: bitwise
    counts, masks = dense_force.dense_lists_half(new.pos, spec, RS)
    counts_p, masks_p = dense_force.lists_half_plain(new.pos, spec, RS)
    assert torch.equal(counts, counts_p) and torch.equal(masks, masks_p)

    # K3, K4: f32 sums in another order (atomics): rounding-level agreement
    f_p, pe_p = dense_force.forces_half_plain(new.pos, spec, RC, True)
    scale = max(float(f_p.abs().max()), 1.0)
    for want_pe in (False, True):
        f, pe = dense_force.dense_forces_half(new.pos, spec, RC, want_pe)
        np.testing.assert_allclose(f.cpu(), f_p.cpu(), rtol=1e-4,
                                   atol=2e-5 * scale)
        assert float(f[:, ~new.valid()].abs().sum()) == 0.0
    np.testing.assert_allclose(pe.cpu(), pe_p.cpu(), rtol=1e-4, atol=1e-4)
    pe4, vir4 = dense_force.dense_pe_virial(new.pos, spec, RC)
    pe4_p, vir4_p = dense_force.pe_virial_half_plain(new.pos, spec, RC)
    np.testing.assert_allclose(pe4.cpu(), pe4_p.cpu(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(vir4.cpu(), vir4_p.cpu(), rtol=1e-4, atol=1e-3)

    # K5, K7: integers, bitwise; K5 is K2's count
    valid = new.valid()
    half = dense_force.dense_counts_half(new.pos, spec, RS)
    assert torch.equal(half, dense_force.counts_half_plain(new.pos, spec, RS))
    assert torch.equal(half, counts)
    full = dense_force.dense_counts(new.pos, valid, spec, RS)
    assert torch.equal(full, dense_force.counts_full_plain(new.pos, valid,
                                                           spec, RS))
    assert int(full[valid].sum()) == 2 * int(half[valid].sum())

    # K6: fixed summation order: bitwise from run to run, rounding-level
    # agreement with the plain version; against K3, the other sweep, the
    # force-parity gate of 2e-4 of the largest component
    ff_p, pef_p = dense_force.forces_full_plain(new.pos, valid, spec, RC, True)
    for want_pe in (False, True):
        ff, pef = dense_force.dense_forces(new.pos, valid, spec, RC, want_pe)
        again, _ = dense_force.dense_forces(new.pos, valid, spec, RC, want_pe)
        assert torch.equal(ff, again)
        np.testing.assert_allclose(ff.cpu(), ff_p.cpu(), rtol=1e-4,
                                   atol=2e-5 * scale)
        np.testing.assert_allclose(ff.cpu(), f_p.cpu(), rtol=0,
                                   atol=2e-4 * scale)
        assert float(ff[:, ~valid].abs().sum()) == 0.0
    np.testing.assert_allclose(pef.cpu(), pef_p.cpu(), rtol=1e-4, atol=1e-4)

    # each wrapper launched its kernel exactly once per call above
    after = _cuda.LAUNCHES
    once = ("expand", "lists_half", "forces_half", "forces_half_pe",
            "pe_virial_half", "count_half", "count_full")
    for name in once:
        assert after[name] == before[name] + 1, name
    assert after["force_full"] == before["force_full"] + 2
    assert after["force_full_pe"] == before["force_full_pe"] + 2


@pytest.mark.parametrize("cap", [152, 304])
def test_kernels_take_caps_beyond_four_mask_words(card, cap):
    """A cluster in one cell at mc = 3: the caps the growth ladder reaches
    after 128 (5 and 10 mask words) launch and equal the plain versions."""
    n = 700
    pos, vel, pid = clustered_system(cap - 12, seed=13, n=n)
    state, spec, _ = torch_state(pos, vel, pid, cap)
    state = dense_cells.DenseState(*(t.to(card) for t in state))
    new, _ = dense_cells.rebuild_dense(state, spec)
    valid = new.valid()
    assert int(valid.sum()) == n and int(valid.sum(dim=-1).max()) > 128
    counts, masks = dense_force.dense_lists_half(new.pos, spec, RS)
    counts_p, masks_p = dense_force.lists_half_plain(new.pos, spec, RS)
    assert torch.equal(counts, counts_p) and torch.equal(masks, masks_p)
    assert torch.equal(dense_force.dense_counts_half(new.pos, spec, RS),
                       counts)
    full = dense_force.dense_counts(new.pos, valid, spec, RS)
    assert torch.equal(full, dense_force.counts_full_plain(new.pos, valid,
                                                           spec, RS))
    f_p, _ = dense_force.forces_half_plain(new.pos, spec, RC)
    scale = max(float(f_p.abs().max()), 1.0)
    f = dense_force.dense_forces_half(new.pos, spec, RC)[0]
    np.testing.assert_allclose(f.cpu(), f_p.cpu(), rtol=1e-4,
                               atol=2e-5 * scale)
    ff = dense_force.dense_forces(new.pos, valid, spec, RC, False)[0]
    np.testing.assert_allclose(ff.cpu(), f_p.cpu(), rtol=0, atol=2e-4 * scale)


@pytest.mark.parametrize("cap", [384, 480])
def test_kernels_take_caps_beyond_one_thread_per_lane(card, cap):
    """3*cap > 1024 (12 and 15 mask words): the lane-strided forms of the
    count kernels, and the list and force kernels at caps where the full
    sweep stages its partners in passes, against the plain versions, a
    cluster of more than 341 particles in one cell at mc = 3."""
    n = 700
    pos, vel, pid = clustered_system(cap - 12, seed=13, n=n)
    state, spec, _ = torch_state(pos, vel, pid, cap)
    state = dense_cells.DenseState(*(t.to(card) for t in state))
    new, _ = dense_cells.rebuild_dense(state, spec)
    valid = new.valid()
    assert int(valid.sum()) == n and int(valid.sum(dim=-1).max()) > 341
    counts, masks = dense_force.dense_lists_half(new.pos, spec, RS)
    counts_p, masks_p = dense_force.lists_half_plain(new.pos, spec, RS)
    assert masks.shape[1] == dense_force.mask_words(cap) >= 12
    assert torch.equal(counts, counts_p) and torch.equal(masks, masks_p)
    assert torch.equal(dense_force.dense_counts_half(new.pos, spec, RS),
                       counts)
    full = dense_force.dense_counts(new.pos, valid, spec, RS)
    assert torch.equal(full, dense_force.counts_full_plain(new.pos, valid,
                                                           spec, RS))
    assert int(full[valid].sum()) == 2 * int(counts[valid].sum())
    f_p, pe_p = dense_force.forces_half_plain(new.pos, spec, RC, True)
    scale = max(float(f_p.abs().max()), 1.0)
    for want_pe in (False, True):
        f, pe = dense_force.dense_forces_half(new.pos, spec, RC, want_pe)
        np.testing.assert_allclose(f.cpu(), f_p.cpu(), rtol=1e-4,
                                   atol=2e-5 * scale)
        ff, _ = dense_force.dense_forces(new.pos, valid, spec, RC, want_pe)
        again, _ = dense_force.dense_forces(new.pos, valid, spec, RC, want_pe)
        assert torch.equal(ff, again)
        np.testing.assert_allclose(ff.cpu(), f_p.cpu(), rtol=0,
                                   atol=2e-4 * scale)
    pe_scale = max(float(pe_p.abs().max()), 1.0)
    np.testing.assert_allclose(pe.cpu(), pe_p.cpu(), rtol=1e-4,
                               atol=2e-5 * pe_scale)
    pe4, vir4 = dense_force.dense_pe_virial(new.pos, spec, RC)
    pe4_p, vir4_p = dense_force.pe_virial_half_plain(new.pos, spec, RC)
    np.testing.assert_allclose(pe4.cpu(), pe4_p.cpu(), rtol=1e-4,
                               atol=2e-5 * pe_scale)
    np.testing.assert_allclose(vir4.cpu(), vir4_p.cpu(), rtol=1e-4,
                               atol=2e-5 * max(float(vir4_p.abs().max()), 1.0))


@pytest.mark.parametrize("cap", [32, 40])
def test_merge_and_incremental_rebuild(card, cap):
    """K8 bitwise against its plain version, and the incremental rebuild on
    the card bitwise against its order-exact twin, on a state drifted off
    its cells."""
    n = 1728
    pos, vel, pid = numpy_system(n, seed=14, jitter=0.2)
    state, spec, _ = torch_state(pos, vel, pid, cap)
    state = dense_cells.rebuild_dense(
        dense_cells.DenseState(*(t.to(card) for t in state)), spec)[0]
    drift = 0.3 * torch.randn(state.pos.shape, device=card,
                              generator=torch.Generator(card).manual_seed(3))
    state = state._replace(pos=state.pos + torch.where(state.valid()[None],
                                                       drift, 0.0))
    before = _cuda.LAUNCHES["merge"]
    new, overflow = incremental.rebuild_dense_incremental(state, spec)
    assert _cuda.LAUNCHES["merge"] == before + 1 and not bool(overflow)
    twin = incremental.rebuild_reference_incremental(state, spec)
    for a, b in zip(new, twin):
        assert torch.equal(a, b)
    assert int(new.valid().sum()) == n
    # K8 alone on the same inputs as the rebuild gave it
    args, _ = incremental.merge_inputs(state, spec)
    got = incremental.merge(*args, spec)
    want = incremental.merge_plain(*args, spec)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("p,cap", [(2, 32), (4, 40), (2, 384)])
def test_slab_forms_match_plain_versions(card, p, cap):
    """The slab forms of K1-K3 on the card against their plain versions:
    slabs of a rebuilt mc = 4 cube state (P = 4 is nz = 1; cap 384 runs the
    lane-strided forms), each rebuilt by the slab sort from every record,
    extended by its seam-shifted ghost layer. K1 and K2 bitwise, K3 to
    rounding; every slab form counted once per call."""
    n = 1728
    pos, vel, pid = numpy_system(n, seed=12, jitter=0.2)
    _, cube, _ = torch_state(pos, vel, pid, cap)
    mc = cube.mc
    nz = mc // p
    spec = slab_kernels.SlabSpec(mc=mc, nz=nz, mc_z=mc, cap=cap, L=cube.L,
                                 cell_size=cube.cell_size,
                                 cell_z=cube.cell_size)
    rec = torch.from_numpy(pos.T.copy()).to(card)
    chans = torch.cat([rec, torch.from_numpy(vel.T.copy()).to(card)])
    pids = torch.from_numpy(pid).to(card)
    valid = torch.ones(n, dtype=torch.bool, device=card)
    states = []
    for r in range(p):
        before = _cuda.LAUNCHES["expand_slab"]
        keys = slab_kernels.slab_keys(rec, valid, spec, r * nz)
        st, _ = slab_kernels.slab_sort_expand(keys, chans, pids, spec)
        assert _cuda.LAUNCHES["expand_slab"] == before + 1
        plain, _ = slab_kernels.slab_sort_expand(
            keys.cpu(), chans.cpu(), pids.cpu(), spec)
        for a, b in zip(st, plain):
            assert torch.equal(a.cpu(), b)
        states.append(st)
    assert sum(int(s.valid().sum()) for s in states) == n
    for r in range(p):
        g = states[(r + 1) % p]
        gpos = g.pos[:, :mc].clone()
        if r == p - 1:
            gpos[2] += float(np.float32(spec.L))
        ext = torch.cat([states[r].pos, gpos], dim=1)
        ext_v = torch.cat([states[r].valid(), g.valid()[:mc]], dim=0)
        counts, masks = slab_kernels.slab_lists_half(ext, ext_v, spec, RS)
        counts_p, masks_p = slab_kernels.slab_lists_half(ext.cpu(),
                                                         ext_v.cpu(), spec, RS)
        assert torch.equal(counts.cpu(), counts_p)
        assert torch.equal(masks.cpu(), masks_p)
        f_p, seam_p, pe_p = slab_kernels.slab_forces_half(
            ext.cpu(), ext_v.cpu(), spec, RC, True)
        scale = max(float(f_p.abs().max()), float(seam_p.abs().max()), 1.0)
        for want_pe in (False, True):
            f, seam, pe = slab_kernels.slab_forces_half(ext, ext_v, spec, RC,
                                                        want_pe)
            for got, want in ((f, f_p), (seam, seam_p)):
                np.testing.assert_allclose(got.cpu(), want, rtol=1e-4,
                                           atol=2e-5 * scale)
        np.testing.assert_allclose(pe.cpu(), pe_p, rtol=1e-4, atol=1e-4)
        if nz >= 2:
            low, top = slab_kernels.slab_forces_interior(states[r].pos, spec,
                                                         RC)
            last, seam2 = slab_kernels.slab_forces_boundary(
                states[r].pos[:, (nz - 1) * mc:], gpos, g.valid()[:mc], spec,
                RC)
            np.testing.assert_allclose(
                torch.cat([low, last + top], dim=1).cpu(), f_p, rtol=1e-4,
                atol=2e-5 * scale)
            np.testing.assert_allclose(seam2.cpu(), seam_p, rtol=1e-4,
                                       atol=2e-5 * scale)


def test_dense_slab_p1_on_the_card_matches_the_cube_engine(card):
    """The P = 1 self-halo engine on the card (no process group) against
    the cube engine on the card: 20 steps, same rebuilds, positions within
    2e-4; the slab forms launched on its path."""
    from md_neighbor_list_tpu_torch import DenseSimulator, MDConfig
    from md_neighbor_list_tpu_torch.parallel.dense_slab import \
        DenseSlabSimulator

    cfg = MDConfig(n=4096, rc=1.5, skin=0.2, temperature=0.8)
    _cuda.reset_launches()
    dd = DenseSlabSimulator(cfg, cap=16, device=card)
    sd = dd.run(dd.init(), 20, chunk=20)
    launches = dict(_cuda.LAUNCHES)
    cube = DenseSimulator(cfg, cap=16, device=card)
    cc = cube.run(cube.init(), 20, chunk=20)
    pos, _, _ = cube.to_system(cc)
    d = np.abs(dd.gather(sd).pos.cpu().numpy() - pos)
    assert np.minimum(d, dd.box.L - d).max() < 2e-4
    assert int(sd.n_rebuilds) == int(cc.n_rebuilds)
    assert launches["expand_slab"] == int(sd.n_rebuilds)
    assert launches["forces_half_slab"] >= 2 * 20 + 1
    assert launches["expand"] == launches["forces_half"] == 0


def _scattered_on_card(card, cap):
    """A rebuilt state on the card with its slots scattered inside each cell
    (no prefix): mc = 4 at cap 40, a cluster of cap - 12 in one cell of an
    mc = 3 box above."""
    if cap <= 64:
        pos, vel, pid = numpy_system(1728, seed=15, jitter=0.2)
    else:
        pos, vel, pid = clustered_system(cap - 12, seed=13, n=700)
    state, spec, _ = torch_state(pos, vel, pid, cap)
    state = dense_cells.DenseState(*(t.to(card) for t in state))
    new, _ = dense_cells.rebuild_dense(state, spec)
    sc = scatter_slots(new, spec, seed=cap)
    assert not torch.equal(sc.valid(), new.valid())
    return sc, spec


def _slab_of_cube(spec, p):
    return slab_kernels.SlabSpec(mc=spec.mc, nz=spec.mc // p, mc_z=spec.mc,
                                 cap=spec.cap, L=spec.L,
                                 cell_size=spec.cell_size,
                                 cell_z=spec.cell_size)


def _assert_half_forces(f, pe, f_p, pe_p):
    scale = max(float(f_p.abs().max()), 1.0)
    np.testing.assert_allclose(f.cpu(), f_p.cpu(), rtol=1e-4,
                               atol=2e-5 * scale)
    if pe is not None:
        pe_scale = max(float(pe_p.abs().max()), 1.0)
        np.testing.assert_allclose(pe.cpu(), pe_p.cpu(), rtol=1e-4,
                                   atol=2e-5 * pe_scale)


@pytest.mark.parametrize("cap", [40, 384, 480, 700])
def test_half_sweeps_on_scattered_slots(card, cap):
    """K3 (both forms, cube and P = 1 slab) and K4 test occupied slots
    only, found by x < OCCUPIED_BELOW wherever they sit in the cell: on a
    scattered-slot state each equals its plain version, parked slots get
    exactly zero force, PE and virial, and each wrapper launches once. At
    cap 700 the partner list no longer fits the shared memory in one piece
    and is staged in two passes (csrc/half_sweep.cuh)."""
    sc, spec = _scattered_on_card(card, cap)
    valid = sc.valid()
    before = dict(_cuda.LAUNCHES)
    f_p, pe_p = dense_force.forces_half_plain(sc.pos.cpu(), spec, RC, True)
    for want_pe in (False, True):
        f, pe = dense_force.dense_forces_half(sc.pos, spec, RC, want_pe)
        _assert_half_forces(f, pe, f_p, pe_p)
        assert float(f[:, ~valid].abs().sum()) == 0.0
    assert float(pe[~valid].abs().sum()) == 0.0
    pe4, vir4 = dense_force.dense_pe_virial(sc.pos, spec, RC)
    pe4_p, vir4_p = dense_force.pe_virial_half_plain(sc.pos.cpu(), spec, RC)
    _assert_half_forces(vir4, pe4, vir4_p, pe4_p)
    assert float(pe4[~valid].abs().sum() + vir4[~valid].abs().sum()) == 0.0
    # the slab forms at P = 1: [scattered cube | seam-shifted first layer]
    slab = _slab_of_cube(spec, 1)
    gpos = sc.pos[:, :spec.mc].clone()
    gpos[2] += float(np.float32(spec.L))
    ext_v = torch.cat([valid, valid[:spec.mc]])
    ext = slab_kernels._repark_ghost(torch.cat([sc.pos, gpos], dim=1), ext_v,
                                     slab)
    fs_p, pes_p = dense_force.forces_half_plain(ext.cpu(), slab, RC, True,
                                                zwrap=False)
    for want_pe in (False, True):
        f, pe = dense_force.dense_forces_half_slab(ext, slab, RC, want_pe)
        _assert_half_forces(f, pe, fs_p, pes_p)
        assert float(f[:, ~ext_v].abs().sum()) == 0.0
    assert float(pe[~valid].abs().sum()) == 0.0
    after = _cuda.LAUNCHES
    for name in ("forces_half", "forces_half_pe", "pe_virial_half",
                 "forces_half_slab", "forces_half_slab_pe"):
        assert after[name] == before[name] + 1, name


def test_slab_forms_nz1_on_scattered_slots(card):
    """nz = 1 slabs (P = mc = 4) of a scattered-slot cube state, each
    re-parked at slab-local rows with the next slab's first layer as ghost:
    K3's slab forms equal their plain versions on every slab, and the slabs'
    forces with the seams handed on equal the cube's K3."""
    sc, spec = _scattered_on_card(card, 40)
    p = spec.mc
    slab = _slab_of_cube(spec, p)
    valid, mc = sc.valid(), spec.mc
    park = dense_cells.park_lattice(slab, card)
    forces, seams = [], []
    for r in range(p):
        own = slice(r * mc, (r + 1) * mc)
        pos = torch.where(valid[own][None], sc.pos[:, own], park)
        g = slice(((r + 1) % p) * mc, ((r + 1) % p + 1) * mc)
        gpos = sc.pos[:, g].clone()
        if r == p - 1:
            gpos[2] += float(np.float32(spec.L))
        ext_v = torch.cat([valid[own], valid[g]])
        ext = slab_kernels._repark_ghost(torch.cat([pos, gpos], dim=1),
                                         ext_v, slab)
        f_p, pe_p = dense_force.forces_half_plain(ext.cpu(), slab, RC, True,
                                                  zwrap=False)
        for want_pe in (False, True):
            f, pe = dense_force.dense_forces_half_slab(ext, slab, RC, want_pe)
            _assert_half_forces(f, pe, f_p, pe_p)
            assert float(f[:, ~ext_v].abs().sum()) == 0.0
        assert float(pe[~valid[own]].abs().sum()) == 0.0
        forces.append(f[:, :mc].clone())
        seams.append(f[:, mc:])
    for r in range(p):
        forces[(r + 1) % p] += seams[r]
    f_cube, _ = dense_force.dense_forces_half(sc.pos, spec, RC)
    scale = max(float(f_cube.abs().max()), 1.0)
    np.testing.assert_allclose(torch.cat(forces, dim=1).cpu(), f_cube.cpu(),
                               rtol=1e-4, atol=2e-5 * scale)


@pytest.mark.parametrize("cap", [40, 384, 480, 700])
def test_lists_and_full_sweep_on_scattered_slots(card, cap):
    """K2 (cube and P = 1 slab forms) and K6 (both forms) stage occupied or
    valid slots only, wherever they sit in the cell: on a scattered-slot
    state K2's masks and counts equal the plain version's bitwise, K6 equals
    its plain version to rounding with invalid slots exactly zero, two K6
    launches are bitwise equal, and each wrapper launches once a call. At
    cap 384 and above K6, and at cap 700 K2, stage their partners in passes
    (csrc/lists_half.cu, csrc/force_full.cu)."""
    sc, spec = _scattered_on_card(card, cap)
    valid = sc.valid()
    before = dict(_cuda.LAUNCHES)
    counts, masks = dense_force.dense_lists_half(sc.pos, spec, RS)
    counts_p, masks_p = dense_force.lists_half_plain(sc.pos.cpu(), spec, RS)
    assert torch.equal(counts.cpu(), counts_p)
    assert torch.equal(masks.cpu(), masks_p)
    assert int(counts_p.sum()) > 0
    slab = _slab_of_cube(spec, 1)
    gpos = sc.pos[:, :spec.mc].clone()
    gpos[2] += float(np.float32(spec.L))
    ext_v = torch.cat([valid, valid[:spec.mc]])
    ext = slab_kernels._repark_ghost(torch.cat([sc.pos, gpos], dim=1), ext_v,
                                     slab)
    counts, masks = dense_force.dense_lists_half_slab(ext, slab, RS)
    counts_p, masks_p = dense_force.lists_half_plain(ext.cpu(), slab, RS,
                                                     zwrap=False)
    assert torch.equal(counts.cpu(), counts_p)
    assert torch.equal(masks.cpu(), masks_p)
    f_p, pe_p = dense_force.forces_full_plain(sc.pos.cpu(), valid.cpu(), spec,
                                              RC, True)
    for want_pe in (False, True):
        f, pe = dense_force.dense_forces(sc.pos, valid, spec, RC, want_pe)
        again, pe_again = dense_force.dense_forces(sc.pos, valid, spec, RC,
                                                   want_pe)
        assert torch.equal(f, again)
        _assert_half_forces(f, pe, f_p, pe_p)
        assert float(f[:, ~valid].abs().sum()) == 0.0
    assert torch.equal(pe, pe_again)
    assert float(pe[~valid].abs().sum()) == 0.0
    after = _cuda.LAUNCHES
    for name, times in (("lists_half", 1), ("lists_half_slab", 1),
                        ("force_full", 2), ("force_full_pe", 2)):
        assert after[name] == before[name] + times, name
