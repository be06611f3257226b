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
from md_neighbor_list_tpu_torch.utils import graphs
from torch_port_util import (BAND_N, BAND_RHO, CASES, RC, RS,
                             clustered_system, cutoff_band_inputs,
                             numpy_system, ops_build, scatter_slots,
                             torch_state)

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
    """3*cap > 1024 (12 and 15 mask words), caps at which the list,
    half-count and full-sweep kernels stage their partners in passes: every
    kernel against its plain version, a cluster of more than 341 particles
    in one cell at mc = 3."""
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


@pytest.mark.parametrize("cap", [28, 40, 41, 384, 700])
def test_expand_forms_at_any_cap(card, cap):
    """K1 and its slab form K9-K1, reading the records through the sort's
    permutation, bitwise against their plain versions on a stream of n = 1000
    packed records at mc = 3: one cell holds cap + 5 records (its run is cut at cap; at cap 28 every
    cell is over), so the rows take the 16-byte stores (mc*cap % 4 == 0)
    at caps 28, 40, 384 and 700 and the scalar ones at cap 41. The slab form
    is the first of three one-layer slabs: it owns the crowded cell, and its
    stream holds records keyed below its rows (the top layer, across the
    ring) and beyond them (what is left of the middle layer)."""
    from md_neighbor_list_tpu_torch.core.box import Box

    n = 1000
    pos, vel, pid = clustered_system(cap + 5, seed=16, n=n)
    spec = dense_cells.make_spec(Box.from_density(n, 1.0), RS, cap)
    assert spec.mc == 3
    rec = torch.remainder(torch.from_numpy(pos.T.copy()), spec.L)
    rec_vel, pids = torch.from_numpy(vel.T.copy()), torch.from_numpy(pid)
    # the packed records as a stream (cell_keys is elementwise)
    keys = dense_cells.cell_keys(dense_cells.DenseState(rec, rec_vel, pids),
                                 spec)
    keys_s, order = torch.sort(keys, stable=True)
    args = (rec, rec_vel, pids, order, keys_s,
            dense_cells.row_starts(keys_s, spec))
    before = dict(_cuda.LAUNCHES)
    got = dense_cells.expand(*(a.to(card) for a in args), spec)
    want = dense_cells.expand_plain(*args, spec)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    assert int((got[1] >= 0).sum()) < n

    slab = _slab_of_cube(spec, 3)
    skeys = slab_kernels.slab_keys(rec, torch.ones(n, dtype=torch.bool), slab,
                                   0)
    st, srs = slab_kernels.slab_sort_expand(
        skeys.to(card), rec.to(card), rec_vel.to(card), pids.to(card), slab)
    plain, srs_p = slab_kernels.slab_sort_expand(skeys, rec, rec_vel, pids,
                                                 slab)
    for a, b in zip(st, plain):
        assert torch.equal(a.cpu(), b)
    base = slab.mc * slab.mc
    assert int(srs_p[0]) > 0  # records keyed below key_base
    owned = skeys[(skeys >= base) & (skeys < base + slab.rows * slab.mc)]
    assert int(st.valid().sum()) == int(torch.bincount(
        owned - base).clamp(max=cap).sum()) > 0  # each cell's run cut at cap
    after = _cuda.LAUNCHES
    assert after["expand"] == before["expand"] + 1
    assert after["expand_slab"] == before["expand_slab"] + 1


@pytest.mark.parametrize("cap", [32, 40, 41, 384, 700])
def test_merge_at_any_cap(card, cap):
    """K8, and K1 on the mover stream, bitwise against their plain versions,
    and the incremental rebuild bitwise against its order-exact twin: cell
    (0, 0, 0) holds cap stayers (a full cell) and a particle from the far
    corner moves into it, so its stayers and movers exceed cap and the
    mover is dropped; the other particles drift by about 0.3."""
    n = 1728
    pos, vel, pid = clustered_system(cap, seed=17, n=n)
    state, spec, _ = torch_state(pos, vel, pid, cap)
    state, _ = dense_cells.rebuild_dense(
        dense_cells.DenseState(*(t.to(card) for t in state)), spec)
    valid = state.valid()
    assert int(valid[0, 0].sum()) == cap
    drift = np.random.default_rng(cap).normal(0.0, 0.3, state.pos.shape)
    drift = torch.from_numpy(drift.astype(np.float32)).to(card)
    moving = valid.clone()
    moving[0, 0] = False  # the full cell's particles stay
    drift = torch.where(moving[None], drift, 0.0)
    r, x, s = (int(i) for i in torch.nonzero(moving)[-1])
    drift[:, r, x, s] = 0.5 * spec.cell_size - state.pos[:, r, x, s]
    state = state._replace(pos=state.pos + drift)

    before = _cuda.LAUNCHES["merge"]
    new, _ = incremental.rebuild_dense_incremental(state, spec)
    assert _cuda.LAUNCHES["merge"] == before + 1
    twin = incremental.rebuild_reference_incremental(state, spec)
    for a, b in zip(new, twin):
        assert torch.equal(a, b)
    assert int(new.valid().sum()) < n and int(new.valid()[0, 0].sum()) == cap

    args, rs = incremental.merge_inputs(state, spec)
    args_p, rs_p = incremental.merge_inputs(
        dense_cells.DenseState(*(t.cpu() for t in state)), spec)
    assert torch.equal(rs.cpu(), rs_p)
    for a, b in zip((*args[0], args[1], *args[2]),
                    (*args_p[0], args_p[1], *args_p[2])):
        assert torch.equal(a.cpu(), b)
    got = incremental.merge(*args, spec)
    want = incremental.merge_plain(*args_p, spec)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("cap", [32, 40, 384])
def test_wrap_keys_and_window_count_match_plain_versions(card, cap):
    """The incremental rebuild's two small kernels (``csrc/incremental.cu``)
    bitwise against their plain versions on the card and on the CPU: the
    mover keys of a drifted state at mc = 7 (R = 49, a tail group), some of
    whose positions lie on cell faces, on the box's faces, past them and just
    below zero, and of a ``from_packed`` seed at mc = 8; the window
    predicate with the engine's flags and counts on each one's mover stream
    (the drifted one's holds, the seed's trips), from counts that are not
    zero."""
    cases = []
    for n in (9261, 13824):  # L = 21, mc = 7; L = 24, mc = 8
        pos, vel, pid = numpy_system(n, seed=18)
        seed, spec, _ = torch_state(pos, vel, pid, cap)
        if n == 13824:
            cases.append((seed, spec, True))
            continue
        state = dense_cells.rebuild_dense(seed, spec)[0]
        drift = np.random.default_rng(cap).normal(0.0, 0.2, state.pos.shape)
        drift = np.where(state.valid().numpy()[None], drift, 0.0)
        state = state._replace(pos=state.pos + torch.from_numpy(
            drift.astype(np.float32)))
        held = torch.nonzero(state.valid().reshape(-1)).squeeze(1)
        flat = state.pos.reshape(3, -1)
        L, cell = np.float32(spec.L), np.float32(spec.cell_size)
        edges = [0.0, -0.0, float(L), float(np.nextafter(L, np.float32(0))),
                 -1e-7, float(3 * cell), float(np.nextafter(3 * cell, L)),
                 float(L) + 1e-3, -float(cell)]
        for k, v in enumerate(edges):
            flat[k % 3, held[k]] = v
        cases.append((state, spec, False))
    for case, spec, trips in cases:
        on_card = dense_cells.DenseState(*(t.to(card) for t in case))
        want = incremental.wrap_keys_plain(on_card, spec)
        for got in (incremental.wrap_keys(on_card, spec),
                    incremental.wrap_keys_plain(case, spec)):
            for a, b in zip((*got[0], got[1], got[2]),
                            (*want[0], want[1], want[2])):
                assert torch.equal(a.to(card), b)
        _, row_start = incremental.merge_inputs(on_card, spec)
        outs = []
        for run in (incremental.window_count, incremental.window_count_plain):
            window = torch.zeros(2, dtype=torch.bool, device=card)
            taken = torch.tensor([5, 7], dtype=torch.int64, device=card)
            movers = torch.tensor(11, dtype=torch.int64, device=card)
            run(row_start, window, taken, movers)
            outs.append((window.tolist(), taken.tolist(), int(movers)))
        assert outs[0] == outs[1]
        assert outs[0][0] == [trips, not trips]
        assert outs[0][2] == 11 + int(row_start[-1]) > 11


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
    rec_vel = torch.from_numpy(vel.T.copy()).to(card)
    pids = torch.from_numpy(pid).to(card)
    valid = torch.ones(n, dtype=torch.bool, device=card)
    states = []
    for r in range(p):
        before = _cuda.LAUNCHES["expand_slab"]
        keys = slab_kernels.slab_keys(rec, valid, spec, r * nz)
        st, _ = slab_kernels.slab_sort_expand(keys, rec, rec_vel, pids, spec)
        assert _cuda.LAUNCHES["expand_slab"] == before + 1
        plain, _ = slab_kernels.slab_sort_expand(
            keys.cpu(), rec.cpu(), rec_vel.cpu(), pids.cpu(), spec)
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
    2e-4; the slab forms launched on its path (its chunk a captured graph,
    whose warm-up takes the rebuild branch once)."""
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
    warm = sum(b.get("expand_slab", 0) for b in dd._runner.graph.per_body)
    assert warm == 1
    assert launches["expand_slab"] == int(sd.n_rebuilds) + warm
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
    """K2 (cube and P = 1 slab forms), K5, K6 (both forms) and K7 stage
    occupied or valid slots only, wherever they sit in the cell: on a
    scattered-slot state K2's masks and counts equal the plain version's
    bitwise, K5 equals its plain version and K2's counts bitwise, K7 its
    plain version bitwise, K6 its plain version to rounding, invalid slots
    get exactly zero, two K6 launches are bitwise equal, and each wrapper
    launches once a call. At cap 384 and above K2, K6 and K7, and from cap
    480 K5, stage their partners in passes (csrc/lists_half.cu,
    csrc/force_full.cu)."""
    sc, spec = _scattered_on_card(card, cap)
    valid = sc.valid()
    before = dict(_cuda.LAUNCHES)
    counts, masks = dense_force.dense_lists_half(sc.pos, spec, RS)
    counts_p, masks_p = dense_force.lists_half_plain(sc.pos.cpu(), spec, RS)
    assert torch.equal(counts.cpu(), counts_p)
    assert torch.equal(masks.cpu(), masks_p)
    assert int(counts_p.sum()) > 0
    half = dense_force.dense_counts_half(sc.pos, spec, RS)
    assert torch.equal(half.cpu(), dense_force.counts_half_plain(
        sc.pos.cpu(), spec, RS))
    assert torch.equal(half, counts)
    full = dense_force.dense_counts(sc.pos, valid, spec, RS)
    assert torch.equal(full.cpu(), dense_force.counts_full_plain(
        sc.pos.cpu(), valid.cpu(), spec, RS))
    assert int(full[~valid].abs().sum()) == 0 and int(full.sum()) > 0
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
                        ("count_half", 1), ("count_full", 1),
                        ("force_full", 2), ("force_full_pe", 2)):
        assert after[name] == before[name] + times, name


def test_cutoff_band_pair_left_out_on_the_card(card):
    """The pair of ``tests/test_torch_cutoff_band.py`` whose step-rounded f32
    r2 is the cutoff: K2, K5 and K7 leave it out on the card, bitwise as
    their plain versions do (their r2 is rounded step by step, never
    contracted into fused multiply-adds)."""
    pos, _, rs = cutoff_band_inputs()
    n = BAND_N
    state, spec, _ = torch_state(pos, np.zeros_like(pos),
                                 np.arange(n, dtype=np.int32), 32, rs=rs,
                                 rho=BAND_RHO)
    state = dense_cells.DenseState(*(t.to(card) for t in state))
    new, _ = dense_cells.rebuild_dense(state, spec)
    valid = new.valid()
    assert int(valid.sum()) == n
    counts, masks = dense_force.dense_lists_half(new.pos, spec, rs)
    counts_p, masks_p = dense_force.lists_half_plain(new.pos, spec, rs)
    assert torch.equal(counts, counts_p) and torch.equal(masks, masks_p)
    half = dense_force.dense_counts_half(new.pos, spec, rs)
    assert torch.equal(half, dense_force.counts_half_plain(new.pos, spec, rs))
    full = dense_force.dense_counts(new.pos, valid, spec, rs)
    assert torch.equal(full, dense_force.counts_full_plain(new.pos, valid,
                                                           spec, rs))
    assert int(counts[valid].sum()) == int(half[valid].sum()) == 55_954
    assert int(full[valid].sum()) == 2 * 55_954


HOT = dict(dt=0.005, temperature=2.0)  # a rebuild every few steps


def _strict_replays(monkeypatch):
    """Every ``StepGraph.replay`` under ``set_sync_debug_mode("error")``: a
    host read inside a chunk raises."""
    replay = graphs.StepGraph.replay

    def strict(self, nsteps):
        torch.cuda.set_sync_debug_mode("error")
        try:
            replay(self, nsteps)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    monkeypatch.setattr(graphs.StepGraph, "replay", strict)


@pytest.mark.parametrize("engine, cap", [("dense", 32), ("dense", 384),
                                         ("incremental", 32), ("xla", None)])
def test_graph_chunk_matches_eager_steps(card, engine, cap, monkeypatch):
    """``run`` (one captured step replayed, the rebuild a conditional node)
    against a loop of the eager ``step_fn`` from one carry: the same
    rebuilds and branch counts, positions within 5e-4 (K3's and the xla
    scatter's reactions are float atomics), no host read inside the chunk,
    and the launches counted under replay those of the eager loop plus the
    capture's warm-up, which takes every branch once. At cap 384 the sweeps
    opt into more than 48 KB of shared memory while being captured."""
    from md_neighbor_list_tpu_torch import (DenseSimulator, MDConfig,
                                            Simulator)
    from md_neighbor_list_tpu_torch.models import dense_lj, lj_nve
    from md_neighbor_list_tpu_torch.utils import convert

    n, steps = 1728, 40
    pos, vel, pid = numpy_system(n, seed=5)
    system = convert.system_from_numpy(pos, 1.4 * vel, np.zeros_like(pos),
                                       pid, device=card)
    if engine == "xla":
        sim = Simulator(MDConfig(n=n, **HOT), device=card)
        clone, rebuilds = lj_nve._clone, lambda c: int(c.nbr.n_rebuilds)

        def by_pid(c):
            out = np.empty((n, 3), np.float32)
            out[c.system.pid.cpu().numpy()] = c.system.pos.cpu().numpy()
            return out
    else:
        sim = DenseSimulator(MDConfig(n=n, **HOT), cap=cap, device=card,
                             incremental=engine == "incremental")
        clone, rebuilds = dense_lj._clone, lambda c: int(c.n_rebuilds)

        def by_pid(c):
            return sim.to_system(c)[0]
    carry = sim.build(system)
    eager, graph = clone(carry), clone(carry)

    taken = [getattr(sim, "_taken", torch.zeros(2)).tolist()]
    _cuda.reset_launches()
    for _ in range(steps):
        eager = sim.step_fn(eager)
    torch.cuda.synchronize()
    eager_launches = dict(_cuda.LAUNCHES)
    taken.append(getattr(sim, "_taken", torch.zeros(2)).tolist())

    _strict_replays(monkeypatch)
    _cuda.reset_launches()
    graph = sim.run(graph, steps, chunk=steps)
    torch.cuda.synchronize()
    graph_launches = dict(_cuda.LAUNCHES)
    taken.append(getattr(sim, "_taken", torch.zeros(2)).tolist())

    assert sim._runner.captures == 1
    assert rebuilds(graph) == rebuilds(eager) > rebuilds(carry) + 1
    if engine == "incremental":
        assert [b - a for a, b in zip(taken[0], taken[1])] == \
            [b - a for a, b in zip(taken[1], taken[2])]
    d = np.abs(by_pid(graph) - by_pid(eager))
    assert np.minimum(d, sim.box.L - d).max() < 5e-4
    captured = sim._runner.graph
    for name, count in graph_launches.items():
        warm = captured.per_step.get(name, 0) + sum(
            b.get(name, 0) for b in captured.per_body)
        assert count == eager_launches[name] + warm, name
    if engine != "xla":  # the step's force reads the list
        assert graph_launches["forces_list"] == steps + 1
        assert graph_launches["forces_half"] == 0
        # the integrator: two passes a step
        assert graph_launches["kick_drift_vote"] == steps + 1
        assert graph_launches["kick"] == steps + 1


def test_traced_chunk_marks_each_rebuild_on_the_device(card):
    """A chunk replayed under ``torch.profiler``: one pair of the rebuild's
    marker kernels (``csrc/span.cu``) for each rebuild the chunk counted,
    K1 between the two of a pair, the chunk's host spans among the host
    events, and no device event named like a host span (a span encloses no
    launch, so the tracer gives it no device-side range). Outside the
    rebuilds the step's elementwise work is the integrator's two kernels,
    once a step each: no add, reduction, ``where`` or compare kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from md_neighbor_list_tpu_torch import DenseSimulator, MDConfig
    from md_neighbor_list_tpu_torch.utils import convert, trace

    n = 1728
    pos, vel, pid = numpy_system(n, seed=5)
    sim = DenseSimulator(MDConfig(n=n, **HOT), cap=32, device=card)
    carry = sim.build(convert.system_from_numpy(
        pos, 1.4 * vel, np.zeros_like(pos), pid, device=card))
    carry = sim.run(carry, 10, chunk=10)  # the capture
    before = trace.counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        carry = sim.run(carry, 40, chunk=40)
        torch.cuda.synchronize()
    rebuilds = trace.counters()["rebuilds"] - before["rebuilds"]
    assert rebuilds >= 2 and trace.counters()["captures"] == \
        before["captures"]
    dev = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in prof.events() if e.device_type == DeviceType.CUDA)
    begins = [(s, e) for s, e, name in dev if "span_begin_rebuild" in name]
    ends = [(s, e) for s, e, name in dev if "span_end_rebuild" in name]
    assert len(begins) == len(ends) == rebuilds
    for (_, a), (b, _) in zip(begins, ends):
        assert a <= b
        assert any("expand_kernel" in name and a <= s and e <= b
                   for s, e, name in dev)
    assert not [name for _, _, name in dev if name.startswith(trace.PREFIX)]
    # the full engine marks no incremental pass
    assert not [name for _, _, name in dev if "span_begin_increment" in name
                or "span_end_increment" in name]
    spans = [(a, b) for (a, _), (_, b) in zip(begins, ends)]
    outside = [name for s, e, name in dev
               if not any(a <= s and e <= b for a, b in spans)]
    for word in ("CUDAFunctor_add", "reduce_kernel", "where", "Compare"):
        assert not [name for name in outside if word in name], word
    assert sum("kick_drift_vote_kernel" in name for name in outside) == 40
    assert sum("kick_kernel" in name for name in outside) == 40
    host = [e.name for e in prof.events()
            if e.device_type != DeviceType.CUDA]
    for name in ("chunk", "chunk.snapshot", "chunk.launch", "chunk.settle"):
        assert host.count(f"{trace.PREFIX}{name}.begin") == 1, name
        assert host.count(f"{trace.PREFIX}{name}.end") == 1, name


def test_traced_incremental_chunk_marks_the_rebuild_and_the_increment(card):
    """The incremental engine in a traced chunk: one pair of ``rebuild``
    markers for each rebuild, opened in the branch that makes the
    incremental pass and closed after the branch that takes its state, so
    that it holds K8 (``merge_kernel``) and the step's list kernel; inside
    each, one pair of ``increment`` markers holding K8 and no list kernel;
    K8 once per rebuild kept. The captured list build that
    ``_rebuild_and_lists`` replays holds one ``increment`` pair and no
    ``rebuild`` marker."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from md_neighbor_list_tpu_torch import DenseSimulator, MDConfig
    from md_neighbor_list_tpu_torch.utils import convert, trace

    def marks(prof, name):
        dev = sorted((e.time_range.start, e.time_range.end, e.name)
                     for e in prof.events()
                     if e.device_type == DeviceType.CUDA)
        return dev, ([(s, e) for s, e, m in dev if f"span_begin_{name}" in m],
                     [(s, e) for s, e, m in dev if f"span_end_{name}" in m])

    n = 1728
    pos, vel, pid = numpy_system(n, seed=5)
    sim = DenseSimulator(MDConfig(n=n, **HOT), cap=32, device=card,
                         incremental=True)
    carry = sim.build(convert.system_from_numpy(
        pos, 1.4 * vel, np.zeros_like(pos), pid, device=card))
    carry = sim.run(carry, 10, chunk=10)  # the capture
    kept = sim.incremental_rebuilds  # brings the counters up to date
    before = trace.counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        carry = sim.run(carry, 40, chunk=40)
        torch.cuda.synchronize()
    got = {k: trace.counters()[k] - before[k] for k in before}
    rebuilds = got["rebuilds"]
    assert rebuilds >= 2 and got["full_fallbacks"] == 0
    assert got["incremental_rebuilds"] == rebuilds == \
        sim.incremental_rebuilds - kept
    dev, (rb, re) = marks(prof, "rebuild")
    _, (ib, ie) = marks(prof, "increment")
    assert len(rb) == len(re) == len(ib) == len(ie) == rebuilds
    for (_, a), (b, _), (i0, i1), (i2, i3) in zip(rb, re, ib, ie):
        assert a <= i0 and i1 <= i2 and i3 <= b  # increment inside rebuild
        rebuild = [m for s, e, m in dev if a <= s and e <= b]
        increment = [m for s, e, m in dev if i1 <= s and e <= i2]
        for inside in (rebuild, increment):
            assert sum("merge_kernel" in m for m in inside) == 1, inside
        assert any("list_sparse_kernel" in m for m in rebuild), rebuild
        assert not any("list_sparse_kernel" in m for m in increment)
    assert sum("merge_kernel" in m for _, _, m in dev) == rebuilds
    sim._rebuild_and_lists(carry.state)  # its capture
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sim._rebuild_and_lists(carry.state)
        torch.cuda.synchronize()
    dev, (ib, ie) = marks(prof, "increment")
    _, (rb, re) = marks(prof, "rebuild")
    assert len(ib) == len(ie) == 1 and rb == re == []
    (_, i1), (i2, _) = ib[0], ie[0]
    assert [m for s, e, m in dev if "merge_kernel" in m and i1 <= s
            and e <= i2]


def test_traced_chunk_marks_the_half_list_inside_each_rebuild(card):
    """The ``lammps_lj`` preset at a small fcc shape (n = 4 * 12^3, 7 cells
    a side): in a traced chunk each pair of ``rebuild`` markers holds one
    pair of ``halflist`` markers (``csrc/span.cu``) around the list's kernel
    (``list_sparse_kernel``) and no K2 nor any kernel of the former count
    and pack, and the captured list build that ``_rebuild_and_lists``
    replays launches K2 and no ``halflist`` marker."""
    import dataclasses

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from md_neighbor_list_tpu_torch import DenseSimulator, PRESETS
    from md_neighbor_list_tpu_torch.utils import trace

    def marks(prof, name):
        dev = sorted((e.time_range.start, e.time_range.end, e.name)
                     for e in prof.events()
                     if e.device_type == DeviceType.CUDA)
        return dev, ([(s, e) for s, e, m in dev if f"span_begin_{name}" in m],
                     [(s, e) for s, e, m in dev if f"span_end_{name}" in m])

    cfg = dataclasses.replace(PRESETS["lammps_lj"], n=4 * 12**3)
    sim = DenseSimulator(cfg, device=card)
    carry = sim.init(torch.Generator(card).manual_seed(7))
    carry = sim.run(carry, 20, chunk=20)  # the capture, the melt's start
    before = trace.counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        carry = sim.run(carry, 40, chunk=40)
        torch.cuda.synchronize()
    rebuilds = trace.counters()["rebuilds"] - before["rebuilds"]
    assert rebuilds >= 2
    dev, (rb, re) = marks(prof, "rebuild")
    _, (hb, he) = marks(prof, "halflist")
    assert len(rb) == len(re) == len(hb) == len(he) == rebuilds
    for (_, a), (b, _), (h0, h1), (h2, h3) in zip(rb, re, hb, he):
        assert a <= h0 and h1 <= h2 and h3 <= b  # halflist inside rebuild
        inside = [m for s, e, m in dev if h1 <= s and e <= h2]
        assert any("list_sparse_kernel" in m for m in inside), inside
        for kernel in ("lists_half_kernel", "list_pack_kernel"):
            assert not any(kernel in m for m in inside), kernel
    # the timed list build carries no marker
    sim._rebuild_and_lists(carry.state)  # its capture
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sim._rebuild_and_lists(carry.state)
        torch.cuda.synchronize()
    dev, (hb, he) = marks(prof, "halflist")
    assert any("lists_half_kernel" in m for _, _, m in dev)
    assert hb == he == []


def test_graph_recaptured_after_the_capacity_grows(card):
    """Rows that fit the start exactly overflow inside a chunk (rs = 1.42
    next to the lattice's second shell, as in ``test_torch_simulator``): the
    chunk rolls back, the capacity grows and a new graph is captured for the
    rebuilt carry; the run ends where an engine with ample rows ends."""
    from md_neighbor_list_tpu_torch import MDConfig, Simulator
    from md_neighbor_list_tpu_torch.core.capacity import Capacity
    from md_neighbor_list_tpu_torch.utils import convert

    n = 1728
    pos, vel, pid = numpy_system(n, seed=3)
    cfg = MDConfig(n=n, rho=1.0, dt=0.002, skin=0.12, rc=1.3,
                   temperature=1.0)

    def system():
        return convert.system_from_numpy(pos, vel, np.zeros_like(pos), pid,
                                         device=card)

    ample = Simulator(cfg, device=card)
    want = ample.run(ample.build(system()), 20, chunk=10)
    start = ample.build(system())
    tight = Capacity(neighbors=int(start.nbr.max_count),
                     cell=ample.capacity.cell)
    sim = Simulator(cfg, capacity=tight, device=card)
    carry = sim.run(sim.build(system()), 20, chunk=10)
    assert sim.capacity.neighbors > tight.neighbors
    assert sim._runner.captures >= 2 and not bool(carry.nbr.overflow)
    assert int(carry.nbr.n_rebuilds) == int(want.nbr.n_rebuilds)
    got = np.empty((n, 3), np.float32)
    got[carry.system.pid.cpu().numpy()] = carry.system.pos.cpu().numpy()
    ref = np.empty((n, 3), np.float32)
    ref[want.system.pid.cpu().numpy()] = want.system.pos.cpu().numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-4)


@pytest.mark.parametrize("ring_kind", ["none", "nccl_one_rank", "local"])
def test_dense_slab_graph_matches_eager_steps(card, ring_kind, monkeypatch):
    """The slab engine at P = 1 (nz = 4): ``run`` against a loop of the eager
    ``step_fn`` from one carry. With no group and on a one-rank NCCL group
    (its ``all_reduce`` calls captured in the step, outside the rebuild's
    conditional body) one graph is captured and replayed with no host read; on a
    ``LocalRing`` the step runs eagerly and nothing is captured. The same
    rebuilds, positions within 5e-4, and under replay the launches of the
    eager loop plus the capture's warm-up."""
    import torch.distributed as dist

    from md_neighbor_list_tpu_torch import MDConfig
    from md_neighbor_list_tpu_torch.parallel import dense_slab, mesh
    from md_neighbor_list_tpu_torch.utils import convert

    n, steps = 1728, 40
    pos, vel, pid = numpy_system(n, seed=5)
    system = convert.system_from_numpy(pos, 1.4 * vel, np.zeros_like(pos),
                                       pid, device=card)

    def run(ring):
        sim = dense_slab.DenseSlabSimulator(MDConfig(n=n, **HOT), cap=48,
                                            device=card, ring=ring)
        carry = sim.build(system)
        eager, graph = dense_slab._clone(carry), dense_slab._clone(carry)
        _cuda.reset_launches()
        for _ in range(steps):
            eager = sim.step_fn(eager)
        torch.cuda.synchronize()
        eager_launches = dict(_cuda.LAUNCHES)
        _cuda.reset_launches()
        graph = sim.run(graph, steps, chunk=steps)
        torch.cuda.synchronize()
        graph_launches = dict(_cuda.LAUNCHES)
        d = np.abs(sim.gather(graph).pos.cpu().numpy()
                   - sim.gather(eager).pos.cpu().numpy())
        gap = float(np.minimum(d, sim.box.L - d).max())
        return sim, carry, eager, graph, eager_launches, graph_launches, gap

    _strict_replays(monkeypatch)
    if ring_kind == "local":
        sim, carry, eager, graph, eager_l, graph_l, gap = mesh.run_ranks(
            1, run, device=card)[0]
    elif ring_kind == "none":
        sim, carry, eager, graph, eager_l, graph_l, gap = run(None)
    else:
        ring = mesh.init_ring(card, world_size=1, rank=0,
                              store=dist.HashStore())
        try:
            assert ring.capturable
            sim, carry, eager, graph, eager_l, graph_l, gap = run(ring)
        finally:
            dist.destroy_process_group()
    assert sim.spec.nz == 4 and not bool(graph.overflow)
    assert int(graph.n_rebuilds) == int(eager.n_rebuilds) > \
        int(carry.n_rebuilds) + 1
    assert gap < 5e-4
    if ring_kind == "local":
        assert sim._runner.captures == 0 and graph_l == eager_l
        return
    assert sim._runner.captures == 1
    captured = sim._runner.graph
    for name, count in graph_l.items():
        warm = captured.per_step.get(name, 0) + sum(
            b.get(name, 0) for b in captured.per_body)
        assert count == eager_l[name] + warm, name
    assert graph_l["forces_half_slab"] == 2 * (steps + 1)


def test_dense_slab_p1_graph_over_chunks_matches_its_eager_twin(card,
                                                                monkeypatch):
    """The slab step with every exchange outside its branch, at P = 1 on a
    one-rank NCCL group: 40 steps by ``run`` in four chunks (one capture,
    replayed by every chunk) against 40 eager steps from one carry. The
    same rebuilds, none of the particles migrated, each kept once,
    positions within 5e-4."""
    import torch.distributed as dist

    from md_neighbor_list_tpu_torch import MDConfig
    from md_neighbor_list_tpu_torch.parallel import dense_slab, mesh
    from md_neighbor_list_tpu_torch.utils import convert

    n, steps = 1728, 40
    pos, vel, pid = numpy_system(n, seed=6)
    system = convert.system_from_numpy(pos, 1.4 * vel, np.zeros_like(pos),
                                       pid, device=card)
    _strict_replays(monkeypatch)
    ring = mesh.init_ring(card, world_size=1, rank=0, store=dist.HashStore())
    try:
        sim = dense_slab.DenseSlabSimulator(MDConfig(n=n, **HOT), cap=48,
                                            device=card, ring=ring)
        carry = sim.build(system)
        eager, graph = dense_slab._clone(carry), dense_slab._clone(carry)
        for _ in range(steps):
            eager = sim.step_fn(eager)
        graph = sim.run(graph, steps, chunk=10)
        torch.cuda.synchronize()
        d = np.abs(sim.gather(graph).pos.cpu().numpy()
                   - sim.gather(eager).pos.cpu().numpy())
        gap = float(np.minimum(d, sim.box.L - d).max())
    finally:
        dist.destroy_process_group()
    assert sim._runner.captures == 1
    assert int(graph.n_rebuilds) == int(eager.n_rebuilds) > \
        int(carry.n_rebuilds) + 1
    assert int(graph.n_migrated) == int(eager.n_migrated) == 0
    assert int((graph.pid >= 0).sum()) == n and not bool(graph.overflow)
    assert gap < 5e-4


def test_ring_exchange_in_a_body_is_refused_on_the_card(card):
    """A step whose branch body makes a ring reduction, on a one-rank NCCL
    group: the body's capture raises (a step's collectives run outside its
    branches), and nothing steps eagerly instead."""
    import torch.distributed as dist

    from md_neighbor_list_tpu_torch.parallel import mesh

    ring = mesh.init_ring(card, world_size=1, rank=0, store=dist.HashStore())
    try:
        x = torch.zeros((), device=card)

        def step(cond):
            x.add_(1.0)
            cond(x > 0.0, lambda: x.copy_(ring.sum(x)))

        runner = graphs.ChunkRunner()
        with pytest.raises(RuntimeError, match="inside a conditional body"):
            runner.run(step, 5, [x], capturable=ring.capturable)
        torch.cuda.synchronize()
        assert float(x) == 0.0 and runner.captures == 0
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("engine", ["dense_slab", "slab"])
def test_ring_check_on_two_cards_or_more(card, engine):
    """Both slab engines' captured steps on an NCCL ring of P = min(4, cards)
    processes (``parallel/ring_check.py`` under ``torch.distributed.run``,
    100 steps each way at ``c4_sorted``): exit 0, one capture, the checks
    held. NCCL takes one card a rank, so one card cannot run it."""
    import json
    import os
    import signal
    import subprocess
    import sys

    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip(f"needs two CUDA devices or more, {cards} here: an NCCL "
                    "rank takes a card of its own")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={min(4, cards)}", "-m",
         "md_neighbor_list_tpu_torch.parallel.ring_check", "--engine",
         engine, "--preset", "c4_sorted", "--steps", "100"],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        out, err = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f"ring_check {engine}: no end within 300 s")
    assert proc.returncode == 0, err[-3000:]
    result = json.loads(out.strip().splitlines()[-1])
    assert result["ok"] and result["captures"] == 1, result
    assert result["rebuilds_graph"] == result["rebuilds_eager"] >= 1


@pytest.mark.parametrize("incremental", [False, True])
def test_captured_build_equals_the_eager_twin(card, incremental,
                                              monkeypatch):
    """``_rebuild_and_lists`` on the card (the caller's state copied in, one
    replay of the captured build) against the build the ops make
    (``ops_build``), from a state whose mover stream trips the window
    predicate and from a drifted one that does not: state, counts, masks and
    total bitwise, the branch the ops take counted once; one capture for
    both calls, whose outputs the second call overwrites."""
    from md_neighbor_list_tpu_torch import DenseSimulator, MDConfig

    n, cap = 13824, 32
    sim = DenseSimulator(MDConfig(n=n), cap=cap, device=card,
                         incremental=incremental)
    rs = sim.config.rs
    pos, vel, pid = numpy_system(n, seed=21)
    seed = dense_cells.from_packed(torch.from_numpy(pos).to(card),
                                   torch.from_numpy(1.4 * vel).to(card),
                                   torch.from_numpy(pid).to(card), sim.spec)
    new = ops_build(seed, sim.spec, rs, incremental)[0]
    g = torch.Generator(card).manual_seed(1)
    dr = 0.08 * torch.randn(new.pos.shape, generator=g, device=card)
    drifted = new._replace(pos=new.pos + torch.where(new.valid()[None], dr,
                                                     0.0))
    _strict_replays(monkeypatch)
    outputs = []
    start = sim._taken.clone()
    for state in (seed, drifted):
        want = ops_build(state, sim.spec, rs, incremental)
        taken = sim._taken.clone()
        got = sim._rebuild_and_lists(state)
        assert (sim._taken - taken).tolist() == want[4]
        for a, b in zip((*got[0], *got[1:]), (*want[0], *want[1:4])):
            assert torch.equal(a, b)
        outputs.append([t.data_ptr() for t in (*got[0], *got[1:])])
    assert sim._build_runner.captures == 1
    assert outputs[0] == outputs[1]
    if incremental:  # the seed falls back, the drift is merged
        assert (sim._taken - start).tolist() == [1, 1]


def test_refused_capture_raises_and_runs_nothing_eagerly(card):
    """A step that reads the device from the host: the warm-up runs it (and
    puts the carry back), the capture is refused by CUDA, and the runner
    raises instead of stepping eagerly."""
    x = torch.zeros((), device=card)

    def step(cond):
        x.add_(1.0)
        float(x)  # a host read: not permitted while the stream captures

    runner = graphs.ChunkRunner()
    with pytest.raises(RuntimeError):
        runner.run(step, 5, [x])
    torch.cuda.synchronize()
    assert float(x) == 0.0
    assert runner.graph is None and runner.captures == 0


def _list_on(state, spec, n, device):
    lst = dense_force.half_list_buffers(spec, n, RS, device)
    assert not bool(dense_force.build_half_list(state.pos, spec, RS, lst))
    return lst


@pytest.mark.parametrize("case", sorted(CASES) + ["scattered_cap40",
                                                  "scattered_cap384",
                                                  "scattered_cap448"])
def test_list_kernels_match_plain_versions(card, case):
    """The list's kernel (bitwise, one launch a build: the one-walk form up
    to cap 192, the two-walk form at cap 384 and 448) and the list-driven K3
    against their plain versions on the rebuilt state, and K3 also against
    the sweep, on the rebuilt state and on it drifted to just under the
    vote's trigger (every particle 0.999 skin/2 from where the list was
    built); parked slots get exactly zero force. On scattered slots (no
    prefix of occupied slots), up to cap 448 (``LIST_MAX_CAP``), as the
    step's graph runs it there."""
    if case.startswith("scattered"):
        cap = int(case[len("scattered_cap"):])
        state, spec = _scattered_on_card(card, cap)
        n = int(state.valid().sum())
    else:
        n, cap = CASES[case]
        pos, vel, pid = numpy_system(n, seed=11, jitter=0.2)
        state, spec, _ = torch_state(pos, vel, pid, cap)
        state, _ = dense_cells.rebuild_dense(
            dense_cells.DenseState(*(t.to(card) for t in state)), spec)
    before = dict(_cuda.LAUNCHES)
    lst = _list_on(state, spec, n, card)
    cpu = _list_on(dense_cells.DenseState(*(t.cpu() for t in state)), spec,
                   n, "cpu")
    for got, want in zip(lst, cpu):
        assert torch.equal(got.cpu(), want)
    skin = RS - RC
    g = torch.Generator(device="cpu").manual_seed(3)
    u = torch.randn(state.pos.shape, generator=g)
    u = (u / torch.sqrt(torch.sum(u * u, dim=0, keepdim=True))).to(card)
    valid = state.valid()
    for frac in (0.0, 0.999):
        pos = state.pos + torch.where(valid[None], frac * skin / 2 * u, 0.0)
        f = dense_force.dense_forces_list(pos, lst, spec, RC)
        f_p = dense_force.forces_list_plain(pos.cpu(), cpu, spec, RC)
        f_s = dense_force.dense_forces_half(pos, spec, RC)[0]
        scale = max(float(f_p.abs().max()), 1.0)
        for want in (f_p, f_s.cpu()):
            np.testing.assert_allclose(f.cpu(), want, rtol=1e-4,
                                       atol=2e-5 * scale)
        assert float(f[:, ~valid].abs().sum()) == 0.0
    after = _cuda.LAUNCHES
    assert after["list_sparse"] - before["list_sparse"] == 1
    assert "list_count" not in after and "list_pack" not in after
    assert after["lists_half"] == before["lists_half"]
    assert after["forces_list"] - before["forces_list"] == 2


def test_list_overflow_on_the_card_clips_and_stores_the_plain_entries(card):
    """A list whose capacity is half its entries: the kernel returns the
    flag, its starts are clipped at the capacity, and every entry it stores
    (and every count) equals the plain version's bit for bit."""
    n, cap = CASES["mc4_cap40"]
    pos, vel, pid = numpy_system(n, seed=11, jitter=0.2)
    state, spec, _ = torch_state(pos, vel, pid, cap)
    state, _ = dense_cells.rebuild_dense(
        dense_cells.DenseState(*(t.to(card) for t in state)), spec)
    full = _list_on(state, spec, n, card)
    entries = int(full.nsparse.sum())
    capacity = entries // 2 // 8 * 8
    assert 0 < capacity < entries

    def small(device):
        shape = full.start.shape
        return dense_force.HalfList(
            start=torch.full(shape, -1, dtype=torch.int32, device=device),
            nsparse=torch.full(shape, -1, dtype=torch.int32, device=device),
            lanes=torch.zeros(capacity, dtype=torch.int16, device=device))

    got, want = small(card), small("cpu")
    assert bool(dense_force.build_half_list(state.pos, spec, RS, got))
    assert bool(dense_force.build_half_list(state.pos.cpu(), spec, RS, want))
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    assert int(got.start.max()) == capacity
    assert torch.equal(got.nsparse, full.nsparse)
    assert torch.equal(got.lanes, full.lanes[:capacity])


def test_list_kernel_places_a_cell_past_its_buffer(card):
    """Five cells around one corner, the own cell (1, 1, 1) and its sparse
    cells at (dz, dy, dx) = (0, 1, 1), (1, 0, 1), (1, 1, 0), (1, 1, 1), hold
    40 particles each within 0.3 of the corner, so all their pairs lie within
    rs: the own cell lists 40 x 160 entries, more than the 88 x cap = 4,224
    its staged slots hold at cap 48 (the one-walk form), and places them in
    two passes. The list equals the plain version's bit for bit."""
    n, cap, L = 200, 48, 12.0  # mc = 4 at rs 2.8
    rng = np.random.default_rng(31)
    offsets = ((0, 0, 0), (0, 1, 1), (1, 0, 1), (1, 1, 0), (1, 1, 1))
    pos = np.concatenate([5.7 + 0.3 * np.array(off[::-1])  # x, y, z
                          + rng.uniform(0.0, 0.3, (40, 3)) for off in offsets])
    state, spec, _ = torch_state(pos.astype(np.float32),
                                 np.zeros((n, 3), np.float32),
                                 np.arange(n, dtype=np.int32), cap,
                                 rho=n / L**3)
    assert spec.mc == 4
    state, _ = dense_cells.rebuild_dense(
        dense_cells.DenseState(*(t.to(card) for t in state)), spec)

    def buffers(device):
        return dense_force.HalfList(
            start=torch.zeros(state.pid.shape, dtype=torch.int32,
                              device=device),
            nsparse=torch.zeros(state.pid.shape, dtype=torch.int32,
                                device=device),
            lanes=torch.zeros(n * 10 * cap, dtype=torch.int16,
                              device=device))

    got, want = buffers(card), buffers("cpu")
    assert not bool(dense_force.build_half_list(state.pos, spec, RS, got))
    assert not bool(dense_force.build_half_list(state.pos.cpu(), spec, RS,
                                                want))
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    assert int(want.nsparse.reshape(-1, cap).sum(1).max()) > 88 * cap


def _pair_force_sums(pos4, lst, spec, rc):
    """Each slot's sum of |pair force| over the pairs ``forces_list_plain``
    takes (the dense cells' and the listed ones), in float64: the scale of
    the rounding its float32 sum can carry. (3, R, mc, cap), CPU."""
    p = pos4.cpu().double().reshape(3, -1)
    total = torch.zeros(p.shape[1], dtype=torch.float64)
    for own, part, shift in (dense_force.dense_pairs(pos4.cpu(), spec),
                             dense_force.list_pairs(lst, spec)):
        d = p[:, own] - (p[:, part] + shift.double())
        r2 = (d * d).sum(0)
        s2 = 1.0 / r2
        s6 = s2 * s2 * s2
        f = torch.where(r2 < rc * rc,
                        (24.0 * s6 * (2.0 * s6 - 1.0) * s2).abs()
                        * r2.sqrt(), 0.0)
        total.index_add_(0, own, f)
        total.index_add_(0, part, f)
    return total.expand(3, -1).reshape(pos4.shape)


def _list_cut_at(lst, cap, kept):
    """``lst`` with each cell's list range cut after its first ``kept``
    entries (counted from the entry of the cell's slot 0, as K3 stages
    them)."""
    start = lst.start.reshape(-1, cap).long()
    n = lst.nsparse.reshape(-1, cap).long()
    n = torch.clamp(torch.minimum(n, start[:, :1] + kept - start), min=0)
    return dense_force.HalfList(lst.start, n.to(torch.int32).reshape(
        lst.nsparse.shape), lst.lanes)


def test_list_force_reads_a_list_range_past_its_stage(card):
    """A simple cubic lattice of spacing 0.75 (each particle moved by up to
    0.05 a component) at cap 72, mc = 4: 64 particles a cell, each cell
    listing 1,800 or more entries, more than the 1,024 the list-driven K3
    stages a cell (``csrc/force_list.cu``), so it reads the rest from global
    memory. Its forces agree with the plain version and the sweep, each
    particle to 1e-4 of its sum of |pair force|; parked slots get exactly
    zero. The tolerance can fail: the plain forces without the entries past
    the first 1,024 of each cell lie outside it."""
    side, spacing, cap = 16, 0.75, 72
    n, L = side**3, side * spacing
    g = (np.arange(side) + 0.5) * spacing
    pos = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    pos += np.random.default_rng(31).uniform(-0.05, 0.05, pos.shape)
    state, spec, _ = torch_state(pos.astype(np.float32),
                                 np.zeros((n, 3), np.float32),
                                 np.arange(n, dtype=np.int32), cap,
                                 rho=n / L**3)
    assert spec.mc == 4
    state, _ = dense_cells.rebuild_dense(
        dense_cells.DenseState(*(t.to(card) for t in state)), spec)
    lst = _list_on(state, spec, n, card)
    cpu = dense_force.HalfList(*(t.cpu() for t in lst))
    assert int(cpu.nsparse.reshape(-1, cap).sum(1).min()) > 1024
    f = dense_force.dense_forces_list(state.pos, lst, spec, RC).cpu()
    f_p = dense_force.forces_list_plain(state.pos.cpu(), cpu, spec, RC)
    f_s = dense_force.dense_forces_half(state.pos, spec, RC)[0].cpu()
    tol = 1e-4 * _pair_force_sums(state.pos, cpu, spec, RC)
    for want in (f_p, f_s):
        err = (f.double() - want.double()).abs()
        assert bool((err <= tol).all()), float((err / tol).nan_to_num().max())
    valid = state.valid().cpu()
    assert not bool(valid.all())
    assert float(f[:, ~valid].abs().sum()) == 0.0
    cut = dense_force.forces_list_plain(state.pos.cpu(),
                                        _list_cut_at(cpu, cap, 1024), spec, RC)
    assert bool(((cut.double() - f.double()).abs() > tol).any())


def test_list_kernel_replayed_at_full_width_is_bitwise_each_time(card):
    """At ``c4_sorted``'s shape (N = 1M, mc = 35: 42,875 blocks, so the
    look-back crosses many waves of resident blocks), the list built inside
    a captured graph and replayed 5 times in a row equals, bitwise, at each
    replay, K2's sparse bits counted and packed by the plain versions: the
    status words and the ticket are reset inside the graph. The outputs are
    overwritten with -1 before each replay."""
    n, cap = 1_000_000, 40
    pos, vel, pid = numpy_system(n, seed=5, jitter=0.2)
    state, spec, _ = torch_state(pos, vel, pid, cap)
    assert spec.mc == 35
    state, _ = dense_cells.rebuild_dense(
        dense_cells.DenseState(*(t.to(card) for t in state)), spec)
    want = dense_force.half_list_buffers(spec, n, RS, card)
    counts, masks = dense_force.dense_lists_half(state.pos, spec, RS)
    dense_force.count_half_list_plain(masks, counts, want.nsparse, spec)
    flat = want.nsparse.reshape(-1)
    ends = torch.cumsum(flat, 0, dtype=torch.int64)
    want.start.reshape(-1).copy_(ends - flat)
    dense_force.pack_half_list_plain(masks, counts, want.start, want.lanes,
                                     spec)
    total = int(ends[-1])
    assert 0 < total <= want.lanes.numel()
    del counts, masks
    got = dense_force.half_list_buffers(spec, n, RS, card)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # the warm-up, outside the capture
        dense_force.build_half_list(state.pos, spec, RS, got)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = _cuda.LAUNCHES["list_sparse"]
    with torch.cuda.graph(graph):
        overflow = dense_force.build_half_list(state.pos, spec, RS, got)
    assert _cuda.LAUNCHES["list_sparse"] - before == 1
    for _ in range(5):
        got.start.fill_(-1)
        got.nsparse.fill_(-1)
        got.lanes[:total].fill_(-1)
        overflow.fill_(True)
        graph.replay()
        torch.cuda.synchronize()
        assert not bool(overflow)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("incremental", [False, True],
                         ids=["dense", "incremental"])
def test_list_steps_follow_the_sweep_steps_on_the_card(card, incremental):
    """40 steps by ``run`` (the captured chunk) over several rebuilds, the
    step's force over the list and, in a twin engine, over the cell sweep:
    the same rebuilds, positions within 5e-4 (float atomics on both sides)
    and forces within the force gate; every step counted in
    ``list_forces``."""
    from md_neighbor_list_tpu_torch import DenseSimulator, MDConfig
    from md_neighbor_list_tpu_torch.utils import convert, trace

    n = 1728
    pos, vel, pid = numpy_system(n, seed=5)
    carries = []
    for sweep in (False, True):
        sim = DenseSimulator(MDConfig(n=n, **HOT), cap=32, device=card,
                             incremental=incremental)
        if sweep:
            sim._reads_list = lambda: False
        carry = sim.build(convert.system_from_numpy(
            pos, 1.4 * vel, np.zeros_like(pos), pid, device=card))
        before = trace.counters()["list_forces"]
        carries.append((sim, sim.run(carry, 40, chunk=20)))
        assert trace.counters()["list_forces"] - before == (0 if sweep
                                                            else 40)
    (sl, cl), (ss, cs) = carries
    assert int(cl.n_rebuilds) == int(cs.n_rebuilds) >= 3
    (pl, _, fl), (ps, _, fs) = sl.to_system(cl), ss.to_system(cs)
    d = np.abs(pl - ps)
    assert np.minimum(d, sl.box.L - d).max() < 5e-4
    np.testing.assert_allclose(fl, fs, atol=2e-4 * max(np.abs(fs).max(), 1.0))


def _on(card, *tensors):
    return [t.to(card) for t in tensors]


@pytest.mark.parametrize("voting", [True, False], ids=["vote", "no_vote"])
@pytest.mark.parametrize("scale", [0.01, 0.08])
@pytest.mark.parametrize("n, cap", [(1728, 40), (700, 48), (700, 37)])
def test_integrator_kernels_match_the_plain_sequence(card, n, cap, scale,
                                                     voting):
    """``kick_drift_vote`` and ``kick`` (``csrc/integrate.cu``) against
    their plain versions on the card, on rebuilt states with parked slots:
    velocities and positions bit for bit, the vote (raised for the larger
    displacements, not for the smaller) and the flag lowered by the closing
    kick; one launch each. At cap 37 (999 slots) the kernels take a slot a
    thread, else four."""
    from md_neighbor_list_tpu_torch.ops import integrate
    from test_torch_integrate import DT, SKIN, bits, inputs

    state, force, ref = inputs(n, cap, 11, scale)
    vel, pos, pid, force, ref = _on(card, state.vel, state.pos, state.pid,
                                    force, ref)
    skin = SKIN if voting else None
    want = [vel.clone(), pos.clone()]
    want_vote = integrate.kick_drift_vote_plain(*want, force, ref, pid, DT,
                                                skin)
    flag = torch.zeros((), dtype=torch.bool, device=card)
    before = dict(_cuda.LAUNCHES)
    got = integrate.kick_drift_vote(vel, pos, force, ref, pid, DT, skin, flag)
    assert torch.equal(bits(vel), bits(want[0]))
    assert torch.equal(bits(pos), bits(want[1]))
    if voting:
        assert got is flag and bool(flag) == bool(want_vote) == (scale > 0.05)
    else:
        assert got is None and not bool(flag)
    # another force, zero on empty slots as the park invariant has it
    force2 = torch.where((pid >= 0)[None], torch.flip(force, dims=(3,)), 0.0)
    integrate.kick_plain(want[0], force2, DT)
    integrate.kick(vel, force2, pid, DT, lower=got)
    assert torch.equal(bits(vel), bits(want[0])) and not bool(flag)
    after = _cuda.LAUNCHES
    assert after["kick_drift_vote"] - before["kick_drift_vote"] == 1
    assert after["kick"] - before["kick"] == 1


def test_integrator_vote_at_the_skin_half_trigger(card):
    """One occupied slot (the first, then the last) at the vote's trigger
    and its f32 neighbours (``np.nextafter``), along x and along three
    axes, every other slot at rest on its reference: the kernel's flag is
    the plain vote on the card in each placement, and both outcomes
    occur."""
    from md_neighbor_list_tpu_torch.ops import integrate
    from test_torch_integrate import (DT, SKIN, boundary_displacements,
                                      inputs, place_at_trigger)

    state, _, _ = inputs(1728, 40, 11, 0.0)
    held = torch.nonzero(state.valid().reshape(-1)).reshape(-1)
    pid = state.pid.to(card)
    flag = torch.zeros((), dtype=torch.bool, device=card)
    seen = set()
    for slot in (int(held[0]), int(held[-1])):
        for d in boundary_displacements(SKIN):
            vel, pos, force, ref = _on(card, *place_at_trigger(state, slot, d))
            want = integrate.kick_drift_vote_plain(
                vel.clone(), pos.clone(), force, ref, pid, DT, SKIN)
            integrate.kick_drift_vote(vel, pos, force, ref, pid, DT, SKIN,
                                      flag)
            assert bool(flag) == bool(want), (slot, d)
            integrate.kick(vel, force, pid, DT, lower=flag)
            seen.add(bool(want))
    assert seen == {False, True}


def test_captured_chunk_equals_eager_steps_bit_for_bit(card, monkeypatch):
    """100 steps with several rebuilds from one carry three ways: by ``run``
    (one captured step: the integrator's two kernels, the flag they raise
    and lower, the rebuild's conditional node on it), by the eager
    ``step_fn`` and by ``step_fn`` with the plain sequence in place of the
    kernels. Every tensor of the carries bit for bit, and the integrator
    launched twice a step (the graph's once more, in the capture's
    warm-up). The step's force is the full sweep (K6, whose sums run in a
    fixed order) in place of K3, whose float atomics would part the three
    ways by rounding."""
    from md_neighbor_list_tpu_torch import DenseSimulator, MDConfig
    from md_neighbor_list_tpu_torch.models import dense_lj
    from md_neighbor_list_tpu_torch.ops import integrate
    from md_neighbor_list_tpu_torch.utils import convert

    def swept(self, carry):
        carry.force.copy_(dense_force.dense_forces(
            carry.state.pos, carry.state.valid(), self.spec,
            self.config.rc)[0])

    monkeypatch.setattr(DenseSimulator, "_step_forces", swept)
    n, steps = 1728, 100
    pos, vel, pid = numpy_system(n, seed=5)
    sim = DenseSimulator(MDConfig(n=n, **HOT), cap=32, device=card)
    carry = sim.build(convert.system_from_numpy(
        pos, 1.4 * vel, np.zeros_like(pos), pid, device=card))
    graph, eager, plain = (dense_lj._clone(carry) for _ in range(3))

    _strict_replays(monkeypatch)
    _cuda.reset_launches()
    graph = sim.run(graph, steps, chunk=steps)
    torch.cuda.synchronize()
    graph_launches = dict(_cuda.LAUNCHES)
    _cuda.reset_launches()
    for _ in range(steps):
        eager = sim.step_fn(eager)
    eager_launches = dict(_cuda.LAUNCHES)
    with monkeypatch.context() as m:
        m.setattr(integrate, "kick_drift_vote",
                  lambda *a: integrate.kick_drift_vote_plain(*a[:7]))
        m.setattr(integrate, "kick",
                  lambda vel, force, pid, dt, lower=None:
                  integrate.kick_plain(vel, force, dt))
        for _ in range(steps):
            plain = sim.step_fn(plain)

    assert sim._runner.captures == 1 and not bool(graph.overflow)
    assert int(graph.n_rebuilds) >= int(carry.n_rebuilds) + 3
    for other in (eager, plain):
        for a, b in zip(graph.state, other.state):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        for name in ("force", "ref_pos", "n_rebuilds"):
            a, b = getattr(graph, name), getattr(other, name)
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), name
    for name in ("kick_drift_vote", "kick"):
        assert eager_launches[name] == steps
        assert graph_launches[name] == steps + 1
