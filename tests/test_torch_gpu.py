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
                                            incremental)
from torch_port_util import (CASES, RC, RS, clustered_system, numpy_system,
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
    """3*cap > 1024 (12 and 15 mask words): the lane-strided forms of every
    sweep kernel against the plain versions, a cluster of more than 341
    particles in one cell at mc = 3."""
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
