"""The plain reference against brute force at a small N, its band rule, and
the reading of the program's list artifact."""

import math

import torch

from mdbench.lib import inputs
from mdbench.reference import lj, pairsets

L = 10.0


def positions(n=600, seed=5):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n, 3), generator=g) * L


def test_half_pairs_match_brute_force():
    for pos in (positions(), inputs.jittered(
            inputs.lattice(1000, L, "cpu"), torch.Generator().manual_seed(1),
            0.2, L)):
        for r in (2.5, 2.8, 4.9):  # 4, 3 and 2 cells a side (2: all pairs)
            keys, band = lj.half_pairs(pos, L, r)
            assert torch.equal(keys, lj.brute_half_pairs(pos, L, r))
            assert torch.all(torch.isin(band, lj.half_pairs(
                pos, L, r + 2 * lj.BAND)[0]))


def test_band_holds_a_pair_at_the_cutoff():
    r = 2.8
    pos = torch.tensor([[1.0, 1.0, 1.0], [1.0 + r, 1.0, 1.0],
                        [5.0, 5.0, 5.0], [5.0 + r - 1e-3, 5.0, 5.0]])
    keys, band = lj.half_pairs(pos, L, r)
    assert 0 * 4 + 1 in band.tolist() and 2 * 4 + 3 not in band.tolist()
    assert 2 * 4 + 3 in keys.tolist()
    got, ref = torch.tensor([1]), torch.tensor([11])  # 1 extra, 11 missing
    assert pairsets.mismatches(got, ref, band) == (1, 1)


def test_forces_match_brute_force_and_newton_three():
    pos = positions(300)
    rc = 2.5
    ref = lj.forces(pos, L, rc)
    p = pos.to(torch.float64)
    d = p[None, :, :] - p[:, None, :]
    d = d - L * torch.round(d / L)
    r2 = torch.sum(d * d, dim=-1)
    hit = (r2 < rc * rc) & ~torch.eye(len(p), dtype=torch.bool)
    s2 = torch.where(hit, 1.0 / torch.where(hit, r2, 1.0), 0.0)
    s6 = s2**3
    f = torch.where(hit, 24 * s6 * (2 * s6 - 1) * s2, 0.0)
    want = -torch.sum(f[..., None] * d, dim=1)
    assert torch.allclose(ref.force, want, rtol=1e-10, atol=1e-8)
    assert float(ref.force.sum(0).abs().max()) <= 1e-12 * float(
        ref.force.abs().max())
    assert ref.pairs == int(hit.sum()) // 2
    sc6 = (1 / rc**2)**3
    u = torch.where(hit, 4 * (s6 * s6 - s6) - 4 * (sc6 * sc6 - sc6), 0.0)
    assert math.isclose(float(ref.pe), float(u.sum()) / 2, rel_tol=1e-12)


def test_control_precision_differs_from_f64():
    pos = positions(2000, seed=3)
    ref = lj.forces(pos, L, 2.5)
    low = lj.forces(pos, L, 2.5, precision="bf16")
    err = (low.force - ref.force).abs().max() / ref.scale.max()
    assert err > 1e-4


def test_mask_pair_keys_read_the_ports_artifact():
    """The packed masks of the port's list build (its plain version, on the
    CPU), read as pairs, are the reference's pairs."""
    from md_neighbor_list_tpu_torch.core.box import Box
    from md_neighbor_list_tpu_torch.ops.dense_cells import (from_packed,
                                                            make_spec,
                                                            rebuild_dense)
    from md_neighbor_list_tpu_torch.ops.dense_force import dense_lists_half
    n, side, rs = 2744, 14.0, 2.8  # 5 cells a side, at most 27 a cell
    pos = inputs.shuffled(inputs.jittered(
        inputs.lattice(n, side, "cpu"), torch.Generator().manual_seed(2),
        0.1, side), torch.Generator().manual_seed(3))
    spec = make_spec(Box(L=side), rs, cap=40)
    state, _ = rebuild_dense(from_packed(pos, torch.zeros_like(pos),
                                         torch.arange(n, dtype=torch.int32),
                                         spec), spec)
    counts, masks = dense_lists_half(state.pos, spec, rs)
    keys, bad = pairsets.mask_pair_keys(masks, state.pid, spec.mc, spec.cap,
                                        n)
    ref, band = lj.half_pairs(pos, side, rs)
    assert int((state.pid >= 0).sum()) == n and bad == 0
    assert pairsets.mismatches(keys, ref, band)[0] == 0
    assert keys.numel() == int(counts[state.pid >= 0].sum())


def test_unphysical_states_are_refused():
    import pytest
    pos = positions()
    bad = pos.clone()
    bad[3, 1] = float("nan")
    with pytest.raises(lj.Unphysical):
        lj.forces(bad, L, 2.5)
    heap = pos.clone()
    heap[: len(pos) // 2] = 1.0  # half the particles in one cell
    with pytest.raises(lj.Unphysical):
        lj.half_pairs(heap, L, 2.5)
