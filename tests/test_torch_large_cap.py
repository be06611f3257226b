"""Caps beyond one thread per window lane (cap > 341): a cluster of more than
341 particles in one cell of an mc = 3 box, cap = 384 (12 mask words). The
port's plain sweep versions — what the CPU runs, and what the lane-strided
kernels are held against on the card — against the JAX package's
``dense_ref`` sweeps on the same numpy state: counts bitwise, forces within
the fp32 gate of 2e-4 of the largest component."""

import functools

import numpy as np
import pytest
import torch

from md_neighbor_list_tpu.ops import dense_ref as jref
from md_neighbor_list_tpu_torch.ops import dense_cells as tdc
from md_neighbor_list_tpu_torch.ops import dense_force as tdf
from torch_port_util import (RC, RS, assert_state_equal, clustered_system,
                             jax_state, torch_state)

CAP, CLUSTER, N = 384, 360, 700


@functools.lru_cache(maxsize=None)
def rebuilt():
    """(jax state, jax spec, port state, port spec) of the clustered system
    after the rebuild on both sides."""
    pos, vel, pid = clustered_system(CLUSTER, seed=13, n=N)
    js, jspec, _ = jax_state(pos, vel, pid, CAP)
    ts, tspec, _ = torch_state(pos, vel, pid, CAP)
    return (jref.rebuild_reference(js, jspec), jspec,
            tdc.rebuild_dense(ts, tspec)[0], tspec)


@functools.lru_cache(maxsize=None)
def jax_full_sweep(radius: float, want_forces: bool):
    js, jspec, _, _ = rebuilt()
    out = jref.sweep_reference(js, jspec, radius, want_forces,
                               want_virial=want_forces)
    return [np.asarray(a) for a in out] if want_forces else np.asarray(out)


def test_rebuild_holds_the_cluster_in_one_cell():
    js, _, ts, tspec = rebuilt()
    assert (tspec.mc, tspec.cap, tdf.mask_words(tspec.cap)) == (3, CAP, 12)
    assert int(ts.valid().sum()) == N
    assert int(ts.valid().sum(dim=-1).max()) == CLUSTER > 341
    assert_state_equal(ts, js)


def test_counts_full_bitwise():
    """K7's plain version per slot, bitwise."""
    _, _, ts, tspec = rebuilt()
    got = tdf.counts_full_plain(ts.pos, ts.valid(), tspec, RS)
    np.testing.assert_array_equal(got.numpy(), jax_full_sweep(RS, False))


def test_half_counts_and_masks():
    """K2's counts and masks and K5's counts: the same per slot, the masks'
    popcount equal to the counts, twice the total equal to the JAX full
    sweep's."""
    _, _, ts, tspec = rebuilt()
    counts, masks = tdf.lists_half_plain(ts.pos, tspec, RS)
    assert masks.shape == (5, 12, tspec.rows, tspec.mc, 3 * CAP)
    assert torch.equal(tdf.counts_half_plain(ts.pos, tspec, RS), counts)
    assert torch.equal(tdf.mask_slot_counts(masks, CAP), counts)
    v = ts.valid()
    assert int(counts[~v].abs().sum()) == 0
    full = jax_full_sweep(RS, False)
    assert 2 * int(counts[v].sum()) == int(full[v.numpy()].sum())


@pytest.mark.parametrize("sweep", ["half", "half_pe", "full", "full_pe"])
def test_forces_within_gate(sweep):
    """K3 (both forms) and K6 (both forms) against the JAX full sweep's
    forces; the potential's total (once per pair) to rtol 1e-5."""
    _, _, ts, tspec = rebuilt()
    f_j, pe_j, _ = jax_full_sweep(RC, True)
    want_pe = sweep.endswith("_pe")
    v = ts.valid()
    if sweep.startswith("half"):
        f, pe = tdf.forces_half_plain(ts.pos, tspec, RC, want_pe)
        half = 1.0
    else:
        f, pe = tdf.forces_full_plain(ts.pos, v, tspec, RC, want_pe)
        half = 0.5
    scale = max(float(np.abs(f_j).max()), 1.0)
    np.testing.assert_allclose(f.numpy(), f_j, rtol=0, atol=2e-4 * scale)
    assert float(f[:, ~v].abs().sum()) == 0.0
    if want_pe:
        vn = v.numpy()
        np.testing.assert_allclose(
            half * float(pe[v].sum(dtype=torch.float64)),
            0.5 * float(pe_j[vn].astype(np.float64).sum()), rtol=1e-5)


def test_pe_virial_totals():
    """K4's per-slot sums, once per pair, total to half the JAX full
    sweep's potential and virial."""
    _, _, ts, tspec = rebuilt()
    _, pe_j, w_j = jax_full_sweep(RC, True)
    pe, vir = tdf.pe_virial_half_plain(ts.pos, tspec, RC)
    v, vn = ts.valid(), ts.valid().numpy()
    for got, want in ((pe, pe_j), (vir, w_j)):
        np.testing.assert_allclose(
            float(got[v].sum(dtype=torch.float64)),
            0.5 * float(want[vn].astype(np.float64).sum()), rtol=1e-5)
        assert float(got[~v].abs().sum()) == 0.0
