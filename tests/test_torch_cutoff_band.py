"""A pair on the cutoff: where the port and the JAX package part (CPU).

The port rounds the f32 r2 = dx*dx + dy*dy + dz*dz after every product and
every sum, in its plain versions and in its CUDA kernels alike. XLA on the CPU
contracts the same sum into fused multiply-adds, which round once. For a pair
whose step-rounded r2 lands exactly on the f32 cutoff, the two disagree by an
ulp: the port leaves the pair out (r2 < r2cut is false), the JAX package and
a float64 search count it. These tests pin one such pair from a seeded
uniform draw and state what each side counts; neither side is changed to
match the other (the JAX package's own rounding differs by backend).
"""

import numpy as np
import pytest
import torch

import md_neighbor_list_tpu as jmdnl
import md_neighbor_list_tpu_torch as tmdnl
from md_neighbor_list_tpu_torch.core.box import Box
from md_neighbor_list_tpu_torch.ops import (binning, dense_cells, dense_force,
                                            oracle, pairlist)
from torch_port_util import (BAND_N, BAND_PAIR, BAND_RHO, cutoff_band_inputs,
                             torch_state)
from util import numpy_pairs

N, RHO, PAIR = BAND_N, BAND_RHO, BAND_PAIR  # the pair straddles the x face
PORT_PAIRS = 55_954  # the pair left out
JAX_PAIRS = 55_955  # the pair counted
CAP = 32  # the fullest cell holds 25

def _pairs(i, j) -> set:
    i, j = np.asarray(i), np.asarray(j)
    return set(zip(np.minimum(i, j).tolist(), np.maximum(i, j).tolist()))


def test_the_pair_sits_on_the_f32_cutoff():
    pos, L, rs = cutoff_band_inputs()
    assert L == pytest.approx(13.572088, abs=1e-6)
    assert rs == pytest.approx(2.5600349, abs=1e-7)
    raw = pos[PAIR[0]] - pos[PAIR[1]]
    d = raw - np.float32(L) * np.round(raw / np.float32(L))
    sq = d * d
    r2 = (sq[0] + sq[1]) + sq[2]
    r2cut = np.float32(rs * rs)
    assert r2 == r2cut  # so r2 < r2cut is false, step by step
    exact = np.sum(np.float64(d) ** 2)  # the products and sums unrounded
    assert exact < rs * rs and exact < np.float64(r2cut)
    assert abs(raw[0]) > L / 2  # the minimum image is across the x face


@pytest.mark.parametrize("which", ["oracle", "xla_sweep", "counts_half",
                                   "lists_half", "counts_full"])
def test_port_plain_versions_leave_the_pair_out(which):
    """The port's oracle, the xla sweep and the dense plain sweeps (the
    plain versions of K5, K2 and K7) count 55,954 pairs, the full sweep each
    of them twice."""
    pos, L, rs = cutoff_band_inputs()
    box, tpos = Box(L), torch.from_numpy(pos)
    if which == "oracle":
        assert int(oracle.pair_count(tpos, box, rs)) == PORT_PAIRS
        idx, cnt = oracle.neighbors(tpos, box, rs, 128, half=True)
        assert int(idx[PAIR[0]].eq(PAIR[1]).sum()) == 0
        assert int(cnt.sum()) == PORT_PAIRS
        return
    if which == "xla_sweep":
        grid = binning.make_grid(box, rs)
        bins = binning.bin_particles(tpos, grid, 64)
        perm = bins.perm.long()
        idx, cnt = pairlist.sweep_from_bins(tpos[perm], bins, box, grid, rs,
                                            128, half=True)
        assert not bool(bins.overflow) and int(cnt.max()) <= 128
        assert int(cnt.sum()) == PORT_PAIRS
        pid = bins.perm.numpy()
        rows, cols = np.nonzero(idx.numpy() < N)
        found = _pairs(pid[rows], pid[idx.numpy()[rows, cols]])
        assert len(found) == PORT_PAIRS and PAIR not in found
        return
    state, spec, _ = torch_state(pos, np.zeros_like(pos),
                                 np.arange(N, dtype=np.int32), CAP, rs=rs,
                                 rho=RHO)
    state, _ = dense_cells.rebuild_dense(state, spec)
    valid = state.valid()
    assert int(valid.sum()) == N
    if which == "counts_half":
        counts = dense_force.counts_half_plain(state.pos, spec, rs)
        assert int(counts[valid].sum()) == PORT_PAIRS
    elif which == "lists_half":
        counts, _ = dense_force.lists_half_plain(state.pos, spec, rs)
        assert int(counts[valid].sum()) == PORT_PAIRS
    else:
        counts = dense_force.counts_full_plain(state.pos, valid, spec, rs)
        assert int(counts[valid].sum()) == 2 * PORT_PAIRS


@pytest.mark.parametrize("backend", ["xla", "dense"])
def test_port_pair_list_leaves_the_pair_out(backend):
    pos, L, rs = cutoff_band_inputs()
    i, j = tmdnl.pair_list(torch.from_numpy(pos), L, rs, backend=backend,
                           device="cpu")
    found = _pairs(i, j)
    assert len(i) == len(found) == PORT_PAIRS
    assert PAIR not in found


@pytest.mark.parametrize("backend", ["xla", "dense"])
def test_jax_package_counts_the_pair_on_the_cpu(backend):
    """The reference on the CPU: XLA's fused multiply-adds give an r2 one
    ulp below the cutoff ("dense" runs its Pallas kernel in interpret
    mode)."""
    pos, L, rs = cutoff_band_inputs()
    i, j = jmdnl.pair_list(pos, L, rs, backend=backend)
    found = _pairs(i, j)
    assert len(i) == len(found) == JAX_PAIRS
    assert PAIR in found


def test_float64_reference_counts_the_pair():
    pos, L, rs = cutoff_band_inputs()
    found = numpy_pairs(pos, L, rs)
    assert len(found) == JAX_PAIRS and PAIR in found
    port = _pairs(*tmdnl.pair_list(torch.from_numpy(pos), L, rs,
                                   backend="xla", device="cpu"))
    assert found - port == {PAIR} and port <= found
