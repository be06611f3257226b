"""The half-count and full-sweep functions of the port (plain versions, on the
CPU) against the JAX package's Pallas kernels in interpret mode, on the same
rebuilt state. ``make_windows`` and all counts are bitwise; full-sweep forces
and PE agree to fp32 rounding (summation order and, on the hot form, the
exact divide the port uses where the TPU kernel takes a reciprocal with two
Newton steps) — the tolerances of tests/test_dense.py for the same forms."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from md_neighbor_list_tpu.ops import pallas_force as jpf
from md_neighbor_list_tpu_torch.core.box import Box as TBox
from md_neighbor_list_tpu_torch.ops import dense_cells as tdc
from md_neighbor_list_tpu_torch.ops import dense_force as tdf
from md_neighbor_list_tpu_torch.ops import dense_ref as tref
from md_neighbor_list_tpu_torch.ops import oracle as toracle
from torch_port_util import CASES, RC, RS, rebuilt_pair

ALL = sorted(CASES)


def _cleared(ts, every: int = 7):
    """``valid`` with every ``every``-th occupied slot cleared: slots that
    hold an in-box position and must give and receive nothing."""
    valid = ts.valid().clone()
    occupied = valid.reshape(-1).nonzero()[:, 0]
    valid.reshape(-1)[occupied[::every]] = False
    return valid


@functools.lru_cache(maxsize=None)
def _full_counts(case):
    js, jspec, ts, tspec, _ = rebuilt_pair(case)
    jv = js.valid().astype(jnp.float32)
    return (np.asarray(jpf.dense_counts(js.pos, jv, jspec, RS, True)),
            tdf.dense_counts(ts.pos, ts.valid(), tspec, RS))


@pytest.mark.parametrize("case", ALL)
@pytest.mark.parametrize("cleared", [False, True], ids=["state", "cleared"])
def test_make_windows_bitwise(case, cleared):
    js, jspec, ts, tspec, _ = rebuilt_pair(case)
    valid = _cleared(ts) if cleared else ts.valid()
    w_t = tdf.make_windows(ts.pos, valid, tspec)
    w_j = jpf.make_windows(js.pos, jnp.asarray(valid.numpy(), jnp.float32),
                           jspec)
    assert w_t.dtype == torch.float32 and w_t.is_contiguous()
    assert tuple(w_t.shape) == (tspec.rows, 3, tspec.mc, 3 * tspec.cap)
    np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))


@pytest.mark.parametrize("case", ALL)
def test_counts_half_bitwise(case):
    js, jspec, ts, tspec, _ = rebuilt_pair(case)
    jv = js.valid().astype(jnp.float32)
    c_j = jpf.dense_counts_half(js.pos, jv, jspec, RS, True)
    c_t = tdf.dense_counts_half(ts.pos, tspec, RS)
    assert c_t.dtype == torch.int32
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    # the list build's counts and the popcount of its masks are the same
    counts, masks = tdf.dense_lists_half(ts.pos, tspec, RS)
    assert torch.equal(c_t, counts)
    assert torch.equal(c_t, tdf.mask_slot_counts(masks, tspec.cap))
    assert int(c_t[~ts.valid()].abs().sum()) == 0


@pytest.mark.parametrize("case", ALL)
def test_counts_full_bitwise(case):
    _, _, ts, tspec, pos = rebuilt_pair(case)
    c_j, c_t = _full_counts(case)
    assert c_t.dtype == torch.int32
    np.testing.assert_array_equal(c_t.numpy(), c_j)
    np.testing.assert_array_equal(
        c_t.numpy(), tref.sweep_reference(ts, tspec, RS, False).numpy())
    assert int(c_t[~ts.valid()].abs().sum()) == 0


@pytest.mark.parametrize("case", ALL)
def test_full_total_is_twice_half_and_oracle(case):
    _, _, ts, tspec, pos = rebuilt_pair(case)
    _, c_full = _full_counts(case)
    half = int(tdf.dense_counts_half(ts.pos, tspec, RS)[ts.valid()].sum())
    full = int(c_full[ts.valid()].sum())
    assert full == 2 * half
    box = TBox.from_density(pos.shape[0], 1.0)
    assert half == int(toracle.pair_count(torch.from_numpy(pos), box, RS))


@pytest.mark.parametrize("case", ALL)
@pytest.mark.parametrize("want_pe", [True, False], ids=["pe", "hot"])
def test_forces_full_match(case, want_pe):
    js, jspec, ts, tspec, _ = rebuilt_pair(case)
    jv = js.valid().astype(jnp.float32)
    f_j, pe_j = jpf.dense_forces(js.pos, jv, jspec, RC, True, want_pe)
    f_t, pe_t = tdf.dense_forces(ts.pos, ts.valid(), tspec, RC, want_pe)
    valid = ts.valid().numpy()
    rtol, atol = (1e-5, 1e-4) if want_pe else (1e-4, 5e-3)
    np.testing.assert_allclose(f_t.numpy()[:, valid],
                               np.asarray(f_j)[:, valid], rtol=rtol, atol=atol)
    assert float(f_t[:, ~ts.valid()].abs().sum()) == 0.0
    f_r, pe_r = tref.sweep_reference(ts, tspec, RC, True)
    np.testing.assert_allclose(f_t.numpy(), f_r.numpy(), rtol=1e-5, atol=1e-4)
    if want_pe:
        np.testing.assert_allclose(pe_t.numpy()[valid],
                                   np.asarray(pe_j)[valid], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(pe_t.numpy(), pe_r.numpy(), rtol=1e-5,
                                   atol=1e-5)
        assert float(pe_t[~ts.valid()].abs().sum()) == 0.0
    else:
        assert pe_t is None and pe_j is None


def test_forces_full_match_oracle_and_half_sweep():
    _, _, ts, tspec, pos = rebuilt_pair("mc3_cap48")
    n = pos.shape[0]
    f, pe = tdf.dense_forces(ts.pos, ts.valid(), tspec, RC)
    keep = ts.valid().reshape(-1)
    packed = torch.empty((n, 3))
    packed[ts.pid.reshape(-1)[keep].long()] = f.reshape(3, -1)[:, keep].T
    p, _ = tdc.to_packed(ts, n)
    f_o, u_o = toracle.forces_energy(torch.from_numpy(p),
                                     TBox.from_density(n, 1.0), RC)
    scale = max(float(f_o.abs().max()), 1.0)
    np.testing.assert_allclose(packed.numpy(), f_o.numpy(), atol=2e-4 * scale)
    np.testing.assert_allclose(0.5 * float(pe[ts.valid()].sum()), float(u_o),
                               rtol=1e-4, atol=1e-2)
    f_h, pe_h = tdf.dense_forces_half(ts.pos, tspec, RC, True)
    np.testing.assert_allclose(f.numpy(), f_h.numpy(), rtol=1e-4,
                               atol=2e-5 * scale)
    np.testing.assert_allclose(0.5 * float(pe.sum()), float(pe_h.sum()),
                               rtol=1e-5)


@pytest.mark.parametrize("case", ["mc3_cap48", "mc4_cap32"])
def test_cleared_valid_slots_give_and_receive_nothing(case):
    """The full sweep honours ``valid`` and not the state's park invariant: a
    slot that holds an in-box position but is marked invalid is absent."""
    js, jspec, ts, tspec, _ = rebuilt_pair(case)
    valid = _cleared(ts)
    jv = jnp.asarray(valid.numpy(), jnp.float32)
    c_t = tdf.dense_counts(ts.pos, valid, tspec, RS)
    c_j = jpf.dense_counts(js.pos, jv, jspec, RS, True)
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    assert int(c_t[~valid].abs().sum()) == 0
    # the reference sweep of the state without those particles
    gone = tdc.DenseState(pos=tdc.park_positions(ts.pos, valid, tspec),
                          vel=ts.vel,
                          pid=torch.where(valid, ts.pid, -1))
    np.testing.assert_array_equal(
        c_t.numpy(), tref.sweep_reference(gone, tspec, RS, False).numpy())
    f_t, pe_t = tdf.dense_forces(ts.pos, valid, tspec, RC)
    f_r, pe_r = tref.sweep_reference(gone, tspec, RC, True)
    np.testing.assert_allclose(f_t.numpy(), f_r.numpy(), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(pe_t.numpy(), pe_r.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert float(f_t[:, ~valid].abs().sum()) == 0.0
    assert float(pe_t[~valid].abs().sum()) == 0.0


def test_full_sweep_wrappers_reject_wrong_inputs():
    _, _, ts, tspec, _ = rebuilt_pair("mc4_cap32")
    with pytest.raises(ValueError):
        tdf.dense_counts(ts.pos, ts.valid().float(), tspec, RS)
    with pytest.raises(ValueError):
        tdf.dense_forces(ts.pos, ts.valid()[:-1], tspec, RC)
    with pytest.raises(ValueError):
        tdf.dense_counts_half(ts.pos.double(), tspec, RS)
