"""The occupancy rule of the half-force and pe/virial kernels: a slot holds a
particle exactly when its stored x lies below ``PARK_BASE / 2``. Checked on
every state producer of the port (the full and incremental rebuilds,
``from_packed``, a grown cap, a slab's extended state after the ghost
re-park) and on a state whose occupied slots are scattered inside each cell,
where the port's plain half sweeps are also held against the JAX package's
kernels (interpret mode). The kernels themselves run on the card only
(``tests/test_torch_gpu.py``)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from md_neighbor_list_tpu.ops import dense_cells as jdc
from md_neighbor_list_tpu.ops import pallas_force as jpf
from md_neighbor_list_tpu_torch import DenseSimulator, MDConfig
from md_neighbor_list_tpu_torch.ops import dense_cells as tdc
from md_neighbor_list_tpu_torch.ops import dense_force as tdf
from md_neighbor_list_tpu_torch.ops import incremental as tinc
from md_neighbor_list_tpu_torch.ops import slab_kernels
from md_neighbor_list_tpu_torch.utils import convert
from torch_port_util import (CASES, RC, RS, numpy_system, rebuilt_pair,
                             scatter_slots, torch_state)

N = 1728  # L = 12, mc = 4


def _rebuilt(cap: int = 40, seed: int = 4):
    pos, vel, pid = numpy_system(N, seed)
    state, spec, _ = torch_state(pos, vel, pid, cap)
    return tdc.rebuild_dense(state, spec)[0], spec


def _from_packed():
    pos, vel, pid = numpy_system(N, 4)
    state, spec, _ = torch_state(pos, vel, pid, 40)
    return state.pos, state.valid()


def _rebuild_dense():
    state, _ = _rebuilt()
    return state.pos, state.valid()


def _rebuild_incremental():
    state, spec = _rebuilt()
    rng = np.random.default_rng(3)
    dr = rng.normal(0.0, 0.3, state.pos.shape).astype(np.float32)
    drift = torch.where(state.valid()[None], torch.from_numpy(dr), 0.0)
    new, _ = tinc.rebuild_dense_incremental(
        state._replace(pos=state.pos + drift), spec)
    return new.pos, new.valid()


def _grown_cap():
    """All particles in one corner cell: the engine grows cap from 8."""
    n = 256
    sim = DenseSimulator(MDConfig(n=n, rc=1.5, skin=0.2), cap=8, device="cpu")
    rng = np.random.default_rng(0)
    pos = rng.uniform(0, sim.spec.cell_size, (n, 3)).astype(np.float32)
    zeros = np.zeros((n, 3), np.float32)
    carry = sim.build(convert.system_from_numpy(
        pos, zeros, zeros, np.arange(n, dtype=np.int32), device="cpu"))
    assert sim.cap > 8
    return carry.state.pos, carry.state.valid()


def _slab_extended(p: int):
    """Slab 0 of P (mc = 4: P = 4 is nz = 1, P = 1 is nz = 4), built by the
    slab rebuild from every record, with its ghost layer (the next slab's
    first layer, seam-shifted) re-parked as the slab engine does."""
    pos, vel, pid = numpy_system(N, 12, jitter=0.2)
    _, cube, _ = torch_state(pos, vel, pid, 40)
    nz = cube.mc // p
    spec = slab_kernels.SlabSpec(mc=cube.mc, nz=nz, mc_z=cube.mc, cap=40,
                                 L=cube.L, cell_size=cube.cell_size,
                                 cell_z=cube.cell_size)
    rec = torch.from_numpy(pos.T.copy())
    chans = torch.cat([rec, torch.from_numpy(vel.T.copy())])
    valid = torch.ones(N, dtype=torch.bool)
    states = [slab_kernels.slab_sort_expand(
        slab_kernels.slab_keys(rec, valid, spec, r * nz), chans,
        torch.from_numpy(pid), spec)[0] for r in range(min(p, 2))]
    ghost = states[1 % len(states)]
    gpos = ghost.pos[:, :spec.mc].clone()
    if p == 1:
        gpos[2] += float(np.float32(spec.L))
    ext_v = torch.cat([states[0].valid(), ghost.valid()[:spec.mc]])
    ext = slab_kernels._repark_ghost(torch.cat([states[0].pos, gpos], dim=1),
                                     ext_v, spec)
    return ext, ext_v


def _scattered():
    state, spec = _rebuilt()
    sc = scatter_slots(state, spec, seed=5)
    return sc.pos, sc.valid()


SOURCES = {"from_packed": _from_packed, "rebuild_dense": _rebuild_dense,
           "rebuild_dense_incremental": _rebuild_incremental,
           "grown_cap": _grown_cap, "slab_ext_nz1": lambda: _slab_extended(4),
           "slab_ext_nz4": lambda: _slab_extended(1), "scattered": _scattered}


@pytest.mark.parametrize("source", sorted(SOURCES))
def test_occupancy_rule_equals_validity(source):
    pos4, valid = SOURCES[source]()
    assert valid.any() and not valid.all()
    assert torch.equal(pos4[0] < tdf.OCCUPIED_BELOW, valid)
    assert tdf.OCCUPIED_BELOW == tdc.PARK_BASE / 2


def test_scattered_slots_form_no_prefix():
    state, spec = _rebuilt()
    sc = scatter_slots(state, spec, seed=5)
    occ = sc.valid().reshape(-1, spec.cap)
    count = occ.sum(dim=1, keepdim=True)
    prefix = torch.arange(spec.cap)[None] < count
    assert not torch.equal(occ, prefix)  # some cell has a hole before a slot
    assert torch.equal(torch.sort(sc.pid[sc.valid()]).values,
                       torch.sort(state.pid[state.valid()]).values)
    empty = ~sc.valid()
    assert torch.equal(sc.pos[:, empty], tdc.park_lattice(spec, "cpu")[:, empty])
    assert float(sc.vel[:, empty].abs().sum()) == 0.0


WRAPPERS = {
    "forces_half": lambda pos, spec: tdf.dense_forces_half(pos, spec, RC),
    "pe_virial": lambda pos, spec: tdf.dense_pe_virial(pos, spec, RC),
    "lists_half": lambda pos, spec: tdf.dense_lists_half(pos, spec, 2.8),
    "forces_half_slab": lambda pos, spec: tdf.dense_forces_half_slab(
        pos, spec, RC),
}


@pytest.mark.parametrize("wrapper", sorted(WRAPPERS))
def test_check_state_rejects_a_box_too_large(wrapper):
    """A box whose positions could reach the park base's half is refused
    before anything runs; one just inside the limit passes the check."""
    big = tdc.DenseSpec(mc=3, cap=4, L=tdf.MAX_BOX, cell_size=tdf.MAX_BOX / 3)
    pos = torch.zeros((3, 9, 3, 4))
    with pytest.raises(ValueError, match="too large"):
        WRAPPERS[wrapper](pos, big)
    inside = tdc.DenseSpec(mc=3, cap=4, L=0.99 * tdf.MAX_BOX,
                           cell_size=0.33 * tdf.MAX_BOX)
    park = tdc.park_lattice(inside, "cpu")
    WRAPPERS[wrapper](park, inside)  # an empty box: nothing in range


PARK_SPECS = {"mc4_cap40": (4, 40, 12.0), "mc3_cap48": (3, 48, 8.879),
              "mc35_cap8": (35, 8, 100.0)}


@pytest.mark.parametrize("case", sorted(PARK_SPECS))
def test_park_lattice_unchanged(case):
    """``park_lattice`` with the named base is bitwise the lattice of the
    JAX package and of the formula it had before the base was named."""
    mc, cap, L = PARK_SPECS[case]
    spec = tdc.DenseSpec(mc=mc, cap=cap, L=L, cell_size=L / mc)
    got = tdc.park_lattice(spec, "cpu")
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jdc.park_lattice(spec)))
    step = np.float32(2.0 * spec.cell_size)
    lane = (np.arange(mc, dtype=np.float32)[None, :, None] * cap
            + np.arange(cap, dtype=np.float32)[None, None, :])
    row = np.arange(mc * mc, dtype=np.float32)[:, None, None]
    shape = (mc * mc, mc, cap)
    want = np.stack([
        np.broadcast_to(np.float32(1.0e5) + lane * step, shape),
        np.broadcast_to(np.float32(1.0e5) + row * step, shape),
        np.full(shape, np.float32(1.0e5))])
    np.testing.assert_array_equal(got.numpy(), want)


@functools.lru_cache(maxsize=None)
def _scattered_pair(case):
    """The rebuilt state of ``case`` with its slots scattered, as a port
    state and as the JAX package's."""
    _, jspec, ts, tspec, _ = rebuilt_pair(case)
    sc = scatter_slots(ts, tspec, seed=9)
    js = jdc.DenseState(*(jnp.asarray(t.numpy()) for t in sc))
    return sc, tspec, js, jspec


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("form", ["hot", "pe", "pe_virial"])
def test_plain_half_sweeps_match_jax_on_scattered_slots(case, form):
    """The port's plain half sweeps against the JAX kernels (interpret
    mode), slot by slot, on occupied slots that form no prefix; parked
    slots get zeros; with the tolerances of test_torch_dense_force.py."""
    sc, tspec, js, jspec = _scattered_pair(case)
    jv = js.valid().astype(jnp.float32)
    valid = sc.valid().numpy()
    if form == "pe_virial":
        pe_j, w_j = jpf.dense_pe_virial(js.pos, jv, jspec, RC, True)
        pe_t, w_t = tdf.pe_virial_half_plain(sc.pos, tspec, RC)
        np.testing.assert_allclose(pe_t.numpy()[valid],
                                   np.asarray(pe_j)[valid], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(w_t.numpy()[valid], np.asarray(w_j)[valid],
                                   rtol=1e-5, atol=1e-4)
        assert float(pe_t[~sc.valid()].abs().sum()
                     + w_t[~sc.valid()].abs().sum()) == 0.0
        return
    want_pe = form == "pe"
    f_j, pe_j = jpf.dense_forces_half(js.pos, jv, jspec, RC, True, want_pe)
    f_t, pe_t = tdf.forces_half_plain(sc.pos, tspec, RC, want_pe)
    rtol, atol = (1e-5, 1e-4) if want_pe else (1e-4, 5e-3)
    np.testing.assert_allclose(f_t.numpy()[:, valid],
                               np.asarray(f_j)[:, valid], rtol=rtol, atol=atol)
    assert float(f_t[:, ~sc.valid()].abs().sum()) == 0.0
    if want_pe:
        np.testing.assert_allclose(pe_t.numpy()[valid],
                                   np.asarray(pe_j)[valid], rtol=1e-5,
                                   atol=1e-5)
        assert float(pe_t[~sc.valid()].abs().sum()) == 0.0


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("form", ["lists", "full_hot", "full_pe"])
def test_plain_lists_and_full_sweep_match_jax_on_scattered_slots(case, form):
    """The port's plain list build and full-sweep forces against the JAX
    kernels (interpret mode) on occupied slots that form no prefix: masks
    and counts bitwise; forces slot by slot with test_torch_counts_full.py's
    tolerances and within the force-parity gate (2e-4 of the largest
    component); invalid slots get exactly zero."""
    sc, tspec, js, jspec = _scattered_pair(case)
    jv = js.valid().astype(jnp.float32)
    invalid = ~sc.valid()
    if form == "lists":
        c_j, m_j = jpf.dense_lists_half(js.pos, jv, jspec, RS, True)
        c_t, m_t = tdf.lists_half_plain(sc.pos, tspec, RS)
        np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
        np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
        assert int(c_t[invalid].abs().sum()) == 0
        assert int(c_t.sum()) > 0
        return
    want_pe = form == "full_pe"
    f_j, pe_j = jpf.dense_forces(js.pos, jv, jspec, RC, True, want_pe)
    f_t, pe_t = tdf.forces_full_plain(sc.pos, sc.valid(), tspec, RC, want_pe)
    valid = sc.valid().numpy()
    f_j = np.asarray(f_j)
    rtol, atol = (1e-5, 1e-4) if want_pe else (1e-4, 5e-3)
    np.testing.assert_allclose(f_t.numpy()[:, valid], f_j[:, valid],
                               rtol=rtol, atol=atol)
    scale = max(float(np.abs(f_j[:, valid]).max()), 1.0)
    np.testing.assert_allclose(f_t.numpy()[:, valid], f_j[:, valid], rtol=0,
                               atol=2e-4 * scale)
    assert float(f_t[:, invalid].abs().sum()) == 0.0
    if want_pe:
        np.testing.assert_allclose(pe_t.numpy()[valid],
                                   np.asarray(pe_j)[valid], rtol=1e-5,
                                   atol=1e-5)
        assert float(pe_t[invalid].abs().sum()) == 0.0
    else:
        assert pe_t is None and pe_j is None
