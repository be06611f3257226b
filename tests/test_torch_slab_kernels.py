"""The slab forms of the dense kernels: the port on the CPU (plain versions)
against the JAX package's ``ops/slab_kernels.py`` (Pallas in interpret mode)
on the same numpy inputs. Keys, the slab rebuild, list masks and counts are
bitwise; forces, seams and PE agree to fp32 rounding (summation order, and the
exact divide the port takes where the TPU hot form uses a reciprocal with two
Newton steps). Slabs cut from a cube state reproduce the cube's sweeps."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from md_neighbor_list_tpu.core.box import Box as JBox
from md_neighbor_list_tpu.ops import dense_cells as jdc
from md_neighbor_list_tpu.ops import slab_kernels as jsk
from md_neighbor_list_tpu.parallel import dense_slab as jds
from md_neighbor_list_tpu_torch.core.box import Box as TBox
from md_neighbor_list_tpu_torch.ops import dense_cells as tdc
from md_neighbor_list_tpu_torch.ops import dense_force as tdf
from md_neighbor_list_tpu_torch.ops import slab_kernels as tsk
from md_neighbor_list_tpu_torch.parallel import dense_slab as tds
from torch_port_util import numpy_system, rebuilt_pair

# the JAX slab tests' geometry: L = 16, mc = 9; P = 2 gives mc_z = 8, nz = 4
# and cell_z = 2 (anisotropic cells); P = 8 gives nz = 1
N, RC, RS, CAP = 4096, 1.5, 1.7, 16
# forces: the hot-form tolerance of tests/test_torch_dense_force.py, for both
# forms: the want_pe form divides exactly on both sides, but its per-slot sums
# of terms up to ~700 cancel to values near 0.3 here, where the summation
# order alone moves them by 1.4e-4
RTOL, ATOL = 1e-4, 5e-3


def _specs(p: int, cap: int = CAP):
    j = jds.make_slab_spec(JBox.from_density(N, 1.0), RS, p, cap)
    t = tds.make_slab_spec(TBox.from_density(N, 1.0), RS, p, cap)
    return j, t


@functools.lru_cache(maxsize=None)
def _records(seed: int = 3):
    """A jittered lattice of N particles (numpy f32)."""
    return numpy_system(N, seed, jitter=0.1)


def _jax_chans(pos, vel, pid):
    return tuple(jnp.asarray(c) for c in (*pos.T, *vel.T)) + (
        jnp.asarray(pid.astype(np.float32)),)


@functools.lru_cache(maxsize=None)
def _slab_states(p: int):
    """Per rank, (jax state, port state) of rank r's slab, each rebuilt from
    ALL N records by that package's slab keys and slab sort + expand: the
    records of other slabs key out, emigrants below the owned range."""
    pos, vel, pid = _records()
    jspec, tspec = _specs(p)
    out = []
    for r in range(p):
        z0 = r * jspec.nz
        jkeys = jsk.slab_keys(jnp.asarray(pos.T), jnp.ones(N, bool), jspec,
                              jnp.int32(z0))
        js, _ = jsk.slab_sort_expand(jkeys, _jax_chans(pos, vel, pid), jspec,
                                     True)
        tkeys = tsk.slab_keys(torch.from_numpy(pos.T.copy()),
                              torch.ones(N, dtype=torch.bool), tspec, z0)
        ts, _ = tsk.slab_sort_expand(
            tkeys, torch.from_numpy(pos.T.copy()),
            torch.from_numpy(vel.T.copy()), torch.from_numpy(pid), tspec)
        out.append((js, ts))
    return out


def _ext(p: int, r: int):
    """Rank r's extended (owned + seam-shifted ghost) positions and validity
    on both sides: the ghost layer is rank r+1's first layer."""
    jspec, tspec = _specs(p)
    states = _slab_states(p)
    mc = jspec.mc
    (js, ts), (jg, tg) = states[r], states[(r + 1) % p]
    shift = np.float32(jspec.L) if r == p - 1 else np.float32(0.0)
    jgpos = jg.pos[:, :mc].at[2].add(shift)
    tgpos = tg.pos[:, :mc].clone()
    tgpos[2] += float(shift)
    j_ext = jnp.concatenate([js.pos, jgpos], axis=1)
    j_v = jnp.concatenate([js.pid >= 0, jg.pid[:mc] >= 0],
                          axis=0).astype(jnp.float32)
    t_ext = torch.cat([ts.pos, tgpos], dim=1)
    t_v = torch.cat([ts.pid >= 0, tg.pid[:mc] >= 0], dim=0)
    return j_ext, j_v, t_ext, t_v


RANKS = [(2, 0), (2, 1), (8, 3), (8, 7)]
RANK_IDS = [f"P{p}r{r}" for p, r in RANKS]


def _fields(spec):
    return (spec.mc, spec.nz, spec.mc_z, spec.cap, spec.L, spec.cell_size,
            spec.cell_z)


@pytest.mark.parametrize("n,rs,p", [(4096, 1.7, 1), (4096, 1.7, 2),
                                    (4096, 1.7, 8), (1_000_000, 2.8, 1),
                                    (8_000_000, 2.8, 8)])
def test_make_slab_spec_matches(n, rs, p):
    j = jds.make_slab_spec(JBox.from_density(n, 1.0), rs, p, 40)
    t = tds.make_slab_spec(TBox.from_density(n, 1.0), rs, p, 40)
    assert _fields(t) == _fields(j)
    assert (t.rows, t.ncells, t.slots) == (j.rows, j.ncells, j.slots)
    assert _fields(t.ext()) == _fields(j.ext())


def test_make_slab_spec_rejects_too_many_slabs():
    with pytest.raises(ValueError):
        tds.make_slab_spec(TBox.from_density(N, 1.0), RS, 16)


@pytest.mark.parametrize("p", [1, 2, 8])
@pytest.mark.parametrize("wrap", [True, False], ids=["wrap", "unwrapped"])
def test_slab_keys_bitwise(p, wrap):
    """Every z0, positions on and next to cell faces, invalid slots."""
    jspec, tspec = _specs(p)
    rng = np.random.default_rng(p)
    L = np.float32(jspec.L)
    faces = np.float32(np.arange(jspec.mc_z) * jspec.cell_z)
    pos = rng.uniform(0, L, (3, 600)).astype(np.float32)
    pos[2, :jspec.mc_z] = faces
    pos[2, jspec.mc_z:2 * jspec.mc_z] = np.nextafter(faces, np.float32(-1))
    pos[:, -1] = np.nextafter(L, np.float32(0))
    pos = np.abs(pos)
    valid = rng.uniform(size=600) > 0.1
    for z0 in range(0, jspec.mc_z, jspec.nz):
        want = jsk.slab_keys(jnp.asarray(pos), jnp.asarray(valid), jspec,
                             jnp.int32(z0), wrap=wrap)
        got = tsk.slab_keys(torch.from_numpy(pos), torch.from_numpy(valid),
                            tspec, z0, wrap=wrap)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_slab_keys_unwrapped_owns_top_layer():
    """P = 1 geometry: the ring-wrapped key maps the top owned layer to a
    left-emigrant key; the unwrapped one keys every layer as owned."""
    spec = tsk.SlabSpec(mc=4, nz=4, mc_z=4, cap=8, L=8.0, cell_size=2.0,
                        cell_z=2.0)
    valid = torch.tensor([True])
    lo, hi = spec.mc ** 2, spec.mc ** 2 * (spec.nz + 1)
    top = torch.tensor([[0.5], [0.5], [7.5]])
    assert int(tsk.slab_keys(top, valid, spec, 0)[0]) < lo
    for iz in range(4):
        p = torch.tensor([[0.5], [0.5], [2.0 * iz + 1.0]])
        k = int(tsk.slab_keys(p, valid, spec, 0, wrap=False)[0])
        assert lo + iz * spec.mc ** 2 <= k < min(hi, lo + (iz + 1) * spec.mc ** 2)


def test_row_starts_with_key_base_match():
    jspec, tspec = _specs(2)
    base = jspec.mc * jspec.mc
    keys = np.sort(np.random.default_rng(0).integers(
        0, base * (jspec.nz + 3), 3000)).astype(np.int32)
    want = jdc._row_starts(jnp.asarray(keys), jspec, base)
    got = tdc.row_starts(torch.from_numpy(keys), tspec, base)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[0]) == int((keys < base).sum())  # emigrants before row 0


@pytest.mark.parametrize("p", [2, 8])
def test_slab_sort_expand_bitwise(p):
    """pid and valid-slot pos/vel bitwise; parked slots equal the port's park
    lattice (the JAX kernel in interpret mode parks a few slots one ulp off,
    tests/test_torch_dense_cells.py); every particle kept by one slab."""
    _, tspec = _specs(p)
    kept = []
    for js, ts in _slab_states(p):
        jpid = np.asarray(js.pid)
        np.testing.assert_array_equal(ts.pid.numpy(), jpid)
        v = jpid >= 0
        np.testing.assert_array_equal(ts.pos.numpy()[:, v],
                                      np.asarray(js.pos)[:, v])
        np.testing.assert_array_equal(ts.vel.numpy()[:, v],
                                      np.asarray(js.vel)[:, v])
        park = tdc.park_lattice(tspec, "cpu")
        assert torch.equal(ts.pos[:, ~ts.valid()], park[:, ~ts.valid()])
        assert float(ts.vel[:, ~ts.valid()].abs().sum()) == 0.0
        kept.append(ts.pid[ts.valid()])
    kept = torch.cat(kept)
    assert kept.numel() == N and torch.unique(kept).numel() == N


def test_expand_drops_records_keyed_below_base():
    """The slab form of K1 on a record stream with keys below key_base and
    at or beyond the owned range: only the owned records land, each once."""
    _, tspec = _specs(2)
    base = tspec.mc * tspec.mc
    rng = np.random.default_rng(1)
    keys = torch.from_numpy(rng.integers(0, base * (tspec.nz + 3), 2000)
                            .astype(np.int32))
    keys_s, order = torch.sort(keys, stable=True)
    M = keys_s.shape[0]
    chans = torch.from_numpy(rng.standard_normal((6, M)).astype(np.float32))
    pid = torch.arange(M, dtype=torch.int32)
    rs = tdc.row_starts(keys_s, tspec, base)
    posvel, pid4 = tdc.expand_plain(chans[:3], chans[3:], pid, order, keys_s,
                                    rs, tspec, base)
    owned = (keys >= base) & (keys < base + tspec.rows * tspec.mc)
    got = pid4[pid4 >= 0]
    assert got.numel() == int(owned.sum())  # no cell reaches cap here
    assert torch.equal(torch.sort(got).values,
                       torch.nonzero(owned)[:, 0].to(torch.int32))
    flat = posvel.reshape(6, -1)[:, (pid4 >= 0).reshape(-1)]
    assert torch.equal(flat, chans[:, got.long()])


@pytest.mark.parametrize("p,r", RANKS, ids=RANK_IDS)
def test_slab_lists_half_bitwise(p, r):
    jspec, tspec = _specs(p)
    j_ext, j_v, t_ext, t_v = _ext(p, r)
    jc, jm = jsk.slab_lists_half(j_ext, j_v, jspec, RS, True)
    tc, tm = tsk.slab_lists_half(t_ext, t_v, tspec, RS)
    assert tuple(tm.shape) == tuple(jm.shape)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert torch.equal(tdf.mask_slot_counts(tm, tspec.cap), tc)


@pytest.mark.parametrize("want_pe", [True, False], ids=["pe", "hot"])
@pytest.mark.parametrize("p,r", RANKS, ids=RANK_IDS)
def test_slab_forces_half_match(p, r, want_pe):
    jspec, tspec = _specs(p)
    j_ext, j_v, t_ext, t_v = _ext(p, r)
    jf, jseam, jpe = jsk.slab_forces_half(j_ext, j_v, jspec, RC, True,
                                          want_pe)
    tf, tseam, tpe = tsk.slab_forces_half(t_ext, t_v, tspec, RC, want_pe)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tseam.numpy(), np.asarray(jseam), rtol=RTOL,
                               atol=ATOL)
    assert float(tseam.abs().max()) > 0.0  # pairs across the face exist
    valid = t_v[:tspec.rows]
    assert float(tf[:, ~valid].abs().sum()) == 0.0
    if want_pe:
        np.testing.assert_allclose(tpe.numpy(), np.asarray(jpe), rtol=1e-5,
                                   atol=1e-5)
    else:
        assert tpe is None and jpe is None


@pytest.mark.parametrize("r", [0, 1])
def test_slab_forces_interior_and_boundary_match(r):
    """P = 2 (nz = 4): the split passes against the JAX split passes, and
    together against the combined pass."""
    jspec, tspec = _specs(2)
    mc, nz = tspec.mc, tspec.nz
    j_ext, j_v, t_ext, t_v = _ext(2, r)
    rows = tspec.rows
    j_low, j_top = jsk.slab_forces_interior(j_ext[:, :rows], jspec, RC, True)
    t_low, t_top = tsk.slab_forces_interior(t_ext[:, :rows].contiguous(),
                                            tspec, RC)
    j_last, j_seam = jsk.slab_forces_boundary(
        j_ext[:, (nz - 1) * mc:rows], j_ext[:, rows:], j_v[rows:], jspec, RC,
        True)
    t_last, t_seam = tsk.slab_forces_boundary(
        t_ext[:, (nz - 1) * mc:rows], t_ext[:, rows:], t_v[rows:], tspec, RC)
    for got, want in ((t_low, j_low), (t_top, j_top), (t_last, j_last),
                      (t_seam, j_seam)):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
    f, seam, _ = tsk.slab_forces_half(t_ext, t_v, tspec, RC)
    split = torch.cat([t_low, t_last + t_top], dim=1)
    scale = max(float(f.abs().max()), 1.0)
    assert float((split - f).abs().max()) <= 1e-5 * scale
    assert float((t_seam - seam).abs().max()) <= 1e-5 * scale


def test_slab_forces_interior_needs_two_layers():
    _, tspec = _specs(8)
    with pytest.raises(ValueError):
        tsk.slab_forces_interior(torch.zeros((3, tspec.rows, tspec.mc,
                                              tspec.cap)), tspec, RC)


def _park_alias_case():
    """The JAX regression case of tests/test_dense_slab.py: nz = 1, one
    particle per cell at slot 0 in the owned layer and in the ghost layer,
    whose empty slots sit on the SENDER's park rows 0..mc-1."""
    spec = tsk.SlabSpec(mc=4, nz=1, mc_z=4, cap=8, L=8.0, cell_size=2.0,
                        cell_z=2.0)
    mc, cap, rows = spec.mc, spec.cap, spec.rows
    park = tdc.park_lattice(spec, "cpu")
    pos, gpos = park.clone(), park.clone()
    pid = torch.full((rows, mc, cap), -1, dtype=torch.int32)
    gpid = pid.clone()
    for y in range(mc):
        for x in range(mc):
            pos[:, y, x, 0] = torch.tensor([2.0 * x + 1, 2.0 * y + 1, 1.5])
            gpos[:, y, x, 0] = torch.tensor([2.0 * x + 1, 2.0 * y + 1, 2.5])
            pid[y, x, 0] = y * mc + x
            gpid[y, x, 0] = mc * mc + y * mc + x
    ext = torch.cat([pos, gpos], dim=1)
    valid = torch.cat([pid >= 0, gpid >= 0], dim=0)
    return spec, ext, valid


def test_repark_ghost_park_alias_nz1(monkeypatch):
    """Finite with the ghost re-park, NaN without it (the case really builds
    the collision), and equal to the JAX production path."""
    spec, ext, valid = _park_alias_case()
    f, seam, _ = tsk.slab_forces_half(ext, valid, spec, 2.5)
    assert bool(torch.isfinite(f).all()) and bool(torch.isfinite(seam).all())
    assert float(seam.abs().max()) > 0.0
    jspec = jsk.SlabSpec(mc=4, nz=1, mc_z=4, cap=8, L=8.0, cell_size=2.0,
                         cell_z=2.0)
    jf, jseam, _ = jsk.slab_forces_half(
        jnp.asarray(ext.numpy()), jnp.asarray(valid.numpy(), jnp.float32),
        jspec, 2.5, True)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(seam.numpy(), np.asarray(jseam), rtol=RTOL,
                               atol=ATOL)
    monkeypatch.setattr(tsk, "_repark_ghost", lambda e, v, s: e)
    f_raw, _, _ = tsk.slab_forces_half(ext, valid, spec, 2.5)
    assert not bool(torch.isfinite(f_raw).all())


@pytest.mark.parametrize("p", [2, 4])
def test_slabs_cut_from_a_cube_reproduce_its_sweeps(p):
    """Serial emulation of P slabs over a rebuilt cube state (mc = 4), the
    seams handed on by hand: per-slot counts bitwise equal to the cube's,
    forces within 1e-5 of the largest. P = 4 is nz = 1 (the combined pass
    only); P = 2 also through the interior/boundary split. Each slab's empty
    slots are re-parked at slab-local rows, as a slab rebuild parks them."""
    _, _, ts, tspec, _ = rebuilt_pair("mc4_cap32")
    mc, L = tspec.mc, tspec.L
    nz = mc // p
    spec = tsk.SlabSpec(mc=mc, nz=nz, mc_z=mc, cap=tspec.cap, L=L,
                        cell_size=tspec.cell_size, cell_z=tspec.cell_size)
    valid = ts.valid()
    counts_cube = tdf.counts_half_plain(ts.pos, tspec, 2.8)
    f_cube, _ = tdf.forces_half_plain(ts.pos, tspec, 2.5)
    rows = nz * mc
    park = tdc.park_lattice(spec, "cpu")
    parts, seams, counts, split = [], [], [], []
    for r in range(p):
        own = slice(r * rows, (r + 1) * rows)
        pos = torch.where(valid[own][None], ts.pos[:, own], park)
        g0 = ((r + 1) * rows) % (mc * mc)
        gpos = ts.pos[:, g0:g0 + mc].clone()
        if r == p - 1:
            gpos[2] += float(np.float32(L))
        ext = torch.cat([pos, gpos], dim=1)
        ext_v = torch.cat([valid[own], valid[g0:g0 + mc]], dim=0)
        f, seam, _ = tsk.slab_forces_half(ext, ext_v, spec, 2.5)
        parts.append(f.clone())
        seams.append(seam)
        counts.append(tsk.slab_lists_half(ext, ext_v, spec, 2.8)[0])
        if nz >= 2:
            low, top = tsk.slab_forces_interior(pos, spec, 2.5)
            last, seam2 = tsk.slab_forces_boundary(
                pos[:, (nz - 1) * mc:], gpos, valid[g0:g0 + mc], spec, 2.5)
            split.append((torch.cat([low, last + top], dim=1), seam2))
    for r in range(p):
        parts[(r + 1) % p][:, :mc] += seams[r]
    assert torch.equal(torch.cat(counts), counts_cube)
    scale = max(float(f_cube.abs().max()), 1.0)
    assert float((torch.cat(parts, dim=1) - f_cube).abs().max()) <= 1e-5 * scale
    if split:
        forces = [f for f, _ in split]
        for r in range(p):
            forces[(r + 1) % p][:, :mc] += split[r][1]
        err = float((torch.cat(forces, dim=1) - f_cube).abs().max())
        assert err <= 1e-5 * scale


def test_slab_forms_reject_wrong_inputs():
    _, tspec = _specs(2)
    one_layer = torch.zeros((3, tspec.mc, tspec.mc, tspec.cap))
    with pytest.raises(ValueError):
        tdf.dense_forces_half_slab(one_layer, tspec, RC)
    with pytest.raises(ValueError):
        tdf.dense_lists_half_slab(torch.zeros((3, tspec.mc + 1, tspec.mc,
                                               tspec.cap)), tspec, RS)
    with pytest.raises(ValueError):
        tdf.dense_forces_half_slab(torch.zeros((3, 2 * tspec.mc, tspec.mc,
                                                tspec.cap),
                                               dtype=torch.float64), tspec,
                                   RC)
