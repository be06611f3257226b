"""The port's LJ over padded rows (``ops/lj.py``) and integrator pieces
(``ops/integrate.py``) against the JAX package's on the same numpy state and
rows, on the CPU.

Tolerances: forces within 2e-4 of the largest force component (the repo's
fp32 force gate: the Newton-3 scatter and the row sums add the same terms in
another order, ``index_add_`` one by one where the JAX package sums each
chunk's reactions first); energy and virial to a relative 1e-5 (a sum of some
10^5 f32 pair terms, chunk by chunk in the JAX order, whose rows are summed
in another order). The kick and drift are elementwise: bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from md_neighbor_list_tpu.core.box import Box as JBox
from md_neighbor_list_tpu.ops import binning as jb
from md_neighbor_list_tpu.ops import integrate as jint
from md_neighbor_list_tpu.ops import lj as jlj
from md_neighbor_list_tpu.ops import pairlist as jp
from md_neighbor_list_tpu_torch.core.box import Box as TBox
from md_neighbor_list_tpu_torch.ops import integrate as tint
from md_neighbor_list_tpu_torch.ops import lj as tlj
from md_neighbor_list_tpu_torch.ops import oracle as toracle
from torch_port_util import RC, RS, numpy_system

N = 1728
L = 12.0
FORCE_GATE = 2e-4
ENERGY_RTOL = 1e-5


def _rows(half, seed=3, jitter=0.05):
    """Sorted positions and padded rows of a jittered lattice, built by the
    JAX sweep (which the port's equals bit for bit: test_torch_pairlist)."""
    pos, _, _ = numpy_system(N, seed, jitter)
    box = JBox(L=L)
    pos_s, nl = jax.jit(jp.build_neighbor_lists, static_argnums=range(1, 8))(
        jnp.asarray(pos), box, jb.make_grid(box, RS), RS, 208, 40, half,
        "morton")
    return np.array(pos_s), np.array(nl.idx)


def _gate(got, want):
    scale = max(float(np.abs(want).max()), 1.0)
    assert float(np.abs(got - want).max()) <= FORCE_GATE * scale


@pytest.mark.parametrize("chunk", [8192, 500], ids=["one_chunk", "chunks"])
@pytest.mark.parametrize("half", [True, False], ids=["half", "full"])
def test_forces_energy_match_the_jax_package(half, chunk):
    pos, idx = _rows(half)
    jf, je = jax.jit(jlj.forces_energy, static_argnums=(2, 3, 4, 5))(
        jnp.asarray(pos), jnp.asarray(idx), JBox(L=L), RC, half, chunk)
    tf, te = tlj.forces_energy(torch.from_numpy(pos), torch.from_numpy(idx),
                               TBox(L=L), RC, half, chunk)
    assert tf.dtype == torch.float32 and tuple(tf.shape) == (N, 3)
    assert te.dtype == torch.float32 and te.dim() == 0
    _gate(tf.numpy(), np.asarray(jf))
    assert abs(float(te) - float(je)) <= ENERGY_RTOL * abs(float(je))
    # and the oracle's, on the same sorted positions
    of, oe = toracle.forces_energy(torch.from_numpy(pos), TBox(L=L), RC)
    _gate(tf.numpy(), of.numpy())
    assert abs(float(te) - float(oe)) <= ENERGY_RTOL * abs(float(oe))


@pytest.mark.parametrize("half", [True, False], ids=["half", "full"])
def test_energy_rows_restrict_the_energy_like_the_jax_package(half):
    pos, idx = _rows(half, seed=4)
    rows = np.random.default_rng(4).uniform(size=N) < 0.5
    _, je = jlj.forces_energy(jnp.asarray(pos), jnp.asarray(idx), JBox(L=L),
                              RC, half, energy_rows=jnp.asarray(rows))
    _, te = tlj.forces_energy(torch.from_numpy(pos), torch.from_numpy(idx),
                              TBox(L=L), RC, half,
                              energy_rows=torch.from_numpy(rows))
    assert abs(float(te) - float(je)) <= ENERGY_RTOL * abs(float(je))


@pytest.mark.parametrize("half", [True, False], ids=["half", "full"])
def test_pe_virial_match_the_jax_package(half):
    pos, idx = _rows(half, seed=5)
    je, jw = jlj.pe_virial(jnp.asarray(pos), jnp.asarray(idx), JBox(L=L), RC,
                           half)
    te, tw = tlj.pe_virial(torch.from_numpy(pos), torch.from_numpy(idx),
                           TBox(L=L), RC, half)
    assert abs(float(te) - float(je)) <= ENERGY_RTOL * abs(float(je))
    assert abs(float(tw) - float(jw)) <= ENERGY_RTOL * abs(float(jw))
    # the energy is forces_energy's
    _, fe = tlj.forces_energy(torch.from_numpy(pos), torch.from_numpy(idx),
                              TBox(L=L), RC, half)
    assert abs(float(te) - float(fe)) <= ENERGY_RTOL * abs(float(fe))


def test_sentinel_rows_give_nothing():
    pos, _ = _rows(True)
    idx = np.full((N, 16), N, np.int32)
    f, e = tlj.forces_energy(torch.from_numpy(pos), torch.from_numpy(idx),
                             TBox(L=L), RC, True)
    assert float(f.abs().max()) == 0.0 and float(e) == 0.0


def test_integrator_pieces_bitwise_equal_the_jax_package():
    pos, vel, _ = numpy_system(N, seed=6)
    force = np.random.default_rng(6).standard_normal((N, 3)).astype(
        np.float32) * 100
    off = np.float32(L) * (np.arange(N)[:, None] % 3 - 1)  # off the box
    pos = (pos + off).astype(np.float32)
    dt = 0.001
    tv = tint.half_kick(torch.from_numpy(vel), torch.from_numpy(force), dt)
    jv = jint.half_kick(jnp.asarray(vel), jnp.asarray(force), dt)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    tp = tint.drift(torch.from_numpy(pos), tv, dt, TBox(L=L))
    jpos = jint.drift(jnp.asarray(pos), jv, dt, JBox(L=L))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jpos))
    assert float(tp.min()) >= 0.0 and float(tp.max()) < L
    ke_t = float(tint.kinetic_energy(tv))
    ke_j = float(jint.kinetic_energy(jv))
    assert abs(ke_t - ke_j) <= 1e-6 * ke_j
