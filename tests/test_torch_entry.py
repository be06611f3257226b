"""The port's entry points (``md_neighbor_list_tpu_torch/entry.py``) on the
CPU: ``entry()`` steps, its step continues the JAX ``__graft_entry__``
carry as the JAX step does, and ``dryrun_multichip(2)`` passes every gate of
the JAX dry run with its ranks as ``LocalRing`` threads (P = 4 in
``test_torch_entry_dryrun.py``, so that each file stays well inside a
minute)."""

import jax
import numpy as np

import __graft_entry__ as graft
from md_neighbor_list_tpu_torch.entry import dryrun_multichip, entry
from md_neighbor_list_tpu_torch.utils import convert
from torch_port_util import check_dryrun


def test_entry_steps_on_the_cpu():
    fn, (carry,) = entry(device="cpu")
    out = fn(carry)
    assert int(out.state.valid().sum()) == 8192
    assert bool(out.state.vel.isfinite().all())
    assert int(out.n_rebuilds) >= 1 and not bool(out.overflow)


def test_entry_step_continues_the_jax_entry_carry():
    """The JAX ``entry()`` carry taken across as numpy arrays: one step of
    the port's ``entry`` function gives the JAX step's forces within the
    force gate (2e-4 of the largest component), its slots bitwise."""
    jfn, (jcarry,) = graft.entry()
    fn, _ = entry(device="cpu")
    arrays = [np.asarray(a) for a in (*jcarry.state, jcarry.force,
                                      jcarry.ref_pos, jcarry.n_rebuilds,
                                      jcarry.overflow)]
    got = fn(convert.carry_from_numpy(*arrays, device="cpu"))
    want = jax.jit(jfn)(jcarry)
    f_j = np.asarray(want.force)
    scale = max(float(np.abs(f_j).max()), 1.0)
    np.testing.assert_allclose(got.force.numpy(), f_j, rtol=0,
                               atol=2e-4 * scale)
    np.testing.assert_array_equal(got.state.pid.numpy(),
                                  np.asarray(want.state.pid))
    np.testing.assert_allclose(got.state.pos.numpy(),
                               np.asarray(want.state.pos), rtol=0, atol=1e-5)
    assert int(got.n_rebuilds) == int(np.asarray(want.n_rebuilds))


def test_dryrun_multichip_p2_passes_its_gates(capsys):
    """At P = 2 with one layer a rank, where both neighbours are one rank
    (``test_torch_dense_slab_single_layer.py`` holds that case against the
    JAX engine, which keeps particles twice there)."""
    check_dryrun(dryrun_multichip(2, device="cpu"), 2,
                 capsys.readouterr().out)
