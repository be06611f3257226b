"""The slab engine at P = 2 with one owned layer a rank, where both
neighbours of a rank are one rank and its first layer is its last, against
the JAX engine from one JAX carry: the rebuild's boundary exchange, which
the JAX engine makes twice there (``dryrun_multichip(2)``'s physics)."""

import jax
import numpy as np

from md_neighbor_list_tpu.core.config import MDConfig as JConfig
from md_neighbor_list_tpu.parallel.dense_slab import \
    DenseSlabSimulator as JSlab
from md_neighbor_list_tpu_torch import MDConfig
from md_neighbor_list_tpu_torch.parallel.dense_slab import DenseSlabSimulator
from md_neighbor_list_tpu_torch.parallel.mesh import run_ranks
from md_neighbor_list_tpu_torch.utils import convert


def test_p2_single_layer_rebuild_keeps_each_particle_once():
    """At P = 2 with one owned layer a rank both neighbours are one rank and
    its first layer is its last: the JAX engine receives that layer twice at
    a rebuild, keeps the particles it owns twice, and takes it for a cell
    overflow (its ``run`` then grows cap at every rebuild, so the JAX
    ``dryrun_multichip(2)`` never ends). The port receives it once. From one
    JAX carry (the dry run's P = 2 physics) to just past the first
    rebuild."""
    fields = dict(n=611, rho=1.0, rc=2.5, skin=0.3, dt=0.0005,
                  temperature=1.0, mesh_devices=2)
    jsim = JSlab(JConfig(**fields), cap=96)  # no cell fills: only a
    # duplicate can raise the overflow flag
    jstate = jsim.init(jax.random.PRNGKey(0))
    carries = convert.slab_carries_from_numpy(
        *(np.asarray(a) for a in jstate), device="cpu")
    steps = 80  # the first vote for a rebuild comes at step 61-80
    jout = jsim._run_chunk(jstate, steps)
    assert np.asarray(jout.n_rebuilds).tolist() == [2, 2]
    assert np.asarray(jout.overflow).all()

    def rank(ring):
        sim = DenseSlabSimulator(MDConfig(**fields), cap=96, device="cpu",
                                 ring=ring)
        assert sim.spec.nz == 1
        out = sim._run_chunk(carries[ring.rank], steps)
        pid = ring.gather(out.pid).reshape(-1)
        return int(out.n_rebuilds), bool(out.overflow), pid[pid >= 0]

    for rebuilds, overflow, held in run_ranks(2, rank):
        assert (rebuilds, overflow) == (2, False)
        assert np.array_equal(np.sort(held.numpy()), np.arange(611))
