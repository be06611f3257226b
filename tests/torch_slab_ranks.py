"""One rank of a ``DenseSlabSimulator`` run on a gloo group, as a process of
its own: what ``tests/test_torch_dense_slab.py`` spawns. It imports no JAX, so
a rank starts in the time it takes to import PyTorch.

    python tests/torch_slab_ranks.py RANK WORLD STORE JOB_JSON OUT_NPZ

``STORE`` is the path of the group's ``FileStore``; ``JOB_JSON`` holds the
``MDConfig`` fields (``config``), ``cap``, ``steps``, ``chunk`` and
optionally ``system`` (an ``.npz`` with the packed ``pos`` and ``vel`` every
rank starts from; else ``init()`` makes the lattice start). The rank writes
the gathered initial and final states, the global pair count and energies,
and its own counters to ``OUT_NPZ``.
"""

from __future__ import annotations

import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from md_neighbor_list_tpu_torch.core.config import MDConfig  # noqa: E402
from md_neighbor_list_tpu_torch.parallel.dense_slab import \
    DenseSlabSimulator  # noqa: E402
from md_neighbor_list_tpu_torch.parallel.mesh import init_ring  # noqa: E402
from md_neighbor_list_tpu_torch.utils import convert  # noqa: E402


def main(rank: int, world: int, store: str, job: dict, out: str) -> None:
    torch.set_num_threads(1)
    ring = init_ring("cpu", f"file://{store}", world, rank)
    try:
        cfg = MDConfig(**job["config"], mesh_devices=world)
        sim = DenseSlabSimulator(cfg, cap=job["cap"], device="cpu", ring=ring)
        if job.get("system"):
            npz = np.load(job["system"])
            n = npz["pos"].shape[0]
            system = convert.system_from_numpy(
                npz["pos"], npz["vel"], np.zeros((n, 3), np.float32),
                np.arange(n, dtype=np.int32), device="cpu")
            carry = sim.build(system)
        else:
            carry = sim.init()
        first = sim.gather(carry)
        _, pairs0 = sim.lists(carry)
        ke0, pe0 = sim.energies(carry)
        carry = sim.run(carry, job["steps"], chunk=job["chunk"])
        last = sim.gather(carry)
        _, pairs1 = sim.lists(carry)
        ke1, pe1 = sim.energies(carry)
        held = ring.gather(carry.pid).reshape(-1)  # every rank's slots
        np.savez(
            out, pos0=first.pos.numpy(), force0=first.force.numpy(),
            pos1=last.pos.numpy(), pairs0=pairs0, pairs1=pairs1,
            e0=float(ke0 + pe0), e1=float(ke1 + pe1),
            n_rebuilds=int(carry.n_rebuilds),
            n_migrated=int(carry.n_migrated),
            overflow=bool(carry.overflow),
            pids=held[held >= 0].numpy(),
            cap=sim.cap, mc=sim.spec.mc, nz=sim.spec.nz)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
         json.loads(sys.argv[4]), sys.argv[5])
