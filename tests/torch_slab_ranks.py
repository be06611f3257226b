"""One rank of a slab run on a gloo group, as a process of its own: what
``tests/test_torch_dense_slab.py`` and ``tests/test_torch_slab_ring.py``
spawn. It imports no JAX, so a rank starts in the time it takes to import
PyTorch.

    python tests/torch_slab_ranks.py RANK WORLD STORE JOB_JSON OUT_NPZ

``STORE`` is the path of the group's ``FileStore``; ``JOB_JSON`` holds
``engine`` (optional) and the job's fields. The rank writes its outputs to
``OUT_NPZ``. Engines:

- ``dense_slab`` (the default, ``dense_slab_run``): ``DenseSlabSimulator``
  with the ``MDConfig`` fields (``config``), ``cap``, ``steps``, ``chunk``
  and optionally ``system`` (an ``.npz`` with the packed ``pos`` and ``vel``
  every rank starts from; else ``init()`` makes the lattice start).
  Outputs: the gathered initial and final states, the global pair count and
  energies, and the rank's own counters.
- ``slab``: ``SlabSimulator`` with ``config``, ``steps`` and ``system``.
  Outputs: the rank's ``DDState`` after the build and after ``steps`` steps
  (``slab_states``).
- ``ring``: the ring's shifts and reductions on tensors made from a seed
  (``ring_ops``).

``dense_slab_run``, ``slab_states`` and ``ring_ops`` take any ring, so a test
runs them on a ``LocalRing`` too and compares. ``spawn_ranks`` starts the
processes of a run.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

WORKER = pathlib.Path(__file__).resolve()
ROOT = WORKER.parent.parent
sys.path.insert(0, str(ROOT))
RANK_SECONDS = 600

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from md_neighbor_list_tpu_torch.core.config import MDConfig  # noqa: E402
from md_neighbor_list_tpu_torch.parallel.dense_slab import \
    DenseSlabSimulator  # noqa: E402
from md_neighbor_list_tpu_torch.parallel.mesh import init_ring  # noqa: E402
from md_neighbor_list_tpu_torch.parallel.slab import \
    SlabSimulator  # noqa: E402
from md_neighbor_list_tpu_torch.utils import convert  # noqa: E402


def spawn_ranks(tmp_path, world: int, job: dict) -> list:
    """Run ``world`` ranks of this script on one gloo group (a ``FileStore``
    under ``tmp_path``); returns each rank's outputs."""
    outs = [tmp_path / f"rank{r}.npz" for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), str(world),
         str(tmp_path / "store"), json.dumps(job), str(outs[r])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_SECONDS)[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [dict(np.load(o)) for o in outs]


def load_system(path: str):
    """The packed start every rank reads: ``pos`` and ``vel``, pids 0..N-1."""
    npz = np.load(path)
    n = npz["pos"].shape[0]
    return convert.system_from_numpy(
        npz["pos"], npz["vel"], np.zeros((n, 3), np.float32),
        np.arange(n, dtype=np.int32), device="cpu")


def ring_ops(ring) -> dict:
    """Every operation of the ring on tensors made from a seed and the rank
    (f32 and i32), by name."""
    g = torch.Generator().manual_seed(100 + ring.rank)
    f = torch.randn((5, 3), generator=g)
    i = torch.randint(-50, 50, (7,), generator=g, dtype=torch.int32)
    return {
        "plus_f": ring.shift_plus(f), "minus_f": ring.shift_minus(f),
        "plus_i": ring.shift_plus(i, async_op=True).wait(),
        "minus_i": ring.shift_minus(i, async_op=True).wait(),
        "sum_f": ring.sum(f), "max_f": ring.max(f), "sum_i": ring.sum(i),
        "max_i": ring.max(i), "sum_0d": ring.sum(f[0, 0]),
        "gather_f": ring.gather(f), "gather_i": ring.gather(i)}


def slab_states(ring, job: dict) -> dict:
    """``SlabSimulator`` on this rank: its ``DDState`` after the build
    (``first_<field>``) and after ``job["steps"]`` steps (``last_<field>``)."""
    cfg = MDConfig(**job["config"], mesh_devices=ring.size)
    sim = SlabSimulator(cfg, device="cpu", ring=ring)
    first = sim.build(load_system(job["system"]))
    last = sim.run(first, job["steps"])
    out = {}
    for tag, st in (("first", first), ("last", last)):
        out.update({f"{tag}_{k}": v for k, v in st._asdict().items()})
    return out


def dense_slab_run(ring, job: dict) -> dict:
    """``DenseSlabSimulator`` on this rank: the gathered states, pair counts
    and energies before and after ``job["steps"]`` steps, and the counters,
    as numpy values."""
    cfg = MDConfig(**job["config"], mesh_devices=ring.size)
    sim = DenseSlabSimulator(cfg, cap=job["cap"], device="cpu", ring=ring)
    if job.get("system"):
        carry = sim.build(load_system(job["system"]))
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
    return dict(
        pos0=first.pos.numpy(), force0=first.force.numpy(),
        pos1=last.pos.numpy(), pairs0=pairs0, pairs1=pairs1,
        e0=float(ke0 + pe0), e1=float(ke1 + pe1),
        n_rebuilds=int(carry.n_rebuilds), n_migrated=int(carry.n_migrated),
        overflow=bool(carry.overflow), pids=held[held >= 0].numpy(),
        cap=sim.cap, mc=sim.spec.mc, nz=sim.spec.nz)


def main(rank: int, world: int, store: str, job: dict, out: str) -> None:
    torch.set_num_threads(1)
    ring = init_ring("cpu", f"file://{store}", world, rank)
    try:
        engine = job.get("engine", "dense_slab")
        if engine == "dense_slab":
            np.savez(out, **dense_slab_run(ring, job))
            return
        fn = ring_ops if engine == "ring" else (
            lambda r: slab_states(r, job))
        np.savez(out, **{k: v.numpy() for k, v in fn(ring).items()})
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
         json.loads(sys.argv[4]), sys.argv[5])
