"""The repo-level entry points of the port: one engine step to call, and the
slab engine's distributed step run over P ranks (the counterpart of the JAX
package's ``__graft_entry__.py``, gate for gate).

``entry()`` returns one NVE step of the dense engine at N = 8,192 and its
example carry. ``dryrun_multichip(P)`` runs ``DenseSlabSimulator`` over P
ranks at c5-shaped physics until the melt has crossed a rebuild vote with
real migrations, and holds the run to particle conservation, the O(N^2)
oracle's pair count and NVE energy; for P >= 2 it adds a P = 2 run with
nz >= 2 owned layers a rank, which takes the interior/boundary force split.

The ranks are P threads of one process on a ``parallel.mesh.LocalRing`` (the
counterpart of the JAX package's virtual-device mesh), on
``cuda:rank % device_count`` or on the CPU. On a ``LocalRing`` the engine runs
its eager step (its exchanges are host barriers, which a graph cannot hold).
A gate that fails raises ``AssertionError``.

    from md_neighbor_list_tpu_torch.entry import dryrun_multichip
    dryrun_multichip(4)                  # dryrun_multichip(4, device="cpu")
"""

from __future__ import annotations

import math

import torch

from md_neighbor_list_tpu_torch.core.box import Box
from md_neighbor_list_tpu_torch.core.config import MDConfig
from md_neighbor_list_tpu_torch.models.dense_lj import DenseSimulator
from md_neighbor_list_tpu_torch.ops.oracle import pair_count
from md_neighbor_list_tpu_torch.parallel.dense_slab import DenseSlabSimulator
from md_neighbor_list_tpu_torch.parallel.mesh import run_ranks

MAX_STEPS = 600  # the melt must cross a rebuild vote with migration by then
DRIFT_GATE = 1e-4


def entry(device="cuda"):
    """(fn, example_args): one velocity-Verlet step of the dense engine (the
    CUDA kernels on the card, their plain versions on the CPU) and the
    carry of its lattice start at N = 8,192."""
    cfg = MDConfig(n=8192, dt=0.001, temperature=0.8)
    sim = DenseSimulator(cfg, device=device)
    carry = sim.init(torch.Generator(sim.device).manual_seed(0))
    return sim.step_fn, (carry,)


def _gate(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def _energy(sim: DenseSlabSimulator, carry) -> float:
    ke, pe = sim.energies(carry)
    return float(ke) + float(pe)


def _conserved(sim: DenseSlabSimulator, carry) -> None:
    """Every particle held by exactly one slot of one rank."""
    pid = sim.ring.gather(carry.pid).reshape(-1)
    held = torch.sort(pid[pid >= 0].long()).values
    n = sim.config.n
    _gate(torch.equal(held.cpu(), torch.arange(n)),
          f"P={sim.p}: {held.numel()} slots hold particles, not each of the "
          f"{n} once")


def _melt(ring, cfg: MDConfig, device) -> dict:
    """One rank of the main phase: run until 2 or more rebuilds (the first
    is the initial build) and 1 or more migrations, then the energies and
    the exact pair count of a fresh build of the gathered system."""
    sim = DenseSlabSimulator(cfg, device=device, ring=ring)
    state = sim.init(torch.Generator(sim.device).manual_seed(0))
    e0 = _energy(sim, state)
    steps = 0
    while steps < MAX_STEPS:
        state = sim.run(state, 20, chunk=20)
        steps += 20
        if int(state.n_rebuilds) >= 2 and int(state.n_migrated) >= 1:
            break
    rebuilds, migrated = int(state.n_rebuilds), int(state.n_migrated)
    _gate(rebuilds >= 2, f"no post-init rebuild vote in {steps} steps")
    _gate(migrated >= 1, f"no migration exercised in {steps} steps")
    _gate(not bool(state.overflow), "a cell overflowed")
    _conserved(sim, state)
    system = sim.gather(state)
    # the energy before the parity build, which may grow cap; the pairs of
    # FRESH bins (the state's are up to 20 steps stale): the oracle and the
    # kernels then see the same positions
    e1 = _energy(sim, state)
    _, pairs = sim.lists(sim.build(system))
    return dict(steps=steps, rebuilds=rebuilds, migrated=migrated, e0=e0,
                e1=e1, pairs=pairs, pos=system.pos, L=sim.box.L,
                rs=cfg.rs)


def _overlap(ring, cfg: MDConfig, device) -> dict:
    """One rank of the overlap phase: 100 steps in chunks of 20."""
    sim = DenseSlabSimulator(cfg, device=device, ring=ring)
    _gate(sim.spec.nz >= 2, "overlap phase must split interior/seam")
    state = sim.init(torch.Generator(sim.device).manual_seed(1))
    e0 = _energy(sim, state)
    state = sim.run(state, 100, chunk=20)
    _gate(int(state.n_rebuilds) >= 1, "overlap phase: no rebuild")
    _gate(not bool(state.overflow), "overlap phase: a cell overflowed")
    _conserved(sim, state)
    return dict(nz=sim.spec.nz, rebuilds=int(state.n_rebuilds), e0=e0,
                e1=_energy(sim, state))


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """The slab engine's full distributed step — contiguous-layer ghost
    halos, boundary-layer migration, the Newton-3 seam return, the global
    rebuild vote — over ``n_devices`` ranks (``LocalRing`` threads on
    ``device``) at c5-shaped physics (rc = 2.5, skin = 0.3, rho = 1), run
    until a rebuild vote with real migrations. Asserts conservation, the
    oracle's pair count and |dE/E| < 1e-4; for ``n_devices`` >= 2 also the
    P = 2, nz >= 2 overlap phase. Prints one line a phase and returns their
    numbers."""
    # c5 physics at the smallest box with one cell layer per rank:
    # mc = max(3, P), L = mc * rs (1 % margin so floor(L / rs) lands on mc).
    # dt = 0.0005 keeps the integrator inside the 1e-4 drift gate at this N
    rc, skin = 2.5, 0.3
    n = int(math.ceil((max(3, n_devices) * (rc + skin) * 1.01) ** 3))
    cfg = MDConfig(n=n, rho=1.0, rc=rc, skin=skin, dt=0.0005,
                   temperature=1.0, mesh_devices=n_devices)
    ranks = run_ranks(n_devices, lambda ring: _melt(ring, cfg, device),
                      device=device)
    out = ranks[0]
    oracle = int(pair_count(out["pos"], Box(L=out["L"]), out["rs"]))
    _gate(out["pairs"] == oracle,
          f"P={n_devices} pair count {out['pairs']} != oracle {oracle}")
    drift = abs(out["e1"] - out["e0"]) / abs(out["e0"])
    _gate(drift < DRIFT_GATE,
          f"NVE drift {drift:.2e} over {out['steps']} steps")
    print(f"dryrun_multichip OK: P={n_devices}, N={n}, steps={out['steps']}, "
          f"rebuilds={out['rebuilds']}, migrated={out['migrated']}, "
          f"pairs={out['pairs']}==oracle, |dE/E|={drift:.2e}", flush=True)
    result = dict(p=n_devices, n=n, steps=out["steps"],
                  rebuilds=out["rebuilds"], migrated=out["migrated"],
                  pairs=out["pairs"], oracle_pairs=oracle, drift=drift)

    if n_devices >= 2:
        cfg2 = MDConfig(n=4096, rho=1.0, rc=1.5, skin=0.2, dt=0.0005,
                        temperature=0.8, mesh_devices=2)
        o = run_ranks(2, lambda ring: _overlap(ring, cfg2, device),
                      device=device)[0]
        drift2 = abs(o["e1"] - o["e0"]) / abs(o["e0"])
        _gate(drift2 < DRIFT_GATE, f"overlap-path NVE drift {drift2:.2e}")
        print(f"dryrun_multichip overlap phase OK: P=2, nz={o['nz']}, "
              f"N=4096, 100 steps, rebuilds={o['rebuilds']}, "
              f"|dE/E|={drift2:.2e}", flush=True)
        result.update(overlap_nz=o["nz"], overlap_rebuilds=o["rebuilds"],
                      overlap_drift=drift2)
    return result
