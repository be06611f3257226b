"""The command line: runs and validates an engine (PyTorch port of
``md_neighbor_list_tpu/cli.py``).

Initializes N particles, runs an engine, times it and cross-checks pair
counts and forces:

  python -m md_neighbor_list_tpu_torch --preset c3_verlet --steps 500
  python -m md_neighbor_list_tpu_torch --preset c1_brute --check-parity
  python -m md_neighbor_list_tpu_torch --n 100000 --engine dense --save s.npz
  python -m md_neighbor_list_tpu_torch --preset lammps_lj   # fcc, 2,048,000
  python -m md_neighbor_list_tpu_torch --device cpu --n 4096 --compare

Engines: ``xla`` (padded-row ``Simulator``), ``dense`` (``DenseSimulator``),
``dense_slab`` (``DenseSlabSimulator``: in process at ``--mesh-devices 1``)
and ``slab`` (``SlabSimulator``, the XLA slab engine: P >= 2 only). A slab
run with P > 1 takes one process per rank, started by ``torchrun
--nproc-per-node=P -m md_neighbor_list_tpu_torch ...``, rank 0 printing. A
box ``dense_slab`` cannot tile falls back to ``slab``, with a warning, as in
the JAX package. Runs on ``--device`` (the card by default). Emits JSON-lines
metrics on stderr and a summary on stdout.
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import os
import sys
import time

import numpy as np
import torch

from md_neighbor_list_tpu_torch.core.box import Box
from md_neighbor_list_tpu_torch.core.capacity import estimate
from md_neighbor_list_tpu_torch.core.config import PRESETS
from md_neighbor_list_tpu_torch.core.system import System, init_start
from md_neighbor_list_tpu_torch.models.dense_lj import DenseSimulator
from md_neighbor_list_tpu_torch.models.lj_nve import Simulator
from md_neighbor_list_tpu_torch.ops import oracle
from md_neighbor_list_tpu_torch.ops.binning import make_grid
from md_neighbor_list_tpu_torch.ops.pairlist import build_neighbor_lists
from md_neighbor_list_tpu_torch.parallel.dense_slab import (
    DenseSlabSimulator, make_slab_spec)
from md_neighbor_list_tpu_torch.parallel.mesh import init_ring
from md_neighbor_list_tpu_torch.parallel.slab import (SlabSimulator,
                                                      check_geometry)
from md_neighbor_list_tpu_torch.utils.checkpoint import load, save
from md_neighbor_list_tpu_torch.utils import trace
from md_neighbor_list_tpu_torch.utils.jsonlog import JsonLogger

TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
SLAB_ENGINES = ("slab", "dense_slab")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="md_neighbor_list_tpu_torch")
    ap.add_argument("--preset", default="c3_verlet",
                    help="c1_brute|c2_cell|c3_verlet|c4_sorted|c5_dd|"
                    "lammps_lj")
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--dt", type=float, default=None)
    ap.add_argument("--temperature", type=float, default=None)
    ap.add_argument("--mesh-devices", type=int, default=None,
                    help="slab count for the DD engine (c5 preset: 8; "
                    "1 = self-halo mode in one process)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engine", default="auto",
                    choices=["auto", "xla", "dense", "slab", "dense_slab"])
    ap.add_argument("--check-parity", action="store_true",
                    help="pair-count + force parity vs the O(N^2) oracle")
    ap.add_argument("--compare", action="store_true",
                    help="compare mode: run the xla AND dense "
                    "engines on one initial state, cross-check each "
                    "engine's own pair count and forces, time both")
    ap.add_argument("--save", default=None, help="checkpoint path (.npz)")
    ap.add_argument("--resume", default=None, help="resume from checkpoint")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    return ap


def _ring(engine: str, p: int, device):
    """The ring of a P > 1 slab run: this process's rank, from the env://
    variables that ``torchrun`` sets."""
    missing = [k for k in TORCHRUN_VARS if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"--engine {engine} with {p} slabs runs one process per rank: "
            f"start it as `torchrun --nproc-per-node={p} -m "
            "md_neighbor_list_tpu_torch ...` (the env:// variables "
            f"{', '.join(missing)} are not set)")
    if int(os.environ["WORLD_SIZE"]) != p:
        raise ValueError(f"WORLD_SIZE={os.environ['WORLD_SIZE']} but "
                         f"--mesh-devices is {p}")
    return init_ring(device)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the CLI runs on a CUDA device by default and none "
                           "is available; pass --device cpu")
    cfg = PRESETS[args.preset]
    over = {k: getattr(args, k)
            for k in ("n", "steps", "dt", "temperature", "mesh_devices")
            if getattr(args, k) is not None}
    if over:
        cfg = dataclasses.replace(cfg, **over)

    engine = args.engine
    if engine == "auto":
        engine = "dense_slab" if cfg.mesh_devices > 1 else (
            "dense" if device.type != "cpu" else "xla")
    if args.compare:
        logger = JsonLogger()
        logger.log("start", preset=args.preset, engine=engine, n=cfg.n,
                   steps=cfg.steps, device=str(device))
        generator = torch.Generator(device=device).manual_seed(args.seed)
        return _compare(cfg, generator, args.check_parity, logger, device)
    if engine == "dense_slab":
        # fall back to the XLA slab engine for a box the dense slabs cannot
        # tile. Only a tiny box lands here (under 3 cells a side, or fewer
        # rs-thick z-layers than ranks), and there the slab engine refuses
        # the box too, with its own ValueError
        try:
            make_slab_spec(Box.from_density(cfg.n, cfg.rho), cfg.rs,
                           cfg.mesh_devices)
        except ValueError as e:
            JsonLogger().log("engine_fallback", wanted="dense_slab",
                             reason=str(e))
            print(f"WARNING: dense_slab cannot tile this box ({e}); falling "
                  "back to the correctness-only XLA slab engine", flush=True)
            engine = "slab"
    if engine == "slab":
        check_geometry(cfg)  # its ValueError before any rank starts
    ring = None
    if engine in SLAB_ENGINES and cfg.mesh_devices > 1:
        ring = _ring(engine, cfg.mesh_devices, device)
    rc = _run(args, cfg, engine, ring, device)
    # not on an error: after a failed capture, tearing the NCCL group down
    # can wait forever, where the rank's exit ends it (PERF.md)
    if ring is not None:
        torch.distributed.destroy_process_group()
    return rc


def _run(args, cfg, engine, ring, device) -> int:
    rank0 = ring is None or ring.rank == 0
    # every rank runs the engine; rank 0 alone reports
    logger = JsonLogger() if rank0 else JsonLogger(stream=io.StringIO())
    logger.log("start", preset=args.preset, engine=engine, n=cfg.n,
               steps=cfg.steps, device=str(device))

    if engine == "dense_slab":
        sim = DenseSlabSimulator(cfg, device=device, ring=ring)
    elif engine == "slab":
        sim = SlabSimulator(cfg, device=device, ring=ring)
    elif engine == "dense":
        sim = DenseSimulator(cfg, device=device)
    else:
        sim = Simulator(cfg, device=device)

    if args.resume:
        system0, start_step = load(args.resume, device)
        carry = sim.build(system0)
        logger.log("resumed", path=args.resume, step=start_step)
    else:  # a slab rank's device is its own card
        carry = sim.init(torch.Generator(device=sim.device).manual_seed(
            args.seed))
    ke0, pe0 = (float(x) for x in sim.energies(carry))
    t1 = time.time()
    carry = sim.run(carry, cfg.steps)
    ke1, pe1 = (float(x) for x in sim.energies(carry))
    elapsed = time.time() - t1
    if engine in SLAB_ENGINES:
        system = sim.gather(carry)
        rebuilds = int(carry.n_rebuilds)
        pressure = None  # the DD engines: energies only
    else:
        if engine == "dense":
            pos, vel, force = sim.to_system(carry)
            system = System(*(torch.from_numpy(a).to(device)
                              for a in (pos, vel, force)),
                            pid=torch.arange(cfg.n, dtype=torch.int32,
                                             device=device))
            rebuilds = int(carry.n_rebuilds)
        else:
            system = carry.system
            rebuilds = int(carry.nbr.n_rebuilds)
        pressure = round(sim.pressure(carry), 6)

    e0, e1 = ke0 + pe0, ke1 + pe1
    drift = abs(e1 - e0) / max(abs(e0), 1e-9)
    logger.log("run_done", steps=cfg.steps, seconds=round(elapsed, 3),
               steps_per_s=round(cfg.steps / max(elapsed, 1e-9), 2),
               rebuilds=rebuilds, energy_drift=drift, pressure=pressure,
               counters=trace.counters())
    if not rank0:
        return 0

    parity_ok = None
    if args.check_parity:
        parity_ok = _check_parity(cfg, system, logger, device)

    if args.save:
        save(args.save, system, step=cfg.steps)
        logger.log("saved", path=args.save)

    print(
        f"{engine}: N={cfg.n} steps={cfg.steps} "
        f"steps/s={cfg.steps / max(elapsed, 1e-9):.2f} "
        f"rebuilds={rebuilds} |dE/E|={drift:.2e}"
        + ("" if parity_ok is None
           else f" parity={'OK' if parity_ok else 'FAIL'}"), flush=True)
    return 0 if (parity_ok is None or parity_ok) else 1


def compare(cfg, system0, device) -> dict:
    """Both single-card engines from one initial state: each engine's OWN
    artifact's pair count and step-0 forces (in pid order), then
    ``cfg.steps`` steps each, timed. Pair counts must be equal and forces
    within 2e-4 of the largest component."""
    rows = []
    # --- xla engine: padded-row artifact
    sim_x = Simulator(cfg, device=device)
    t0 = time.time()
    cx = sim_x.build(system0)
    hits = int(torch.sum(cx.nbr.idx < cfg.n))
    pairs_x = hits if cfg.half_list else hits // 2
    f_x = np.empty((cfg.n, 3), np.float32)
    f_x[cx.system.pid.cpu().numpy()] = cx.system.force.cpu().numpy()
    t1 = time.time()
    cx = sim_x.run(cx, cfg.steps)
    [float(x) for x in sim_x.energies(cx)]
    el_x = time.time() - t1
    rows.append(("xla", pairs_x, el_x, int(cx.nbr.n_rebuilds),
                 time.time() - t0))
    del cx, sim_x

    # --- dense engine: cluster-bitmask artifact
    sim_d = DenseSimulator(cfg, device=device)
    t0 = time.time()
    cd = sim_d.build(system0)
    _, _, _, total = sim_d._rebuild_and_lists(cd.state)
    pairs_d = int(total)
    _, _, f_d = sim_d.to_system(cd)
    t1 = time.time()
    cd = sim_d.run(cd, cfg.steps)
    [float(x) for x in sim_d.energies(cd)]
    el_d = time.time() - t1
    rows.append(("dense", pairs_d, el_d, int(cd.n_rebuilds),
                 time.time() - t0))

    scale = max(float(np.abs(f_x).max()), 1.0)
    ferr = float(np.abs(f_d - f_x).max())
    return {"rows": rows, "pairs_ok": pairs_x == pairs_d,
            "force_ok": ferr <= 2e-4 * scale, "max_cross_force_err": ferr,
            "force_scale": scale}


def _compare(cfg, generator, check_oracle: bool, logger, device) -> int:
    """Compare mode: the two engines on one lattice start (the preset's)
    (``compare``), and with ``check_oracle`` the xla pair count against the
    O(N^2) oracle; a table on stdout."""
    system0, _ = init_start(cfg, generator, device)
    res = compare(cfg, system0, device)
    rows = res["rows"]
    ok = res["pairs_ok"] and res["force_ok"]
    oracle_pairs = None
    if check_oracle:
        box = Box.from_density(cfg.n, cfg.rho)
        oracle_pairs = int(oracle.pair_count(system0.pos, box, cfg.rs))
        ok &= rows[0][1] == oracle_pairs

    logger.log("compare", pairs={r[0]: r[1] for r in rows},
               pairs_oracle=oracle_pairs,
               max_cross_force_err=res["max_cross_force_err"],
               force_scale=res["force_scale"], ok=ok)
    print(f"{'engine':<8} {'pairs':>12} {'steps/s':>9} "
          f"{'rebuilds':>8} {'total_s':>8}")
    for name, pairs, el, reb, tot in rows:
        print(f"{name:<8} {pairs:>12} {cfg.steps / max(el, 1e-9):>9.2f} "
              f"{reb:>8} {tot:>8.1f}")
    scale = res["force_scale"]
    print(f"cross-check: pairs {'==' if res['pairs_ok'] else '!='}"
          + (f" (oracle {oracle_pairs})" if oracle_pairs is not None else "")
          + f", max|dF| {res['max_cross_force_err']:.2e} vs 2e-4*scale="
          f"{2e-4 * scale:.2e} -> {'OK' if ok else 'FAIL'}", flush=True)
    return 0 if ok else 1


def _check_parity(cfg, system, logger, device) -> bool:
    """Pair-count + force parity vs the O(N^2) oracle."""
    box = Box.from_density(cfg.n, cfg.rho)
    grid = make_grid(box, cfg.rs)
    cap = estimate(cfg.rho, cfg.rs, grid.cell_size, half_list=True)
    pos = system.pos.to(device)
    want = int(oracle.pair_count(pos, box, cfg.rs))
    _, nl = build_neighbor_lists(pos, box, grid, cfg.rs, cap.neighbors,
                                 cap.cell, half=True, layout=cfg.layout)
    got = int(torch.sum(nl.count))
    # the oracle on the engine's own row order: rows compare 1:1
    f_o, _ = oracle.forces_energy(pos, box, cfg.rc)
    ferr = float((system.force.to(device) - f_o).abs().max())
    scale = float(f_o.abs().max())
    ok = (got == want) and ferr <= 2e-4 * max(scale, 1.0)
    logger.log("parity", pair_count_oracle=want, pair_count_engine=got,
               max_force_err=ferr, force_scale=scale, ok=ok)
    return ok


if __name__ == "__main__":
    sys.exit(main())
