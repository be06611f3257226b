"""Captured steps on a ring of P processes: the check that a slab engine's
chunk runs as one device program at P > 1, and the probe of how a captured
step may hold the ring's exchanges.

One process a rank, started by ``torch.distributed.run``::

    python -m torch.distributed.run --standalone --nproc-per-node=P \\
        -m md_neighbor_list_tpu_torch.parallel.ring_check \\
        --engine {dense_slab,slab} --preset c4_sorted --steps S [--stage d]

Stages, each a separate run (a stage that hangs cannot be followed by another
in the same processes):

  a  a step of exchanges alone, captured and replayed S times: the vote (a
     ``max``), a ghost shift posted before local work and waited on after it,
     a seam shift, and a branch whose body holds no exchange and never runs
  b  the same with the branch taken every step, its body two ring sums
  c  the same, the body one shift
  d  (the default) the engine's own step: from one carry, S steps by ``run``
     (on a capturable ring one captured step replayed, each replay under
     ``torch.cuda.set_sync_debug_mode("error")``) and S by ``step_fn``;
     checks equal rebuilds (more than at the start), gathered positions
     within 5e-4 of each other and |dE/E| of the graph run within 1e-4

Stages a-c hold the graph's tensors bitwise against the same step run
eagerly. Their exchanges go straight to ``torch.distributed`` with the
``Ring``'s calls (``batch_isend_irecv`` pairs, ``all_reduce``), since the
ring refuses an exchange inside a body (``utils/graphs.py``); stage d uses
the engine's ring. The geometry (a layer of the dense slab grid) comes from
``--preset`` and ``--n`` at P ranks.

Every rank arms ``faulthandler`` for ``HANG_S`` seconds before each phase: a
phase that hangs prints every rank's Python stack and exits with status 1.
Rank 0 prints one JSON line; the exit status is 0 only if every check held.
With ``--device cpu`` (gloo) nothing is captured: both ways step eagerly,
which checks the control flow only.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import faulthandler
import json
import sys
import time
import traceback

import torch
import torch.distributed as dist

from md_neighbor_list_tpu_torch.core.box import Box
from md_neighbor_list_tpu_torch.core.config import PRESETS
from md_neighbor_list_tpu_torch.parallel import dense_slab, mesh, slab
from md_neighbor_list_tpu_torch.parallel.mesh import init_ring, rank_device
from md_neighbor_list_tpu_torch.utils import graphs

HANG_S = 50  # seconds a phase may take before every stack is dumped
GAP_TOL = 5e-4  # gathered positions, graph against step_fn
DRIFT_TOL = 1e-4


def arm() -> None:
    """Start (or restart) the hang timer of the phase that follows."""
    faulthandler.dump_traceback_later(HANG_S, exit=True)


@dataclasses.dataclass
class Result:
    fields: dict
    failures: list


@contextlib.contextmanager
def strict_replays():
    """``set_sync_debug_mode("error")`` around every ``StepGraph.replay``:
    a host read inside a replayed chunk raises."""
    replay = graphs.StepGraph.replay

    def strict(graph, nsteps):
        torch.cuda.set_sync_debug_mode("error")
        try:
            replay(graph, nsteps)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    graphs.StepGraph.replay = strict
    try:
        yield
    finally:
        graphs.StepGraph.replay = replay


def config(args, p: int):
    over = {"mesh_devices": p}
    if args.n is not None:
        over["n"] = args.n
    return dataclasses.replace(PRESETS[args.preset], **over)


# --------------------------------------------------------- stages a to c
def _shift(t: torch.Tensor, by: int) -> torch.Tensor:
    """``Ring``'s shift on the default group: send ``t`` to rank + by and
    return what rank - by sent."""
    rank, size = dist.get_rank(), dist.get_world_size()
    out = torch.empty_like(t)
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, t.contiguous(), (rank + by) % size),
        dist.P2POp(dist.irecv, out, (rank - by) % size)])
    for w in works:
        w.wait()
    return out


def _reduce(t: torch.Tensor, op) -> torch.Tensor:
    t = t.clone()
    dist.all_reduce(t, op=op)
    return t


def probe_state(layer: int, device) -> list[torch.Tensor]:
    """(x, ghost, seam, count): small integers in f32, so that every sum
    the steps take is exact."""
    rank = dist.get_rank()
    x = (torch.arange(3 * layer, device=device) % 4).to(torch.float32)
    x = x.reshape(3, layer) + rank
    return [x, torch.zeros_like(x), torch.zeros_like(x),
            torch.zeros((), dtype=torch.int64, device=device)]


def probe_step(stage: str, state: list[torch.Tensor]):
    x, ghost, seam, count = state

    def body() -> None:
        if stage == "a":
            count.add_(1)
        elif stage == "b":
            count.add_(_reduce(torch.sum(x > 1.0), dist.ReduceOp.SUM))
            count.add_(_reduce(torch.max(x).to(torch.int64),
                               dist.ReduceOp.SUM))
        else:
            ghost.add_(_shift(x, 1))

    def step(cond) -> None:
        x.add_(1.0)
        vote = _reduce(torch.max(x), dist.ReduceOp.MAX)
        pred = vote < 0.0 if stage == "a" else vote > 0.0
        rank, size = dist.get_rank(), dist.get_world_size()
        recv = torch.empty_like(x)
        works = dist.batch_isend_irecv([  # the ghost shift, posted
            dist.P2POp(dist.isend, x, (rank - 1) % size),
            dist.P2POp(dist.irecv, recv, (rank + 1) % size)])
        work = 2.0 * x  # local work while it is in flight
        for w in works:
            w.wait()
        ghost.copy_(recv)
        seam.copy_(_shift(work, 1))
        cond(pred, body)

    return step


def probe(args, device) -> Result:
    cfg = config(args, dist.get_world_size())
    spec = dense_slab.make_slab_spec(Box.from_density(cfg.n, cfg.rho),
                                     cfg.rs, cfg.mesh_devices)
    layer = spec.mc * spec.mc * spec.cap
    graph_state = probe_state(layer, device)
    eager_state = [t.clone() for t in graph_state]
    runner = graphs.ChunkRunner()
    arm()
    with strict_replays():
        runner.run(probe_step(args.stage, graph_state), args.steps,
                   graph_state, capturable=device.type == "cuda")
    arm()
    graphs.ChunkRunner().run(probe_step(args.stage, eager_state), args.steps,
                             eager_state, capturable=False)
    same = [bool(torch.equal(a, b)) for a, b in zip(graph_state, eager_state)]
    failures = [] if all(same) else [
        f"graph and eager differ (x, ghost, seam, count): {same}"]
    runs = int(graph_state[3]) if args.stage == "a" else args.steps
    if args.stage == "a" and runs:
        failures.append(f"the untaken body ran {runs} times")
    return Result({"layer_bytes": 4 * 3 * layer, "captures": runner.captures,
                   "capture_s": runner.capture_s}, failures)


# --------------------------------------------------------------- stage d
def engine_check(args, ring, device) -> Result:
    cfg = config(args, ring.size)
    if args.engine == "dense_slab":
        sim = dense_slab.DenseSlabSimulator(cfg, device=device, ring=ring)
        clone = dense_slab._clone
    else:
        sim = slab.SlabSimulator(cfg, device=device, ring=ring)
        clone = slab._clone
    card = sim.device.type == "cuda"

    def sync() -> None:
        if card:
            torch.cuda.synchronize(sim.device)

    arm()
    carry = sim.init(torch.Generator(device=sim.device).manual_seed(
        args.seed))
    e0 = sum(float(x) for x in sim.energies(carry))
    start = int(carry.n_rebuilds)
    graph, eager = clone(carry), clone(carry)
    arm()
    captures = sim._runner.captures
    sync()
    t0 = time.perf_counter()
    with strict_replays():
        graph = sim.run(graph, args.steps, chunk=args.steps)
    sync()
    graph_s = time.perf_counter() - t0
    captured = sim._runner.captures - captures
    capture_s = sim._runner.capture_s if captured else 0.0
    arm()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        eager = sim.step_fn(eager)
    sync()
    eager_s = time.perf_counter() - t0
    arm()
    d = (sim.gather(graph).pos - sim.gather(eager).pos).abs()
    gap = float(torch.minimum(d, sim.box.L - d).max())
    e1 = sum(float(x) for x in sim.energies(graph))
    drift = abs(e1 - e0) / abs(e0)
    r_graph, r_eager = int(graph.n_rebuilds), int(eager.n_rebuilds)
    failures = []
    if not r_graph == r_eager > start:
        failures.append(f"rebuilds: {r_graph} by the graph, {r_eager} "
                        f"eager, {start} at the start")
    if gap > GAP_TOL:
        failures.append(f"positions {gap} apart, more than {GAP_TOL}")
    if drift > DRIFT_TOL:
        failures.append(f"|dE/E| = {drift} > {DRIFT_TOL}")
    if card and ring.capturable and captured != 1:
        failures.append(f"{captured} captures on a capturable ring")
    fields = {}
    if args.profile and card:
        at = [eager]

        def eager_steps(k: int) -> None:
            for _ in range(k):
                at[0] = sim.step_fn(at[0])

        arm()
        fields["profile_graph"] = traced_share(
            ring, lambda k: sim._run_chunk(graph, k), args.profile)
        arm()
        fields["profile_eager"] = traced_share(ring, eager_steps,
                                               args.profile)
    return Result({
        **fields, "n": cfg.n, "rebuilds_graph": r_graph - start,
        "rebuilds_eager": r_eager - start, "position_gap": gap,
        "energy_drift": drift, "captures": captured, "capture_s": capture_s,
        "steps_per_s_graph": args.steps / (graph_s - capture_s),
        "steps_per_s_eager": args.steps / eager_s}, failures)


def traced_share(ring, advance, steps: int) -> dict:
    """``advance(steps)`` on every rank under ``torch.profiler`` (after 5
    traced steps that pay the tracer's set-up): each
    rank's wall ms (synchronised), the device ms of its kernels and of those
    among them that are NCCL's (which spin while they wait for a peer),
    gathered in rank order; and rank 0's eight longest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def trace(k: int):
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            advance(k)
            torch.cuda.synchronize()
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        return (time.perf_counter() - t0) * 1e3, sorted(rows,
                                                        key=lambda r: -r[1])

    trace(5)
    wall_ms, rows = trace(steps)
    here = torch.device("cuda", torch.cuda.current_device())
    mine = torch.tensor([wall_ms, sum(r[1] for r in rows),
                         sum(r[1] for r in rows if "nccl" in r[0].lower())],
                        dtype=torch.float64, device=here)
    wall, busy, nccl = ring.gather(mine).T.tolist()
    return {"steps": steps, "wall_ms": wall, "device_busy_ms": busy,
            "nccl_ms": nccl, "busy_share": [b / w for b, w in zip(busy, wall)],
            "top_rank0": [[k, ms, n] for k, ms, n in rows[:8]]}


# ------------------------------------------------------------------ main
def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m md_neighbor_list_tpu_torch.parallel.ring_check")
    ap.add_argument("--engine", choices=["dense_slab", "slab"],
                    default="dense_slab")
    ap.add_argument("--preset", default="c4_sorted")
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--stage", choices=["a", "b", "c", "d"], default="d")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", type=int, default=0, metavar="STEPS",
                    help="stage d on cards: trace STEPS more steps each way "
                    "(device busy share per rank)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    arm()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("ring_check runs on CUDA devices by default and "
                           "none is available; pass --device cpu")
    ring = init_ring(device)
    here = rank_device(device, ring.rank)
    try:
        result = (engine_check(args, ring, device) if args.stage == "d"
                  else probe(args, here))
        arm()
        failed = int(ring.sum(torch.tensor([len(result.failures)],
                                           device=here)))
    except BaseException:
        traceback.print_exc()  # now: tearing the group down may not return
        raise
    finally:
        # torn down on an error too, so that stage b shows what a teardown
        # after a refused capture does: it waits forever (PERF.md). The hang
        # timer stays armed through it and ends the rank
        arm()
        dist.destroy_process_group()
        faulthandler.cancel_dump_traceback_later()
    if ring.rank == 0:
        print(json.dumps({
            "ring_check": args.stage, "engine": args.engine,
            "preset": args.preset, "p": ring.size, "steps": args.steps,
            "backend": mesh.backend_for(device),
            "capturable": ring.capturable,
            "device": (torch.cuda.get_device_name(here)
                       if here.type == "cuda" else "cpu"),
            **result.fields, "failures": result.failures,
            "ok": failed == 0}), flush=True)
    for msg in result.failures:
        print(f"ring_check rank {ring.rank}: FAILED: {msg}", file=sys.stderr,
              flush=True)
    return 0 if failed == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
