"""A cell of several cards: one process a rank, started and watched by
``run.py``.

The launcher (``launch``), in the process that ``run.py`` was started as,
measures nothing itself. It makes a folder under ``TMPDIR`` for the ranks'
``FileStore`` and rank 0's result, starts P processes of ``run.py`` with the
same arguments and the hidden ``--rank r --ranks P --store <path> --t0 <s>``,
each with ``OMP_NUM_THREADS=1`` and the cards numbered in PCI order, and waits
for them. If any rank exits non-zero, is killed, or the run passes
``LIMIT_S``, it ends the others, waits until each has ended, and reports no
result. If every rank returns 0 it reads rank 0's result, which ``run.py``
prints as its last line.

A rank (``rank_main``):

  pins itself, before it starts a thread, to its contiguous equal share of
  the CPUs this process may use;
  joins the process group through the ``FileStore`` (NCCL on the cards, gloo
  for a run on the CPU), binds ``cuda:r`` and builds the port's ``Ring``;
  runs ``harness.run_cell``'s phases (set-up, the untraced window, the traced
  stretch, the check), each opened and closed by a barrier, with
  ``faulthandler`` armed for ``PHASE_S[phase]`` seconds: a phase that hangs
  prints every thread's stack and exits 1, and the launcher ends the rest;
  applies the look for JAX (``run.py``'s ``forbidden_modules``) and gathers
  every rank's finding: any rank that loaded it fails the run;
  tears the group down only after a run that returned (a group torn down after
  a failed capture can wait forever): a rank that fails exits at once.

Rank 0 times the window between two barriers, each after
``torch.cuda.synchronize()``, and decides for every rank when it closes: after
each chunk it broadcasts whether the window goes on, so every rank runs the
same chunks. ``setup_s`` runs from the launcher's first statement (``--t0``, on
the host's wall clock) to the first timed step.
"""

from __future__ import annotations

import contextlib
import faulthandler
import json
import os
import pathlib
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import traceback

RUN_PY = pathlib.Path(__file__).resolve().parents[1] / "run.py"
LIMIT_S = 1190.0  # a whole run, the first one in a checkout building
# seconds a phase may take before its rank dumps its stacks and exits
PHASE_S = {"setup": 1050.0, "window": 240.0, "trace": 300.0, "check": 420.0,
           "report": 120.0}
POLL_S = 0.2
END_S = 10.0  # from SIGTERM to SIGKILL when the launcher ends a rank


# ------------------------------------------------------------- the launcher
def launch(argv: list, size: int, t0: float, limit_s: float = LIMIT_S,
           program: list | None = None) -> tuple[int, dict | None]:
    """Run ``size`` ranks of ``run.py argv`` (``program`` in its place, for
    tests) and return (status, rank 0's result): status 0 where every rank
    returned 0 and rank 0 left its result, else the first failing rank's
    status (1 where it left none, 124 past ``limit_s``), and no result."""
    folder = tempfile.mkdtemp(prefix="mdbench-ranks-")
    out = os.path.join(folder, "result.json")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               CUDA_DEVICE_ORDER="PCI_BUS_ID")
    base = program or [sys.executable, str(RUN_PY)]
    procs = []
    old = signal.signal(signal.SIGTERM, _ended)
    try:
        for r in range(size):
            procs.append(subprocess.Popen(
                [*base, *argv, "--rank", str(r), "--ranks", str(size),
                 "--store", os.path.join(folder, "store"), "--t0", repr(t0)],
                env=env))
        status = _watch(procs, time.monotonic() + limit_s)
        result = None
        if status == 0:
            if os.path.exists(out):
                with open(out) as f:
                    result = json.load(f)
            else:
                print("mdbench: rank 0 left no result", file=sys.stderr,
                      flush=True)
                status = 1
        return status, result
    finally:
        _end(procs)
        signal.signal(signal.SIGTERM, old)
        shutil.rmtree(folder, ignore_errors=True)


def _ended(signum, frame):
    raise SystemExit(128 + signum)  # the ranks are ended on the way out


def _watch(procs, deadline: float) -> int:
    """0 once every rank has returned 0; the status of the first that did
    not; 124 past the deadline."""
    while True:
        codes = [p.poll() for p in procs]
        bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
        if bad:
            r, c = bad[0]
            print(f"mdbench: rank {r} exited with status {c}: ending the "
                  "others, no result", file=sys.stderr, flush=True)
            return c if c > 0 else 1
        if all(c == 0 for c in codes):
            return 0
        if time.monotonic() > deadline:
            print("mdbench: the ranks passed their time limit: ending them, "
                  "no result", file=sys.stderr, flush=True)
            return 124
        time.sleep(POLL_S)


def _end(procs) -> None:
    """End every rank still running and wait until each has ended."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + END_S
    for p in procs:
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


# ----------------------------------------------------------- a rank's host
def _die_with_parent() -> None:
    """Have the kernel end this rank if the launcher dies (PR_SET_PDEATHSIG):
    no rank outlives its run."""
    try:
        import ctypes
        ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, signal.SIGKILL)
    except (OSError, AttributeError):
        pass


def share(rank: int, size: int, allowed) -> list:
    """The CPUs of ``rank``: its contiguous equal share of the sorted CPUs
    this process may use (every allowed CPU where the share would be
    empty)."""
    cpus = sorted(allowed)
    part = cpus[rank * len(cpus) // size:(rank + 1) * len(cpus) // size]
    return part or cpus


def pin(rank: int, size: int, on_card: bool) -> list:
    """Pin this process to its share of the CPUs it may use (on the card
    only); returns the CPUs it then runs on."""
    if on_card:
        with contextlib.suppress(OSError):
            os.sched_setaffinity(0, share(rank, size,
                                          os.sched_getaffinity(0)))
    return sorted(os.sched_getaffinity(0))


# ----------------------------------------------------------- a rank's group
class Group:
    """This rank's member of the run: the process group, its ``Ring``, and
    the harness's phases across the ranks (``harness.Solo`` is the same
    surface for one process)."""

    def __init__(self, rank: int, size: int, store: str, device: str):
        import torch
        import torch.distributed as dist
        from md_neighbor_list_tpu_torch.parallel import mesh

        self.rank, self.size, self.root = rank, size, rank == 0
        self.ring = mesh.init_ring(
            device, store=dist.FileStore(store, size), world_size=size,
            rank=rank)
        self.device = mesh.rank_device(device, rank)
        self.on_card = self.device.type == "cuda"
        self.driver_args = {"ring": self.ring}
        self._flag = torch.zeros((), dtype=torch.int32, device=self.device)

    def barrier(self) -> None:
        import torch.distributed as dist
        if self.on_card:
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    @contextlib.contextmanager
    def phase(self, name: str):
        """A phase of the run: a barrier opens and closes it, and a rank
        that spends more than ``PHASE_S[name]`` in it dumps its stacks and
        exits 1."""
        faulthandler.dump_traceback_later(PHASE_S[name], exit=True)
        self.barrier()
        yield
        self.barrier()
        faulthandler.cancel_dump_traceback_later()

    def sync(self, device_sync):
        """The window's fence: the card drained, then a barrier."""
        def fence():
            device_sync()
            self.barrier()
        return fence

    def agree(self, go: bool) -> bool:
        """Rank 0's decision, on every rank (whether the window goes on)."""
        import torch.distributed as dist
        self._flag.fill_(int(go))
        dist.broadcast(self._flag, src=0)
        return bool(self._flag.item())

    def gather(self, value) -> list:
        """Every rank's ``value``, in rank order, on every rank."""
        import torch.distributed as dist
        out = [None] * self.size
        dist.all_gather_object(out, value)
        return out

    def share(self, value):
        """Rank 0's ``value``, on every rank."""
        import torch.distributed as dist
        box = [value]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def close(self) -> None:
        import torch.distributed as dist
        self.barrier()
        dist.destroy_process_group()


def rank_main(args, forbidden_modules) -> int:
    """One rank of ``args.workload`` (``run.py``'s arguments with the hidden
    ones); rank 0 leaves its result beside the store for the launcher."""
    _die_with_parent()
    device = args.device or "cuda"
    cpus = pin(args.rank, args.ranks, device == "cuda")
    # this process's perf_counter at the launcher's first statement
    t_start = time.perf_counter() - (time.time() - args.t0)
    try:
        from mdbench import faults
        from mdbench.lib import harness, spec
        root = pathlib.Path(args.root) if args.root else spec.HERE
        cell = spec.load_cell(args.workload, root=root,
                              benchmark=root.parent / "BENCHMARK.json")
        if cell.chips != args.ranks:
            raise ValueError(f"cell {cell.name} asks for {cell.chips} "
                             f"ranks, {args.ranks} started")
        group = Group(args.rank, args.ranks, args.store, device)
        plant = (faults.planted(args.fault, cell.driver) if args.fault
                 else contextlib.nullcontext())
        with plant as fault:
            result = harness.run_cell(
                cell, args.seed, args.seconds, bool(args.trace), group.device,
                t_start, control=bool(args.control),
                on_window=fault and fault.arm, group=group)
        with group.phase("report"):
            found = group.gather(forbidden_modules())
            cpus_by_rank = group.gather(cpus)
        loaded = sorted({m for f in found for m in f})
        if loaded:
            print(f"mdbench: rank {args.rank}: the ranks loaded {loaded}: no "
                  "result", file=sys.stderr, flush=True)
            os._exit(3)
        if group.root:
            result["device"]["affinity"] = cpus_by_rank
            result["checks"] = result.pop("checks")  # last
            out = pathlib.Path(args.store).parent / "result.json"
            tmp = out.with_suffix(".part")
            tmp.write_text(json.dumps(result))
            tmp.rename(out)
        group.close()
        return 0
    except BaseException:  # no teardown after a failure: end at once
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
