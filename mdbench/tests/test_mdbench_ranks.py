"""The launcher of ranks on the CPU: a cell of two ranks on gloo at a small N
runs through ``run.py``'s own code (two processes of it, started and watched
by ``lib/ranks.py``) and prints one correct result; a rank that fails, or
that hangs, ends the run with no result within a limit; a cell of four cards
on a machine without them still exits 2; and the readers and helpers that
only the ranks use."""

import json
import subprocess
import sys
import time

import pytest

from mdbench.lib import harness, ranks, spec, trace
from mdbench.tests import util

CELL = "c5_dd.p2.quick"
QUICK = {"nve_slab_quick": {"driver": "nve_slab", "chunk": 10,
                            "warm_steps": 20, "check_steps": 3,
                            "trace_chunks": 1}}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A copy with ``c5_dd`` cut to two ranks and a small N (``c5_dd_p2``)
    and its cell under ``c5_dd.p4``'s limits."""
    body = json.loads((util.HERE / "workloads" / "c5_dd.p4.json")
                      .read_text())
    body.update(config="c5_dd_p2", traffic="nve_slab_quick", chips=2,
                reports_like="c5_dd.p4")
    root = util.bench_copy(tmp_path_factory.mktemp("bench"), traffic=QUICK,
                           cells={CELL: body})
    cfg = json.loads((util.HERE / "configs" / "c5_dd.json").read_text())
    cfg.update(mesh_devices=2, n=util.N_SMALL)
    (root / "configs" / "c5_dd_p2.json").write_text(json.dumps(cfg))
    return root


def launch(root, *extra, limit_s=300.0, program=None):
    argv = ["--workload", CELL, "--seed", str(util.SEED), "--seconds", "0.3",
            "--device", "cpu", "--root", str(root),
            *extra]
    return ranks.launch(argv, 2, time.time(), limit_s=limit_s,
                        program=program)


def test_two_gloo_ranks_print_one_correct_result(root):
    status, r = launch(root, "--trace", "1", "--control", "1")
    assert status == 0 and r is not None
    assert r["correct"], r["checks"]
    assert r["checks"]["lost"] == {"value": 0, "limit": 0}
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["device"]["count"] == 2 and len(r["device"]["affinity"]) == 2
    assert r["control"]["correct"] is False
    assert list(r)[-1] == "checks"
    counters = r["window"]["counters"]
    assert counters["steps"] == r["attempted"] + 1 + 10  # + the traced
    assert counters["rebuilds"] >= 0 and counters["migrated"] >= 0
    names = {m["name"] for m in spec.load_cell(
        CELL, root=root, benchmark=root.parent / "BENCHMARK.json").per_layer}
    assert {"step_device_ms", "rank_imbalance", "nccl_ms_per_step",
            "forces_half_slab_roofline"} <= names
    # on the CPU the trace holds no device operation: the readers find
    # nothing, and each rank's readings are there
    assert len(r["ranks"]) == 2


def test_a_fault_in_the_exchange_is_caught_through_the_launcher(root):
    for fault in ("ring", "frozen"):
        status, r = launch(root, "--fault", fault)
        assert status == 0 and r is not None
        assert not r["correct"], (fault, r["checks"])
        assert r["failed"] == r["attempted"]


def test_a_failing_rank_ends_the_run_with_no_result(tmp_path):
    """Rank 1 exits 3 at once while rank 0 would sleep a minute: the launcher
    ends rank 0, reports rank 1's status and no result, within seconds."""
    script = tmp_path / "rank.py"
    script.write_text(
        "import sys, time\n"
        "r = int(sys.argv[sys.argv.index('--rank') + 1])\n"
        "sys.exit(3) if r == 1 else time.sleep(60)\n")
    t0 = time.monotonic()
    status, r = ranks.launch([], 2, time.time(), limit_s=120.0,
                             program=[sys.executable, str(script)])
    assert (status, r) == (3, None)
    assert time.monotonic() - t0 < 20


def test_a_rank_killed_partway_ends_the_run(root, tmp_path):
    """A real run of two ranks in which rank 1 is killed during its window:
    rank 0, waiting in the ring, is ended and nothing is reported."""
    script = tmp_path / "rank.py"
    script.write_text(
        "import os, signal, sys, threading\n"
        f"sys.path.insert(0, {str(util.HERE.parent)!r})\n"
        "from mdbench.lib import window\n"
        "if int(sys.argv[sys.argv.index('--rank') + 1]) == 1:\n"
        "    run_window = window.run_window\n"
        "    def killed(*a, **k):\n"
        "        os.kill(os.getpid(), signal.SIGKILL)\n"
        "    window.run_window = killed\n"
        "sys.argv[0] = " + repr(str(ranks.RUN_PY)) + "\n"
        "import runpy\n"
        "runpy.run_path(sys.argv[0], run_name='__main__')\n")
    t0 = time.monotonic()
    status, r = launch(root, limit_s=240.0,
                       program=[sys.executable, str(script)])
    assert status != 0 and r is None
    assert time.monotonic() - t0 < 200


def test_a_hung_rank_passes_the_limit_and_is_ended(tmp_path):
    script = tmp_path / "rank.py"
    script.write_text("import time\ntime.sleep(60)\n")
    t0 = time.monotonic()
    status, r = ranks.launch([], 2, time.time(), limit_s=1.0,
                             program=[sys.executable, str(script)])
    assert (status, r) == (124, None)
    assert time.monotonic() - t0 < 20


def test_four_cards_asked_for_without_them_exits_2():
    import torch
    if torch.cuda.is_available() and torch.cuda.device_count() >= 4:
        return
    out = subprocess.run([sys.executable, str(ranks.RUN_PY), "--workload",
                          "c5_dd.p4", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         timeout=300, cwd=util.HERE.parent)
    assert out.returncode == 2 and out.stdout.strip() == ""


@pytest.mark.parametrize("size,allowed,shares", [
    (4, range(32), [list(range(8 * r, 8 * r + 8)) for r in range(4)]),
    (2, {4, 5, 6, 7, 20}, [[4, 5], [6, 7, 20]]),
    (4, {0, 1, 2, 3, 8, 9}, [[0], [1, 2], [3], [8, 9]]),
    (2, {3}, [[3], [3]])])
def test_each_rank_gets_its_equal_share_of_the_allowed_cpus(size, allowed,
                                                            shares):
    """Contiguous equal shares of the CPUs this process may use, disjoint
    where there are enough of them; every CPU where one share would be
    empty."""
    assert [ranks.share(r, size, allowed) for r in range(size)] == shares


@pytest.mark.parametrize("extra", [["--device", "cpu"], ["--root", "."],
                                   ["--ranks", "2"], ["--store", "s"],
                                   ["--t0", "0"]])
def test_options_of_a_rank_are_refused_where_no_rank_is_named(extra):
    out = subprocess.run([sys.executable, str(ranks.RUN_PY), "--workload",
                          "c5_dd.p4", "--seed", "1", "--seconds", "1",
                          *extra], capture_output=True, text=True,
                         timeout=120, cwd=util.HERE.parent)
    assert out.returncode == 2 and out.stdout.strip() == ""
    assert extra[0] in out.stderr


def test_per_rank_readers_make_one_number():
    def ctx(ops, rank):
        cell = spec.load_cell("c5_dd.p4")
        run = type("R", (), {"work": {"n": 1000, "ghost": 100,
                                      "pairs_rc": 50_000, "cap": 40}})()
        return harness.Context(cell, run, units=1000, window_s=1.0,
                               trace=trace.Trace(ops, [], [], units=10,
                                                 wall_s=1e-3), rank=rank)

    slow = [("void mdnl::force_sweep_kernel<0, false>(float const*)", 0, 30),
            ("void mdnl::force_sweep_kernel<0, false>(float const*)", 30, 40),
            ("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)",
             40, 45)]
    fast = slow[:1]
    roof = spec.metric_reader("forces_half_slab_roofline")
    a, b = roof.read(ctx(slow, 0)), roof.read(ctx(fast, 1))
    assert a[1] == pytest.approx(4e-6) and b[1] == pytest.approx(3e-6)
    assert roof.combine([a, b]) == a[0]
    nccl = spec.metric_reader("nccl_ms_per_step")
    assert nccl.read(ctx(slow, 0)) == pytest.approx(5e-4)
    assert nccl.read(ctx(fast, 1)) is None
    # the NCCL kernel's wait is left out of a rank's share
    busy = spec.metric_reader("step_device_ms")
    imb = spec.metric_reader("rank_imbalance")
    assert busy.read(ctx(slow, 0)) == pytest.approx(4.5e-3)
    assert imb.read(ctx(slow, 0)) == pytest.approx(4e-3)
    waits = slow[:1] + [(slow[2][0], 30, 45)]
    assert busy.read(ctx(waits, 1)) == pytest.approx(4.5e-3)
    assert imb.read(ctx(waits, 1)) == pytest.approx(3e-3)
    assert imb.combine([1.0, 1.0, 1.0, 1.0]) == 0.0
    assert imb.combine([2.0, 1.0, 1.0, 0.0]) == pytest.approx(100.0)


def test_slab_counters_and_the_ranks_mfu_are_read_from_the_run():
    """steps_per_rebuild reads the driver's own counters where it keeps
    them; step_mfu's ranks make the ring's share of the cards' peak."""
    cell = spec.load_cell("c5_dd.p4")
    spr = spec.metric_reader("steps_per_rebuild")

    def ctx(counters):
        run = type("R", (), {"work": {}, "counters": counters})()
        return harness.Context(cell, run, units=1000, window_s=1.0,
                               trace=None)

    assert spr.read(ctx({"steps": 600, "rebuilds": 25,
                         "migrated": 9})) == 24.0
    assert spr.read(ctx({"steps": 600, "rebuilds": 0, "migrated": 0})) \
        is None
    assert spr.read(ctx({"steps": 600, "rebuilds": None,
                         "migrated": None})) is None
    mfu = spec.metric_reader("step_mfu")
    assert mfu.combine([1.0, 2.0, 3.0, 2.0]) == 2.0
    assert mfu.combine([1.5]) == 1.5


def test_pairs_of_each_rank_add_up_to_the_pairs():
    """The ranks' shares of the pairs within rc partition them: every pair
    is one rank's work."""
    import torch
    from mdbench.reference import lj, slabs
    g = torch.Generator().manual_seed(5)
    L, n = 12.0, 1500
    pos = torch.rand((n, 3), generator=g, dtype=torch.float64) * L
    total = len(lj.brute_half_pairs(pos, L, 2.5))
    for p, nz in ((2, 2), (4, 1), (3, 1)):
        works = [slabs.rank_work(pos, L, 2.5, p * nz, nz, r)
                 for r in range(p)]
        assert sum(w["pairs_rc"] for w in works) == total
        assert sum(w["n"] for w in works) == n
