#!/usr/bin/env python3
"""Check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``md_neighbor_list_tpu_torch/csrc``, holds each
against its plain PyTorch version (at small shapes that exercise wrap-around,
cell capacities from 28 to 480 — from 384 the partner passes of the list,
half-count, full-force and full-count kernels —, overflow and cleared
validity, then at the full N = 1,000,000 size;
the list, half-count, half-force, pe/virial and full-sweep kernels also on
each state with its slots scattered inside every cell, so that the occupied
slots form no prefix),
holds the NVE step's integrator (``csrc/integrate.cu``: the kicks, the drift
and the displacement vote) bit for bit against its plain sequence at
``c4_sorted``'s and ``lammps_lj``'s shapes (phase ``integrator``), holds the
NVE step's half list against the cell sweep at the same two shapes and runs
``c2_cell``, whose step keeps the sweep (phase ``list_sweep``),
and drives four paths through the entry points a user calls, each with the
launch counters set to 0 just before and read just after:

  main_path      the dense LJ engine (init -> list build -> NVE steps ->
                 observables) through ``DenseSimulator``;
  list_delivery  ``neighbor_list`` / ``pair_list`` at N = 1,000,000 (rebuild,
                 list kernel, host decode, built here with g++), held against
                 the half and full count kernels and a brute-force search of
                 1,000 sampled rows, then the full-sweep parity passes
                 (counts, forces, energy) of the lattice start, and one
                 ``neighbor_list`` call on a clustered input that needs
                 cap > 341, against a brute-force search of every row;
  incremental    ``DenseSimulator(incremental=True)``: the lattice start (its
                 from_packed seed trips the mover window, so the engine takes
                 the full rebuild), 1000 NVE steps whose rebuilds go through
                 the merge kernel. After it, at N = 1,000,000: the merge
                 kernel against its plain version, the incremental rebuild
                 against its order-exact twin and against the full rebuild;
  dense_slab     ``DenseSlabSimulator`` (the slab domain decomposition) in its
                 P = 1 self-halo mode on a one-rank NCCL group at
                 N = 1,000,000: 40,000,000 pairs, 1000 NVE steps through the
                 slab forms of K1-K3 (replays of one captured step, the
                 group's ``all_reduce`` calls in the graph: ``chunk`` says
                 "graph"), the trajectory of the cube engine after
                 100 steps. Before it, phase ``small_slab_shapes`` holds the
                 slab forms against their plain versions and the oracle at
                 nz = 1 and at cap 384 (a cluster in one cell), and grows the
                 P = 1 engine's cap past 341; phase ``slab_kernels`` holds the
                 slab forms against their plain versions at N = 1,000,000 and
                 emulates P = 5 and P = 7 slabs of the cube state serially
                 (counts bitwise, forces to rounding), and phase
                 ``slab_c5_geometry`` cuts the ``c5_dd`` deployment
                 (N = 8,000,000, P = 8, mc = 71, mc_z = 64) into its eight
                 slabs by the slab rebuild and holds them, one after the
                 other on the one card, against the cube engine at N = 8M.

Then the padded-row engine and the paths around it, which are plain PyTorch
and must launch none of the kernels (their counters are read around each):

  xla_engine        ``Simulator`` on ``c3_verlet`` uncut (N = 100,000, Morton,
                    half rows): the build's pairs against the oracle and the
                    dense engine's half count, its forces against the oracle,
                    1000 NVE steps, the observables, one ``rebuild_only``;
  xla_c2            ``Simulator`` on ``c2_cell`` (row-major, a rebuild every
                    step), 100 steps, the last list against the oracle;
  xla_compare       the CLI's ``--compare`` on ``c4_sorted`` at N = 1M (100
                    steps, cut from 1000): 40,000,000 pairs by each engine,
                    forces within the gate;
  xla_list_delivery ``neighbor_list(backend="xla")`` on the caller positions of
                    ``list_delivery``, half and full, against the dense
                    backend's rows, and what ``auto`` picks at N = 100k and
                    1M;
  xla_slab          ``SlabSimulator`` (the xla engine's slab decomposition)
                    on ``c4_sorted`` uncut at P = 4, the ranks four threads
                    of a ``LocalRing`` on the card: the lattice start's pairs
                    against the lattice's count and the dense engine's, then
                    100 steps from the lattice moved so that particles change
                    slab, against ``Simulator(half_list=False)``;
  xla_slab_c5       the same engine on ``c5_dd`` (N = 8,000,000, P = 8): the
                    pairs, then 20 steps;
  ring_graph        with two or more cards, both slab engines (their chunk a
                    captured step whose exchanges are NCCL's) on a ring of
                    P = min(4, cards) processes through
                    ``parallel/ring_check.py``: graph against eager; on one
                    card the line says ``"ran": false`` (NCCL takes one card
                    a rank), which is no pass;
  cli               ``python -m md_neighbor_list_tpu_torch`` in subprocesses:
                    ``c3_verlet`` with the oracle parity check and a
                    checkpoint, the xla engine resuming it, the slab engine at
                    P = 1.

Since the engines run each chunk as one captured CUDA graph (``run`` replays one
step, the rebuild a conditional node), phase ``graph_chunk`` follows
``main_path``, ``incremental``, ``dense_slab`` and ``xla_engine``: from the
path's final carry, 100 steps by ``run``, every replay under
``set_sync_debug_mode("error")`` (a host read inside a chunk fails the run),
against 100 steps of the eager ``step_fn``: equal rebuilds (and branch
counts), positions within 5e-4 (the slab engine's gathered by pid), the
drift, and one capture. Each path's own run captures its step once, too.
Phase ``build_graph`` follows ``graph_chunk`` on the two ``DenseSimulator``
paths: the list build ``_rebuild_and_lists`` as one replay of its captured
graph (the state copied into the engine's buffers first) against the build
the ops make (the full or incremental rebuild, then the list kernel) on five
states (the lattice's ``from_packed`` seed, which trips the incremental
engine's window predicate, the lattice start, three drifted states): state,
counts and masks bitwise, totals and branch counts equal. Phase ``entry``
(after ``dense_slab``) drives the port's entry points,
``md_neighbor_list_tpu_torch/entry.py``: ``entry()`` and one step at
N = 8,192, then ``dryrun_multichip(4)`` (four ``LocalRing`` threads on the
card, eager steps, with its P = 2 overlap phase), whose gates raise.

Each phase prints one JSON line of what it checked; any failure ends the run
with a non-zero exit code. Without a CUDA device the script fails at once. It
times nothing: the port's times come from ``mdbench/`` (a cell's
``--trace 1`` run). The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from md_neighbor_list_tpu_torch import (PRESETS, DenseSimulator, MDConfig,
                                        Simulator, api, cli, neighbor_list,
                                        pair_list)
from md_neighbor_list_tpu_torch import entry as entry_points
from md_neighbor_list_tpu_torch.core.box import Box
from md_neighbor_list_tpu_torch.core.system import System, init_lattice
from md_neighbor_list_tpu_torch.models import dense_lj, lj_nve
from md_neighbor_list_tpu_torch.ops import (_cuda, decode, dense_cells,
                                            dense_force, dense_ref,
                                            incremental, integrate, oracle,
                                            slab_kernels)
from md_neighbor_list_tpu_torch.parallel import dense_slab, mesh
from md_neighbor_list_tpu_torch.parallel.dense_slab import (
    DenseSlabSimulator, make_slab_spec)
from md_neighbor_list_tpu_torch.parallel.slab import SlabSimulator
from md_neighbor_list_tpu_torch.utils import graphs, native

# Forces sum ~30 f32 terms per slot (~70 in the full sweep) in an order that
# differs between the kernels (atomics in the half sweep, a fixed sequential
# order in the full sweep) and the plain versions (tree sums): agreement is
# to rounding. The tolerance scales with the largest force component.
FORCE_RTOL = 1e-4
FORCE_ATOL_SCALE = 2e-5
# Two different sweeps (half against full, either against the O(N^2) oracle)
# also see a pair across the periodic boundary from different sides:
# own - (partner + L) rounds at ulp(L), partner - (own - L) nearly exactly, and
# the r^-14 force law multiplies that difference. The repo's fp32 force-parity
# gate covers it: the largest deviation is at most this share of the largest
# force component.
FORCE_GATE = 2e-4
# The same two views can put a pair across the boundary on either side of the
# cutoff: at L = 100 the difference rounds at ulp(L)/2 = 3.8e-6, which moves
# r2 = 7.84 by up to 2.7e-6 of itself. Only a pair whose r2 lies within this
# relative band of the cutoff may be counted by one view and not the other
# (the full sweep counts both views, the half sweep and the lists take one,
# a brute-force minimum image is a third). On a lattice no pair is that close
# to the cutoff and every count is exact.
CUTOFF_BAND = 1e-5


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def captured_once(sim, before: int, path: str) -> None:
    """A run of ``sim`` captured its step once (its first chunk captures;
    ``before``: the engine's captures before the run)."""
    made = sim._runner.captures - before
    check(made == 1, f"{path}: {made} graph captures in the run, expected 1")


@contextlib.contextmanager
def strict_replays():
    """``torch.cuda.set_sync_debug_mode("error")`` around every
    ``StepGraph.replay``: a synchronising call (a host read) inside a chunk
    raises there."""
    replay = graphs.StepGraph.replay

    def strict(self, nsteps):
        torch.cuda.set_sync_debug_mode("error")
        try:
            replay(self, nsteps)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    graphs.StepGraph.replay = strict
    try:
        yield
    finally:
        graphs.StepGraph.replay = replay


def force_close(got: torch.Tensor, want: torch.Tensor) -> tuple[bool, float]:
    scale = max(float(want.abs().max()), 1.0)
    err = (got - want).abs()
    ok = bool((err <= FORCE_ATOL_SCALE * scale + FORCE_RTOL * want.abs()).all())
    return ok, float(err.max())


def within_force_gate(got: torch.Tensor,
                      want: torch.Tensor) -> tuple[bool, float]:
    err = float((got - want).abs().max())
    return err <= FORCE_GATE * max(float(want.abs().max()), 1.0), err


# ------------------------------------------------------------------ inputs
def cubic_sites(n: int) -> tuple[np.ndarray, int]:
    """(n, 3) integer sites of the smallest cubic lattice that holds n, and
    its sites per side."""
    m = math.ceil(n ** (1.0 / 3.0))
    while m**3 < n:
        m += 1
    idx = np.arange(n)
    return np.stack([idx % m, (idx // m) % m, idx // (m * m)], -1), m


def jittered_system(n: int, rho: float, seed: int, jitter: float, device,
                    cluster: int = 0, rs: float = 2.8) -> tuple[System, Box]:
    """Lattice positions moved by uniform numpy noise from ``seed`` (so the
    state has left the lattice) and Maxwell velocities at T = 1. With
    ``cluster`` = k, k particles are moved onto a fine jittered lattice inside
    cell (0, 0, 0) of the rs-grid and nobody else stays in that cell: one
    cell holds exactly k particles, no two closer than about 0.3."""
    box = Box.from_density(n, rho)
    rng = np.random.default_rng(seed)
    lattice, m = cubic_sites(n)
    pos = (lattice + 0.5) * (box.L / m) + rng.uniform(-jitter, jitter, (n, 3))
    pos %= box.L
    vel = rng.standard_normal((n, 3))
    vel -= vel.mean(axis=0, keepdims=True)
    if cluster:
        cell = box.L / int(box.L / rs)
        inside = np.all(pos < cell, axis=1)
        movers = np.concatenate([
            np.nonzero(inside)[0],
            np.nonzero(~inside)[0][:cluster - inside.sum()]])
        fine, mf = cubic_sites(cluster)
        pos[movers] = (0.15 + (fine + 0.5) * ((cell - 0.3) / mf)
                       + rng.uniform(-0.02, 0.02, (cluster, 3)))
    system = System(
        pos=torch.tensor(pos, dtype=torch.float32, device=device),
        vel=torch.tensor(vel, dtype=torch.float32, device=device),
        force=torch.zeros((n, 3), dtype=torch.float32, device=device),
        pid=torch.arange(n, dtype=torch.int32, device=device))
    return system, box


def expand_inputs(state: dense_cells.DenseState, spec, keys=None,
                  key_base: int = 0):
    """The expand kernel's inputs, as ``rebuild_dense`` makes them: the
    wrapped records, unsorted, the stable sort's permutation, the sorted keys
    and the row starts. ``keys`` (R, mc, cap) replace the cell keys: the
    mover stream's (``incremental.merge_inputs``), or a slab's from
    ``key_base`` on (``DenseSlabSimulator._rebuild``)."""
    state = state._replace(pos=torch.remainder(state.pos, spec.L))
    if keys is None:
        keys = dense_cells.cell_keys(state, spec)
    keys_s, order = torch.sort(keys.reshape(-1), stable=True)
    return (state.pos.reshape(3, -1), state.vel.reshape(3, -1),
            state.pid.reshape(-1), order, keys_s,
            dense_cells.row_starts(keys_s, spec, key_base))


def mover_inputs(state: dense_cells.DenseState, spec):
    """The mover expand's inputs, as ``incremental.merge_inputs`` makes
    them."""
    wrapped = state._replace(pos=torch.remainder(state.pos, spec.L))
    return expand_inputs(state, spec, incremental.mover_keys(wrapped,
                                                             spec)[0])


def slab_path_inputs(state: dense_cells.DenseState, spec):
    """The K1 slab form's inputs as the P = 1 slab engine's rebuild makes
    them from its own state (``DenseSlabSimulator._rebuild``): unwrapped
    slab keys of the wrapped slots, key_base = mc*mc."""
    keys = slab_kernels.slab_keys(torch.remainder(state.pos, spec.L),
                                  state.valid(), spec, 0, wrap=False)
    return expand_inputs(state, spec, keys, spec.mc * spec.mc)


# ------------------------------------------------- kernel against plain
def compare_kernels(state0: dense_cells.DenseState, spec, cfg, label: str):
    """Run every kernel and its plain version on the same inputs; fail on
    any disagreement. Returns (rebuilt state, per-kernel max errors)."""
    recs = expand_inputs(state0, spec)
    posvel, pid = dense_cells.expand(*recs, spec)
    torch.cuda.synchronize()
    posvel_p, pid_p = dense_cells.expand_plain(*recs, spec)
    check(torch.equal(pid, pid_p) and torch.equal(posvel, posvel_p),
          f"{label}: expand differs from its plain version")
    state = dense_cells.DenseState(pos=posvel[:3].contiguous(),
                                   vel=posvel[3:].contiguous(), pid=pid)
    valid = state.valid()
    pos = state.pos

    counts, masks = dense_force.dense_lists_half(pos, spec, cfg.rs)
    torch.cuda.synchronize()
    counts_p, masks_p = dense_force.lists_half_plain(pos, spec, cfg.rs)
    check(torch.equal(counts, counts_p), f"{label}: half counts differ")
    check(torch.equal(masks, masks_p), f"{label}: half masks differ")
    check(int(counts[~valid].abs().sum()) == 0,
          f"{label}: counts on empty slots")

    errs = {"expand": 0.0, "lists_half": 0.0}
    f_hot, _ = dense_force.dense_forces_half(pos, spec, cfg.rc)
    torch.cuda.synchronize()
    f_pe, pe = dense_force.dense_forces_half(pos, spec, cfg.rc, True)
    torch.cuda.synchronize()
    f_p, pe_p = dense_force.forces_half_plain(pos, spec, cfg.rc, True)
    for name, f in (("forces_half", f_hot), ("forces_half_pe", f_pe)):
        ok, errs[name] = force_close(f, f_p)
        check(ok, f"{label}: {name} forces off by {errs[name]}")
        check(float(f[:, ~valid].abs().sum()) == 0.0,
              f"{label}: {name} left a force on an empty slot")
    ok, pe_err = force_close(pe, pe_p)
    check(ok, f"{label}: forces_half_pe potential off by {pe_err}")
    check(float(pe[~valid].abs().sum()) == 0.0,
          f"{label}: forces_half_pe left a potential on an empty slot")
    errs["forces_half_pe"] = max(errs["forces_half_pe"], pe_err)

    pe4, vir4 = dense_force.dense_pe_virial(pos, spec, cfg.rc)
    torch.cuda.synchronize()
    pe4_p, vir4_p = dense_force.pe_virial_half_plain(pos, spec, cfg.rc)
    ok_pe, e_pe = force_close(pe4, pe4_p)
    ok_w, e_w = force_close(vir4, vir4_p)
    check(ok_pe and ok_w, f"{label}: pe/virial off by {e_pe}/{e_w}")
    check(float(pe4[~valid].abs().sum() + vir4[~valid].abs().sum()) == 0.0,
          f"{label}: pe_virial_half left a value on an empty slot")
    errs["pe_virial_half"] = max(e_pe, e_w)

    # K5: the list kernel's counts, bitwise
    half = dense_force.dense_counts_half(pos, spec, cfg.rs)
    torch.cuda.synchronize()
    check(torch.equal(half, dense_force.counts_half_plain(pos, spec, cfg.rs)),
          f"{label}: count_half differs from its plain version")
    check(torch.equal(half, counts),
          f"{label}: count_half differs from the list kernel's counts")
    errs["count_half"] = 0.0
    errs.update(compare_full_sweep(pos, valid, spec, cfg, label, f_p))
    full = dense_force.dense_counts(pos, valid, spec, cfg.rs)
    gap = int(full[valid].sum()) - 2 * int(half[valid].sum())
    check(abs(gap) <= band_pairs(pos, valid, spec, cfg.rs),
          f"{label}: full counts differ from twice the half counts by {gap}, "
          "more than the pairs in the cutoff band")
    return state, errs


def scatter_slots(state: dense_cells.DenseState, spec, seed: int):
    """``state`` with the slots of every cell permuted at random (a numpy
    seed): each cell keeps its particles, in slots drawn at random rather
    than a prefix, and its empty slots are re-parked at their new places
    with zero velocity (the twin of ``tests/torch_port_util.py``'s)."""
    rng = np.random.default_rng(seed)
    cells, cap = spec.rows * spec.mc, spec.cap
    perm = torch.from_numpy(np.argsort(rng.random((cells, cap)), axis=1))
    perm = perm.to(state.pid.device)

    def take(a):  # (..., R, mc, cap): new slot s of a cell holds slot perm[s]
        lead = a.shape[:-3]
        flat = a.reshape(lead + (cells, cap))
        return torch.gather(flat, -1, perm.expand(flat.shape)).reshape(a.shape)

    pid = take(state.pid)
    valid = pid >= 0
    pos = dense_cells.park_positions(take(state.pos), valid, spec)
    vel = torch.where(valid[None], take(state.vel), 0.0)
    return dense_cells.DenseState(pos=pos, vel=vel, pid=pid)


def half_sweeps_scattered(state: dense_cells.DenseState, spec, cfg,
                          label: str, seed: int = 5) -> dict:
    """K3 (both forms, cube and P = 1 slab) and K4 on ``state`` with its
    slots scattered inside each cell (``scatter_slots``): the occupied slots
    form no prefix. Each against its plain version; parked slots get exactly
    zero force, PE and virial; forces by pid equal those of ``state``'s own
    order to rounding. Returns the largest errors."""
    sc = scatter_slots(state, spec, seed)
    pos, valid = sc.pos, sc.valid()
    check(not torch.equal(valid, state.valid()),
          f"{label}: scattering left every slot in place")
    errs = {}
    f_p, pe_p = dense_force.forces_half_plain(pos, spec, cfg.rc, True)
    for name, want_pe in (("forces_half", False), ("forces_half_pe", True)):
        f, pe = dense_force.dense_forces_half(pos, spec, cfg.rc, want_pe)
        torch.cuda.synchronize()
        ok, errs[name] = force_close(f, f_p)
        check(ok, f"{label}: {name} forces off by {errs[name]} on scattered "
              "slots")
        check(float(f[:, ~valid].abs().sum()) == 0.0,
              f"{label}: {name} left a force on an empty scattered slot")
    ok, err = force_close(pe, pe_p)
    check(ok and float(pe[~valid].abs().sum()) == 0.0,
          f"{label}: forces_half_pe potential off by {err} on scattered slots")
    pe4, vir4 = dense_force.dense_pe_virial(pos, spec, cfg.rc)
    torch.cuda.synchronize()
    pe4_p, vir4_p = dense_force.pe_virial_half_plain(pos, spec, cfg.rc)
    ok_pe, e_pe = force_close(pe4, pe4_p)
    ok_w, e_w = force_close(vir4, vir4_p)
    check(ok_pe and ok_w and float(pe4[~valid].abs().sum()
                                   + vir4[~valid].abs().sum()) == 0.0,
          f"{label}: pe/virial off by {e_pe}/{e_w} on scattered slots")
    errs["pe_virial_half"] = max(e_pe, e_w)
    # the slab forms at P = 1: [scattered cube | its seam-shifted first layer]
    slab, windows, ext_v = p1_windows(pos, valid, spec)
    fs_p, pes_p = dense_force.forces_half_plain(windows, slab, cfg.rc, True,
                                                zwrap=False)
    for name, want_pe in (("forces_half_slab", False),
                          ("forces_half_slab_pe", True)):
        f, pe = dense_force.dense_forces_half_slab(windows, slab, cfg.rc,
                                                   want_pe)
        torch.cuda.synchronize()
        ok, errs[name] = force_close(f, fs_p)
        check(ok and float(f[:, ~ext_v].abs().sum()) == 0.0,
              f"{label}: {name} off by {errs[name]} on scattered slots")
    ok, err = force_close(pe, pes_p)
    check(ok and float(pe[~valid].abs().sum()) == 0.0,
          f"{label}: forces_half_slab_pe potential off by {err} on scattered "
          "slots")
    # the particles feel the same forces in either slot order
    f0, _ = dense_force.dense_forces_half(state.pos, spec, cfg.rc)
    by_pid = []
    for st, f in ((state, f0), (sc, dense_force.dense_forces_half(
            pos, spec, cfg.rc)[0])):
        keep = st.valid().reshape(-1)
        out = torch.zeros((int(state.pid.max()) + 1, 3), device=f.device)
        out[st.pid.reshape(-1)[keep].long()] = f.reshape(3, -1)[:, keep].T
        by_pid.append(out)
    ok, err = force_close(by_pid[1], by_pid[0])
    check(ok, f"{label}: forces by pid differ by {err} between the slot "
          "orders")
    errs["by_pid"] = err
    return errs


def lists_full_scattered(state: dense_cells.DenseState, spec, cfg,
                         label: str, seed: int = 5) -> dict:
    """K2 (cube and P = 1 slab forms), K5 and the full sweep (K6 both
    forms, K7) on ``state`` with its slots scattered inside each cell
    (``scatter_slots``): masks and counts bitwise equal to the plain
    versions, K5 also to K2's counts, the pair count that of ``state``'s own
    order; the full sweep as ``compare_full_sweep`` holds it. Returns the
    largest errors."""
    sc = scatter_slots(state, spec, seed)
    pos, valid = sc.pos, sc.valid()
    check(not torch.equal(valid, state.valid()),
          f"{label}: scattering left every slot in place")
    counts, masks = dense_force.dense_lists_half(pos, spec, cfg.rs)
    torch.cuda.synchronize()
    counts_p, masks_p = dense_force.lists_half_plain(pos, spec, cfg.rs)
    check(torch.equal(counts, counts_p) and torch.equal(masks, masks_p),
          f"{label}: lists_half differs from its plain version on scattered "
          "slots")
    before, _ = dense_force.dense_lists_half(state.pos, spec, cfg.rs)
    check(int(counts[valid].sum()) == int(before[state.valid()].sum()),
          f"{label}: lists_half counts other pairs on scattered slots")
    del masks, masks_p
    half = dense_force.dense_counts_half(pos, spec, cfg.rs)
    torch.cuda.synchronize()
    check(torch.equal(half, counts_p) and torch.equal(half, counts),
          f"{label}: count_half differs from its plain version or from the "
          "list kernel's counts on scattered slots")
    slab, windows, _ = p1_windows(pos, valid, spec)
    counts, masks = dense_force.dense_lists_half_slab(windows, slab, cfg.rs)
    torch.cuda.synchronize()
    counts_p, masks_p = dense_force.lists_half_plain(windows, slab, cfg.rs,
                                                     zwrap=False)
    check(torch.equal(counts, counts_p) and torch.equal(masks, masks_p),
          f"{label}: lists_half_slab differs from its plain version on "
          "scattered slots")
    del masks, masks_p
    errs = {"lists_half": 0.0, "lists_half_slab": 0.0, "count_half": 0.0}
    errs.update(compare_full_sweep(pos, valid, spec, cfg, label))
    return errs


def band_pairs(pos, valid, spec, radius: float) -> int:
    """Pairs whose r2 lies within CUTOFF_BAND of the cutoff, by the half
    count kernel at the band's two edges."""
    outer, inner = (dense_force.dense_counts_half(
        pos, spec, radius * math.sqrt(1.0 + sign * CUTOFF_BAND))[valid].sum()
        for sign in (1, -1))
    return int(outer) - int(inner)


def compare_full_sweep(pos, valid, spec, cfg, label: str, f_half=None) -> dict:
    """K6 (both forms) and K7 against their plain versions under ``valid``;
    K6 bitwise across two launches and, given the half sweep's forces,
    within the force-parity gate of them."""
    errs = {}
    full = dense_force.dense_counts(pos, valid, spec, cfg.rs)
    torch.cuda.synchronize()
    check(torch.equal(full, dense_force.counts_full_plain(pos, valid, spec,
                                                          cfg.rs)),
          f"{label}: count_full differs from its plain version")
    check(int(full[~valid].abs().sum()) == 0,
          f"{label}: count_full counted on an invalid slot")
    errs["count_full"] = 0.0
    f_p, pe_p = dense_force.forces_full_plain(pos, valid, spec, cfg.rc, True)
    for name, want_pe in (("force_full", False), ("force_full_pe", True)):
        f, pe = dense_force.dense_forces(pos, valid, spec, cfg.rc, want_pe)
        torch.cuda.synchronize()
        again, pe_again = dense_force.dense_forces(pos, valid, spec, cfg.rc,
                                                   want_pe)
        check(torch.equal(f, again), f"{label}: {name} differs between two "
              "launches on the same input")
        ok, errs[name] = force_close(f, f_p)
        check(ok, f"{label}: {name} forces off by {errs[name]}")
        check(float(f[:, ~valid].abs().sum()) == 0.0,
              f"{label}: {name} left a force on an invalid slot")
        if f_half is not None:
            ok, err = within_force_gate(f, f_half)
            check(ok, f"{label}: {name} off the half sweep by {err}")
    check(torch.equal(pe, pe_again),
          f"{label}: force_full_pe potential differs between two launches")
    ok, pe_err = force_close(pe, pe_p)
    check(ok, f"{label}: force_full_pe potential off by {pe_err}")
    check(float(pe[~valid].abs().sum()) == 0.0,
          f"{label}: force_full_pe left a potential on an invalid slot")
    errs["force_full_pe"] = max(errs["force_full_pe"], pe_err)
    return errs


def small_shapes(device) -> None:
    """Wrap-around (mc = 3), one to fifteen mask words (cap = 152, 304, 384
    and 480 with a cluster in one cell: the caps the growth ladder reaches
    beyond 128; from 384 the partner passes of the list, half-count and
    full-sweep kernels), an overflowing cell,
    validity cleared on in-box slots, and the port on the card against the
    O(N^2) oracle."""
    cases = []
    for n, rho, cap, jitter, cluster, label in (
            (1728, 1.0, 32, 0.1, 0, "mc4_cap32"),
            (1728, 1.0, 40, 0.1, 0, "mc4_cap40"),
            (700, 1.0, 56, 0.25, 0, "mc3_cap56"),
            (700, 1.0, 152, 0.1, 140, "mc3_cap152_cluster"),
            (700, 1.0, 304, 0.1, 292, "mc3_cap304_cluster"),
            (700, 1.0, 384, 0.1, 372, "mc3_cap384_cluster"),
            (700, 1.0, 480, 0.1, 468, "mc3_cap480_cluster"),
            (1728, 1.0, 28, 0.6, 0, "mc4_cap28_overflow")):
        cfg = MDConfig(n=n, rho=rho)
        system, box = jittered_system(n, rho, seed=n + cap, jitter=jitter,
                                      device=device, cluster=cluster)
        spec = dense_cells.make_spec(box, cfg.rs, cap)
        state0 = dense_cells.from_packed(system.pos, system.vel, system.pid,
                                         spec)
        # negative and > L coordinates must wrap inside the rebuild
        state0 = state0._replace(pos=state0.pos + torch.where(
            state0.valid()[None] & (state0.pid % 3 == 0)[None],
            spec.L, 0.0) - torch.where(
            state0.valid()[None] & (state0.pid % 3 == 1)[None], spec.L, 0.0))
        state, errs = compare_kernels(state0, spec, cfg, label)
        errs["scattered"] = half_sweeps_scattered(state, spec, cfg,
                                                  label + "/scattered")
        errs["scattered"].update(lists_full_scattered(state, spec, cfg,
                                                      label + "/scattered"))
        ref = dense_ref.rebuild_reference(state0, spec)
        check(all(torch.equal(a, b) for a, b in zip(state, ref)),
              f"{label}: rebuild differs from the scatter reference")
        kept = int(state.valid().sum())
        if cluster:
            check(int(state.valid().sum(dim=-1).max()) == cluster,
                  f"{label}: the cluster is not in one cell")
        # validity cleared on every 7th occupied slot: in-box positions that
        # the full sweep must treat as absent
        cleared = state.valid().clone()
        occupied = cleared.reshape(-1).nonzero()[:, 0]
        cleared.reshape(-1)[occupied[::7]] = False
        compare_full_sweep(state.pos, cleared, spec, cfg, label + "/cleared")
        if "overflow" in label:
            check(kept < n, f"{label}: expected a truncated cell")
        else:
            check(kept == n, f"{label}: lost particles ({kept} != {n})")
            counts, masks = dense_force.dense_lists_half(state.pos, spec,
                                                         cfg.rs)
            pairs = int(counts[state.valid()].sum())
            pos, _ = dense_cells.to_packed(state, n, spec.L)
            pos_t = torch.from_numpy(pos).to(device)
            want = int(oracle.pair_count(pos_t, box, cfg.rs))
            check(pairs == want, f"{label}: {pairs} pairs, oracle {want}")
            f_o, u_o = oracle.forces_energy(pos_t, box, cfg.rc)
            f, pe = dense_force.dense_forces_half(state.pos, spec, cfg.rc, True)
            keep = state.valid().reshape(-1)
            f_packed = torch.empty_like(f_o)
            f_packed[state.pid.reshape(-1)[keep].long()] = \
                f.reshape(3, -1)[:, keep].T
            ok, err = within_force_gate(f_packed, f_o)
            check(ok, f"{label}: force vs oracle off by {err}")
            u = float(pe[state.valid()].sum())
            check(abs(u - float(u_o)) <= 1e-4 * abs(float(u_o)) + 1e-2,
                  f"{label}: PE {u} vs oracle {float(u_o)}")
            # the same three against the full sweep and the mask popcount
            valid = state.valid()
            check(torch.equal(dense_force.mask_slot_counts(masks, cap),
                              counts),
                  f"{label}: mask popcounts differ from the counts")
            full = dense_force.dense_counts(state.pos, valid, spec, cfg.rs)
            check(int(full[valid].sum()) == 2 * want,
                  f"{label}: full counts {int(full[valid].sum())}, oracle "
                  f"2 x {want}")
            for want_pe in (False, True):
                f6, pe6 = dense_force.dense_forces(state.pos, valid, spec,
                                                   cfg.rc, want_pe)
                f_packed[state.pid.reshape(-1)[keep].long()] = \
                    f6.reshape(3, -1)[:, keep].T
                ok, err = within_force_gate(f_packed, f_o)
                check(ok, f"{label}: full-sweep force vs oracle off by {err}")
            u6 = 0.5 * float(pe6[valid].sum())
            check(abs(u6 - float(u_o)) <= 1e-4 * abs(float(u_o)) + 1e-2,
                  f"{label}: full-sweep PE {u6} vs oracle {float(u_o)}")
        cases.append({"case": label, "mc": spec.mc, "cap": cap, "kept": kept,
                      "max_abs_err": errs})
    emit("small_shapes", cases=cases)


# --------------------------------------------------------- kernel table
SOURCES = {
    "expand": ("md_neighbor_list_tpu_torch/csrc/expand.cu",
               "md_neighbor_list_tpu/ops/dense_cells.py:192"),
    "lists_half": ("md_neighbor_list_tpu_torch/csrc/lists_half.cu",
                   "md_neighbor_list_tpu/ops/pallas_force.py:935"),
    "forces_half": ("md_neighbor_list_tpu_torch/csrc/force_half.cu",
                    "md_neighbor_list_tpu/ops/pallas_force.py:613"),
    "forces_half_pe": ("md_neighbor_list_tpu_torch/csrc/force_half.cu",
                       "md_neighbor_list_tpu/ops/pallas_force.py:613"),
    "pe_virial_half": ("md_neighbor_list_tpu_torch/csrc/pe_virial_half.cu",
                       "md_neighbor_list_tpu/ops/pallas_force.py:860"),
    "count_half": ("md_neighbor_list_tpu_torch/csrc/lists_half.cu",
                   "md_neighbor_list_tpu/ops/pallas_force.py:801"),
    "force_full": ("md_neighbor_list_tpu_torch/csrc/force_full.cu",
                   "md_neighbor_list_tpu/ops/pallas_force.py:185"),
    "force_full_pe": ("md_neighbor_list_tpu_torch/csrc/force_full.cu",
                      "md_neighbor_list_tpu/ops/pallas_force.py:185"),
    "count_full": ("md_neighbor_list_tpu_torch/csrc/force_full.cu",
                   "md_neighbor_list_tpu/ops/pallas_force.py:230"),
    "merge": ("md_neighbor_list_tpu_torch/csrc/merge.cu",
              "md_neighbor_list_tpu/ops/incremental.py:127"),
    # the NVE step's K3 over the half list (one block a cell, 12 an SM at 40
    # registers; its staged list range shorter than a clustered cell's, the
    # rest read from global memory), and the list's build (no TPU kernel:
    # the JAX step sweeps the cells)
    "forces_list": ("md_neighbor_list_tpu_torch/csrc/force_list.cu",
                    "md_neighbor_list_tpu/ops/pallas_force.py:613"),
    "list_sparse": ("md_neighbor_list_tpu_torch/csrc/list_sparse.cu", None),
    # the incremental rebuild's mover keys and window predicate (no TPU
    # kernel: array expressions, which XLA fuses; md_neighbor_list_tpu/ops/
    # incremental.py:241 and :257)
    "mover_keys": ("md_neighbor_list_tpu_torch/csrc/incremental.cu", None),
    "window_count": ("md_neighbor_list_tpu_torch/csrc/incremental.cu", None),
    # the NVE step's integrator (no TPU kernel: the JAX step's half kick,
    # drift and vote, which XLA fuses; md_neighbor_list_tpu/models/
    # dense_lj.py:128)
    "kick_drift_vote": ("md_neighbor_list_tpu_torch/csrc/integrate.cu", None),
    "kick": ("md_neighbor_list_tpu_torch/csrc/integrate.cu", None),
    # K9: the slab forms of K1-K3, where ops/slab_kernels.py runs them
    "expand_slab": ("md_neighbor_list_tpu_torch/csrc/expand.cu",
                    "md_neighbor_list_tpu/ops/slab_kernels.py:333"),
    "lists_half_slab": ("md_neighbor_list_tpu_torch/csrc/lists_half.cu",
                        "md_neighbor_list_tpu/ops/slab_kernels.py:288"),
    "forces_half_slab": ("md_neighbor_list_tpu_torch/csrc/force_half.cu",
                         "md_neighbor_list_tpu/ops/slab_kernels.py:113"),
    "forces_half_slab_pe": ("md_neighbor_list_tpu_torch/csrc/force_half.cu",
                            "md_neighbor_list_tpu/ops/slab_kernels.py:113"),
}
# K1b: the blocked, fuse_keys and split_dma forms of the expand are TPU
# layouts of K1's function; the port maps them onto K1, so K1's row names them.
# The slab half-force form also stands for the interior and boundary passes.
ALSO_REPLACES = {"expand": ["md_neighbor_list_tpu/ops/dense_cells.py:358",
                            "md_neighbor_list_tpu/ops/dense_cells.py:709"],
                 "forces_half_slab": [
                     "md_neighbor_list_tpu/ops/slab_kernels.py:170",
                     "md_neighbor_list_tpu/ops/slab_kernels.py:238"]}


def kernel_row(name: str, err: float) -> dict:
    """A row of the kernel table: the kernel, its source, the TPU kernel it
    replaces and its largest error against its plain version; ``launches``
    is filled in at the end of the run."""
    source, replaces = SOURCES[name]
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": None, "max_abs_err": err}
    if name in ALSO_REPLACES:
        row["also_replaces"] = ALSO_REPLACES[name]
    return row


def full_width(sim: DenseSimulator) -> list[dict]:
    """Every kernel against its plain version at N = 1M, cap = 40: on a
    jittered state, on its scattered-slot twin and, for K2 and the full
    sweep, on the main path's lattice start; K1 also on the rebuilt state
    drifted by skin/2; the NVE step's list kernels (the list's build, K3
    over the list) on the jittered state's list, K3 also drifted by skin/2.
    Returns the kernel table's rows."""
    cfg, spec, dev = sim.config, sim.spec, sim.device
    system, _ = jittered_system(cfg.n, cfg.rho, seed=7, jitter=0.1, device=dev)
    state0 = dense_cells.from_packed(system.pos, system.vel, system.pid, spec)
    state, errs = compare_kernels(state0, spec, cfg, "full_width")
    check(int(state.valid().sum()) == cfg.n, "full_width: lost particles")
    scattered = half_sweeps_scattered(state, spec, cfg, "full_width/scattered")
    scattered.update(lists_full_scattered(state, spec, cfg,
                                          "full_width/scattered"))
    for name in ("forces_half", "forces_half_pe", "pe_virial_half",
                 "lists_half", "count_half", "force_full", "force_full_pe",
                 "count_full"):
        errs[name] = max(errs[name], scattered[name])
    # the main path's lattice start: K2 (both forms) bitwise, the full sweep
    lattice = sim.init().state
    lat_pos, lat_valid = lattice.pos, lattice.valid()
    ok, _ = agree(dense_force.dense_lists_half(lat_pos, spec, cfg.rs),
                  dense_force.lists_half_plain(lat_pos, spec, cfg.rs), True)
    check(ok, "full_width/lattice: lists_half differs from its plain version")
    slab, windows, _ = p1_windows(lat_pos, lat_valid, spec)
    ok, _ = agree(dense_force.dense_lists_half_slab(windows, slab, cfg.rs),
                  dense_force.lists_half_plain(windows, slab, cfg.rs,
                                               zwrap=False), True)
    check(ok, "full_width/lattice: lists_half_slab differs from its plain "
          "version")
    lat_errs = compare_full_sweep(lat_pos, lat_valid, spec, cfg,
                                  "full_width/lattice")
    for name in ("force_full", "force_full_pe", "count_full"):
        errs[name] = max(errs[name], lat_errs[name])
    del lattice, lat_pos, lat_valid, windows
    pos = state.pos
    # K1 as the main path runs it, on a rebuilt state drifted by skin/2:
    # cell-sorted, so the reads through the permutation nearly coalesce (the
    # from_packed seed above reads through one far from the identity)
    drift_recs = expand_inputs(drifted_state(sim, state), spec)
    ok, _ = agree(dense_cells.expand(*drift_recs, spec),
                  dense_cells.expand_plain(*drift_recs, spec), True)
    check(ok, "full_width/drifted: expand differs from its plain version")
    # the NVE step's list of this rebuilt state: the list's kernel bitwise
    # its plain version, the list-driven K3 against its plain version here
    # and drifted by skin/2
    lst = list_bitwise(pos, spec, cfg, "full_width")
    errs["list_sparse"] = errs["forces_list"] = 0.0
    drifted = drifted_state(sim, state).pos
    for p in (pos, drifted):
        ok, err = force_close(
            dense_force.dense_forces_list(p, lst, spec, cfg.rc),
            dense_force.forces_list_plain(p, lst, spec, cfg.rc))
        check(ok, f"full_width: forces_list off its plain version by {err}")
        errs["forces_list"] = max(errs["forces_list"], err)
    listed = int(lst.nsparse.sum())
    rows = [kernel_row(name, errs[name]) for name in (
        "expand", "lists_half", "forces_half", "forces_half_pe",
        "pe_virial_half", "count_half", "force_full", "force_full_pe",
        "count_full", "forces_list", "list_sparse")]
    del lst, drifted
    dense_force._window_slots.cache_clear()
    emit("kernels_full_width", n=cfg.n, mc=spec.mc, cap=spec.cap,
         slots=spec.slots, listed=listed,
         launches_so_far=dict(_cuda.LAUNCHES),
         scattered_slots_max_abs_err=scattered, kernels=rows)
    return rows


# ------------------------------------------------------------ integrator
def integrator_kernels(preset: str, device) -> list[dict]:
    """The NVE step's integrator (``ops/integrate.py``) at the shapes of
    ``PRESETS[preset]``, on the engine's state 20 steps into a run: both
    kernels, each form, bitwise against their plain versions (velocities,
    positions, the vote, the flag lowered) against the state's own
    reference, against its positions (no vote) and with one particle moved
    past the vote's trigger; and the launches. Returns the kernel table's
    rows."""
    cfg = PRESETS[preset]
    sim = DenseSimulator(cfg, cap=40, device=device)
    carry = sim.run(sim.init(), 20, chunk=20)
    st, spec, force, ref = carry.state, sim.spec, carry.force, carry.ref_pos
    dt, skin = float(np.float32(cfg.dt)), cfg.skin
    flag = torch.zeros((), dtype=torch.bool, device=device)
    first = int(torch.argmax((st.pid.reshape(-1) >= 0).to(torch.int32)))
    far = st.pos.clone()
    far[0].view(-1)[first] -= skin  # one particle past skin/2
    before = dict(_cuda.LAUNCHES)
    votes = []
    for r, s in ((ref, skin), (st.pos, skin), (far, skin), (ref, None)):
        want = [st.vel.clone(), st.pos.clone()]
        got = [st.vel.clone(), st.pos.clone()]
        vote_p = integrate.kick_drift_vote_plain(*want, force, r, st.pid, dt,
                                                 s)
        vote_k = integrate.kick_drift_vote(*got, force, r, st.pid, dt, s, flag)
        check(all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                  for a, b in zip(got, want)),
              f"integrator/{preset}: kick_drift_vote differs from its plain "
              "version")
        check((vote_k is None and vote_p is None)
              or bool(vote_k) == bool(vote_p),
              f"integrator/{preset}: the vote differs from the plain one")
        votes.append(None if vote_p is None else bool(vote_p))
        integrate.kick_plain(want[0], force, dt)
        integrate.kick(got[0], force, st.pid, dt, lower=vote_k)
        check(torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
              and not bool(flag),
              f"integrator/{preset}: kick differs from its plain version")
    check(votes[1:] == [False, True, None],
          f"integrator/{preset}: votes {votes}, want [*, False, True, None]")
    launches = {k: v - before[k] for k, v in _cuda.LAUNCHES.items()
                if v != before[k]}
    rows = [kernel_row(name, 0.0) for name in ("kick_drift_vote", "kick")]
    emit("integrator", config=preset, n=cfg.n, mc=spec.mc, cap=spec.cap,
         slots=spec.slots, votes=votes, launches=launches, kernels=rows)
    return rows


# ------------------------------------------------------ list and sweep
def list_bitwise(pos, spec, cfg, label: str):
    """The step's list of ``pos`` at ``cfg.rs`` by its kernel, held bit for
    bit (starts, counts, entries, the overflow flag) against its plain
    version run on the same card tensors; returns the kernel's list."""
    lst = dense_force.half_list_buffers(spec, cfg.n, cfg.rs, pos.device)
    flag = dense_force.build_half_list(pos, spec, cfg.rs, lst)
    check(not bool(flag), f"{label}: the step's list overflowed its capacity")
    ref = dense_force.half_list_buffers(spec, cfg.n, cfg.rs, pos.device)
    check(not bool(dense_force.build_half_list_plain(pos, spec, cfg.rs, ref)),
          f"{label}: the plain list overflowed its capacity")
    for name, got, want in zip(ref._fields, lst, ref):
        check(torch.equal(got, want),
              f"{label}: list_sparse's {name} differs from its plain version")
    return lst


def list_sweep(device) -> None:
    """The NVE step's half list against the cell sweep at the shapes of
    ``c4_sorted`` (N = 1M) and ``lammps_lj`` (LAMMPS ``bench/in.lj`` x 4,
    N = 2,048,000 from fcc), each on the engine's state after 200 NVE steps
    (cap still 40), rebuilt, then drifted by skin/2 (the last state before
    the vote fires): the list built (``build_half_list``, one kernel)
    without overflow and bitwise its plain version, its force on the drifted
    state against the sweep's and the plain version's, its pairs within rc
    those the sweep counts. Then
    ``c2_cell``, which rebuilds every step and so keeps the sweep in its
    step: 100 steps by ``run`` at cap 40, a rebuild each, no list force."""
    for preset in ("c4_sorted", "lammps_lj"):
        emit("list_sweep", config=preset, **list_against_sweep(
            PRESETS[preset], device))
        torch.cuda.empty_cache()
    cfg = PRESETS["c2_cell"]
    sim = DenseSimulator(cfg, cap=40, device=device)
    carry = sim.init()
    before = dict(_cuda.LAUNCHES)
    carry = sim.run(carry, cfg.steps)
    rebuilds = int(carry.n_rebuilds)
    launches = {k: _cuda.LAUNCHES[k] - before[k]
                for k in ("forces_half", "forces_list")}
    check(not bool(carry.overflow) and sim.cap == 40,
          f"list_sweep c2_cell: the run grew cap to {sim.cap}")
    check(rebuilds == 1 + cfg.steps,
          f"list_sweep c2_cell: {rebuilds} rebuilds, want {1 + cfg.steps}")
    check(launches["forces_half"] >= cfg.steps
          and launches["forces_list"] == 0,
          f"list_sweep c2_cell: the step's forces launched {launches}")
    emit("list_sweep", config="c2_cell", n=cfg.n, steps=cfg.steps,
         n_rebuilds=rebuilds, launches=launches)


def list_against_sweep(cfg: MDConfig, device) -> dict:
    """One configuration of ``list_sweep``; returns its numbers."""
    sim = DenseSimulator(cfg, cap=40, device=device)
    spec, df = sim.spec, dense_force
    carry = sim.run(sim.init(), 200)
    check(not bool(carry.overflow) and sim.cap == 40,
          f"list_sweep: {cfg.n} particles: the run grew cap to {sim.cap}")
    new, _ = dense_cells.rebuild_dense(carry.state, spec)
    del carry
    lst = list_bitwise(new.pos, spec, cfg, "list_sweep")
    counts = df.dense_counts_half(new.pos, spec, cfg.rs)
    drifted = drifted_state(sim, new)
    f_list = df.dense_forces_list(drifted.pos, lst, spec, cfg.rc)
    errs = {}
    for name, want in (
            ("sweep", df.dense_forces_half(drifted.pos, spec, cfg.rc)[0]),
            ("plain", df.forces_list_plain(drifted.pos, lst, spec, cfg.rc))):
        ok, errs[name] = force_close(f_list, want)
        check(ok, f"list_sweep: the list's force off the {name} by "
                  f"{errs[name]}")
    p = drifted.pos.reshape(3, -1)
    pairs_rc = 0
    for own, part, shift in (df.dense_pairs(drifted.pos, spec),
                             df.list_pairs(lst, spec)):
        d = p[:, own] - (p[:, part] + shift)
        r2 = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]
        pairs_rc += int((r2 < float(np.float32(cfg.rc * cfg.rc))).sum())
    counts_rc = df.dense_counts_half(drifted.pos, spec, cfg.rc)
    sweep_rc = int(counts_rc[drifted.valid()].sum())
    check(pairs_rc == sweep_rc, f"list_sweep: {pairs_rc} listed pairs "
                                f"within rc against the sweep's {sweep_rc}")
    result = dict(n=cfg.n, cap=spec.cap, mc=spec.mc,
                  pairs_rs=int(counts[new.valid()].sum()),
                  listed=int(lst.nsparse.sum()),
                  capacity=df.list_capacity(spec, cfg.n, cfg.rs),
                  pairs_rc=pairs_rc, max_force_err=errs)
    df._window_slots.cache_clear()
    return result


# ------------------------------------------------------------ main path
def main_path(sim: DenseSimulator) -> dict:
    cfg = sim.config
    _cuda.reset_launches()
    carry = sim.init()
    new, counts, masks, total = sim._rebuild_and_lists(carry.state)
    pairs = int(total)
    check(pairs == 40_000_000, f"main_path: {pairs} pairs, want 40000000")
    check(masks.shape == (5, 2, sim.spec.rows, sim.spec.mc, 3 * sim.spec.cap),
          "main_path: mask artifact has the wrong shape")
    ke0, pe0 = (float(x) for x in sim.energies(carry))
    e0 = ke0 + pe0

    captures = sim._runner.captures
    steps = cfg.steps
    carry = sim.run(carry, steps)
    captured_once(sim, captures, "main_path")

    ke1, pe1 = (float(x) for x in sim.energies(carry))
    drift = abs((ke1 + pe1) - e0) / abs(e0)
    pressure = sim.pressure(carry)
    kept = int(carry.state.valid().sum())
    rebuilds = int(carry.n_rebuilds)
    launches = dict(_cuda.LAUNCHES)  # read before anything else launches

    check(math.isfinite(e0) and math.isfinite(ke1 + pe1),
          "main_path: energies not finite")
    check(drift <= 1e-4, f"main_path: |dE/E| = {drift} > 1e-4")
    check(kept == cfg.n, f"main_path: {kept} particles kept of {cfg.n}")
    check(rebuilds > 0, "main_path: no rebuild happened")
    check(math.isfinite(pressure), "main_path: pressure not finite")
    check(carry.force.shape == (3, sim.spec.rows, sim.spec.mc, sim.spec.cap)
          and bool(torch.isfinite(carry.force).all()),
          "main_path: forces not finite or of the wrong shape")

    emit("main_path", n=cfg.n, cap=sim.spec.cap, pairs=pairs, steps=steps,
         energy_drift=drift, e0=e0, e1=ke1 + pe1, pressure=pressure,
         n_rebuilds=rebuilds, kept=kept)

    need = {"expand": rebuilds + 1, "lists_half": 1, "list_sparse": rebuilds,
            "forces_list": steps + 1, "kick_drift_vote": steps,
            "kick": steps, "forces_half_pe": 2, "pe_virial_half": 1}
    for name, least in need.items():
        check(launches[name] >= least,
              f"launches: {name} launched {launches[name]} times on the main "
              f"path, expected at least {least}")
    emit("launches", path="main_path", launches=launches,
         expected_at_least=need)
    return launches, carry


# ------------------------------------------------------------ graph chunk
GRAPH_STEPS = 100  # steps by ``run`` and by ``step_fn`` from one carry
# The graph and the eager loop part by the order of float atomics (K3's
# reactions, the xla engine's Newton-3 scatter), which the dynamics then
# amplify: positions are held within the slab-against-cube tolerance.
TRAJECTORY_TOL = 5e-4


def graph_chunk(sim, carry, path: str) -> None:
    """From one carry cloned twice: ``GRAPH_STEPS`` steps by ``run`` (one
    step captured as a CUDA graph and replayed, the rebuild a conditional
    node; every replay under ``strict_replays``) and as many by a loop of
    the eager ``step_fn`` (the vote read on the host each step). Equal
    rebuilds, for the two dense engines equal branch counts, positions
    within ``TRAJECTORY_TOL`` of each other, |dE/E| of the graph run at most
    1e-4, one capture. The engine is the cube or incremental
    ``DenseSimulator``, the xla ``Simulator`` or the slab engine (its
    positions gathered by pid over the ring)."""
    xla = isinstance(sim, Simulator)
    slab = isinstance(sim, DenseSlabSimulator)
    counted = not (xla or slab)  # the dense engines count their branches
    clone = (lj_nve._clone if xla else dense_slab._clone if slab
             else dense_lj._clone)

    def rebuilds(c) -> int:
        return int(c.nbr.n_rebuilds if xla else c.n_rebuilds)

    def by_pid(c) -> np.ndarray:
        if slab:
            return sim.gather(c).pos.cpu().numpy()
        if not xla:
            return sim.to_system(c)[0]
        out = np.empty(tuple(c.system.pos.shape), np.float32)
        out[c.system.pid.cpu().numpy()] = c.system.pos.cpu().numpy()
        return out

    graph, eager = clone(carry), clone(carry)
    e0 = sum(float(x) for x in sim.energies(carry))
    taken = [sim._taken.tolist()] if counted else []
    captures = sim._runner.captures
    with strict_replays():
        graph = sim.run(graph, GRAPH_STEPS, chunk=GRAPH_STEPS)
    captured_once(sim, captures, f"graph_chunk {path}")
    if counted:
        taken.append(sim._taken.tolist())
    for _ in range(GRAPH_STEPS):
        eager = sim.step_fn(eager)
    if counted:
        taken.append(sim._taken.tolist())

    d = np.abs(by_pid(graph) - by_pid(eager))
    gap = float(np.minimum(d, sim.box.L - d).max())
    e1 = sum(float(x) for x in sim.energies(graph))
    drift = abs(e1 - e0) / abs(e0)
    r_graph, r_eager = rebuilds(graph), rebuilds(eager)
    check(r_graph == r_eager > rebuilds(carry),
          f"graph_chunk {path}: {r_graph} rebuilds by the graph, {r_eager} "
          f"eager, {rebuilds(carry)} at the start")
    branches = {}
    if counted:
        by_graph = [b - a for a, b in zip(taken[0], taken[1])]
        by_eager = [b - a for a, b in zip(taken[1], taken[2])]
        check(by_graph == by_eager,
              f"graph_chunk {path}: branch counts {by_graph} by the graph, "
              f"{by_eager} eager")
        branches = {"incremental_kept": by_graph[0],
                    "full_fallbacks": by_graph[1]}
    check(gap <= TRAJECTORY_TOL,
          f"graph_chunk {path}: positions {gap} apart after {GRAPH_STEPS} "
          f"steps, more than {TRAJECTORY_TOL}")
    check(drift <= 1e-4, f"graph_chunk {path}: |dE/E| = {drift} > 1e-4")
    emit("graph_chunk", path=path, steps=GRAPH_STEPS,
         n_rebuilds=r_graph - rebuilds(carry), **branches,
         position_gap=gap, tolerance=TRAJECTORY_TOL, energy_drift=drift,
         launches_per_step=sim._runner.graph.per_step,
         launches_per_branch=sim._runner.graph.per_body)


# ------------------------------------------------------------ build graph
def build_states(sim: DenseSimulator, carry) -> list[tuple[str, object]]:
    """The states the captured build is held on: the ``from_packed`` seed of
    the lattice start (nearly every particle away from its cell: the mover
    stream trips the window predicate), the lattice start's rebuilt state,
    and three drifted states (the path's final state moved ballistically to
    a largest displacement of skin/2, and two Gaussian drifts)."""
    cfg = sim.config
    system, _ = init_lattice(cfg.n, cfg.rho, None, cfg.temperature,
                             sim.device)
    seed = dense_cells.from_packed(system.pos, system.vel, system.pid,
                                   sim.spec)
    lattice = dense_cells.rebuild_dense(seed, sim.spec)[0]
    st = carry.state
    v2 = torch.sum(st.vel * st.vel, dim=0)
    tau = 0.5 * cfg.skin / torch.sqrt(torch.max(v2))
    g = torch.Generator(sim.device).manual_seed(12)
    out = [("from_packed_seed", seed), ("lattice", lattice),
           ("ballistic_skin_half", st._replace(pos=st.pos + tau * st.vel))]
    for sigma in (0.05, 0.1):
        dr = sigma * torch.randn(st.pos.shape, generator=g,
                                 device=sim.device)
        out.append((f"gauss_{sigma}", st._replace(
            pos=st.pos + torch.where(st.valid()[None], dr, 0.0))))
    return out


def ops_build(sim: DenseSimulator, state):
    """The list build from the ops themselves, into new tensors: the full
    rebuild, or in the incremental engine the incremental one unless its
    window predicate holds, where the full one is taken; then the half-list
    kernel and the total over valid slots. Returns (new_state, counts,
    masks, total, taken), ``taken`` the branches the engine counts:
    [incremental rebuilds kept, full fallbacks] (the twin of
    ``tests/torch_port_util.py``'s)."""
    spec = sim.spec
    taken = [0, 0]
    full = not sim.incremental
    if sim.incremental:
        new, window_overflow = incremental.rebuild_dense_incremental(state,
                                                                     spec)
        full = bool(window_overflow)
        taken[int(full)] = 1
    if full:
        new = dense_cells.rebuild_dense(state, spec)[0]
    counts, masks = dense_force.dense_lists_half(new.pos, spec,
                                                 sim.config.rs)
    total = torch.sum(torch.where(new.valid(), counts, 0))
    return new, counts, masks, total, taken


def build_graph(sim: DenseSimulator, carry, path: str) -> None:
    """``_rebuild_and_lists`` on the card (the state copied into the
    engine's buffers, then one replay of the captured build, every replay
    under ``strict_replays``) against the build the ops make (``ops_build``)
    on each of ``build_states``: the state, counts and masks bitwise, the
    totals equal, the branch the ops take counted (one state must take the
    full rebuild of the incremental engine); one capture for all."""
    cases = []
    for label, state in build_states(sim, carry):
        want = ops_build(sim, state)
        before = sim._taken.clone()
        with strict_replays():
            got = sim._rebuild_and_lists(state)
        by_graph = (sim._taken - before).tolist()
        same = [torch.equal(a, b) for a, b in
                zip((*got[0], got[1], got[2]), (*want[0], want[1], want[2]))]
        check(all(same) and int(got[3]) == int(want[3]),
              f"build_graph {path} {label}: captured build differs from the "
              f"ops' (pos, vel, pid, counts, masks equal: {same}; totals "
              f"{int(got[3])}, {int(want[3])})")
        check(by_graph == want[4],
              f"build_graph {path} {label}: branch counts {by_graph} "
              f"captured, {want[4]} by the ops")
        cases.append({"state": label, "pairs": int(got[3]),
                      "incremental_kept": by_graph[0],
                      "full_fallbacks": by_graph[1]})
        del want, got
    if sim.incremental:
        check(any(c["full_fallbacks"] for c in cases)
              and any(c["incremental_kept"] for c in cases),
              f"build_graph {path}: not both branches taken: {cases}")
    check(sim._build_runner.captures == 1,
          f"build_graph {path}: {sim._build_runner.captures} captures")
    emit("build_graph", path=path, n=sim.config.n, cap=sim.spec.cap,
         cases=cases, launches_per_build=sim._build_runner.graph.per_step,
         launches_per_branch=sim._build_runner.graph.per_body)


# ------------------------------------------------------------ entry points
def entry_phase(device) -> dict:
    """The port's entry points (``md_neighbor_list_tpu_torch/entry.py``):
    ``entry()`` and one step of the function it returns (N = 8,192: every
    slot kept, finite velocities), then ``dryrun_multichip(4)``, the slab
    engine's ranks four ``LocalRing`` threads on the card (eager steps by
    design), with its P = 2 overlap phase: at least 2 rebuilds and 1
    migration, conservation, the oracle's pairs and |dE/E| < 1e-4 (it raises
    on a gate). Returns the launch counts of both."""
    _cuda.reset_launches()
    fn, (carry,) = entry_points.entry(device=device)
    out = fn(carry)
    valid = int(out.state.valid().sum())
    finite = bool(torch.isfinite(out.state.vel).all())
    check(valid == 8192 and finite,
          f"entry: {valid} valid slots after a step, finite: {finite}")
    dry = entry_points.dryrun_multichip(4, device=device)
    launches = dict(_cuda.LAUNCHES)
    need = {"expand": 1, "forces_list": 2, "expand_slab": 1,
            "forces_half_slab": 1, "lists_half_slab": 1}
    for name, least in need.items():
        check(launches[name] >= least,
              f"launches: {name} launched {launches[name]} times on the "
              f"entry path, expected at least {least}")
    emit("entry", n=fn.__self__.config.n, valid=valid,
         dryrun_multichip=dry)
    emit("launches", path="entry", launches=launches, expected_at_least=need)
    return launches


# -------------------------------------------------------- list delivery
SAMPLE_ROWS = 1000  # rows held against a brute-force search
SAMPLE_SEED = 11


def brute_force_rows(pos: torch.Tensor, L: float, radius: float,
                     ids: torch.Tensor, chunk: int = 50):
    """Two (len(ids), N) bool matrices of the sampled particles against all N
    positions: neighbours (min-image, r2 < f32(radius^2), self excluded),
    and pairs inside the cutoff band."""
    r2cut = float(np.float32(radius * radius))
    hits, near = [], []
    for start in range(0, ids.shape[0], chunk):
        sel = ids[start:start + chunk]
        d = pos[sel][:, None, :] - pos[None, :, :]
        d = d - L * torch.round(d / L)
        r2 = torch.sum(d * d, dim=-1)
        r2[torch.arange(sel.shape[0], device=pos.device), sel] = float("inf")
        hits.append(r2 < r2cut)
        near.append((r2 - r2cut).abs() <= CUTOFF_BAND * r2cut)
    return torch.cat(hits), torch.cat(near)


def caller_positions(sim: DenseSimulator) -> tuple[torch.Tensor, Box]:
    """The jittered system of the full-width comparison, its particles in a
    shuffled order: what a caller of ``neighbor_list`` hands over."""
    cfg = sim.config
    system, box = jittered_system(cfg.n, cfg.rho, seed=7, jitter=0.1,
                                  device=sim.device)
    order = torch.randperm(cfg.n, generator=torch.Generator().manual_seed(3))
    return system.pos[order.to(sim.device)], box


def list_delivery(sim: DenseSimulator) -> dict:
    """``neighbor_list`` / ``pair_list`` at full width, and the parity passes
    of the lattice start. Returns the launch counts of this path."""
    cfg, dev = sim.config, sim.device
    n, rs = cfg.n, cfg.rs
    pos, box = caller_positions(sim)
    _cuda.reset_launches()

    idx_h, cnt_h = neighbor_list(pos, box.L, rs, half=True, backend="dense")
    idx_f, cnt_f = neighbor_list(pos, box.L, rs, half=False, backend="dense")
    pi, pj = pair_list(pos, box.L, rs, backend="dense")

    # the same build piece by piece (rebuild, list kernel, copy to the host,
    # host decode), and the parity passes on it
    spec = dense_cells.make_spec(box, rs, 40)
    pid = torch.arange(n, dtype=torch.int32, device=dev)
    seed_state = dense_cells.from_packed(box.wrap(pos), torch.zeros_like(pos),
                                         pid, spec)
    state, _ = dense_cells.rebuild_dense(seed_state, spec)
    _, masks = dense_force.dense_lists_half(state.pos, spec, rs)
    masks_h, pid_h = masks.cpu().numpy(), state.pid.cpu().numpy()
    idx_m, cnt_m = decode.masks_to_padded(masks_h, pid_h, spec, n=n)
    valid = state.valid()
    check(int(valid.sum()) == n, "list_delivery: lost particles")
    check(np.array_equal(idx_m, idx_h.cpu().numpy())
          and np.array_equal(cnt_m, cnt_h.cpu().numpy()),
          "list_delivery: neighbor_list differs from rebuild + lists + decode")

    half_total = int(dense_force.dense_counts_half(state.pos, spec,
                                                   rs)[valid].sum())
    full_total = int(dense_force.dense_counts(state.pos, valid, spec,
                                              rs)[valid].sum())
    in_band = band_pairs(state.pos, valid, spec, rs)
    check(abs(full_total - 2 * half_total) <= in_band,
          f"list_delivery: full count {full_total} differs from 2 x "
          f"{half_total} by more than the {in_band} pairs in the cutoff band")
    check(int(cnt_h.sum()) == half_total,
          f"list_delivery: half rows hold {int(cnt_h.sum())} pairs, the "
          f"count kernel {half_total}")
    check(int(cnt_f.sum()) == 2 * half_total,
          f"list_delivery: full rows hold {int(cnt_f.sum())} entries, "
          f"expected {2 * half_total}")
    check(idx_h.shape[0] == n and idx_f.shape[0] == n
          and idx_h.dtype == torch.int32 and idx_h.is_cuda,
          "list_delivery: rows of the wrong shape, type or device")
    check(bool(((idx_f < n).sum(dim=1) == cnt_f).all()),
          "list_delivery: sentinel padding does not match the counts")
    check(pi.shape[0] == half_total and bool((pi < pj).all()),
          f"list_delivery: pair_list has {pi.shape[0]} pairs, expected "
          f"{half_total} with i < j")

    # sampled rows against a brute-force search over all N positions
    ids = torch.from_numpy(np.sort(np.random.default_rng(
        SAMPLE_SEED).choice(n, SAMPLE_ROWS, replace=False))).to(dev)
    want, near = brute_force_rows(box.wrap(pos), box.L, rs, ids)
    got = torch.zeros((SAMPLE_ROWS, n + 1), dtype=torch.bool, device=dev)
    got.scatter_(1, idx_f[ids].long(), True)
    differ = got[:, :n] ^ want
    n_differ = int(differ.sum())
    check(int((differ & ~near).sum()) == 0,
          f"list_delivery: {n_differ} sampled entries differ from the brute "
          "force, some outside the cutoff band")
    check(bool((got[:, :n].sum(dim=1) == cnt_f[ids]).all()),
          "list_delivery: a sampled row repeats a neighbour")
    half_rows = torch.zeros_like(got)
    half_rows.scatter_(1, idx_h[ids].long(), True)
    check(bool((half_rows[:, :n] & ~got[:, :n]).sum() == 0),
          "list_delivery: a half row holds a pair its full row lacks")
    del got, want, near, differ, half_rows

    # the half sweep's forces and energy of the delivered state against the
    # full sweep, whose sums have a fixed order
    f3, pe3 = dense_force.dense_forces_half(state.pos, spec, cfg.rc, True)
    f6, _ = dense_force.dense_forces(state.pos, valid, spec, cfg.rc, False)
    ok, f_err = within_force_gate(f3, f6)
    check(ok, f"list_delivery: half-sweep forces off the full sweep by "
          f"{f_err}")
    _, pe6 = dense_force.dense_forces(state.pos, valid, spec, cfg.rc, True)
    pe_full = 0.5 * float(pe6[valid].sum(dtype=torch.float64))
    pe_half = float(pe3[valid].sum(dtype=torch.float64))
    check(abs(pe_full - pe_half) <= 1e-5 * abs(pe_full),
          f"list_delivery: PE {pe_half} (half sweep) vs {pe_full} (full)")

    # the lattice start of the main path, by the full-sweep count
    st = sim.init().state
    v = st.valid()
    k2_total = int(dense_force.dense_lists_half(st.pos, sim.spec,
                                                rs)[0][v].sum())
    k7_total = int(dense_force.dense_counts(st.pos, v, sim.spec, rs)[v].sum())
    check(k7_total // 2 == 40_000_000 == k2_total and k7_total % 2 == 0,
          f"list_delivery: lattice start has {k7_total} / 2 pairs by the "
          f"full sweep, {k2_total} by the list kernel, want 40000000")

    clustered = clustered_neighbor_list(dev)
    launches = dict(_cuda.LAUNCHES)
    emit("list_delivery", n=n, cap=spec.cap, pairs=half_total,
         full_sweep_count=full_total, pairs_in_cutoff_band=in_band,
         k_half=idx_h.shape[1], k_full=idx_f.shape[1],
         sampled_rows=SAMPLE_ROWS, sampled_entries_in_cutoff_band=n_differ,
         mask_bytes=masks_h.nbytes, force_err_half_vs_full_sweep=f_err,
         pe_half_sweep=pe_half, pe_full_sweep=pe_full,
         lattice_pairs=k7_total // 2, clustered=clustered)
    need = {"expand": 4, "lists_half": 4, "count_half": 1, "count_full": 2,
            "force_full": 1, "force_full_pe": 1}
    for name, least in need.items():
        check(launches[name] >= least,
              f"launches: {name} launched {launches[name]} times on the list "
              f"delivery path, expected at least {least}")
    emit("launches", path="list_delivery", launches=launches,
         expected_at_least=need)
    return launches


CLUSTER_N, CLUSTER_K = 8000, 400  # L = 20, mc = 7; 400 in one cell


def clustered_neighbor_list(dev) -> dict:
    """One ``neighbor_list`` call on an input with 400 particles in one cell,
    so the API grows cap from 40 to 480 and the list kernel stages its
    partners in passes; every full row against a brute-force search."""
    system, box = jittered_system(CLUSTER_N, 1.0, seed=17, jitter=0.1,
                                  device=dev, cluster=CLUSTER_K)
    n, rs = CLUSTER_N, MDConfig(n=CLUSTER_N).rs
    spec40 = dense_cells.make_spec(box, rs, 40)
    idx, cnt = neighbor_list(system.pos, box.L, rs, half=False,
                             backend="dense")
    want, near = brute_force_rows(system.pos, box.L, rs,
                                  torch.arange(n, device=dev), chunk=500)
    got = torch.zeros((n, n + 1), dtype=torch.bool, device=dev)
    got.scatter_(1, idx.long(), True)
    differ = got[:, :n] ^ want
    check(int((differ & ~near).sum()) == 0,
          f"clustered neighbor_list: {int(differ.sum())} entries differ from "
          "the brute force, some outside the cutoff band")
    check(bool((got[:, :n].sum(dim=1) == cnt).all()),
          "clustered neighbor_list: a row repeats a neighbour")
    # the cap the call had to reach: the growth ladder from 40 up to the
    # largest cell of this input
    mc = spec40.mc
    cells = torch.clamp(torch.floor(system.pos / spec40.cell_size).long(), 0,
                        mc - 1)
    most = int(torch.bincount(cells[:, 0] + mc * (cells[:, 1] + mc
                                                   * cells[:, 2])).max())
    cap = 40
    while cap < most:
        cap = dense_cells.grow_cap(cap)
    check(most >= CLUSTER_K and cap > 341,
          f"clustered neighbor_list: largest cell {most}, cap {cap}: the "
          "input does not need cap > 341")
    return {"n": n, "largest_cell": most, "cap": cap,
            "mask_words": dense_force.mask_words(cap),
            "pairs_full_rows": int(cnt.sum()), "k": idx.shape[1],
            "entries_in_cutoff_band": int(differ.sum())}


# ------------------------------------------------------------ incremental
def drifted_state(sim: DenseSimulator, state):
    """``state`` drifted ballistically so that the largest displacement is
    skin/2: the state a rebuild sees when the displacement vote fires."""
    v2 = torch.sum(state.vel * state.vel, dim=0)
    tau = 0.5 * sim.config.skin / torch.sqrt(torch.max(v2))
    return state._replace(pos=state.pos + tau * state.vel)


def per_cell_sets(pid: torch.Tensor, spec) -> torch.Tensor:
    """Each cell's pids in ascending order, empty slots last."""
    rows = pid.reshape(spec.ncells, spec.cap).to(torch.int64)
    return torch.sort(torch.where(rows >= 0, rows, 1 << 40), dim=1).values


def window_counts_agree(row_start: torch.Tensor) -> tuple[bool, list]:
    """``window_count`` against ``window_count_plain`` on ``row_start``, each
    from the same counts, none of them zero: (equal, the kernel's flags)."""
    outs = []
    for run in (incremental.window_count, incremental.window_count_plain):
        dev = row_start.device
        window = torch.tensor([True, True], device=dev)
        taken = torch.tensor([5, 7], dtype=torch.int64, device=dev)
        movers = torch.tensor(11, dtype=torch.int64, device=dev)
        run(row_start, window, taken, movers)
        outs.append((window.tolist(), taken.tolist(), int(movers)))
    return outs[0] == outs[1], outs[0][0]


def incremental_kernels(sim: DenseSimulator,
                        state) -> tuple[list[dict], dict]:
    """At N = 1M, on ``state`` (the incremental run's last state) drifted by
    skin/2: the mover keys (wrapped pos, keys, stayer pid) and K8 bitwise
    against their plain versions, the window predicate with its flags and
    counts against its plain version there and on a from_packed seed, which
    trips it; the incremental rebuild bitwise against its twin and as the
    same partition per cell as the full rebuild. Returns (the rows of the
    kernel table, numbers for the phase)."""
    cfg, spec, dev = sim.config, sim.spec, sim.device
    system, _ = init_lattice(cfg.n, cfg.rho,
                             torch.Generator(dev).manual_seed(5),
                             cfg.temperature, dev)
    seed = dense_cells.from_packed(system.pos, system.vel, system.pid, spec)
    _, seed_overflow = incremental.rebuild_dense_incremental(seed, spec)
    check(bool(seed_overflow), "incremental: a from_packed seed did not trip "
          "the mover window")
    same, flags = window_counts_agree(incremental.merge_inputs(seed, spec)[1])
    check(same and flags == [True, False], "incremental: the window count "
          "kernel differs from its plain version on a from_packed seed")
    del seed, system
    state = drifted_state(sim, state)

    got = incremental.wrap_keys(state, spec)
    torch.cuda.synchronize()
    want = incremental.wrap_keys_plain(state, spec)
    check(all(torch.equal(a, b) for a, b in zip((*got[0], *got[1:]),
                                                (*want[0], *want[1:]))),
          "incremental: the mover keys kernel differs from its plain version")
    del got, want
    args, row_start = incremental.merge_inputs(state, spec)
    same, flags = window_counts_agree(row_start)
    check(same and flags == [False, True], "incremental: the window count "
          "kernel differs from its plain version after a skin/2 drift")
    movers_n = int((args[2].pid >= 0).sum())
    check(0 < movers_n < cfg.n // 2,
          f"incremental: {movers_n} movers after a skin/2 drift")
    got = incremental.merge(*args, spec)
    torch.cuda.synchronize()
    want = incremental.merge_plain(*args, spec)
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          "incremental: the merge kernel differs from its plain version")
    # K1 on the mover stream, as merge_inputs runs it
    mover_recs = mover_inputs(state, spec)
    got = dense_cells.expand(*mover_recs, spec)
    torch.cuda.synchronize()
    check(agree(got, dense_cells.expand_plain(*mover_recs, spec), True)[0]
          and torch.equal(got[0], torch.cat([args[2].pos, args[2].vel]))
          and torch.equal(got[1], args[2].pid),
          "incremental: the mover expand differs from its plain version or "
          "from the mover state merge_inputs made")
    new, overflow = incremental.rebuild_dense_incremental(state, spec)
    check(not bool(overflow) and not bool(incremental.window_overflow(
        row_start)), "incremental: a skin/2 drift tripped the mover window")
    twin = incremental.rebuild_reference_incremental(state, spec)
    check(all(torch.equal(a, b) for a, b in zip(new, twin)),
          "incremental: the rebuild differs from its order-exact twin")
    full, _ = dense_cells.rebuild_dense(state, spec)
    kept = int(new.valid().sum())
    check(kept == cfg.n, f"incremental: {kept} particles kept of {cfg.n}")
    check(torch.equal(per_cell_sets(new.pid, spec),
                      per_cell_sets(full.pid, spec)),
          "incremental: not the same partition per cell as the full rebuild")

    numbers = {"movers": movers_n, "mover_share": movers_n / cfg.n,
               "stayers": int((args[1] >= 0).sum())}
    return [kernel_row(name, 0.0)
            for name in ("merge", "mover_keys", "window_count")], numbers


def incremental_path(sim: DenseSimulator):
    """``DenseSimulator(incremental=True)``: init, 1000 NVE steps, energies.
    Returns the launch counts of this path and the last carry."""
    cfg = sim.config
    _cuda.reset_launches()
    carry = sim.init()
    check(sim.full_fallbacks == 1 and sim.incremental_rebuilds == 0,
          "incremental: the lattice seed did not take the full rebuild")
    ke0, pe0 = (float(x) for x in sim.energies(carry))
    e0 = ke0 + pe0
    captures = sim._runner.captures
    carry = sim.run(carry, cfg.steps)
    captured_once(sim, captures, "incremental")
    ke1, pe1 = (float(x) for x in sim.energies(carry))
    drift = abs((ke1 + pe1) - e0) / abs(e0)
    kept = int(carry.state.valid().sum())
    rebuilds = int(carry.n_rebuilds)
    launches = dict(_cuda.LAUNCHES)  # read before anything else launches
    taken = (sim.incremental_rebuilds, sim.full_fallbacks)

    check(math.isfinite(e0) and math.isfinite(ke1 + pe1),
          "incremental: energies not finite")
    check(drift <= 1e-4, f"incremental: |dE/E| = {drift} > 1e-4")
    check(kept == cfg.n, f"incremental: {kept} particles kept of {cfg.n}")
    check(launches["merge"] > 0 and taken[0] > 0,
          "incremental: the merge kernel was not launched on the path")
    emit("incremental", n=cfg.n, cap=sim.spec.cap, steps=cfg.steps,
         energy_drift=drift, e0=e0, e1=ke1 + pe1, n_rebuilds=rebuilds,
         kept=kept, incremental_rebuilds=taken[0], full_fallbacks=taken[1])
    need = {"merge": rebuilds - 1, "expand": rebuilds + taken[1],
            "list_sparse": rebuilds, "forces_list": cfg.steps + 1}
    for name, least in need.items():
        check(launches[name] >= least,
              f"launches: {name} launched {launches[name]} times on the "
              f"incremental path, expected at least {least}")
    emit("launches", path="incremental", launches=launches,
         expected_at_least=need)
    return launches, carry


# ------------------------------------------------------------ dense slab
SLAB_EMULATED = (5, 7)  # slab counts emulated at N = 1M (mc = 35)


def cube_slabs(spec, p: int) -> slab_kernels.SlabSpec:
    """P slabs of the cube's own cells (mc_z = mc), as the P = 1 engine and
    the serial emulation cut them."""
    return slab_kernels.SlabSpec(mc=spec.mc, nz=spec.mc // p, mc_z=spec.mc,
                                 cap=spec.cap, L=spec.L,
                                 cell_size=spec.cell_size,
                                 cell_z=spec.cell_size)


def ghost_layer(pos, valid, spec, last: bool) -> tuple:
    """The right-ghost layer a slab receives from the next one, whose rows
    start at ``pos``/``valid``: that slab's first layer, with the ring seam's
    +L on z where it wraps."""
    gpos = pos[:, :spec.mc].clone()
    if last:
        gpos[2] += float(np.float32(spec.L))
    return gpos, valid[:spec.mc]


def p1_windows(pos, valid, spec):
    """The P = 1 slab forms' input made from a cube state: its layers and its
    first layer again, seam-shifted, as ghost, the ghost's empty slots
    re-parked. Returns (slab spec, the array, its validity)."""
    slab = cube_slabs(spec, 1)
    gpos, gvalid = ghost_layer(pos, valid, slab, last=True)
    ext_v = torch.cat([valid, gvalid], dim=0)
    return (slab, slab_kernels._repark_ghost(torch.cat([pos, gpos], dim=1),
                                             ext_v, slab), ext_v)


def slab_records(system: System, spec, z0: int, wrap: bool = True):
    """The slab rebuild's input over every packed record: keys relative to
    the slab at z-cell ``z0``, the (3, N) positions (wrapped) and
    velocities, and the pids."""
    rec = torch.remainder(system.pos.T, spec.L).contiguous()
    valid = torch.ones(system.n, dtype=torch.bool, device=rec.device)
    keys = slab_kernels.slab_keys(rec, valid, spec, z0, wrap=wrap)
    return keys, rec, system.vel.T.contiguous(), system.pid


def slab_state(system: System, spec, z0: int, wrap: bool = True):
    """A slab's state by the slab rebuild over every record (the K1 slab
    form, launched once)."""
    state, _ = slab_kernels.slab_sort_expand(
        *slab_records(system, spec, z0, wrap), spec)
    return state


def expand_args(system: System, spec, z0: int, wrap: bool = True):
    """The K1 slab form's arguments as ``slab_sort_expand`` makes them: the
    records, the stable sort's permutation, the sorted keys and the row
    starts; and key_base."""
    keys, pos, vel, pid = slab_records(system, spec, z0, wrap)
    keys_s, order = torch.sort(keys, stable=True)
    base = spec.mc * spec.mc
    row_start = dense_cells.row_starts(keys_s, spec, base)
    return (pos, vel, pid, order, keys_s, row_start), base


def emulate_slabs(cube_state, cube_spec, p: int, cfg, split: bool):
    """P slabs cut from a rebuilt cube state, serially, the seams handed on
    by hand: (per-slot counts at rs, forces at rc), each in the cube's row
    order. Each slab's empty slots are re-parked at slab-local rows, as the
    slab rebuild parks them. ``split``: forces by the interior and boundary
    passes instead of the combined one."""
    spec = cube_slabs(cube_spec, p)
    mc, rows = spec.mc, spec.rows
    valid = cube_state.valid()
    park = dense_cells.park_lattice(spec, cube_state.pos.device)
    forces, seams, counts = [], [], []
    for r in range(p):
        own = slice(r * rows, (r + 1) * rows)
        pos = torch.where(valid[own][None], cube_state.pos[:, own], park)
        g0 = ((r + 1) % p) * rows
        gpos, gvalid = ghost_layer(cube_state.pos[:, g0:], valid[g0:], spec,
                                   last=r == p - 1)
        ext = torch.cat([pos, gpos], dim=1)
        ext_v = torch.cat([valid[own], gvalid], dim=0)
        counts.append(slab_kernels.slab_lists_half(ext, ext_v, spec,
                                                   cfg.rs)[0])
        if split:
            low, top = slab_kernels.slab_forces_interior(pos, spec, cfg.rc)
            last, seam = slab_kernels.slab_forces_boundary(
                pos[:, (spec.nz - 1) * mc:], gpos, gvalid, spec, cfg.rc)
            forces.append(torch.cat([low, last + top], dim=1))
        else:
            f, seam, _ = slab_kernels.slab_forces_half(ext, ext_v, spec,
                                                       cfg.rc)
            forces.append(f.clone())
        seams.append(seam)
    for r in range(p):
        forces[(r + 1) % p][:, :mc] += seams[r]
    return torch.cat(counts), torch.cat(forces, dim=1)


SLAB_SMALL = (  # n, cap, cluster, P, label; P = mc gives nz = 1
    (1728, 40, 0, 4, "mc4_cap40_p4"),
    (700, 384, 372, 1, "mc3_cap384_cluster_p1"),
    (700, 384, 372, 3, "mc3_cap384_cluster_p3"),
)


def small_slab_shapes(device) -> None:
    """The slab forms at small size: nz = 1 slabs (a ghost's empty slots lie
    on the receiver's own park rows until re-parked) at cap 40 and 384, and
    a large cap (384, a cluster of 372 in one cell) with the
    interior/boundary split at P = 1. Each slab is built by the slab rebuild
    from every record; each form is held against its plain version, the
    slabs together against the oracle. Then the P = 1 engine builds the
    clustered start from cap 40, growing cap on the card past 341."""
    cases = []
    for n, cap, cluster, p, label in SLAB_SMALL:
        cfg = MDConfig(n=n, rho=1.0)
        system, box = jittered_system(n, cfg.rho, seed=n + cap, jitter=0.1,
                                      device=device, cluster=cluster)
        spec = cube_slabs(dense_cells.make_spec(box, cfg.rs, cap), p)
        mc, nz = spec.mc, spec.nz
        states = [slab_state(system, spec, r * nz, wrap=p > 1)
                  for r in range(p)]
        kept = sum(int(st.valid().sum()) for st in states)
        check(kept == n, f"{label}: {kept} particles kept of {n}")
        errs, forces, seams, pairs = {}, [], [], 0
        for r in range(p):
            st, nxt = states[r], states[(r + 1) % p]
            gpos, gvalid = ghost_layer(nxt.pos, nxt.valid(), spec,
                                       last=r == p - 1)
            ext = torch.cat([st.pos, gpos], dim=1)
            ext_v = torch.cat([st.valid(), gvalid], dim=0)
            windows = slab_kernels._repark_ghost(ext, ext_v, spec)
            counts, masks = dense_force.dense_lists_half_slab(windows, spec,
                                                              cfg.rs)
            torch.cuda.synchronize()
            counts_p, masks_p = dense_force.lists_half_plain(
                windows, spec, cfg.rs, zwrap=False)
            check(torch.equal(counts, counts_p) and torch.equal(masks, masks_p),
                  f"{label}: lists_half_slab differs from its plain version "
                  f"on slab {r}")
            pairs += int(counts[st.valid()].sum())
            f_p, pe_p = dense_force.forces_half_plain(windows, spec, cfg.rc,
                                                      True, zwrap=False)
            for want_pe in (False, True):
                f, pe = dense_force.dense_forces_half_slab(windows, spec,
                                                           cfg.rc, want_pe)
                torch.cuda.synchronize()
                ok, err = force_close(f, f_p)
                check(ok and bool(torch.isfinite(f).all()),
                      f"{label}: forces_half_slab (pe={want_pe}) off its "
                      f"plain version by {err} on slab {r}")
                errs["combined"] = max(errs.get("combined", 0.0), err)
            ok, err = force_close(pe, pe_p)
            check(ok, f"{label}: forces_half_slab_pe potential off by {err}")
            if nz >= 2:  # the interior (owned) and boundary ([last | ghost])
                for name, arr in (("interior", st.pos),
                                  ("boundary", windows[:, (nz - 1) * mc:])):
                    arr = arr.contiguous()
                    f, _ = dense_force.dense_forces_half_slab(arr, spec, cfg.rc)
                    torch.cuda.synchronize()
                    want, _ = dense_force.forces_half_plain(arr, spec, cfg.rc,
                                                            zwrap=False)
                    ok, err = force_close(f, want)
                    check(ok, f"{label}: forces_half_slab ({name}) off its "
                          f"plain version by {err}")
                    errs[name] = err
            # the module's passes as the engine calls them
            if nz >= 2:
                low, top = slab_kernels.slab_forces_interior(st.pos, spec,
                                                             cfg.rc)
                last, seam = slab_kernels.slab_forces_boundary(
                    st.pos[:, (nz - 1) * mc:], gpos, gvalid, spec, cfg.rc)
                forces.append(torch.cat([low, last + top], dim=1))
            else:
                f, seam, _ = slab_kernels.slab_forces_half(ext, ext_v, spec,
                                                           cfg.rc)
                forces.append(f.clone())
            seams.append(seam)
        for r in range(p):
            forces[(r + 1) % p][:, :mc] += seams[r]
        f_slab = torch.empty((n, 3), dtype=torch.float32, device=device)
        for st, f in zip(states, forces):
            keep = st.valid().reshape(-1)
            f_slab[st.pid.reshape(-1)[keep].long()] = \
                f.reshape(3, -1)[:, keep].T
        pos_t = torch.remainder(system.pos, box.L)
        want = int(oracle.pair_count(pos_t, box, cfg.rs))
        check(pairs == want, f"{label}: {pairs} pairs over the slabs, oracle "
              f"{want}")
        f_o, _ = oracle.forces_energy(pos_t, box, cfg.rc)
        ok, err = within_force_gate(f_slab, f_o)
        check(ok, f"{label}: slab forces vs oracle off by {err}")
        largest = max(int(st.valid().sum(dim=-1).max()) for st in states)
        cases.append({"case": label, "p": p, "nz": nz, "cap": cap,
                      "largest_cell": largest, "pairs": pairs,
                      "max_abs_err": errs, "oracle_force_err": err})

    # the engine grows cap on the card from 40 until the cluster fits
    n, _, cluster, _, label = SLAB_SMALL[1]
    cfg = MDConfig(n=n, rho=1.0)
    system, box = jittered_system(n, cfg.rho, seed=n + 384, jitter=0.1,
                                  device=device, cluster=cluster)
    sim = DenseSlabSimulator(cfg, cap=40, device=device)
    carry = sim.build(system)
    check(sim.spec.cap >= cluster and not bool(carry.overflow),
          f"{label}: the slab engine grew cap to {sim.spec.cap} only")
    _, pairs = sim.lists(carry)
    pos_t = torch.remainder(system.pos, box.L)
    want = int(oracle.pair_count(pos_t, box, cfg.rs))
    check(pairs == want, f"{label}: engine {pairs} pairs, oracle {want}")
    f_o, u_o = oracle.forces_energy(pos_t, box, cfg.rc)
    ok, err = within_force_gate(sim.gather(carry).force, f_o)
    check(ok, f"{label}: engine forces vs oracle off by {err}")
    _, pe = sim.energies(carry)
    check(abs(float(pe) - float(u_o)) <= 1e-4 * abs(float(u_o)) + 1e-2,
          f"{label}: engine PE {float(pe)} vs oracle {float(u_o)}")
    emit("small_slab_shapes", cases=cases, engine={
        "case": label, "grown_cap": sim.spec.cap, "pairs": pairs,
        "oracle_force_err": err, "pe": float(pe), "oracle_pe": float(u_o)})


def slab_kernels_phase(sim: DenseSimulator) -> list[dict]:
    """The slab forms of K1-K3 against their plain versions at N = 1M,
    cap = 40, on the P = 1 extended state of the jittered system; K1's
    slab form on a stream with records keyed below key_base;
    P = 5 and P = 7 slabs emulated serially against the cube's sweeps.
    Returns the kernel rows."""
    cfg, cube_spec, dev = sim.config, sim.spec, sim.device
    system, _ = jittered_system(cfg.n, cfg.rho, seed=7, jitter=0.1, device=dev)
    spec = cube_slabs(cube_spec, 1)
    mc = spec.mc

    # K1: the P = 1 slab rebuild (unwrapped keys), bitwise
    recs, base = expand_args(system, spec, 0, wrap=False)
    posvel, pid = dense_cells.expand(*recs, spec, base)
    torch.cuda.synchronize()
    posvel_p, pid_p = dense_cells.expand_plain(*recs, spec, base)
    check(torch.equal(pid, pid_p) and torch.equal(posvel, posvel_p),
          "slab_kernels: expand_slab differs from its plain version")
    state = dense_cells.DenseState(pos=posvel[:3].contiguous(),
                                   vel=posvel[3:].contiguous(), pid=pid)
    check(int(state.valid().sum()) == cfg.n, "slab_kernels: lost particles")
    # ... and as the slab engine runs it, on its own state drifted by skin/2
    # (the packed stream above is in pid order)
    path_recs = slab_path_inputs(drifted_state(sim, state), spec)
    ok, _ = agree(dense_cells.expand(*path_recs, spec, base),
                  dense_cells.expand_plain(*path_recs, spec, base), True)
    check(ok, "slab_kernels: expand_slab differs from its plain version on "
          "the drifted slab state")
    # K1 on a stream that holds records keyed below key_base and beyond the
    # owned range: a middle slab of P = 5 (wrapped keys) keeps exactly its
    # own records
    p5 = SLAB_EMULATED[0]
    s5, r5 = cube_slabs(cube_spec, p5), p5 // 2
    recs5, base5 = expand_args(system, s5, r5 * s5.nz)
    keys5 = recs5[4]
    below = int((keys5 < base5).sum())
    owned = int(((keys5 >= base5) & (keys5 < base5 + s5.rows * mc)).sum())
    got5 = dense_cells.expand(*recs5, s5, base5)
    torch.cuda.synchronize()
    want5 = dense_cells.expand_plain(*recs5, s5, base5)
    check(all(torch.equal(a, b) for a, b in zip(got5, want5)),
          "slab_kernels: expand_slab differs from its plain version on a "
          "stream with emigrants")
    iz = torch.clamp(torch.floor(system.pos[:, 2] * float(np.float32(
        1.0 / s5.cell_z))).long(), 0, s5.mc_z - 1)
    mine = int(((iz >= r5 * s5.nz) & (iz < (r5 + 1) * s5.nz)).sum())
    kept5 = int((got5[1] >= 0).sum())
    check(below > 0 and kept5 == owned == mine,
          f"slab_kernels: slab {r5} of {p5} kept {kept5} records, {owned} "
          f"keyed owned, {mine} in its layers ({below} keyed below key_base)")
    del recs5, got5, want5

    # K2, K3 over the extended state: [owned | seam-shifted first layer]
    gpos, gvalid = ghost_layer(state.pos, state.valid(), spec, last=True)
    ext = torch.cat([state.pos, gpos], dim=1)
    ext_v = torch.cat([state.valid(), gvalid], dim=0)
    windows = slab_kernels._repark_ghost(ext, ext_v, spec)
    counts, masks = dense_force.dense_lists_half_slab(windows, spec, cfg.rs)
    torch.cuda.synchronize()
    counts_p, masks_p = dense_force.lists_half_plain(windows, spec, cfg.rs,
                                                     zwrap=False)
    check(torch.equal(counts, counts_p) and torch.equal(masks, masks_p),
          "slab_kernels: lists_half_slab differs from its plain version")
    errs = {"expand_slab": 0.0, "lists_half_slab": 0.0}
    f_p, pe_p = dense_force.forces_half_plain(windows, spec, cfg.rc, True,
                                              zwrap=False)
    for name, want_pe in (("forces_half_slab", False),
                          ("forces_half_slab_pe", True)):
        f, pe = dense_force.dense_forces_half_slab(windows, spec, cfg.rc,
                                                   want_pe)
        torch.cuda.synchronize()
        ok, errs[name] = force_close(f, f_p)
        check(ok, f"slab_kernels: {name} forces off by {errs[name]}")
    ok, pe_err = force_close(pe, pe_p)
    check(ok, f"slab_kernels: forces_half_slab_pe potential off by {pe_err}")
    errs["forces_half_slab_pe"] = max(errs["forces_half_slab_pe"], pe_err)
    # the interior (owned layers) and boundary ([last | ghost]) arrays
    for label, arr in (("interior", state.pos),
                       ("boundary", windows[:, (spec.nz - 1) * mc:])):
        f, _ = dense_force.dense_forces_half_slab(arr.contiguous(), spec,
                                                  cfg.rc)
        torch.cuda.synchronize()
        want, _ = dense_force.forces_half_plain(arr.contiguous(), spec,
                                                cfg.rc, zwrap=False)
        ok, err = force_close(f, want)
        check(ok, f"slab_kernels: forces_half_slab ({label}) off by {err}")
        errs["forces_half_slab"] = max(errs["forces_half_slab"], err)
    # at P = 1 the slab sweep is the cube's: the same slots, counts, forces
    cube, _ = dense_cells.rebuild_dense(dense_cells.from_packed(
        system.pos, system.vel, system.pid, cube_spec), cube_spec)
    check(torch.equal(cube.pid, state.pid) and torch.equal(cube.pos,
                                                           state.pos),
          "slab_kernels: the P = 1 slab rebuild differs from the cube's")
    counts_cube = dense_force.dense_counts_half(cube.pos, cube_spec, cfg.rs)
    f_cube, _ = dense_force.dense_forces_half(cube.pos, cube_spec, cfg.rc)
    check(torch.equal(counts, counts_cube),
          "slab_kernels: P = 1 slab counts differ from the cube's K5")

    # serial emulation of P = 5 and 7 slabs of the cube state
    scale = max(float(f_cube.abs().max()), 1.0)
    emulated = {}
    for p in SLAB_EMULATED:
        for split in (False, True):
            c, f = emulate_slabs(cube, cube_spec, p, cfg, split)
            err = float((f - f_cube).abs().max())
            check(torch.equal(c, counts_cube),
                  f"slab_kernels: P = {p} emulated counts differ from K5")
            check(err <= 1e-5 * scale,
                  f"slab_kernels: P = {p} emulated forces off the cube's K3 "
                  f"by {err} (split={split})")
            emulated[f"P{p}{'_split' if split else ''}"] = err

    rows = [kernel_row(name, errs[name]) for name in (
        "expand_slab", "lists_half_slab", "forces_half_slab",
        "forces_half_slab_pe")]
    emit("slab_kernels", n=cfg.n, mc=mc, cap=spec.cap, ext_slots=spec.ext().slots,
         records_below_key_base=below, emulated_max_force_err=emulated,
         force_scale=scale, kernels=rows)
    return rows


C5_SEED = 13


def slab_c5_geometry(device, cfg=PRESETS["c5_dd"]) -> dict:
    """The ``c5_dd`` deployment at full scale (N = 8M, P = 8, mc = 71,
    mc_z = 64, nz = 8, cell_z = 3.125): its eight slabs built one after the
    other on the one card by the slab rebuild over all N records, the seams
    handed on, held against the cube engine's sweeps at N = 8M: pairs
    within the cutoff band, forces by pid within the 2e-4 gate, and within
    1e-5 of the largest away from the x/y periodic faces."""
    p = cfg.mesh_devices
    system, box = jittered_system(cfg.n, cfg.rho, seed=C5_SEED, jitter=0.1,
                                  device=device)
    spec = make_slab_spec(box, cfg.rs, p, 40)
    states = [slab_state(system, spec, r * spec.nz) for r in range(p)]
    kept = sum(int(s.valid().sum()) for s in states)
    check(kept == cfg.n, f"slab_c5_geometry: {kept} particles kept of {cfg.n}")
    forces, seams, pairs, largest = [], [], 0, 0
    for r in range(p):
        nxt = states[(r + 1) % p]
        gpos, gvalid = ghost_layer(nxt.pos, nxt.valid(), spec,
                                   last=r == p - 1)
        ext = torch.cat([states[r].pos, gpos], dim=1)
        ext_v = torch.cat([states[r].valid(), gvalid], dim=0)
        f, seam, _ = slab_kernels.slab_forces_half(ext, ext_v, spec, cfg.rc)
        forces.append(f.clone())
        seams.append(seam)
        counts, _ = slab_kernels.slab_lists_half(ext, ext_v, spec, cfg.rs)
        pairs += int(counts[states[r].valid()].sum())
        largest = max(largest, int(states[r].valid().sum(dim=-1).max()))
    for r in range(p):
        forces[(r + 1) % p][:, :spec.mc] += seams[r]
    n = cfg.n
    f_slab = torch.empty((n, 3), dtype=torch.float32, device=device)
    for st, f in zip(states, forces):
        keep = st.valid().reshape(-1)
        f_slab[st.pid.reshape(-1)[keep].long()] = f.reshape(3, -1)[:, keep].T
    del states, forces, seams

    cube_spec = dense_cells.make_spec(box, cfg.rs, 40)
    cube, _ = dense_cells.rebuild_dense(dense_cells.from_packed(
        system.pos, system.vel, system.pid, cube_spec), cube_spec)
    valid = cube.valid()
    check(int(valid.sum()) == n, "slab_c5_geometry: the cube lost particles")
    cube_pairs = int(dense_force.dense_counts_half(cube.pos, cube_spec,
                                                   cfg.rs)[valid].sum())
    in_band = band_pairs(cube.pos, valid, cube_spec, cfg.rs)
    f3, _ = dense_force.dense_forces_half(cube.pos, cube_spec, cfg.rc)
    keep = valid.reshape(-1)
    f_cube = torch.empty_like(f_slab)
    f_cube[cube.pid.reshape(-1)[keep].long()] = f3.reshape(3, -1)[:, keep].T
    ok, err = within_force_gate(f_slab, f_cube)
    # the z grids differ, so a pair may be evaluated from its other side;
    # only across the x or y periodic faces does that change its arithmetic
    # (own - (partner +- L) rounds differently from the other side)
    xy = system.pos[:, :2]
    near_face = torch.minimum(xy, box.L - xy).min(dim=1).values < cfg.rc
    diff = (f_slab - f_cube).abs().max(dim=1).values
    scale = max(float(f_cube.abs().max()), 1.0)
    check(abs(pairs - cube_pairs) <= in_band,
          f"slab_c5_geometry: {pairs} pairs over the slabs, {cube_pairs} by "
          f"the cube, more apart than the {in_band} pairs in the cutoff band")
    check(ok, f"slab_c5_geometry: forces by pid off the cube's by {err}")
    err_off = float(diff[~near_face].max())
    check(err_off <= 1e-5 * scale,
          f"slab_c5_geometry: forces by pid off the cube's by {err_off} away "
          "from the x/y faces, where only the summation order differs")
    result = {"n": n, "p": p, "mc": spec.mc, "mc_z": spec.mc_z, "nz": spec.nz,
              "cell_z": spec.cell_z, "cap": spec.cap,
              "slab_slots": spec.slots, "cube_slots": cube_spec.slots,
              "largest_slab_cell": largest, "pairs": pairs,
              "cube_pairs": cube_pairs, "pairs_in_cutoff_band": in_band,
              "max_force_err": err, "force_scale": scale,
              "force_gate": FORCE_GATE * scale,
              "particles_near_xy_faces": int(near_face.sum()),
              "max_force_err_near_xy_faces": float(diff[near_face].max()),
              "max_force_err_off_xy_faces": err_off,
              "pairs_in_rc_band": band_pairs(cube.pos, valid, cube_spec,
                                             cfg.rc)}
    emit("slab_c5_geometry", **result)
    return result


def dense_slab_path(device, cfg=PRESETS["c4_sorted"]
                    ) -> tuple[dict, object, DenseSlabSimulator]:
    """``DenseSlabSimulator`` at P = 1 on a one-rank NCCL group, N = 1M,
    cap = 40, from the lattice start: the pair count (40 per particle on
    the lattice), 1000 NVE steps (replays of one captured step, its
    ``all_reduce`` calls in the graph), and after the first 100 the
    trajectory of the cube engine. Returns the launch counts of the path,
    the carry and the engine."""
    # the cube engine's 100 steps come first: they are not this path's
    cube = DenseSimulator(cfg, cap=40, device=device)
    cc = cube.run(cube.init(), 100)
    cube_pos, _, _ = cube.to_system(cc)
    cube_rebuilds = int(cc.n_rebuilds)
    del cube, cc

    # a group of one process needs no rendezvous: an in-process store
    ring = mesh.init_ring(device, world_size=1, rank=0,
                          store=torch.distributed.HashStore())
    _cuda.reset_launches()
    sim = DenseSlabSimulator(cfg, cap=40, device=device, ring=ring)
    carry = sim.init()
    _, pairs = sim.lists(carry)
    check(pairs == 40 * cfg.n, f"dense_slab: {pairs} pairs, want {40 * cfg.n}")
    ke0, pe0 = (float(x) for x in sim.energies(carry))
    e0 = ke0 + pe0
    captures = sim._runner.captures
    carry = sim.run(carry, 100)
    pos100 = sim.gather(carry).pos.cpu().numpy()
    d = np.abs(pos100 - cube_pos)
    gap = float(np.minimum(d, sim.box.L - d).max())
    rebuilds100 = int(carry.n_rebuilds)
    migrated = int(carry.n_migrated)
    carry = sim.run(carry, cfg.steps - 100)
    chunk = "graph" if sim.ring.capturable else "eager"
    if chunk == "graph":
        captured_once(sim, captures, "dense_slab")
    ke1, pe1 = (float(x) for x in sim.energies(carry))
    drift = abs((ke1 + pe1) - e0) / abs(e0)
    kept = int((carry.pid >= 0).sum())
    rebuilds = int(carry.n_rebuilds)
    launches = dict(_cuda.LAUNCHES)  # read before anything else launches

    check(gap <= 5e-4, f"dense_slab: positions after 100 steps {gap} off the "
          "cube engine's")
    check(rebuilds100 == cube_rebuilds,
          f"dense_slab: {rebuilds100} rebuilds in 100 steps, the cube engine "
          f"{cube_rebuilds}")
    check(migrated == 0 and int(carry.n_migrated) == 0,
          "dense_slab: particles migrated at P = 1")
    check(not bool(carry.overflow), "dense_slab: overflow")
    check(math.isfinite(e0) and math.isfinite(ke1 + pe1),
          "dense_slab: energies not finite")
    check(drift <= 1e-4, f"dense_slab: |dE/E| = {drift} > 1e-4")
    check(kept == cfg.n, f"dense_slab: {kept} particles kept of {cfg.n}")
    check(bool(torch.isfinite(carry.force).all()),
          "dense_slab: forces not finite")

    emit("dense_slab_p1", n=cfg.n, p=sim.p, cap=sim.spec.cap, nz=sim.spec.nz,
         pairs=pairs, steps=cfg.steps, energy_drift=drift, e0=e0,
         e1=ke1 + pe1, n_rebuilds=rebuilds, n_migrated=int(carry.n_migrated),
         kept=kept, max_position_gap_100_steps=gap,
         cube_rebuilds_100_steps=cube_rebuilds, chunk=chunk,
         backend=mesh.backend_for(device))
    need = {"expand_slab": rebuilds, "lists_half_slab": 1,
            "forces_half_slab": 2 * cfg.steps + 1, "forces_half_slab_pe": 2}
    for name, least in need.items():
        check(launches[name] >= least,
              f"launches: {name} launched {launches[name]} times on the "
              f"dense_slab path, expected at least {least}")
    check(launches["expand"] == launches["forces_half"] ==
          launches["forces_list"] == 0,
          "launches: the cube forms ran on the dense_slab path")
    emit("launches", path="dense_slab", launches=launches,
         expected_at_least=need)
    return launches, carry, sim


# ------------------------------------------------------------ xla engine
def no_launches(path: str) -> dict:
    """The launch counters after an xla path: that engine and the sweep are
    plain PyTorch, so no kernel of K1-K9 may have run."""
    launches = dict(_cuda.LAUNCHES)
    check(set(launches.values()) == {0},
          f"launches: the {path} path launched kernels: "
          f"{ {k: v for k, v in launches.items() if v} }")
    emit("launches", path=path, launches=launches, expected_at_least={})
    return launches


def xla_pairs(carry) -> int:
    """The half pairs of a ``Simulator`` carry's rows."""
    return int(torch.sum(carry.nbr.idx < carry.system.pos.shape[0]))


def xla_engine(device) -> tuple[dict, Simulator, object]:
    """``Simulator`` (the padded-row engine) on ``c3_verlet`` uncut: the
    lattice start, 1000 NVE steps, the observables and one list build by
    ``rebuild_only``; then the build held against the oracle and the dense
    engine's half count, off the counted path. Returns the launch counts,
    the engine and its carry."""
    cfg = PRESETS["c3_verlet"]
    _cuda.reset_launches()
    sim = Simulator(cfg, device=device)
    carry = sim.init()
    start = System(*(t.clone() for t in carry.system))  # run works in place
    pairs = xla_pairs(carry)
    ke0, pe0 = (float(x) for x in sim.energies(carry))
    captures = sim._runner.captures
    carry = sim.run(carry, cfg.steps)
    captured_once(sim, captures, "xla_engine")
    ke1, pe1 = (float(x) for x in sim.energies(carry))
    ke, pe, w = (float(x) for x in sim.thermo(carry))
    pressure = sim.pressure(carry)
    rebuilds = int(carry.nbr.n_rebuilds)

    system = carry.system
    tau = 0.5 * cfg.skin / float(torch.sqrt(torch.max(
        torch.sum(system.vel * system.vel, dim=-1))))
    sim.rebuild_only(system._replace(
        pos=sim.box.wrap(system.pos + tau * system.vel)))
    launches = no_launches("xla_engine")

    e0, e1 = ke0 + pe0, ke1 + pe1
    drift = abs(e1 - e0) / abs(e0)
    want = int(oracle.pair_count(start.pos, sim.box, cfg.rs))
    f_o, _ = oracle.forces_energy(start.pos, sim.box, cfg.rc)
    ok, f_err = within_force_gate(start.force, f_o)
    dense = DenseSimulator(cfg, cap=40, device=device)
    dense_pairs = int(dense._rebuild_and_lists(dense.init().state)[3])
    del dense
    check(pairs == want == dense_pairs,
          f"xla_engine: {pairs} pairs at the build, the oracle {want}, the "
          f"dense engine {dense_pairs}")
    check(ok, f"xla_engine: build forces off the oracle by {f_err}")
    check(math.isfinite(e0) and math.isfinite(e1) and math.isfinite(pressure),
          "xla_engine: energies or pressure not finite")
    check(drift <= 1e-4, f"xla_engine: |dE/E| = {drift} > 1e-4")
    check(rebuilds > 1 and not bool(carry.nbr.overflow),
          f"xla_engine: {rebuilds} rebuilds, overflow "
          f"{bool(carry.nbr.overflow)}")
    check(bool(torch.isfinite(carry.system.force).all())
          and sorted(carry.system.pid.tolist()) == list(range(cfg.n)),
          "xla_engine: forces not finite or particles lost")
    emit("xla_engine", n=cfg.n, layout=cfg.layout, half_list=cfg.half_list,
         capacity={"neighbors": sim.capacity.neighbors,
                   "cell": sim.capacity.cell},
         pairs=pairs, oracle_pairs=want, dense_pairs=dense_pairs,
         force_err_vs_oracle=f_err, steps=cfg.steps, energy_drift=drift,
         e0=e0, e1=e1, n_rebuilds=rebuilds,
         thermo={"ke": ke, "pe": pe, "virial": w},
         pressure=pressure)
    return launches, sim, carry


def xla_c2(device) -> dict:
    """``Simulator`` on ``c2_cell`` (row-major, a rebuild every step), 100
    steps; the last list's half pairs against the oracle's count of the same
    positions, up to the pairs in the cutoff band. Returns the launch
    counts."""
    cfg = PRESETS["c2_cell"]
    _cuda.reset_launches()
    sim = Simulator(cfg, device=device)
    carry = sim.init()
    captures = sim._runner.captures
    carry = sim.run(carry, cfg.steps)
    captured_once(sim, captures, "xla_c2")
    pairs = xla_pairs(carry)
    rebuilds = int(carry.nbr.n_rebuilds)
    launches = no_launches("xla_c2")

    pos = carry.nbr.ref_pos  # the positions the last list was built at
    want = int(oracle.pair_count(pos, sim.box, cfg.rs))
    outer, inner = (int(oracle.pair_count(
        pos, sim.box, cfg.rs * math.sqrt(1.0 + sign * CUTOFF_BAND)))
        for sign in (1, -1))
    check(rebuilds == 1 + cfg.steps,
          f"xla_c2: {rebuilds} rebuilds, want {1 + cfg.steps}")
    check(abs(pairs - want) <= outer - inner,
          f"xla_c2: {pairs} pairs, the oracle {want}, more apart than the "
          f"{outer - inner} pairs in the cutoff band")
    check(not bool(carry.nbr.overflow), "xla_c2: overflow")
    emit("xla_c2", n=cfg.n, layout=cfg.layout, steps=cfg.steps,
         n_rebuilds=rebuilds, pairs=pairs, oracle_pairs=want,
         pairs_in_cutoff_band=outer - inner)
    return launches


def xla_compare(device) -> dict:
    """The CLI's ``--compare`` on ``c4_sorted`` at N = 1,000,000 (steps cut
    from 1000 to 100 for the time limit): both engines from one lattice
    start, pair counts exact, forces within the gate."""
    cfg = dataclasses.replace(PRESETS["c4_sorted"], steps=100)
    system0, _ = init_lattice(cfg.n, cfg.rho, None, cfg.temperature, device)
    _cuda.reset_launches()
    res = cli.compare(cfg, system0, device)
    launches = dict(_cuda.LAUNCHES)
    pairs = {name: p for name, p, _, _, _ in res["rows"]}
    check(pairs == {"xla": 40_000_000, "dense": 40_000_000},
          f"xla_compare: pairs {pairs}, want 40000000 each")
    check(res["force_ok"], f"xla_compare: forces {res['max_cross_force_err']}"
          f" apart, gate 2e-4 x {res['force_scale']}")
    emit("xla_compare", n=cfg.n, steps=cfg.steps,
         reduced={"steps": [PRESETS["c4_sorted"].steps, cfg.steps]},
         pairs=pairs,
         max_cross_force_err=res["max_cross_force_err"],
         force_scale=res["force_scale"],
         n_rebuilds={name: r for name, _, _, r, _ in res["rows"]},
         launches=launches)


def pair_keys(idx: torch.Tensor, directed: bool) -> torch.Tensor:
    """Sorted int64 keys of the entries of padded rows: i*N + j for each
    entry j of row i (``directed``), else min*N + max."""
    n = idx.shape[0]
    rows = torch.arange(n, device=idx.device)[:, None].expand_as(idx)
    keep = idx < n
    i, j = rows[keep], idx[keep].long()
    if not directed:
        i, j = torch.minimum(i, j), torch.maximum(i, j)
    return torch.sort(i * n + j).values


def outside_band(keys: torch.Tensor, pos: torch.Tensor, L: float,
                 radius: float) -> int:
    """How many of the pairs ``keys`` lie outside the cutoff band."""
    n = pos.shape[0]
    d = pos[keys // n] - pos[keys % n]
    d = d - L * torch.round(d / L)
    r2 = torch.sum(d * d, dim=-1)
    r2cut = float(np.float32(radius * radius))
    return int(((r2 - r2cut).abs() > CUTOFF_BAND * r2cut).sum())


def xla_list_delivery(sim: DenseSimulator) -> dict:
    """``neighbor_list(backend="xla")`` on the caller positions of
    ``list_delivery`` (N = 1M), half and full rows, against the dense
    backend's, and what ``auto`` picks at N = 100k and 1M. Returns the
    launch counts of the xla calls."""
    cfg, dev = sim.config, sim.device
    n, rs = cfg.n, cfg.rs
    pos, box = caller_positions(sim)
    small_L = Box.from_density(100_000, cfg.rho).L
    _cuda.reset_launches()
    idx_h, cnt_h = neighbor_list(pos, box.L, rs, half=True, backend="xla")
    idx_f, cnt_f = neighbor_list(pos, box.L, rs, half=False, backend="xla")
    launches = no_launches("xla_list_delivery")

    idx_hd, _ = neighbor_list(pos, box.L, rs, half=True, backend="dense")
    idx_fd, cnt_fd = neighbor_list(pos, box.L, rs, half=False,
                                   backend="dense")
    auto = {str(m): "dense" if api.use_dense("auto", dev, m, L, rs)
            else "xla" for m, L in ((100_000, small_L), (n, box.L))}

    check(idx_h.is_cuda and idx_h.dtype == torch.int32
          and idx_h.shape[0] == idx_f.shape[0] == n,
          "xla_list_delivery: rows of the wrong shape, type or device")
    check(bool(((idx_f < n).sum(dim=1) == cnt_f).all())
          and bool(((idx_h < n).sum(dim=1) == cnt_h).all()),
          "xla_list_delivery: sentinel padding does not match the counts")
    wrapped = box.wrap(pos)
    spec = dense_cells.make_spec(box, rs, 40)
    state, _ = dense_cells.rebuild_dense(dense_cells.from_packed(
        wrapped, torch.zeros_like(pos),
        torch.arange(n, dtype=torch.int32, device=dev), spec), spec)
    in_band = band_pairs(state.pos, state.valid(), spec, rs)
    diffs = {}
    for name, a, b, directed in (("full", idx_f, idx_fd, True),
                                 ("half", idx_h, idx_hd, False)):
        ka, kb = pair_keys(a, directed), pair_keys(b, directed)
        only_a = ka[~torch.isin(ka, kb)]
        only_b = kb[~torch.isin(kb, ka)]
        check(outside_band(torch.cat([only_a, only_b]), wrapped, box.L,
                           rs) == 0,
              f"xla_list_delivery: {name} rows differ from the dense "
              "backend's by a pair outside the cutoff band")
        diffs[name] = only_a.numel() + only_b.numel()
        del ka, kb
    check(diffs["full"] <= 2 * in_band and diffs["half"] <= in_band,
          f"xla_list_delivery: {diffs} entries differ from the dense "
          f"backend, more than the {in_band} pairs in the cutoff band allow")
    emit("xla_list_delivery", n=n, pairs_half=int(cnt_h.sum()),
         entries_full=int(cnt_f.sum()), entries_full_dense=int(cnt_fd.sum()),
         k_half=idx_h.shape[1], k_full=idx_f.shape[1],
         entries_differing_from_dense=diffs, pairs_in_cutoff_band=in_band,
         auto_picks=auto, dense_api_min_n=api.DENSE_API_MIN_N)
    return launches


# ------------------------------------------------------- xla slab engine
SLAB_SHIFT = 0.45  # the run's start: the lattice moved along x by this


def lattice_pairs(cfg: MDConfig) -> int:
    """The half pairs within rs of the full simple-cubic lattice start
    (N = m^3 sites, spacing L/m): N times half the lattice vectors shorter
    than rs, what the O(N^2) oracle counts there. No lattice distance lies
    within 1e-3 of rs, so no rounding can move a pair across it."""
    m = round(cfg.n ** (1.0 / 3.0))
    check(m**3 == cfg.n, f"lattice_pairs: {cfg.n} is no cube")
    spacing = Box.from_density(cfg.n, cfg.rho).L / m
    k = int(cfg.rs / spacing) + 1
    r = np.arange(-k, k + 1)
    v = np.stack(np.meshgrid(r, r, r), -1).reshape(-1, 3)
    d = np.sqrt((v * v).sum(axis=1)) * spacing
    check(np.abs(d - cfg.rs).min() > 1e-3,
          "lattice_pairs: a lattice distance within 1e-3 of rs")
    return cfg.n * int(((d > 0) & (d < cfg.rs)).sum()) // 2


def slab_rank(ring, cfg: MDConfig, system: System | None, steps: int,
              device) -> dict:
    """One rank of ``SlabSimulator`` on the card: the lattice start by
    ``init`` and its global pair count (the owned rows' entries, summed over
    the ring, halved); then ``system`` built (None: the lattice start kept),
    its energies, ``steps`` NVE steps, the energies and the gathered System
    (rank 0's)."""
    sim = SlabSimulator(cfg, device=device, ring=ring)
    st = sim.init()
    cl, m = sim.capacity.local, st.idx.shape[0]
    entries = int(ring.sum(torch.sum(st.idx[:cl] < m)))
    if system is not None:
        del st
        st = sim.build(system)
    ke0, pe0 = (float(x) for x in sim.energies(st))
    pid0 = st.pid.cpu().numpy()
    st = sim.run(st, steps)
    ke1, pe1 = (float(x) for x in sim.energies(st))
    gathered = sim.gather(st)
    return {"entries": entries, "e0": ke0 + pe0, "e1": ke1 + pe1,
            "n_rebuilds": int(st.n_rebuilds), "overflow": bool(st.overflow),
            "forces_finite": bool(torch.isfinite(st.force).all()),
            "pid0": pid0, "pid1": st.pid.cpu().numpy(),
            "capacity": dataclasses.asdict(sim.capacity),
            "system": gathered if ring.rank == 0 else None}


def slab_ranks(cfg: MDConfig, system: System | None, steps: int, device,
               label: str) -> tuple[list, int, dict]:
    """``slab_rank`` on P threads of a ``LocalRing`` on the card, with the
    checks every slab phase makes: the owned entries even, every pid held
    once, the same rebuilds on every rank, no overflow, finite forces and
    energies, |dE/E| <= 1e-4. Returns (the ranks' results, the particles
    re-homed, the launches); rank 0's has the drift."""
    _cuda.reset_launches()
    out = mesh.run_ranks(cfg.mesh_devices, lambda ring: slab_rank(
        ring, cfg, system, steps, device), device)
    launches = no_launches(label)
    r0 = out[0]
    home = np.full((2, cfg.n), -1)
    for r, o in enumerate(out):
        for k, pid in enumerate((o["pid0"], o["pid1"])):
            held = pid[pid >= 0]
            check(bool((home[k, held] < 0).all()),
                  f"{label}: a pid held twice")
            home[k, held] = r
    check(bool((home >= 0).all()), f"{label}: a pid held by no rank")
    check(r0["entries"] % 2 == 0, f"{label}: {r0['entries']} owned entries")
    check(len({o["n_rebuilds"] for o in out}) == 1,
          f"{label}: rebuilds differ between ranks")
    check(not any(o["overflow"] for o in out), f"{label}: overflow")
    check(all(o["forces_finite"] for o in out), f"{label}: forces not finite")
    check(math.isfinite(r0["e0"]) and math.isfinite(r0["e1"]),
          f"{label}: energies not finite")
    r0["energy_drift"] = abs(r0["e1"] - r0["e0"]) / abs(r0["e0"])
    check(r0["energy_drift"] <= 1e-4,
          f"{label}: |dE/E| = {r0['energy_drift']} > 1e-4")
    return out, int((home[0] != home[1]).sum()), launches


def dense_lattice_pairs(cfg: MDConfig, device) -> int:
    """The dense engine's half pairs of the lattice start (K2)."""
    dense = DenseSimulator(dataclasses.replace(cfg, mesh_devices=1), cap=40,
                           device=device)
    pairs = int(dense._rebuild_and_lists(dense.init().state)[3])
    del dense
    torch.cuda.empty_cache()
    return pairs


def xla_slab(device, p: int = 4, steps: int = 100) -> dict:
    """``SlabSimulator`` (the XLA slab engine) on ``c4_sorted`` uncut
    (N = 1M, P = 4 slabs of width 25 on a ``LocalRing`` of four threads on
    the one card): the lattice start's pairs against the lattice's count and
    the dense engine's; then 100 steps from the lattice moved by 0.45 along
    x (a plane of sites 0.05 below each face, so that particles change slab
    within the run; from the lattice itself the nearest are 0.5 away), with
    >= 1 rebuild in the run, particles re-homed, and the gathered positions
    within 5e-4 of ``Simulator(half_list=False)``'s from the same start.
    Returns the launch counts of the path."""
    cfg = dataclasses.replace(PRESETS["c4_sorted"], mesh_devices=p)
    want = lattice_pairs(cfg)
    dense_pairs = dense_lattice_pairs(cfg, device)
    system, _ = init_lattice(cfg.n, cfg.rho, None, cfg.temperature, device)
    box = Box.from_density(cfg.n, cfg.rho)
    system = system._replace(pos=box.wrap(system.pos + torch.tensor(
        [SLAB_SHIFT, 0.0, 0.0], device=device)))
    # the one-rank engine from the same start: not this path's
    single = Simulator(dataclasses.replace(cfg, half_list=False,
                                           mesh_devices=1), device=device)
    sc = single.run(single.build(system), steps)
    want_pos = torch.empty_like(system.pos)
    want_pos[sc.system.pid.long()] = sc.system.pos
    single_rebuilds = int(sc.nbr.n_rebuilds)
    del single, sc
    torch.cuda.empty_cache()

    out, re_homed, launches = slab_ranks(cfg, system, steps, device,
                                         "xla_slab")
    r0 = out[0]
    pairs = r0["entries"] // 2
    d = (r0["system"].pos - want_pos).abs()
    gap = float(torch.minimum(d, box.L - d).max())
    check(pairs == want == dense_pairs,
          f"xla_slab: {pairs} pairs at the lattice start, the lattice "
          f"{want}, the dense engine {dense_pairs}")
    check(r0["n_rebuilds"] >= 2,
          f"xla_slab: {r0['n_rebuilds']} rebuilds, none in the run")
    check(re_homed >= 1, "xla_slab: no particle changed slab")
    check(gap <= 5e-4, f"xla_slab: positions after {steps} steps {gap} off "
          "Simulator(half_list=False)'s")
    emit("xla_slab", n=cfg.n, p=p, ring="LocalRing", steps=steps,
         capacity=r0["capacity"], pairs=pairs, lattice_pairs=want,
         dense_pairs=dense_pairs, energy_drift=r0["energy_drift"],
         e0=r0["e0"], e1=r0["e1"], n_rebuilds=r0["n_rebuilds"],
         single_rebuilds=single_rebuilds, re_homed=re_homed,
         max_position_gap=gap)
    return launches


def xla_slab_c5(device, steps: int = 20) -> dict:
    """``SlabSimulator`` on ``c5_dd`` (N = 8M, P = 8 on a ``LocalRing`` of
    eight threads on the one card, steps cut from 1000 to 20 for the time
    limit): the lattice start's pairs against the lattice's count and the
    dense engine's, then 20 steps from it. Returns the launch counts."""
    cfg = PRESETS["c5_dd"]
    want = lattice_pairs(cfg)
    dense_pairs = dense_lattice_pairs(cfg, device)
    out, re_homed, launches = slab_ranks(cfg, None, steps, device,
                                         "xla_slab_c5")
    r0 = out[0]
    pairs = r0["entries"] // 2
    check(pairs == want == dense_pairs,
          f"xla_slab_c5: {pairs} pairs at the lattice start, the lattice "
          f"{want}, the dense engine {dense_pairs}")
    emit("xla_slab_c5", n=cfg.n, p=cfg.mesh_devices, ring="LocalRing",
         steps=steps, reduced={"steps": [cfg.steps, steps]},
         capacity=r0["capacity"], pairs=pairs, lattice_pairs=want,
         dense_pairs=dense_pairs, energy_drift=r0["energy_drift"],
         e0=r0["e0"], e1=r0["e1"], n_rebuilds=r0["n_rebuilds"],
         re_homed=re_homed)
    return launches


RING_GRAPH_TIMEOUT_S = 300


def ring_graph() -> None:
    """Both slab engines' captured steps on an NCCL ring of P = min(4, cards)
    processes, one card each: ``parallel/ring_check.py`` under
    ``torch.distributed.run`` (100 steps by ``run``, replays under
    ``set_sync_debug_mode("error")``, against 100 by ``step_fn``: equal
    rebuilds, positions within 5e-4, |dE/E| <= 1e-4), each in a process
    group of its own, killed with it after ``RING_GRAPH_TIMEOUT_S``. NCCL
    takes one card a rank, so on one card nothing runs: the line says
    ``"ran": false``."""
    cards = torch.cuda.device_count()
    if cards < 2:
        emit("ring_graph", ran=False, cards=cards)
        return
    p = min(4, cards)
    root = os.path.dirname(os.path.abspath(__file__))
    for engine in ("dense_slab", "slab"):
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc-per-node={p}", "-m",
               "md_neighbor_list_tpu_torch.parallel.ring_check", "--engine",
               engine, "--preset", "c4_sorted", "--steps", "100"]
        proc = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True,
                                start_new_session=True)
        try:
            out, err = proc.communicate(timeout=RING_GRAPH_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)  # torchrun and its ranks
            proc.communicate()
            fail(f"ring_graph {engine}: no end within "
                 f"{RING_GRAPH_TIMEOUT_S} s")
        check(proc.returncode == 0,
              f"ring_graph {engine}: exit {proc.returncode}: {err[-3000:]}")
        result = json.loads(out.strip().splitlines()[-1])
        check(result["ok"] and result["captures"] == 1,
              f"ring_graph {engine}: {result}")
        emit("ring_graph", ran=True, cards=cards, **result)


def cli_phase() -> None:
    """``python -m md_neighbor_list_tpu_torch`` in subprocesses on the card:
    c3_verlet with the oracle parity check and a checkpoint, the xla engine
    resuming it, and the slab engine at P = 1."""
    root = os.path.dirname(os.path.abspath(__file__))
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "c3.npz")
        for name, args in (
                ("save", ["--steps", "200", "--check-parity", "--save",
                          ckpt]),
                ("resume_xla", ["--steps", "200", "--check-parity",
                                "--engine", "xla", "--resume", ckpt]),
                ("dense_slab_p1", ["--steps", "50", "--engine", "dense_slab",
                                   "--mesh-devices", "1"])):
            out = subprocess.run(
                [sys.executable, "-m", "md_neighbor_list_tpu_torch",
                 "--preset", "c3_verlet", *args], capture_output=True,
                text=True, cwd=root, timeout=300)
            check(out.returncode == 0,
                  f"cli {name}: exit {out.returncode}: {out.stderr[-2000:]}")
            summary = out.stdout.strip().splitlines()[-1]
            check("--check-parity" not in args or "parity=OK" in summary,
                  f"cli {name}: {summary}")
            runs[name] = {"summary": summary}
    emit("cli", runs=runs)


def agree(got, want, exact: bool) -> tuple[bool, float]:
    """``got`` against ``want`` (a tensor or a tuple of them, None left
    out): bitwise if ``exact``, else each within ``force_close``."""
    pairs = [(g, w) for g, w in zip(
        got if isinstance(got, tuple) else (got,),
        want if isinstance(want, tuple) else (want,)) if g is not None]
    if exact:
        return all(torch.equal(g, w) for g, w in pairs), 0.0
    results = [force_close(g, w) for g, w in pairs]
    return all(ok for ok, _ in results), max(err for _, err in results)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only",
              file=sys.stderr)
        return 1
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    emit("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    _cuda.library()
    native.load()  # the host decoder of the list delivery path (g++)
    emit("build", ptxas=[line for text in _cuda.build_log
                         for line in text.splitlines()
                         if "registers" in line or "entry function" in line
                         or "spill" in line or "error" in line.lower()])

    device = torch.device("cuda")
    small_shapes(device)
    sim = DenseSimulator(PRESETS["c4_sorted"], cap=40, device=device)
    rows = full_width(sim)
    rows += integrator_kernels("c4_sorted", device)
    integrator_kernels("lammps_lj", device)
    torch.cuda.empty_cache()
    list_sweep(device)
    torch.cuda.empty_cache()
    sim = DenseSimulator(PRESETS["c4_sorted"], cap=40, device=device)
    launches, carry = main_path(sim)
    graph_chunk(sim, carry, "main_path")
    build_graph(sim, carry, "main_path")
    del carry
    delivery = list_delivery(
        DenseSimulator(PRESETS["c4_sorted"], cap=40, device=device))
    sim = DenseSimulator(PRESETS["c4_sorted"], cap=40, device=device,
                         incremental=True)
    inc, carry = incremental_path(sim)
    rows_inc, numbers = incremental_kernels(sim, carry.state)
    graph_chunk(sim, carry, "incremental")
    build_graph(sim, carry, "incremental")
    del carry
    emit("incremental_kernels", n=sim.config.n, cap=sim.spec.cap,
         kernels=rows_inc, **numbers)
    rows += rows_inc
    small_slab_shapes(device)
    rows += slab_kernels_phase(
        DenseSimulator(PRESETS["c4_sorted"], cap=40, device=device))
    c5 = slab_c5_geometry(device)
    check((c5["mc"], c5["mc_z"], c5["nz"]) == (71, 64, 8)
          and abs(c5["cell_z"] - 3.125) < 1e-9,
          f"slab_c5_geometry: not the c5_dd geometry: {c5}")
    torch.cuda.empty_cache()
    slab, carry, sim = dense_slab_path(device)
    graph_chunk(sim, carry, "dense_slab")
    del carry, sim
    torch.distributed.destroy_process_group()
    torch.cuda.empty_cache()
    entry_launches = entry_phase(device)
    torch.cuda.empty_cache()
    launches_x, sim, carry = xla_engine(device)
    graph_chunk(sim, carry, "xla_engine")
    del carry, sim
    xla_launches = {"xla_engine": launches_x, "xla_c2": xla_c2(device)}
    xla_compare(device)
    torch.cuda.empty_cache()
    xla_launches["xla_list_delivery"] = xla_list_delivery(
        DenseSimulator(PRESETS["c4_sorted"], cap=40, device=device))
    torch.cuda.empty_cache()
    xla_launches["xla_slab"] = xla_slab(device)
    torch.cuda.empty_cache()
    xla_launches["xla_slab_c5"] = xla_slab_c5(device)
    torch.cuda.empty_cache()
    ring_graph()
    cli_phase()
    by_path = {"main_path": launches, "list_delivery": delivery,
               "incremental": inc, "dense_slab": slab,
               "entry": entry_launches, **xla_launches}
    for row in rows:  # launches on the driven paths, and their sum
        row["launches_by_path"] = {p: c[row["name"]]
                                   for p, c in by_path.items()}
        row["launches"] = sum(row["launches_by_path"].values())
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi.splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
