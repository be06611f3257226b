#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Builds the CUDA kernels from ``md_neighbor_list_tpu_torch/csrc``, holds each
against its plain PyTorch version (at small shapes that exercise wrap-around,
cell capacities from 28 to 480 — beyond 341 the sweep kernels' lane-strided
forms —, overflow and cleared validity, then at the full N = 1,000,000 size),
and drives three paths through the entry points a user calls, each with the
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
                 the merge kernel, and the list build through the incremental
                 rebuild. Before it, at N = 1,000,000: the merge kernel
                 against its plain version, the incremental rebuild against
                 its order-exact twin and against the full rebuild.

Each phase prints one JSON line; any failure ends the run with a non-zero exit
code. Without a CUDA device the script fails at once. ``--profile`` adds a
``torch.profiler`` breakdown by device kernel of 50 steps of each engine, of
one ``neighbor_list`` call and of ten incremental and ten full rebuilds
(information only).
The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from md_neighbor_list_tpu_torch import (PRESETS, DenseSimulator, MDConfig,
                                        neighbor_list, pair_list)
from md_neighbor_list_tpu_torch.core.box import Box
from md_neighbor_list_tpu_torch.core.system import System, init_lattice
from md_neighbor_list_tpu_torch.ops import (_cuda, decode, dense_cells,
                                            dense_force, dense_ref,
                                            incremental, oracle)
from md_neighbor_list_tpu_torch.utils import native

# Peak rates of one H100 SXM (NVIDIA data sheet): device memory and fp32
# outside the tensor cores. The bounds below are stated against them.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12

# Operations per pair, as the kernels' arithmetic counts them.
FLOPS_TEST = 9  # 3 sub, 3 mul, 2 add, 1 compare
FLOPS_HIT_FORCE = 16  # divide, s6, f, f*d, own and reaction sums
FLOPS_HIT_FORCE_FULL = 13  # the same without the reaction sums
FLOPS_HIT_PE = 5  # 4*(s6*s6 - s6) - shift, and its sum
FLOPS_HIT_PE_VIRIAL = 13  # divide, s6, pe, virial, two sums

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

MAX_RUN_SECONDS = 420.0  # the NVE run stops early (>= 200 steps) past this


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def sorted_records(state: dense_cells.DenseState, spec):
    """The expand kernel's inputs, as ``rebuild_dense`` makes them."""
    state = state._replace(pos=torch.remainder(state.pos, spec.L))
    keys = dense_cells.cell_keys(state, spec).reshape(-1)
    chans = torch.cat([state.pos.reshape(3, -1), state.vel.reshape(3, -1)])
    keys_s, order = torch.sort(keys, stable=True)
    row_start = dense_cells.row_starts(keys_s, spec)
    return (chans[:, order].contiguous(), state.pid.reshape(-1)[order],
            keys_s, row_start)


# ------------------------------------------------- kernel against plain
def compare_kernels(state0: dense_cells.DenseState, spec, cfg, label: str):
    """Run every kernel and its plain version on the same inputs; fail on
    any disagreement. Returns (rebuilt state, sorted records, per-kernel max
    errors)."""
    recs = sorted_records(state0, spec)
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
    errs["forces_half_pe"] = max(errs["forces_half_pe"], pe_err)

    pe4, vir4 = dense_force.dense_pe_virial(pos, spec, cfg.rc)
    torch.cuda.synchronize()
    pe4_p, vir4_p = dense_force.pe_virial_half_plain(pos, spec, cfg.rc)
    ok_pe, e_pe = force_close(pe4, pe4_p)
    ok_w, e_w = force_close(vir4, vir4_p)
    check(ok_pe and ok_w, f"{label}: pe/virial off by {e_pe}/{e_w}")
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
    return state, recs, errs


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
    beyond 128; above 341 the lane-strided kernels), an overflowing cell,
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
        state, _, errs = compare_kernels(state0, spec, cfg, label)
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


# --------------------------------------------------------------- bounds
def window_tests(valid: torch.Tensor, spec) -> int:
    """Distance tests this state needs in a full sweep: ordered pairs of
    occupied slots whose cells are the same or neighbours (27 cells, self
    pairs left out), from the cells' occupancy. A half sweep needs half."""
    occ = valid.sum(dim=-1, dtype=torch.int64).reshape(spec.mc, spec.mc,
                                                       spec.mc)
    around = sum(torch.roll(occ, (dz, dy, dx), (0, 1, 2))
                 for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1))
    return int((occ * around).sum() - occ.sum())


def bounds(spec, valid: torch.Tensor, records: int, hits: int) -> dict:
    """Least time (ms) the card could take per kernel on these inputs: the
    larger of bytes moved (inputs read once, outputs written once) over the
    memory rate and operations over the fp32 rate. The distance tests are
    those between occupied slots of this state, not between all slots."""
    S, cap = spec.slots, spec.cap
    words = dense_force.mask_words(cap)
    tests_full = window_tests(valid, spec)
    tests = tests_full // 2
    full_read = S * 12 + S  # the state and one validity byte per slot
    work = {
        "expand": (records * 32 + (spec.rows + 1) * 4 + S * 28, 0),
        "lists_half": (S * 12 + 5 * words * S * 3 * 4 + S * 4,
                       tests * FLOPS_TEST),
        "forces_half": (S * 24, tests * FLOPS_TEST + hits * FLOPS_HIT_FORCE),
        "forces_half_pe": (S * 28, tests * FLOPS_TEST
                           + hits * (FLOPS_HIT_FORCE + FLOPS_HIT_PE)),
        "pe_virial_half": (S * 20, tests * FLOPS_TEST
                           + hits * FLOPS_HIT_PE_VIRIAL),
        "count_half": (S * 12 + S * 4, tests * FLOPS_TEST),
        "force_full": (full_read + S * 12, tests_full * FLOPS_TEST
                       + 2 * hits * FLOPS_HIT_FORCE_FULL),
        "force_full_pe": (full_read + S * 16, tests_full * FLOPS_TEST
                          + 2 * hits * (FLOPS_HIT_FORCE_FULL + FLOPS_HIT_PE)),
        "count_full": (full_read + S * 4, tests_full * FLOPS_TEST),
    }
    out = {}
    for name, (nbytes, flops) in work.items():
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FP32_PER_S * 1e3
        out[name] = {"bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "bytes": nbytes, "operations": flops}
    out["distance_tests"] = {"half_sweep": tests, "full_sweep": tests_full}
    return out


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
    "count_half": ("md_neighbor_list_tpu_torch/csrc/count_half.cu",
                   "md_neighbor_list_tpu/ops/pallas_force.py:801"),
    "force_full": ("md_neighbor_list_tpu_torch/csrc/force_full.cu",
                   "md_neighbor_list_tpu/ops/pallas_force.py:185"),
    "force_full_pe": ("md_neighbor_list_tpu_torch/csrc/force_full.cu",
                      "md_neighbor_list_tpu/ops/pallas_force.py:185"),
    "count_full": ("md_neighbor_list_tpu_torch/csrc/count_full.cu",
                   "md_neighbor_list_tpu/ops/pallas_force.py:230"),
    "merge": ("md_neighbor_list_tpu_torch/csrc/merge.cu",
              "md_neighbor_list_tpu/ops/incremental.py:127"),
}
# K1b: the blocked, fuse_keys and split_dma forms of the expand are TPU
# layouts of K1's function; the port maps them onto K1, so K1's row names them
ALSO_REPLACES = {"expand": ["md_neighbor_list_tpu/ops/dense_cells.py:358",
                            "md_neighbor_list_tpu/ops/dense_cells.py:709"]}


def full_width(sim: DenseSimulator) -> list[dict]:
    """Every kernel against its plain version at N = 1M, cap = 40, with
    times."""
    cfg, spec, dev = sim.config, sim.spec, sim.device
    system, _ = jittered_system(cfg.n, cfg.rho, seed=7, jitter=0.1, device=dev)
    state0 = dense_cells.from_packed(system.pos, system.vel, system.pid, spec)
    state, recs, errs = compare_kernels(state0, spec, cfg, "full_width")
    check(int(state.valid().sum()) == cfg.n, "full_width: lost particles")
    pos, valid = state.pos, state.valid()
    counts_rc, _ = dense_force.dense_lists_half(pos, spec, cfg.rc)
    hits = int(counts_rc[state.valid()].sum())

    runs = {
        "expand": (lambda: dense_cells.expand(*recs, spec),
                   lambda: dense_cells.expand_plain(*recs, spec)),
        "lists_half": (
            lambda: dense_force.dense_lists_half(pos, spec, cfg.rs),
            lambda: dense_force.lists_half_plain(pos, spec, cfg.rs)),
        "forces_half": (
            lambda: dense_force.dense_forces_half(pos, spec, cfg.rc),
            lambda: dense_force.forces_half_plain(pos, spec, cfg.rc)),
        "forces_half_pe": (
            lambda: dense_force.dense_forces_half(pos, spec, cfg.rc, True),
            lambda: dense_force.forces_half_plain(pos, spec, cfg.rc, True)),
        "pe_virial_half": (
            lambda: dense_force.dense_pe_virial(pos, spec, cfg.rc),
            lambda: dense_force.pe_virial_half_plain(pos, spec, cfg.rc)),
        "count_half": (
            lambda: dense_force.dense_counts_half(pos, spec, cfg.rs),
            lambda: dense_force.counts_half_plain(pos, spec, cfg.rs)),
        "force_full": (
            lambda: dense_force.dense_forces(pos, valid, spec, cfg.rc, False),
            lambda: dense_force.forces_full_plain(pos, valid, spec, cfg.rc,
                                                  False)),
        "force_full_pe": (
            lambda: dense_force.dense_forces(pos, valid, spec, cfg.rc, True),
            lambda: dense_force.forces_full_plain(pos, valid, spec, cfg.rc,
                                                  True)),
        "count_full": (
            lambda: dense_force.dense_counts(pos, valid, spec, cfg.rs),
            lambda: dense_force.counts_full_plain(pos, valid, spec, cfg.rs)),
    }
    bound = bounds(spec, valid, recs[2].shape[0], hits)
    rows = []
    for name, (kernel, plain) in runs.items():
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1], "launches": None,
            "max_abs_err": errs[name],
            "ms": time_ms(kernel, 10), "plain_ms": time_ms(plain, 1),
            "bound_ms": bound[name]["bound_ms"],
            "bound_by": bound[name]["bound_by"],
            # no single PyTorch call computes any of these functions
            "library_ms": None,
        })
        if name in ALSO_REPLACES:
            rows[-1]["also_replaces"] = ALSO_REPLACES[name]
    emit("kernels_full_width", n=cfg.n, mc=spec.mc, cap=spec.cap,
         slots=spec.slots, hits_rc=hits, launches_so_far=dict(_cuda.LAUNCHES),
         bounds=bound, kernels=rows)
    return rows


# ------------------------------------------------------------ main path
def chained_builds_ms(sim: DenseSimulator, state, reps: int = 10) -> float:
    """ms per list build over ``reps`` chained builds, each from a state
    drifted ballistically so that the largest displacement is skin/2 — the
    state a rebuild sees when the displacement vote fires."""
    v2 = torch.sum(state.vel * state.vel, dim=0)
    tau = 0.5 * sim.config.skin / torch.sqrt(torch.max(v2))

    def chain():
        st = state
        for _ in range(reps):
            st = st._replace(pos=st.pos + tau * st.vel)
            st, _, _, _ = sim._rebuild_and_lists(st)

    return time_ms(chain, 1) / reps


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

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = 0
    while steps < cfg.steps:
        carry = sim.run(carry, 100)
        steps += 100
        torch.cuda.synchronize()
        if steps >= 200 and time.perf_counter() - t0 > MAX_RUN_SECONDS:
            break
    run_s = time.perf_counter() - t0

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

    build_ms = chained_builds_ms(sim, carry.state)
    result = {"n": cfg.n, "cap": sim.spec.cap, "pairs": pairs, "steps": steps,
              "energy_drift": drift, "e0": e0, "e1": ke1 + pe1,
              "pressure": pressure, "n_rebuilds": rebuilds, "kept": kept,
              "steps_per_s": steps / run_s, "build_ms": build_ms}
    emit("main_path", **result)

    need = {"expand": rebuilds + 1, "lists_half": 1,
            "forces_half": steps + 1, "forces_half_pe": 2,
            "pe_virial_half": 1}
    for name, least in need.items():
        check(launches[name] >= least,
              f"launches: {name} launched {launches[name]} times on the main "
              f"path, expected at least {least}")
    emit("launches", path="main_path", launches=launches,
         expected_at_least=need)
    return launches, carry


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

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx_h, cnt_h = neighbor_list(pos, box.L, rs, half=True, backend="dense")
    torch.cuda.synchronize()
    t_half = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx_f, cnt_f = neighbor_list(pos, box.L, rs, half=False, backend="dense")
    torch.cuda.synchronize()
    t_full = time.perf_counter() - t0
    t0 = time.perf_counter()
    pi, pj = pair_list(pos, box.L, rs, backend="dense")
    t_pairs = time.perf_counter() - t0

    # the same build piece by piece: the parity passes, and the split of the
    # time into device part, copy to the host and host decode
    spec = dense_cells.make_spec(box, rs, 40)
    pid = torch.arange(n, dtype=torch.int32, device=dev)
    seed_state = dense_cells.from_packed(box.wrap(pos), torch.zeros_like(pos),
                                         pid, spec)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = dense_cells.rebuild_dense(seed_state, spec)
    _, masks = dense_force.dense_lists_half(state.pos, spec, rs)
    torch.cuda.synchronize()
    t_device = time.perf_counter() - t0
    t0 = time.perf_counter()
    masks_h, pid_h = masks.cpu().numpy(), state.pid.cpu().numpy()
    t_copy = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx_m, cnt_m = decode.masks_to_padded(masks_h, pid_h, spec, n=n)
    t_decode = time.perf_counter() - t0
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
         seconds={"neighbor_list_half": t_half, "neighbor_list_full": t_full,
                  "pair_list": t_pairs, "device_rebuild_and_lists": t_device,
                  "masks_to_host": t_copy, "native_decode_half": t_decode},
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
    so the API grows cap from 40 to 480 and the list kernel runs its
    lane-strided form; every full row against a brute-force search."""
    system, box = jittered_system(CLUSTER_N, 1.0, seed=17, jitter=0.1,
                                  device=dev, cluster=CLUSTER_K)
    n, rs = CLUSTER_N, MDConfig(n=CLUSTER_N).rs
    spec40 = dense_cells.make_spec(box, rs, 40)
    t0 = time.perf_counter()
    idx, cnt = neighbor_list(system.pos, box.L, rs, half=False,
                             backend="dense")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
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
            "entries_in_cutoff_band": int(differ.sum()), "seconds": seconds}


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


def incremental_kernels(sim: DenseSimulator, state) -> tuple[dict, dict]:
    """At N = 1M, on ``state`` (the incremental run's last state) drifted by
    skin/2: K8 bitwise against its plain version, the incremental rebuild
    bitwise against its twin and as the same partition per cell as the full
    rebuild; and the window predicate tripped by a from_packed seed. Returns
    (the K8 row of the kernels line, numbers for the phase)."""
    cfg, spec, dev = sim.config, sim.spec, sim.device
    system, _ = init_lattice(cfg.n, cfg.rho,
                             torch.Generator(dev).manual_seed(5),
                             cfg.temperature, dev)
    seed = dense_cells.from_packed(system.pos, system.vel, system.pid, spec)
    _, seed_overflow = incremental.rebuild_dense_incremental(seed, spec)
    check(bool(seed_overflow), "incremental: a from_packed seed did not trip "
          "the mover window")
    del seed, system
    state = drifted_state(sim, state)

    args, row_start = incremental.merge_inputs(state, spec)
    movers_n = int((args[2].pid >= 0).sum())
    check(0 < movers_n < cfg.n // 2,
          f"incremental: {movers_n} movers after a skin/2 drift")
    got = incremental.merge(*args, spec)
    torch.cuda.synchronize()
    want = incremental.merge_plain(*args, spec)
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          "incremental: the merge kernel differs from its plain version")
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

    S = spec.slots
    stayers_n = int((args[1] >= 0).sum())
    # read: each slot's stayer pid (a stayer's pid is not read again), each
    # particle's pos and vel once from the side it comes from, each mover's
    # pid and one end-of-movers pid per cell; written: each slot once
    nbytes = (S * 4 + (stayers_n + movers_n) * 24 + movers_n * 4
              + spec.ncells * 4 + S * 28)
    bound = nbytes / PEAK_BYTES_PER_S * 1e3
    row = {"name": "merge", "route": "cuda", "source": SOURCES["merge"][0],
           "replaces": SOURCES["merge"][1], "launches": None,
           "max_abs_err": 0.0,
           "ms": time_ms(lambda: incremental.merge(*args, spec), 20),
           "plain_ms": time_ms(lambda: incremental.merge_plain(*args, spec),
                               3),
           "bound_ms": bound, "bound_by": "bytes",
           # no PyTorch call merges two slot arrays per cell
           "library_ms": None}
    numbers = {"movers": movers_n, "mover_share": movers_n / cfg.n,
               "stayers": stayers_n,
               "merge_bytes": nbytes,
               "merge_bytes_all_slots": 21 * 4 * S,
               "keys_sort_expand_movers_ms": time_ms(
                   lambda: incremental.merge_inputs(state, spec), 10),
               "rebuild_incremental_ms": time_ms(
                   lambda: incremental.rebuild_dense_incremental(state, spec),
                   10),
               "rebuild_full_ms": time_ms(
                   lambda: dense_cells.rebuild_dense(state, spec), 10)}
    return row, numbers


def incremental_path(sim: DenseSimulator):
    """``DenseSimulator(incremental=True)``: init, 1000 NVE steps, energies,
    and the list build through the incremental rebuild. Returns the launch
    counts of this path and the last carry."""
    cfg = sim.config
    _cuda.reset_launches()
    carry = sim.init()
    check(sim.full_fallbacks == 1 and sim.incremental_rebuilds == 0,
          "incremental: the lattice seed did not take the full rebuild")
    ke0, pe0 = (float(x) for x in sim.energies(carry))
    e0 = ke0 + pe0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry = sim.run(carry, cfg.steps)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
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
    build_ms = chained_builds_ms(sim, carry.state)
    emit("incremental", n=cfg.n, cap=sim.spec.cap, steps=cfg.steps,
         energy_drift=drift, e0=e0, e1=ke1 + pe1, n_rebuilds=rebuilds,
         kept=kept, steps_per_s=cfg.steps / run_s, build_ms=build_ms,
         incremental_rebuilds=taken[0], full_fallbacks=taken[1],
         chained_builds_incremental=sim.incremental_rebuilds - taken[0])
    need = {"merge": rebuilds - 1, "expand": rebuilds + taken[1],
            "forces_half": cfg.steps + 1}
    for name, least in need.items():
        check(launches[name] >= least,
              f"launches: {name} launched {launches[name]} times on the "
              f"incremental path, expected at least {least}")
    emit("launches", path="incremental", launches=launches,
         expected_at_least=need)
    return launches, carry


def traced(fn) -> tuple[float, list]:
    """Host ms of ``fn()`` under ``torch.profiler`` (synchronised), and its
    device kernels as (name, device ms, calls), longest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return wall_ms, sorted(rows, key=lambda r: -r[1])


def profile_steps(sim: DenseSimulator, carry, path: str,
                  steps: int = 50) -> None:
    """Device time of ``steps`` NVE steps by kernel, with the device's busy
    share of the traced window (tracing slows the host side down, so the
    share in an untraced run is higher: compare ``device_busy_ms / steps``
    with the path's time per step)."""
    at = [carry]  # the steps update the carry's tensors in place

    def advance(nsteps: int) -> None:
        at[0] = sim._run_chunk(at[0], nsteps)

    traced(lambda: advance(5))  # the first trace pays the set-up
    before = int(at[0].n_rebuilds)
    wall_ms, rows = traced(lambda: advance(steps))
    busy_ms = sum(r[1] for r in rows)
    emit("profile", path=path, steps=steps, wall_ms=wall_ms,
         device_busy_ms=busy_ms, device_busy_share=busy_ms / wall_ms,
         rebuilds=int(at[0].n_rebuilds) - before,
         kernels=[{"name": k[:70], "ms": ms, "calls": c}
                  for k, ms, c in rows[:14]])


def profile_neighbor_list(sim: DenseSimulator) -> None:
    """Device time by kernel of one ``neighbor_list`` call at full width,
    with the device's busy share of the call."""
    cfg = sim.config
    pos, box = caller_positions(sim)
    wall_ms, rows = traced(lambda: neighbor_list(
        pos, box.L, cfg.rs, half=True, backend="dense"))
    busy_ms = sum(r[1] for r in rows)
    emit("profile_neighbor_list", n=cfg.n, half=True, wall_ms=wall_ms,
         device_busy_ms=busy_ms, device_busy_share=busy_ms / wall_ms,
         kernels=[{"name": k[:70], "ms": ms, "calls": c}
                  for k, ms, c in rows[:8]])


def profile_rebuilds(sim: DenseSimulator, state, reps: int = 10) -> None:
    """Device time by kernel of ``reps`` incremental and ``reps`` full
    rebuilds of one skin/2-drifted state, with the device's busy share and
    the device operations per rebuild: what bounds a rebuild."""
    runs = (("incremental",
             lambda: incremental.rebuild_dense_incremental(state, sim.spec)),
            ("full", lambda: dense_cells.rebuild_dense(state, sim.spec)))
    for path, fn in runs:
        traced(fn)  # the first trace pays the set-up
        wall_ms, rows = traced(lambda: [fn() for _ in range(reps)])
        busy_ms = sum(r[1] for r in rows)
        emit("profile_rebuild", path=path, reps=reps, wall_ms=wall_ms,
             device_busy_ms=busy_ms, device_busy_share=busy_ms / wall_ms,
             device_ops_per_rebuild=sum(r[2] for r in rows) / reps,
             kernels=[{"name": k[:70], "ms": ms, "calls": c}
                      for k, ms, c in rows[:8]])


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

    t0 = time.perf_counter()
    _cuda.library()
    t_kernels = time.perf_counter() - t0
    native.load()  # the host decoder of the list delivery path (g++)
    emit("build", seconds=t_kernels,
         decoder_seconds=time.perf_counter() - t0 - t_kernels,
         ptxas=[line for text in _cuda.build_log for line in text.splitlines()
                if "registers" in line or "entry function" in line
                or "spill" in line or "error" in line.lower()])

    device = torch.device("cuda")
    small_shapes(device)
    sim = DenseSimulator(PRESETS["c4_sorted"], cap=40, device=device)
    rows = full_width(sim)
    sim = DenseSimulator(PRESETS["c4_sorted"], cap=40, device=device)
    launches, carry = main_path(sim)
    if "--profile" in sys.argv[1:]:
        profile_steps(sim, carry, "main_path")
        profile_neighbor_list(sim)
    del carry
    delivery = list_delivery(
        DenseSimulator(PRESETS["c4_sorted"], cap=40, device=device))
    sim = DenseSimulator(PRESETS["c4_sorted"], cap=40, device=device,
                         incremental=True)
    inc, carry = incremental_path(sim)
    row_k8, numbers = incremental_kernels(sim, carry.state)
    if "--profile" in sys.argv[1:]:
        profile_rebuilds(sim, drifted_state(sim, carry.state))
        profile_steps(sim, carry, "incremental")
    del carry
    emit("incremental_kernels", n=sim.config.n, cap=sim.spec.cap,
         kernels=[row_k8], **numbers)
    rows.append(row_k8)
    by_path = {"main_path": launches, "list_delivery": delivery,
               "incremental": inc}
    for row in rows:  # launches on the three driven paths, and their sum
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
