"""Neighbour-list builds back to back: ``DenseSimulator._rebuild_and_lists``.

Traffic parameters: ``frames`` (M), ``jitter``, ``drift_lo`` and
``drift_hi`` (fractions of the skin), ``samples`` (builds of the window kept
whole for the check, besides the last one), ``trace_builds``.

The inputs. Set-up makes M frames from the seed: the configuration's
simple-cubic lattice, each coordinate moved by a uniform draw within
+-``jitter``, the rows in a seeded order, with Maxwell velocities at the
configuration's temperature. Build j takes frame j mod M drifted ballistically
by its velocities for the time at which its fastest particle has moved a
seeded fraction of the skin, uniform in [drift_lo, drift_hi]: no input
repeats, and every one lies within half a skin of its frame, as the inputs of
a Verlet list's rebuilds do. Why not the chained drift of the JAX package's
bench (each build from the last, drifted by skin / 2): over a window of ten
thousand builds, force-free ballistic drift turns the lattice into an ideal
gas, whose Poisson(23) cells pass the cap of 40 now and then, and the cap
would grow inside the window. Why not snapshots of an NVE run: those are the
program's own state, which the reference may not take as its input.

The window's unit is one build: the drift (the harness's, marked
``mdbench.harness`` in a trace) and one ``_rebuild_and_lists``. A CUDA event
is recorded between builds, so that every build's time is read after the
window with no host read inside it.

Which builds the check sees: a reservoir of ``samples`` builds drawn from the
seed over every build of the window (Vitter's algorithm R: build j >=
``samples`` takes the place of a kept one with chance samples / (j + 1)),
each copied whole as it is made (its masks, its rebuilt state and its pair
total, marked ``mdbench.harness``), and the last build. About samples * (1 +
ln(builds / samples)) builds of a window are copied, some forty of ten
thousand, so the copies move neither the rate nor the tail.

The check, over every kept build: its packed masks read as a set of pairs
against the reference's pairs within rs of its input (``pair_miss``, beyond
the band; bits that name an empty slot count), its pair total against the
reference's count (``total_err``, beyond the band's pairs), and its rebuilt
state (``state_err``: particles missing or held twice, and positions that are
not their wrapped input bit for bit). A list with the right count and wrong
partners fails ``pair_miss`` in whichever build it comes.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from mdbench.drivers.nve import md_config
from mdbench.lib import inputs
from mdbench.lib import trace as tracing
from mdbench.lib import window
from mdbench.reference import lj, pairsets


def drift(pos, vel, t: float, tmp, out):
    """out = pos + (vel * t), two rounded float32 operations (no fused
    multiply-add), so that the slot layout the program is handed and the
    particle order the reference reads hold the same values bit for bit."""
    torch.mul(vel, t, out=tmp)
    return torch.add(pos, tmp, out=out)


class Run:
    unit_name = "builds"

    def __init__(self, cell, seed: int, device, n: int | None = None):
        from md_neighbor_list_tpu_torch.models.dense_lj import DenseSimulator
        from md_neighbor_list_tpu_torch.ops.dense_cells import (DenseState,
                                                                from_packed)
        self.DenseState = DenseState
        c, t = cell.config, cell.traffic
        self.cfg = md_config(c, n)
        self.device = torch.device(device)
        n = self.cfg.n
        self.L = inputs.box_side(n, self.cfg.rho)
        self.samples = int(t["samples"])
        self.trace_units = int(t["trace_builds"])
        self.sim = DenseSimulator(self.cfg, cap=int(c["cap"]), device=device)
        base = inputs.lattice(n, self.L, device)
        pid = torch.arange(n, dtype=torch.int32, device=device)
        self.frames, self.states, vmax = [], [], []
        for i in range(int(t["frames"])):
            g = inputs.generator(seed, 1 + i, device)
            pos = inputs.shuffled(
                inputs.jittered(base, g, float(t["jitter"]), self.L), g)
            vel = inputs.maxwell(g, n, self.cfg.temperature, device)
            self.frames.append((pos, vel))
            self.states.append(from_packed(pos, vel, pid, self.sim.spec))
            vmax.append(float(torch.sqrt(torch.sum(vel * vel, dim=1)).max()))
        rng = np.random.default_rng([seed % 2**63, 7])
        self.frac = rng.uniform(float(t["drift_lo"]), float(t["drift_hi"]),
                                size=1 << 20)
        self.pick = np.random.default_rng([seed % 2**63, 11]).random(1 << 20)
        self.vmax = vmax
        self.buf = torch.empty_like(self.states[0].pos)
        self.tmp = torch.empty_like(self.buf)
        self.on_card = self.device.type == "cuda"
        self.kept = [None] * self.samples  # [j, (pos, pid, masks, total)]
        self.marks = []
        self.j = 0
        for _ in range(max(2, self.samples)):  # the capture, the copies
            self.unit()
        self.j = 0
        self.marks = []
        for k in self.kept:
            k[0] = -1
        self.work = {}

    def drift_time(self, j: int) -> float:
        i = j % len(self.frames)
        return float(self.frac[j % self.frac.size]) * self.cfg.skin \
            / self.vmax[i]

    def _mark(self):
        if self.on_card:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def slot(self, j: int) -> int:
        """Where build j goes in the reservoir; ``samples`` or more: not
        kept."""
        if j < self.samples:
            return j
        return int(self.pick[j % self.pick.size] * (j + 1))

    def keep(self, k: int, j: int, out) -> None:
        """Copy build j's outputs whole into the reservoir's place k (buffers
        made in set-up, made anew only if the capacity grew)."""
        state, _, masks, total = out
        got = (state.pos, state.pid, masks, total)
        have = self.kept[k]
        if have is None or any(a.shape != b.shape
                               for a, b in zip(have[1], got)):
            self.kept[k] = [j, tuple(t.clone() for t in got)]
            return
        for dst, src in zip(have[1], got):
            dst.copy_(src)
        have[0] = j

    def unit(self) -> int:
        j = self.j
        if not self.marks:
            self.marks.append(self._mark())
        st = self.states[j % len(self.states)]
        with tracing.annotate("harness"):
            drift(st.pos, st.vel, self.drift_time(j), self.tmp, self.buf)
        out = self.sim._rebuild_and_lists(self.DenseState(self.buf, st.vel,
                                                          st.pid))
        k = self.slot(j)
        if k < self.samples:
            with tracing.annotate("harness"):
                self.keep(k, j, out)
        self.last = out
        self.marks.append(self._mark())
        self.j += 1
        return 1

    def advance(self, builds: int) -> None:
        for _ in range(builds):
            self.unit()

    def build_times_ms(self) -> list:
        """Every build's time from the marks around it."""
        m = self.marks
        if self.on_card:
            return [a.elapsed_time(b) for a, b in zip(m[:-1], m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m[:-1], m[1:])]

    def end_to_end(self, units: int, seconds: float) -> dict:
        return {"build_ms": {"value": window.per_unit_ms(units, seconds),
                             "unit": "ms"},
                "build_p95_ms": {"value": window.percentile(
                    self.build_times_ms()[:units], 95), "unit": "ms"}}

    def input_of(self, j: int) -> torch.Tensor:
        """Build j's input positions in particle order, as the window's
        drift made them."""
        pos, vel = self.frames[j % len(self.frames)]
        tmp, out = torch.empty_like(pos), torch.empty_like(pos)
        return drift(pos, vel, self.drift_time(j), tmp, out)

    def finish(self) -> None:
        """Read every kept build and the last one as pairs and particles,
        then free the program's state and the copies."""
        spec = self.sim.spec
        n = self.cfg.n
        state, _, masks, total = self.last
        builds = {j: got for j, got in self.kept if j >= 0}
        builds[self.j - 1] = (state.pos, state.pid, masks, total)
        self.got = {}
        for j, (pos, pid, masks, total) in sorted(builds.items()):
            keys, bad = pairsets.mask_pair_keys(masks, pid, spec.mc,
                                                spec.cap, n)
            flat = pid.reshape(-1).to(torch.int64)
            keep = flat >= 0
            self.got[j] = (keys, bad, int(total), flat[keep].clone(),
                           pos.reshape(3, -1)[:, keep].T.clone())
        self.last_j = self.j - 1
        self.cap = self.sim.cap
        del self.last, self.sim, self.states, self.buf, self.tmp, self.kept
        del builds, state, masks, total

    def _reference(self):
        if not hasattr(self, "_ref"):
            rs = self.cfg.rs
            self._ref = {j: lj.half_pairs(self.input_of(j), self.L, rs)
                         for j in self.got}
            keys = self._ref[self.last_j][0]
            self.work = {"n": self.cfg.n, "pairs_rs": keys.numel(),
                         "rs": rs, "cap": self.cap}
        return self._ref

    def check(self, control: bool = False) -> dict:
        ref = self._reference()
        rs, n = self.cfg.rs, self.cfg.n
        miss = total_err = state_err = 0
        for j, (keys, bad, total, ids, pos) in self.got.items():
            ref_keys, band = ref[j]
            if control:  # the reference in bfloat16 in the program's place
                keys = lj.half_pairs(self.input_of(j), self.L, rs,
                                     precision="bf16")[0]
                bad, total = 0, keys.numel()
            miss += pairsets.mismatches(keys, ref_keys, band)[0] + bad
            total_err += max(0, abs(total - ref_keys.numel()) - band.numel())
            if control:
                continue
            want = torch.remainder(self.input_of(j), self.L)
            seen = torch.bincount(ids, minlength=n)[:n]
            lost = int(torch.sum(seen != 1)) + int(torch.sum(ids >= n))
            ok = ids < n
            moved = int(torch.sum(torch.any(pos[ok] != want[ids[ok]], dim=1)))
            state_err += lost + moved
        out = {"pair_miss": miss, "total_err": total_err}
        if not control:
            out["state_err"] = state_err
        return out
