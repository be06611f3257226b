"""The fcc start and the ``lammps_lj`` preset (LAMMPS ``bench/in.lj``): the
port's ``init_fcc``, the lattice each engine's ``init`` takes from the
configuration, the dense engine from the fcc start against the benchmark's
plain reference in float64, the CLI on the preset, and the names of the
device spans' markers."""

import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from md_neighbor_list_tpu_torch.core.box import Box
from md_neighbor_list_tpu_torch.core.config import PRESETS, MDConfig
from md_neighbor_list_tpu_torch.core.system import (init_fcc, init_lattice,
                                                    init_start)
from md_neighbor_list_tpu_torch.models.dense_lj import DenseSimulator
from md_neighbor_list_tpu_torch.models.lj_nve import Simulator
from md_neighbor_list_tpu_torch.ops import _cuda
from md_neighbor_list_tpu_torch.parallel.dense_slab import DenseSlabSimulator
from md_neighbor_list_tpu_torch.parallel.mesh import run_ranks
from md_neighbor_list_tpu_torch.parallel.slab import SlabSimulator
from md_neighbor_list_tpu_torch.utils.trace import COUNTS
from mdbench.drivers import nve, nve_fcc
from mdbench.reference import lj

ROOT = pathlib.Path(__file__).resolve().parent.parent
LAMMPS = PRESETS["lammps_lj"]
FORCE_TOL = 2e-3  # c4_sorted.nve's force_err limit (mdbench/workloads)


def _cfg(n: int, **kw) -> MDConfig:
    return dataclasses.replace(LAMMPS, n=n, **kw)


def _gen(seed: int = 5) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _sorted_rows(pos: torch.Tensor) -> np.ndarray:
    a = pos.numpy()
    return a[np.lexsort(a.T[::-1])]


def test_lammps_preset_is_in_lj_scaled_by_four():
    assert LAMMPS.n == 4 * 80**3 == 2_048_000 and LAMMPS.lattice == "fcc"
    assert (LAMMPS.rho, LAMMPS.rc, LAMMPS.skin, LAMMPS.dt,
            LAMMPS.temperature) == (0.8442, 2.5, 0.3, 0.005, 1.44)
    L = Box.from_density(LAMMPS.n, LAMMPS.rho).L
    assert L / 80 == pytest.approx((4 / 0.8442) ** (1 / 3))
    assert math.floor(L / LAMMPS.rs) == 47  # cells a side, 2.859 sigma
    assert MDConfig().lattice == "sc"
    with pytest.raises(ValueError, match="lattice"):
        MDConfig(lattice="bcc")


@pytest.mark.parametrize("k", [3, 6, 7])
def test_init_fcc_sites(k):
    n = 4 * k**3
    system, box = init_fcc(n, 0.8442, _gen(), 1.44, device="cpu")
    assert box.L == Box.from_density(n, 0.8442).L
    pos = system.pos
    assert pos.shape == (n, 3) and pos.dtype == torch.float32
    assert bool((pos >= 0).all()) and bool((pos < box.L).all())
    assert torch.unique(pos, dim=0).shape[0] == n
    # every site's nearest neighbours (12 of them) lie a / sqrt(2) away
    a = box.L / k
    d = pos[:, None, :].double() - pos[None, :, :].double()
    d = d - box.L * torch.round(d / box.L)
    r = torch.sqrt(torch.sum(d * d, dim=-1)) + 1e9 * torch.eye(n)
    assert float(r.min()) == pytest.approx(a / math.sqrt(2), rel=1e-5)
    near = torch.sum(r < a / math.sqrt(2) * 1.01, dim=1)
    assert bool((near == 12).all())
    # zero net momentum, Maxwell at the temperature
    assert float(system.vel.double().sum(0).abs().max()) < 1e-3
    assert float(system.vel.double().pow(2).mean()) == pytest.approx(
        1.44, rel=0.15)
    assert torch.equal(system.pid, torch.arange(n, dtype=torch.int32))
    # the benchmark's own fcc start holds the same sites
    theirs = nve_fcc.fcc(n, box.L, "cpu")
    np.testing.assert_array_equal(_sorted_rows(pos), _sorted_rows(theirs))


@pytest.mark.parametrize("k", [2, 8])
def test_init_fcc_from_the_harness_generator_is_its_start_bit_for_bit(k):
    """The benchmark's ``nve_fcc`` holds the program's fcc start to its own,
    row by row: the same sites in the same order, and from the same
    generator the same velocities."""
    n = 4 * k**3
    cfg = _cfg(n)
    seed = 2**31 + 12_345
    _, pos, vel = nve_fcc.start_system(cfg, seed, "cpu")
    system, _ = init_start(cfg, nve_fcc.inputs.generator(seed, 0, "cpu"),
                           "cpu")
    assert torch.equal(system.pos, pos) and torch.equal(system.vel, vel)
    c = json.loads((ROOT / "mdbench/configs/lammps_lj.json").read_text())
    named, names_lattice = nve_fcc.md_config(c, n)
    assert names_lattice
    assert named == dataclasses.replace(nve.md_config(c, n), lattice="fcc")
    assert dataclasses.replace(named, layout="morton") == cfg


@pytest.mark.parametrize("n", [0, 100, 863, 865, 1000])
def test_init_fcc_refuses_n_not_four_k_cubed(n):
    with pytest.raises(ValueError, match="4k"):
        init_fcc(n, 0.8442, device="cpu")


def test_harness_fcc_shrinks_n_to_four_k_cubed():
    assert [nve_fcc.fcc_n(n) for n in (4, 31, 32, 2744, 2_048_000)] == [
        4, 4, 32, 2048, 2_048_000]


ENGINES = {"dense": (DenseSimulator, 1), "xla": (Simulator, 1),
           "dense_slab": (DenseSlabSimulator, 1), "slab": (SlabSimulator, 2)}


@pytest.mark.parametrize("lattice", ["sc", "fcc"])
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_each_engine_init_takes_the_configured_start(engine, lattice,
                                                     monkeypatch):
    """``init`` hands ``build`` the lattice the configuration names: the
    fcc start for ``lattice="fcc"``, and by default (no ``lattice`` given)
    the simple-cubic start of ``init_lattice``, bit for bit."""
    cls, p = ENGINES[engine]
    n = 1372  # 4 * 7^3, also a box the two slabs of 2 rs tile
    base = dict(n=n, rho=0.8442, rc=2.5, skin=0.3, temperature=1.44,
                mesh_devices=p)
    cfg = MDConfig(**base) if lattice == "sc" else MDConfig(**base,
                                                            lattice="fcc")
    monkeypatch.setattr(cls, "build", lambda self, system: system)
    if p == 1:
        got = [cls(cfg, device="cpu").init(_gen(11))]
    else:
        got = run_ranks(p, lambda ring: cls(cfg, device="cpu",
                                            ring=ring).init(_gen(11)))
    init = init_fcc if lattice == "fcc" else init_lattice
    want, _ = init(n, 0.8442, _gen(11), 1.44, "cpu")
    for system in got:
        assert torch.equal(system.pos, want.pos)
        assert torch.equal(system.vel, want.vel)
    same, _ = init_start(cfg, _gen(11), "cpu")
    assert torch.equal(same.pos, want.pos)


def _packed(sim, carry):
    """The carry's (pos, vel, force) in particle order, as tensors."""
    return (torch.from_numpy(a) for a in sim.to_system(carry))


@pytest.mark.parametrize("k", [6, 7])  # n = 864, 1372: 3 and 4 cells a side
def test_dense_engine_from_fcc_follows_the_reference(k):
    n = 4 * k**3
    cfg = _cfg(n)
    sim = DenseSimulator(cfg, device="cpu")
    assert sim.spec.mc == k - 3
    system, box = init_start(cfg, _gen(3), "cpu")
    carry = sim.build(system)
    pos, _, force = _packed(sim, carry)
    ref = lj.forces(pos, box.L, cfg.rc)
    assert nve.force_error(force, ref) <= FORCE_TOL
    before = {c: COUNTS[c] for c in ("steps", "rebuilds", "list_forces")}
    carry = sim.run(carry, 40, chunk=10)
    grew = {c: COUNTS[c] - v for c, v in before.items()}
    assert grew["steps"] == 40 and grew["list_forces"] == 40
    assert grew["rebuilds"] >= 1  # displacement-triggered, at dt 0.005
    x, _ = lj.verlet(system.pos, system.vel, ref.force, box.L, cfg.rc,
                     float(np.float32(cfg.dt)), 40)
    pos40, _, force40 = _packed(sim, carry)
    d = pos40.double() - x
    d = d - box.L * torch.round(d / box.L)
    assert float(d.abs().max()) < 1e-4
    assert nve.force_error(force40, lj.forces(pos40, box.L, cfg.rc)) \
        <= FORCE_TOL
    assert not bool(carry.overflow)


def test_cli_runs_the_lammps_preset():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "md_neighbor_list_tpu_torch", "--device",
         "cpu", "--preset", "lammps_lj", "--n", "864", "--steps", "20"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    events = {e["event"]: e for e in (json.loads(line) for line in
                                      out.stderr.splitlines()
                                      if line.startswith("{"))}
    assert events["start"]["preset"] == "lammps_lj"
    assert events["run_done"]["counters"]["steps"] == 20
    assert events["run_done"]["counters"]["rebuilds"] >= 1
    assert "N=864" in out.stdout


def test_no_span_marker_name_holds_another_spans_begin():
    """A reader finds a device span by the substring ``span_begin_<name>``
    (``mdbench/lib/spans.py``): only ``rebuild``'s own markers may contain
    ``span_begin_rebuild``, or a list span would count as a rebuild."""
    assert set(_cuda._SPANS) == {"span_begin_rebuild", "span_end_rebuild",
                                 "span_begin_halflist", "span_end_halflist",
                                 "span_begin_increment", "span_end_increment"}
    spans = {m.split("_", 2)[2] for m in _cuda._SPANS}
    for name in spans:
        holding = [m for m in _cuda._SPANS
                   if f"span_begin_{name}" in m or f"span_end_{name}" in m]
        assert sorted(holding) == sorted(
            [f"span_begin_{name}", f"span_end_{name}"]), name
    assert [m for m in _cuda._SPANS if "span_begin_rebuild" in m] == [
        "span_begin_rebuild"]
