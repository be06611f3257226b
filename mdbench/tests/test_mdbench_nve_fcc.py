"""The ``nve_fcc`` driver (cell ``lammps_lj.nve``) on the CPU at a small N,
through ``harness.run_cell`` under the cell's own limits: a sound run is
correct, the control is not, the program's start is held to the harness's,
and ``faults.py``'s faults planted in the step are caught; and the reader of
``halflist_ms.steps`` on synthetic traces."""

import json

import pytest
import torch

from mdbench import faults
from mdbench.drivers import nve, nve_fcc
from mdbench.lib import harness, spec, trace
from mdbench.tests import util

CELL = "lammps_lj.nve.quick"
# 60 warm-up steps: from the lattice at dt 0.005 the energy swings while the
# lattice melts (the float64 reference's own |dE/E| is 4.7e-5 at step 30 and
# about 1e-5 from step 50), which the cell's 300 cover
QUICK = {"nve_fcc_quick": {"driver": "nve_fcc", "chunk": 10,
                           "warm_steps": 60, "check_steps": 3,
                           "trace_chunks": 1}}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    body = json.loads((util.HERE / "workloads" / "lammps_lj.nve.json")
                      .read_text())
    body.update(traffic="nve_fcc_quick", reports_like="lammps_lj.nve")
    return util.bench_copy(tmp_path_factory.mktemp("bench"), traffic=QUICK,
                           cells={CELL: body})


def test_sound_run_is_correct_and_the_control_is_not(root):
    from md_neighbor_list_tpu_torch.utils.trace import COUNTS

    before = dict(steps=COUNTS["steps"], rebuilds=COUNTS["rebuilds"])
    r = util.run_small(root, CELL, control=True, trace=True)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    # n shrinks to the largest 4k^3 under the small N: 2048 = 4 * 8^3
    assert util.N_SMALL == 2744 and nve_fcc.fcc_n(util.N_SMALL) == 2048
    assert COUNTS["rebuilds"] > before["rebuilds"]  # the trigger fired
    ctl = r["control"]
    assert ctl["correct"] is False
    assert ctl["checks"]["force_err"]["value"] >= 3 * max(
        ctl["checks"]["force_err"]["limit"],
        r["checks"]["force_err"]["value"])
    assert r["metrics"]["steps_per_rebuild"]["value"] > 0
    assert r["checks"]["start_err"] == {"value": 0.0, "limit": 0}
    assert list(r)[-2:] == ["window", "checks"]


def test_the_program_makes_the_start_and_is_held_to_the_harness(
        root, monkeypatch):
    """The program's own fcc start (``DenseSimulator.init``) where its
    configuration names the lattice; a start off the harness's by one site
    fails ``start_err``; a program without the field (the parent of the
    lattice) is handed the harness's start and passes."""
    from md_neighbor_list_tpu_torch.core import system as port_system
    from md_neighbor_list_tpu_torch.models.dense_lj import DenseSimulator

    inits = []
    init = DenseSimulator.init
    monkeypatch.setattr(DenseSimulator, "init", lambda self, g: (
        inits.append(self.config.lattice), init(self, g))[1])
    r = util.run_small(root, CELL)
    assert r["correct"], r["checks"]
    assert inits == ["fcc"]

    fcc = port_system.init_fcc

    def off_by_one_site(*a, **kw):
        system, box = fcc(*a, **kw)
        system.pos[7] = system.pos[8]
        return system, box

    monkeypatch.setattr(port_system, "init_fcc", off_by_one_site)
    r = util.run_small(root, CELL)
    a = nve_fcc.inputs.box_side(2048, 0.8442) / 8  # site 8 lies a from site 7
    assert not r["correct"]
    assert r["checks"]["start_err"]["value"] == pytest.approx(a, rel=1e-6)

    monkeypatch.setattr(port_system, "init_fcc", fcc)
    monkeypatch.setattr(nve_fcc, "md_config", lambda c, n: (
        nve.md_config(c, n), False))
    r = util.run_small(root, CELL)
    assert r["correct"] and r["checks"]["start_err"]["value"] == 0.0
    assert inits == ["fcc", "fcc"]


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_faults_in_the_step_are_caught_from_the_fcc_start(root, fault):
    with faults.planted(fault, "nve_fcc") as switch:
        r = util.run_small(root, CELL, on_window=switch.arm)
    assert not r["correct"], (fault, r["checks"])
    assert r["failed"] == r["attempted"]


def test_start_is_the_fcc_lattice_with_the_seeds_velocities():
    from md_neighbor_list_tpu_torch.core.config import MDConfig
    cfg = MDConfig(n=256, rho=0.8442, temperature=1.44)
    system, pos, vel = nve_fcc.start_system(cfg, util.SEED, "cpu")
    assert pos.shape == (256, 3) and system.pos is pos
    again = nve_fcc.start_system(cfg, util.SEED, "cpu")
    assert bool((again[1] == pos).all()) and bool((again[2] == vel).all())
    assert float(vel.double().sum(0).abs().max()) < 1e-3
    with pytest.raises(ValueError):
        nve_fcc.fcc(255, 6.0, "cpu")


# a traced chunk: two rebuilds, each with its half list between markers
OPS = [("void mdnl::force_half_kernel<0, true>()", 0, 10),
       ("mdnl::span_begin_rebuild()", 10, 11),
       ("void mdnl::expand_kernel<4>()", 11, 13),
       ("mdnl::span_begin_halflist()", 13, 14),
       ("void mdnl::lists_half_kernel<true, true>()", 14, 20),
       ("void mdnl::list_pack_kernel<true>()", 21, 24),
       ("mdnl::span_end_halflist()", 24, 25),
       ("mdnl::span_end_rebuild()", 25, 26),
       ("void mdnl::force_half_kernel<0, true>()", 26, 36),
       ("mdnl::span_begin_rebuild()", 36, 37),
       ("mdnl::span_begin_halflist()", 38, 39),
       ("void mdnl::lists_half_kernel<true, true>()", 39, 43),
       ("mdnl::span_end_halflist()", 43, 44),
       ("mdnl::span_end_rebuild()", 44, 45)]


@pytest.mark.parametrize("cell", ["c4_sorted.nve", "lammps_lj.nve"])
def test_halflist_ms_reads_the_work_between_its_markers(cell):
    def read(ops):
        ctx = harness.Context(spec.load_cell(cell), object(), units=1000,
                              window_s=1.0,
                              trace=trace.Trace(list(ops), [], [], units=100,
                                                wall_s=1e-3))
        return spec.metric_reader("halflist_ms.steps").read(ctx)

    assert "halflist_ms.steps" in {m["name"]
                                   for m in spec.load_cell(cell).per_layer}
    # (6 + 3) us and 4 us: 6.5 us a rebuild
    assert read(OPS) == pytest.approx(6.5e-3)
    # the rebuild span holds the list's markers and work, not its own
    rebuild = spec.metric_reader("rebuild_ms.steps").read(harness.Context(
        spec.load_cell(cell), object(), units=1000, window_s=1.0,
        trace=trace.Trace(list(OPS), [], [], units=100, wall_s=1e-3)))
    assert rebuild == pytest.approx((13 + 6) / 2 * 1e-3)
    # the parent's trace: no halflist markers; and no trace at all
    assert read([o for o in OPS if "halflist" not in o[0]]) is None
    ctx = harness.Context(spec.load_cell(cell), object(), units=1000,
                          window_s=1.0, trace=None)
    assert spec.metric_reader("halflist_ms.steps").read(ctx) is None
