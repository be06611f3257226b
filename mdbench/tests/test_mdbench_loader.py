"""The loader finds every item by its name, and a cell is added by files
alone."""

import importlib
import json

import pytest

from mdbench.lib import harness, spec
from mdbench.tests import util


def test_every_listed_cell_loads_with_its_files():
    bench = json.loads((spec.HERE.parent / "BENCHMARK.json").read_text())
    for c in bench["workloads"]:
        cell = spec.load_cell(c["name"])
        assert cell.config["name"] == c["config"]
        assert cell.traffic["name"] == c["traffic"]
        assert cell.chips == c["chips"]
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer, c["name"]
        for m in cell.per_layer:
            assert m["moves"] in names
            assert hasattr(spec.metric_reader(m["name"]), "read")
        assert set(cell.check["limits"]), c["name"]
    for cfg in bench["configs"]:
        assert (spec.HERE.parent / cfg["file"]).exists()


def test_rooflines_and_drivers_found_by_name():
    for kernel in ("forces_half", "lists_half", "forces_half_slab"):
        mod = spec.roofline(kernel)
        assert mod.KERNELS and callable(mod.work)
    for name in ("nve", "build", "nve_fcc", "nve_slab"):
        assert hasattr(importlib.import_module(f"mdbench.drivers.{name}"),
                       "Run")
    with pytest.raises(FileNotFoundError):
        spec.load_cell("no_such_cell")
    with pytest.raises(FileNotFoundError):
        spec.metric_reader("no_such_metric")


def test_a_cell_added_as_files_only_runs(tmp_path):
    """A new mix (a data file) and a new cell (its file and its entry):
    found by name and run on the CPU, no code touched."""
    mix = dict(util.QUICK["build_quick"], jitter=0.2, drift_lo=0.2,
               drift_hi=0.3)
    cell = {"config": "c4_sorted", "traffic": "build_wide", "chips": 1,
            "reports_like": "c4_sorted.build",
            "check": {"limits": {"pair_miss": 0, "total_err": 0,
                                 "state_err": 0}}}
    root = util.bench_copy(tmp_path, traffic={"build_wide": mix},
                           cells={"c4_sorted.build_wide": cell})
    c = spec.load_cell("c4_sorted.build_wide", root=root,
                       benchmark=root.parent / "BENCHMARK.json")
    assert c.traffic["jitter"] == 0.2 and c.driver == "build"
    assert {m["name"] for m in c.end_to_end} == {"build_ms", "build_p95_ms",
                                                 "setup_s"}
    r = util.run_small(root, "c4_sorted.build_wide")
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"build_ms", "build_p95_ms", "setup_s"}


def test_a_cell_of_four_cards_added_as_files_only_loads(tmp_path):
    """A cell on the slab engine added by its files and entry alone (a new
    mix for the ``nve_slab`` driver) reports ``c5_dd.p4``'s metrics; the
    launcher takes its ranks from ``chips`` (test_mdbench_ranks.py runs
    them)."""
    mix = {"driver": "nve_slab", "chunk": 50, "warm_steps": 100,
           "check_steps": 10, "trace_chunks": 2}
    body = json.loads((util.HERE / "workloads" / "c5_dd.p4.json")
                      .read_text())
    body.update(traffic="nve_slab_short", reports_like="c5_dd.p4")
    root = util.bench_copy(tmp_path, traffic={"nve_slab_short": mix},
                           cells={"c5_dd.short": body})
    c = spec.load_cell("c5_dd.short", root=root,
                       benchmark=root.parent / "BENCHMARK.json")
    assert c.driver == "nve_slab" and c.chips == 4
    assert c.config["mesh_devices"] == 4
    assert {m["name"] for m in c.end_to_end} == {"steps_per_s", "setup_s"}
    assert {"nccl_ms_per_step", "forces_half_slab_roofline",
            "rank_imbalance"} <= {m["name"] for m in c.per_layer}


def test_a_cell_must_agree_with_its_entry(tmp_path):
    root = util.bench_copy(tmp_path)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"][0]["chips"] = 4
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(ValueError):
        spec.load_cell(bench["workloads"][0]["name"], root=root,
                       benchmark=tmp_path / "BENCHMARK.json")


def test_judge_needs_a_limit_and_a_number():
    ok, out = harness.judge({"a": 0.0, "b": 2.0}, {"a": 0.0, "b": 1.0})
    assert not ok and out["b"] == {"value": 2.0, "limit": 1.0}
    assert not harness.judge({"a": 0.0}, {})[0]
    assert not harness.judge({"a": float("nan")}, {"a": 1.0})[0]
    assert harness.judge({"a": 1.0}, {"a": 1.0})[0]
