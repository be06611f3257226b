"""Helpers of the benchmark's CPU tests: a copy of the benchmark's data files
in a temporary folder, with cells and mixes added or changed as files, and
one run of a cell on the CPU at a small N."""

from __future__ import annotations

import json
import pathlib
import shutil
import time

from mdbench.lib import harness, spec

HERE = spec.HERE
N_SMALL = 2744  # 14^3: a lattice of spacing 1 at rho = 1, 5 cells of 2.8 a side
SEED = 2**31 + 987_654_321  # past 32 bits, as the driver's are


def bench_copy(tmp: pathlib.Path, traffic: dict | None = None,
               cells: dict | None = None) -> pathlib.Path:
    """The data files (workloads, configs, traffic) and BENCHMARK.json under
    ``tmp``; ``traffic`` and ``cells`` add or replace files by name (cells
    are also entered in BENCHMARK.json). Returns the copy's folder."""
    root = tmp / "mdbench"
    for sub in ("workloads", "configs", "traffic"):
        shutil.copytree(HERE / sub, root / sub)
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    for name, body in (traffic or {}).items():
        (root / "traffic" / f"{name}.json").write_text(json.dumps(body))
    for name, body in (cells or {}).items():
        (root / "workloads" / f"{name}.json").write_text(json.dumps(body))
        bench["workloads"] = [c for c in bench["workloads"]
                              if c["name"] != name]
        bench["workloads"].append({"name": name, "config": body["config"],
                                   "traffic": body["traffic"],
                                   "chips": body["chips"], "why": "a test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            like = body.get("reports_like")
            if like and like in m.get("workloads", []):
                m["workloads"].append(name)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


# quick mixes for the CPU: fewer warm-up steps and smaller chunks
QUICK = {
    "nve_quick": {"driver": "nve", "chunk": 10, "warm_steps": 20,
                  "check_steps": 3, "trace_chunks": 1},
    "build_quick": {"driver": "build", "frames": 3, "jitter": 0.1,
                    "drift_lo": 0.4, "drift_hi": 0.5, "samples": 2,
                    "trace_builds": 2},
}


def quick_cells(tmp: pathlib.Path) -> pathlib.Path:
    """A copy with the two cells' quick forms, ``<cell>.quick``, under
    the real cells' limits."""
    cells = {}
    for cell, mix in (("c4_sorted.nve", "nve_quick"),
                      ("c4_sorted.build", "build_quick")):
        body = json.loads((HERE / "workloads" / f"{cell}.json").read_text())
        body["traffic"] = mix
        body["reports_like"] = cell
        cells[cell + ".quick"] = body
    return bench_copy(tmp, traffic=QUICK, cells=cells)


def run_small(root: pathlib.Path, cell: str, control: bool = False,
              seconds: float = 0.3, trace: bool = False,
              on_window=None) -> dict:
    c = spec.load_cell(cell, root=root,
                       benchmark=root.parent / "BENCHMARK.json")
    return harness.run_cell(c, SEED, seconds, trace, "cpu",
                            time.perf_counter(), n=N_SMALL, control=control,
                            on_window=on_window)
