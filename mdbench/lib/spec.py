"""Find a cell, its configuration, its traffic mix and its per-layer metrics
by name.

Everything that belongs to one item sits in a file of its own under the
benchmark's folder, and nothing here lists them:

  workloads/<cell>.json    the cell: its config, traffic, chips and the
                           limits of its correctness check
  configs/<config>.json    the configuration as it is run, and the name of its
                           plain reference under reference/
  traffic/<mix>.json       the mix's parameters; ``driver`` names the general
                           generator under drivers/ that reads them
  metrics/<metric>.py      one per-layer metric: ``read(ctx)`` returns a
                           number, or None where it finds nothing to read
  roofline/<kernel>.py     one kernel's work: ``KERNELS`` (the patterns of its
                           ``__global__`` names in a trace) and ``work(w)``
                           (flops, bytes) from what the reference counted
                           on the measured inputs

``BENCHMARK.json``, at the root of the checkout, says which end-to-end and
per-layer metrics each cell reports. A cell that it lists must agree with its
file on config, traffic and chips.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent.parent  # the benchmark's folder


@dataclasses.dataclass
class Cell:
    name: str
    config: dict  # configs/<config>.json, with "name"
    traffic: dict  # traffic/<mix>.json, with "name"
    chips: int
    check: dict  # the cell file's "check": its limits
    end_to_end: list  # BENCHMARK.json entries this cell reports
    per_layer: list

    @property
    def driver(self) -> str:
        return self.traffic["driver"]


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(entry: dict, cell: str, moves: set | None = None) -> bool:
    """Whether a metric of BENCHMARK.json is reported in ``cell``: by its
    ``workloads`` key, or (per-layer metrics without one) wherever the
    end-to-end metric it moves is."""
    if "workloads" in entry:
        return cell in entry["workloads"]
    return moves is None or entry["moves"] in moves


def load_cell(name: str, root: pathlib.Path = HERE,
              benchmark: pathlib.Path | None = None) -> Cell:
    """The cell ``name`` from the files under ``root``; its metrics from
    ``benchmark`` (default: ``BENCHMARK.json`` beside ``root``)."""
    path = root / "workloads" / f"{name}.json"
    if not path.exists():
        raise FileNotFoundError(f"no cell {name!r}: {path} is missing")
    w = _json(path)
    config = {"name": w["config"],
              **_json(root / "configs" / f"{w['config']}.json")}
    traffic = {"name": w["traffic"],
               **_json(root / "traffic" / f"{w['traffic']}.json")}
    bench = _json(benchmark or root.parent / "BENCHMARK.json")
    listed = [c for c in bench["workloads"] if c["name"] == name]
    for c in listed:
        for key in ("config", "traffic", "chips"):
            if c[key] != w[key]:
                raise ValueError(f"cell {name!r}: BENCHMARK.json says {key} "
                                 f"{c[key]!r}, its file {w[key]!r}")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    moves = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, moves)]
    return Cell(name=name, config=config, traffic=traffic, chips=w["chips"],
                check=w.get("check", {}), end_to_end=e2e, per_layer=per_layer)


def _module(path: pathlib.Path):
    """Load a file as a module (metric names hold dots, so no import)."""
    if not path.exists():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(
        "mdbench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: pathlib.Path = HERE):
    return _module(root / "metrics" / f"{name}.py")


def roofline(kernel: str, root: pathlib.Path = HERE):
    return _module(root / "roofline" / f"{kernel}.py")
