"""One run of one cell: set-up, the measured window, the traced stretch, the
correctness check and the result's line.

A driver (``drivers/<name>.py``, named by the traffic mix) is a class ``Run``
with:

  Run(cell, seed, device, n=None) set-up: the inputs from the seed, the
                                   program's objects, the warm-up of every
                                   shape the window uses (``n`` shrinks the
                                   configuration, for tests on the CPU)
  unit() -> int                    one unit of the window's work (a chunk of
                                   steps, a build, a call); returns the units
  advance(k)                       k units, for the traced stretch
  trace_units                      how many units the traced stretch takes
  end_to_end(units, seconds)       the cell's end-to-end metrics but setup_s
  finish()                         after the window: read the program's
                                   outputs, then free its state
  check(control)                   the comparison with the plain reference:
                                   {number: value}; with ``control`` the same
                                   numbers with the reference's bfloat16 form
                                   in the program's place
  work                             what the reference counted on the
                                   measured inputs (pairs within rc, rs), for
                                   the rooflines
  unit_name                        what a unit is
  measure_work()                   optional: fill ``work`` for this rank's
                                   rooflines, in a traced run, after the
                                   check (a driver of several ranks)
  counters                         optional, set by ``finish``: the run's
                                   own counts ({"steps", "rebuilds",
                                   "migrated"}), kept under the result's
                                   ``window``

The check's limits are the cell file's ``check.limits``. The control's
numbers are judged against the same limits, and must come out not correct.

A run of several ranks (``lib/ranks.py``) runs these phases on every rank,
each opened and closed by a barrier, through its ``Group``; ``Solo`` is the
same surface for one process. Only rank 0 checks and builds the result; every
rank reads the per-layer metrics from its own trace, and a metric's
``combine(values)`` (default ``max``) makes one number of the ranks' readings.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import sys
import time

import torch

from mdbench.lib import spec as specs
from mdbench.lib import trace as tracing
from mdbench.lib import window


@dataclasses.dataclass
class Context:
    """What a per-layer metric reads."""

    cell: specs.Cell
    run: object  # the driver's Run
    units: int  # units of the untraced window
    window_s: float  # its seconds
    trace: tracing.Trace | None
    rank: int = 0  # the rank whose trace this is

    @property
    def wall_ms_per_unit(self) -> float:
        return window.per_unit_ms(self.units, self.window_s)


class Solo:
    """The phases of a run in one process: no barriers, nothing to share
    (``lib/ranks.py::Group`` has the same surface for a rank)."""

    rank, size, root = 0, 1, True
    driver_args: dict = {}

    def phase(self, name: str):
        return contextlib.nullcontext()

    def sync(self, device_sync):
        return device_sync

    def agree(self, go: bool) -> bool:
        return go

    def gather(self, value) -> list:
        return [value]

    def share(self, value):
        return value


def sync_for(device):
    dev = torch.device(device)
    if dev.type == "cuda":
        return lambda: torch.cuda.synchronize(dev)
    return lambda: None


def judge(checks: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a number without a limit, or not a number, fails."""
    out, ok = {}, True
    for name, value in checks.items():
        limit = limits.get(name)
        good = (limit is not None and value is not None
                and value == value and value <= limit)
        ok &= good
        out[name] = {"value": value, "limit": limit}
    return ok, out


def per_layer(ctx: Context, group) -> tuple[dict, list]:
    """(the cell's per-layer metrics that its readers find, each rank's
    readings): each metric read on every rank and its readings made one
    number by its reader's ``combine`` (default ``max``)."""
    readers = {m["name"]: specs.metric_reader(m["name"])
               for m in ctx.cell.per_layer}
    mine = {name: r.read(ctx) for name, r in readers.items()}
    ranks = group.gather(mine)
    out = {}
    for m in ctx.cell.per_layer:
        name = m["name"]
        values = [r[name] for r in ranks if r[name] is not None]
        if values:
            value = getattr(readers[name], "combine", max)(values)
            out[name] = {"value": value, "unit": m["unit"]}
    return out, ranks


def run_cell(cell: specs.Cell, seed: int, seconds: float, trace: bool,
             device, t_start: float, n: int | None = None,
             control: bool = False, on_window=None, group=None) -> dict | None:
    """One run of ``cell``; returns the result's fields (the line's keys,
    ``checks`` last, and with ``control`` the control's verdict and numbers
    under ``control``: ``{"correct", "checks"}``). ``on_window`` is called as
    the window starts (a planted fault's switch). With a ``group`` of several
    ranks every rank runs the phases, and only rank 0 returns a result."""
    group = group or Solo()
    drv = importlib.import_module(f"mdbench.drivers.{cell.driver}")
    device_sync = sync_for(device)
    sync = group.sync(device_sync)

    with group.phase("setup"):
        run = drv.Run(cell, seed, device, n=n, **group.driver_args)
        sync()
    setup_s = time.perf_counter() - t_start
    if on_window is not None:
        on_window()
    with group.phase("window"):
        units, window_s = window.run_window(seconds, run.unit, sync,
                                            group.agree)
    units, window_s = group.share((units, window_s))  # rank 0's clock
    tr = None
    if trace:
        with group.phase("trace"):
            tr = tracing.traced(run.advance, run.trace_units, device_sync)
    on_card = torch.device(device).type == "cuda"
    peak = max(group.gather(torch.cuda.max_memory_allocated(device)
                            if on_card else 0))
    with group.phase("check"):
        t_check = time.perf_counter()
        run.finish()
        if on_card:
            torch.cuda.empty_cache()
        limits = cell.check.get("limits", {})
        if group.root:
            correct, checks = judge(run.check(control=False), limits)
        check_s = time.perf_counter() - t_check
    if trace:
        if hasattr(run, "measure_work"):
            run.measure_work()
        ctx = Context(cell, run, units, window_s, tr, group.rank)
        layer_metrics, ranks = per_layer(ctx, group)
        busy = group.gather(tr.busy_s)
    if not group.root:
        return None
    # a failed check leaves no unit of the window trusted
    result = {"correct": correct, "attempted": units,
              "failed": 0 if correct else units}
    if trace:
        result["metrics"] = layer_metrics
    else:
        result["metrics"] = {
            **run.end_to_end(units, window_s),
            "setup_s": {"value": setup_s, "unit": "s"}}
        result["metrics"] = {m["name"]: result["metrics"][m["name"]]
                             for m in cell.end_to_end
                             if m["name"] in result["metrics"]}
    result["device"] = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
        "count": cell.chips, "memory_peak_bytes": peak}
    if tr is not None:
        # busy seconds averaged over the ranks' cards
        result["device"].update(busy_s=sum(busy) / len(busy),
                                window_s=tr.wall_s)
        result["breakdown"] = tr.breakdown()
        if group.size > 1:
            result["ranks"] = ranks
    if control:  # the reference's bfloat16 form in the program's place
        ok, numbers = judge(run.check(control=True), limits)
        result["control"] = {"correct": ok, "checks": numbers}
    result["window"] = {"units": units, "seconds": window_s,
                        "unit": run.unit_name, "check_s": check_s,
                        **{k: v for k, v in run.work.items() if k == "cap"}}
    if getattr(run, "counters", None) is not None:
        result["window"]["counters"] = run.counters
    result["checks"] = checks
    return result


def print_checks(checks: dict, stream=sys.stderr, what: str = "check"
                 ) -> None:
    for name, c in checks.items():
        print(f"{what} {name} {c['value']!r} limit {c['limit']!r}",
              file=stream, flush=True)
