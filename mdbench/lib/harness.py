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

The check's limits are the cell file's ``check.limits``. The control's
numbers are judged against the same limits, and must come out not correct.
"""

from __future__ import annotations

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

    @property
    def wall_ms_per_unit(self) -> float:
        return window.per_unit_ms(self.units, self.window_s)


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


def per_layer(ctx: Context) -> dict:
    """The cell's per-layer metrics that its readers find."""
    out = {}
    for m in ctx.cell.per_layer:
        value = specs.metric_reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(cell: specs.Cell, seed: int, seconds: float, trace: bool,
             device, t_start: float, n: int | None = None,
             control: bool = False, on_window=None) -> dict:
    """One run of ``cell``; returns the result's fields (the line's keys,
    ``checks`` last, and with ``control`` the control's verdict and numbers
    under ``control``: ``{"correct", "checks"}``). ``on_window`` is called as
    the window starts (a planted fault's switch)."""
    drv = importlib.import_module(f"mdbench.drivers.{cell.driver}")
    sync = sync_for(device)

    run = drv.Run(cell, seed, device, n=n)
    sync()
    setup_s = time.perf_counter() - t_start
    if on_window is not None:
        on_window()
    units, window_s = window.run_window(seconds, run.unit, sync)
    tr = None
    if trace:
        tr = tracing.traced(run.advance, run.trace_units, sync)
    on_card = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    t_check = time.perf_counter()
    run.finish()
    if on_card:
        torch.cuda.empty_cache()
    limits = cell.check.get("limits", {})
    correct, checks = judge(run.check(control=False), limits)
    check_s = time.perf_counter() - t_check
    # a failed check leaves no unit of the window trusted
    result = {"correct": correct, "attempted": units,
              "failed": 0 if correct else units}
    if trace:
        ctx = Context(cell, run, units, window_s, tr)
        result["metrics"] = per_layer(ctx)
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
        result["device"].update(busy_s=tr.busy_s, window_s=tr.wall_s)
        result["breakdown"] = tr.breakdown()
    if control:  # the reference's bfloat16 form in the program's place
        ok, numbers = judge(run.check(control=True), limits)
        result["control"] = {"correct": ok, "checks": numbers}
    result["window"] = {"units": units, "seconds": window_s,
                        "unit": run.unit_name, "check_s": check_s,
                        **{k: v for k, v in run.work.items() if k == "cap"}}
    result["checks"] = checks
    return result


def print_checks(checks: dict, stream=sys.stderr, what: str = "check"
                 ) -> None:
    for name, c in checks.items():
        print(f"{what} {name} {c['value']!r} limit {c['limit']!r}",
              file=stream, flush=True)
