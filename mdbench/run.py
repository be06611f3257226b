"""Run one cell of the benchmark once and print its result as the last line.

    python3 mdbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Loads and warms up the cell (set-up), measures
for ``--seconds``, checks what the timed path produced against the plain
reference, and prints one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number compared with its limit (also the last lines of
standard error).

Exits with status 2 and prints no result where there is no card or fewer
cards than the cell asks for (and for a cell of several cards, whose launcher
of ranks is not written yet), and with status 3 where the process has loaded
JAX or the JAX package. ``--control 1`` adds the control (the reference in
bfloat16 in the program's place) under ``control``: its numbers judged
against the same limits, and its verdict, which has to be false;
``--fault <name>`` plants a fault of ``faults.py``. Both are for reading the
limits on the card, and the benchmark's own runs use neither.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# top-level module names that must not be loaded in the printing process,
# compared whole (the port's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "md_neighbor_list_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="mdbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    ap.add_argument("--control", type=int, choices=[0, 1], default=0)
    ap.add_argument("--fault", default=None)
    return ap


def emit(result: dict) -> int:
    """Print the result's line (and its checks on standard error), after
    the check that no JAX was loaded."""
    from mdbench.lib.harness import print_checks
    found = forbidden_modules()
    if found:
        print(f"mdbench: the run loaded {found}: no result", file=sys.stderr,
              flush=True)
        return 3
    print(json.dumps(result), flush=True)
    if "control" in result:
        print(f"control correct {result['control']['correct']}",
              file=sys.stderr, flush=True)
        print_checks(result["control"]["checks"], what="control")
    print_checks(result["checks"])
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from mdbench.lib import spec
    cell = spec.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"mdbench: cell {cell.name} needs {cell.chips} CUDA card(s), "
              f"{have} found: no result", file=sys.stderr, flush=True)
        return 2
    if cell.chips > 1:
        print(f"mdbench: cell {cell.name} asks for {cell.chips} cards; runs "
              "of several ranks have no launcher here: no result",
              file=sys.stderr, flush=True)
        return 2
    from mdbench.lib import harness, peaks
    with planted(args.fault, cell.driver) as fault:
        result = harness.run_cell(cell, args.seed, args.seconds,
                                  bool(args.trace), "cuda", T_START,
                                  control=bool(args.control),
                                  on_window=fault and fault.arm)
    result["device"]["power_limit_w"] = peaks.power_limit_w()
    result["checks"] = result.pop("checks")  # last
    return emit(result)


def planted(fault, driver):
    import contextlib
    if fault is None:
        return contextlib.nullcontext()
    from mdbench import faults
    return faults.planted(fault, driver)


if __name__ == "__main__":
    sys.exit(main())
