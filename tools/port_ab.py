#!/usr/bin/env python3
"""A/B runs of the PyTorch/CUDA port's ``chip_smoke.py`` back to back on
one NVIDIA GPU: a parent tree against this tree, and compile-time variants
of this tree's kernels.

    git archive <parent commit> | tar -x -C <dir>      # the parent's files
    python3 tools/port_ab.py --parent <dir> [--rounds 2] \\
        [--variant regs40=-maxrregcount=40]

Each round runs parent, change, every variant, change, parent: both trees are
read before and after whatever lies between, so a drift of the card shows as
a difference between a tree's own two runs. A variant is this tree with
``MDNL_NVCC_FLAGS`` set to the given flags (``ops/_cuda.py`` hands them to
nvcc, so ``-maxrregcount=40`` caps every kernel at 40 registers).

Prints one JSON line per run — the card, each kernel's ``ms`` from the run's
``kernels`` line, ``steps_per_s`` and ``build_ms`` of its main path and, where
the tree has them, of its incremental and slab paths, the rebuild times of
phase ``incremental_kernels`` and the seconds of one ``neighbor_list`` call —
and a last line with each label's mean over the rounds. A run that fails ends
the script with its exit code.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent.parent


def run_smoke(tree: pathlib.Path, flags: str) -> dict:
    env = dict(os.environ, MDNL_NVCC_FLAGS=flags)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tree, env=env,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-2000:] + proc.stderr[-4000:])
        sys.exit(proc.returncode)
    out = {}
    for line in proc.stdout.splitlines():
        if not line.startswith("{"):
            continue
        rec = json.loads(line)
        if rec.get("phase") == "device":
            out["card"] = rec["nvidia_smi"]
        elif rec.get("phase") == "main_path":
            out["steps_per_s"] = rec["steps_per_s"]
            out["build_ms"] = rec["build_ms"]
        elif rec.get("phase") == "incremental":  # trees that have the path
            out["incremental"] = {k: rec[k] for k in ("steps_per_s",
                                                      "build_ms")}
        elif rec.get("phase") == "incremental_kernels":
            out["rebuild_ms"] = {k: rec[k] for k in (
                "rebuild_full_ms", "keys_sort_expand_movers_ms",
                "rebuild_incremental_ms") if k in rec}
        elif rec.get("phase") == "dense_slab_p1":
            out["dense_slab"] = {k: rec[k] for k in ("steps_per_s",
                                                     "build_ms")}
        elif rec.get("phase") == "list_delivery":
            out["neighbor_list_s"] = rec["seconds"]["neighbor_list_half"]
        elif "kernels" in rec and "phase" not in rec:
            out["ms"] = {row["name"]: row["ms"] for row in rec["kernels"]}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=pathlib.Path,
                    help="directory holding the parent tree's files")
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=FLAGS", help="nvcc flags for a run of "
                    "this tree; may be given more than once")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()

    variants = [tuple(v.split("=", 1)) for v in args.variant]
    plan = ([("parent", args.parent.resolve(), ""), ("change", HERE, "")]
            + [(name, HERE, flags) for name, flags in variants]
            + [("change", HERE, ""), ("parent", args.parent.resolve(), "")])
    runs: dict[str, list[dict]] = {}
    for rnd in range(args.rounds):
        for label, tree, flags in plan:
            res = run_smoke(tree, flags)
            runs.setdefault(label, []).append(res)
            print(json.dumps({"round": rnd, "run": label, "nvcc_flags": flags,
                              **res}), flush=True)

    def mean(values):
        return sum(values) / len(values)

    print(json.dumps({"means": {
        label: {"runs": len(rs),
                "steps_per_s": mean([r["steps_per_s"] for r in rs]),
                "build_ms": mean([r["build_ms"] for r in rs]),
                "ms": {k: mean([r["ms"][k] for r in rs]) for k in rs[0]["ms"]}}
        for label, rs in runs.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
