"""On the card: each cell of BENCHMARK.json runs once, briefly, through the
command, and prints a correct result as its last line. Skips where there is
no card (decided inside the test)."""

import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]


def cells():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return [c["name"] for c in bench["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", cells())
def test_cell_runs_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = next(c["chips"] for c in bench["workloads"] if c["name"] == cell)
    if torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} cards")
    for trace in (0, 1):
        out = subprocess.run(
            [sys.executable, "mdbench/run.py", "--workload", cell, "--seed",
             str(2**31 + 77), "--seconds", "3", "--trace", str(trace)],
            capture_output=True, text=True, timeout=900, cwd=ROOT)
        assert out.returncode == 0, out.stderr[-3000:]
        r = json.loads(out.stdout.strip().splitlines()[-1])
        assert r["correct"], r["checks"]
        assert r["device"]["platform"] == "gpu" and r["metrics"]
