"""Nothing that the benchmark runs loads JAX or the JAX package: a dry run
of cell 1 on the CPU at a small N, in a fresh interpreter, then the
top-level names of ``sys.modules`` compared whole (the port's name begins
with the JAX package's, and must not count)."""

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]

SCRIPT = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
from mdbench.tests import util
import mdbench.run as run
root = util.quick_cells(__import__("pathlib").Path(sys.argv[2]))
r = util.run_small(root, "c4_sorted.nve.quick")
print(json.dumps({"correct": r["correct"],
                  "forbidden": run.forbidden_modules(),
                  "port": "md_neighbor_list_tpu_torch" in sys.modules}))
"""


def test_dry_run_loads_no_jax(tmp_path):
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(ROOT),
                          str(tmp_path)], capture_output=True, text=True,
                         timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "forbidden": [], "port": True}


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    import mdbench.run as run
    monkeypatch.setitem(sys.modules, "md_neighbor_list_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "md_neighbor_list_tpu.ops", sys)
    assert run.forbidden_modules() == ["jax", "md_neighbor_list_tpu"]


def test_no_card_no_result(tmp_path):
    """On a machine without a card (this one) the command exits non-zero and
    prints no result."""
    import torch
    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, str(ROOT / "mdbench" / "run.py"),
                          "--workload", "c4_sorted.nve", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
