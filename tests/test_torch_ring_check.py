"""``parallel/ring_check.py`` on the CPU: two gloo processes under
``torch.distributed.run``. Nothing is captured on gloo, so these check the
control flow only (each stage's step and both engines' ``run`` against
``step_fn``, every exchange made outside the branches); the captured replays
need two cards or more (``tests/test_torch_gpu.py``)."""

import json
import os
import pathlib
import signal
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _ring_check(*args: str) -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node=2", "-m",
         "md_neighbor_list_tpu_torch.parallel.ring_check", "--device", "cpu",
         *args], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=240)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f"ring_check {args}: no end within 240 s")
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("engine", ["dense_slab", "slab"])
def test_engine_stage_steps_both_ways_alike_on_gloo(engine):
    """Stage d at N = 4,096, P = 2: ``run`` and ``step_fn`` from one carry
    give the same state (both eager on gloo: positions bitwise), one
    rebuild or more each, |dE/E| within 1e-4, and no capture."""
    got = _ring_check("--engine", engine, "--n", "4096", "--steps", "60")
    assert got["ok"] and got["failures"] == []
    assert (got["p"], got["backend"], got["capturable"]) == (2, "gloo", False)
    assert got["captures"] == 0
    assert got["rebuilds_graph"] == got["rebuilds_eager"] >= 1
    assert got["position_gap"] == 0.0 and got["energy_drift"] <= 1e-4


@pytest.mark.parametrize("stage", ["a", "b", "c"])
def test_probe_stages_on_gloo(stage):
    """Stages a-c at the ``c4_sorted`` layer of P = 2 (35 x 35 x 40 slots,
    three channels): the runner's step and the same step run again agree
    bitwise, and stage a's untaken body never runs."""
    got = _ring_check("--stage", stage, "--steps", "5")
    assert got["ok"] and got["failures"] == []
    assert got["layer_bytes"] == 4 * 3 * 35 * 35 * 40
    assert got["captures"] == 0
