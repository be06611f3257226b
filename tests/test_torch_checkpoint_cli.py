"""The port's checkpoints (``utils/checkpoint.py``), JSON-lines log
(``utils/jsonlog.py``) and CLI (``python -m md_neighbor_list_tpu_torch``) on
the CPU: npz files written by either package load in the other bit for bit,
resume is exact, and the CLI's parity check, compare mode and save/resume run,
the latter also for P = 2 runs of both slab engines over two ``env://`` gloo
ranks."""

import io
import json
import os
import pathlib
import re
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from md_neighbor_list_tpu import cli as jcli
from md_neighbor_list_tpu.core.system import System as JSystem
from md_neighbor_list_tpu.utils import checkpoint as jckpt
from md_neighbor_list_tpu.utils import jsonlog as jlog
from md_neighbor_list_tpu_torch.core.config import MDConfig
from md_neighbor_list_tpu_torch.models.lj_nve import Simulator
from md_neighbor_list_tpu_torch.parallel.mesh import run_ranks
from md_neighbor_list_tpu_torch.parallel.slab import SlabSimulator
from md_neighbor_list_tpu_torch.utils import checkpoint as tckpt
from md_neighbor_list_tpu_torch.utils import convert
from md_neighbor_list_tpu_torch.utils import jsonlog as tlog
from torch_port_util import numpy_system

ROOT = pathlib.Path(__file__).resolve().parent.parent
N = 512


def _shuffled_state(seed=0):
    """A state in a shuffled row order, pids and forces included."""
    pos, vel, _ = numpy_system(N, seed)
    rng = np.random.default_rng(seed)
    pid = rng.permutation(N).astype(np.int32)
    force = rng.standard_normal((N, 3)).astype(np.float32)
    return pos, vel, force, pid


def test_jax_checkpoint_loads_in_the_port_bitwise(tmp_path):
    pos, vel, force, pid = _shuffled_state(1)
    path = tmp_path / "jax.npz"
    jckpt.save(path, JSystem(jnp.asarray(pos), jnp.asarray(vel),
                             jnp.asarray(force), jnp.asarray(pid)), step=7,
               meta={"note": "t"})
    system, step = tckpt.load(path, device="cpu")
    assert step == 7
    order = np.argsort(pid)
    for got, want in zip(system, (pos[order], vel[order], force[order],
                                  np.arange(N, dtype=np.int32))):
        assert got.dtype in (torch.float32, torch.int32)
        np.testing.assert_array_equal(got.numpy(), want)


def test_port_checkpoint_loads_in_jax_bitwise(tmp_path):
    pos, vel, force, pid = _shuffled_state(2)
    path = tmp_path / "port.npz"
    tckpt.save(path, convert.system_from_numpy(pos, vel, force, pid,
                                               device="cpu"),
               step=11, meta={"note": "t"})
    system, step = jckpt.load(path)
    assert step == 11
    order = np.argsort(pid)
    for got, want in zip(system, (pos[order], vel[order], force[order],
                                  np.arange(N, dtype=np.int32))):
        np.testing.assert_array_equal(np.asarray(got), want)
    with np.load(path) as a, np.load(_jax_twin(tmp_path, pos, vel, force,
                                               pid)) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def _jax_twin(tmp_path, pos, vel, force, pid):
    path = tmp_path / "twin.npz"
    jckpt.save(path, JSystem(jnp.asarray(pos), jnp.asarray(vel),
                             jnp.asarray(force), jnp.asarray(pid)), step=11,
               meta={"note": "t"})
    return path


def test_checkpoint_exact_resume(tmp_path):
    """save -> load -> continue == continuing from the same pid-ordered
    state in memory, bit for bit."""
    sim = Simulator(MDConfig(n=1024, rc=1.5, skin=0.2, temperature=0.6),
                    device="cpu")
    carry = sim.run(sim.init(torch.Generator().manual_seed(0)), 40)
    path = tmp_path / "ckpt.npz"
    tckpt.save(path, carry.system, step=40)

    order = torch.argsort(carry.system.pid)
    canon = carry.system._replace(
        pos=carry.system.pos[order], vel=carry.system.vel[order],
        force=torch.zeros_like(carry.system.force),
        pid=torch.arange(1024, dtype=torch.int32))
    direct = sim.run(sim.build(canon), 40).system
    system, step = tckpt.load(path, device="cpu")
    assert step == 40
    resumed = sim.run(sim.build(system), 40).system
    assert torch.equal(resumed.pid, direct.pid)
    assert torch.equal(resumed.pos, direct.pos)
    assert torch.equal(resumed.vel, direct.vel)


def test_jsonlog_records_have_the_jax_fields():
    records = []
    for mod in (jlog, tlog):
        stream = io.StringIO()
        mod.JsonLogger(stream=stream, run_id="r").log("parity", ok=True, n=3)
        records.append(json.loads(stream.getvalue()))
    assert list(records[0]) == list(records[1]) == ["ts", "run", "event",
                                                    "ok", "n"]
    assert {k: v for k, v in records[1].items() if k != "ts"} == {
        "run": "r", "event": "parity", "ok": True, "n": 3}


def _cli(*args, env=None, timeout=300):
    env = dict(os.environ if env is None else env, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "md_neighbor_list_tpu_torch", "--device",
         "cpu", *args], capture_output=True, text=True, timeout=timeout,
        env=env, cwd=ROOT)


def _events(stderr):
    return [json.loads(line) for line in stderr.splitlines()
            if line.startswith("{")]


def test_cli_check_parity_save_and_resume(tmp_path):
    ckpt = str(tmp_path / "s.npz")
    out = _cli("--preset", "c1_brute", "--n", "1024", "--steps", "10",
               "--check-parity", "--save", ckpt)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "xla: N=1024" in out.stdout and "parity=OK" in out.stdout
    events = {e["event"]: e for e in _events(out.stderr)}
    assert events["parity"]["pair_count_oracle"] == events["parity"][
        "pair_count_engine"]
    assert events["run_done"]["rebuilds"] == 11  # c1: every step
    # the counters of utils/trace.py: the rebuilds in steps (not the build);
    # c1 rebuilds every step, so no step reads a list
    assert events["run_done"]["counters"] == {"steps": 10, "rebuilds": 10,
                                              "redos": 0, "captures": 0,
                                              "list_forces": 0}
    assert pathlib.Path(ckpt).exists()

    out = _cli("--preset", "c1_brute", "--n", "1024", "--steps", "3",
               "--engine", "dense", "--check-parity", "--resume", ckpt)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "dense: N=1024" in out.stdout and "parity=OK" in out.stdout
    resumed = [e for e in _events(out.stderr) if e["event"] == "resumed"]
    assert resumed and resumed[0]["step"] == 10
    done = [e for e in _events(out.stderr) if e["event"] == "run_done"][0]
    assert done["counters"] == {"steps": 3, "rebuilds": 3, "redos": 0,
                                "captures": 0, "list_forces": 0}


def test_cli_compare_mode():
    out = _cli("--preset", "c2_cell", "--n", "4096", "--steps", "3",
               "--compare", "--check-parity")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "-> OK" in out.stdout
    assert "xla" in out.stdout and "dense" in out.stdout
    cmp = [e for e in _events(out.stderr) if e["event"] == "compare"][0]
    assert cmp["pairs"]["xla"] == cmp["pairs"]["dense"] == cmp["pairs_oracle"]
    assert cmp["ok"]


def _jax_cli_refusal(args, capsys):
    """The JAX CLI's stdout and ValueError for ``args``, in this process (the
    slab engines refuse before any device work)."""
    with pytest.raises(ValueError) as e:
        jcli.main(list(args))
    return capsys.readouterr().out, str(e.value)


def test_cli_slab_engine_and_unlaunched_ranks_raise(capsys):
    """``--engine slab`` at P = 1 and the ``dense_slab`` -> ``slab`` fallback
    of a box ``dense_slab`` cannot tile end in the JAX CLI's own ValueError
    (the fallback after the same WARNING); P = 2 without the env://
    variables names ``torchrun``."""
    args = ("--n", "4096", "--steps", "1", "--engine", "slab")
    _, want = _jax_cli_refusal(args, capsys)
    assert "mesh_devices >= 2" in want
    out = _cli(*args, "--mesh-devices", "1")
    assert out.returncode != 0 and f"ValueError: {want}" in out.stderr
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    out = _cli(*args, "--mesh-devices", "2", env=env)
    assert out.returncode != 0 and "torchrun" in out.stderr
    assert "--engine slab with 2 slabs" in out.stderr
    args = ("--n", "64", "--steps", "1", "--engine", "dense_slab")
    jout, want = _jax_cli_refusal(args, capsys)
    out = _cli(*args)
    assert out.returncode != 0 and f"ValueError: {want}" in out.stderr
    # the same WARNING line but for the reason, the dense engine's own words
    warning = re.compile(r"WARNING: dense_slab cannot tile this box \(box too "
                         r"small .*\); falling back to the correctness-only "
                         r"XLA slab engine")
    for text in (jout, out.stdout):
        assert any(warning.fullmatch(ln) for ln in text.splitlines()), text
    assert any(e["event"] == "engine_fallback" for e in _events(out.stderr))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_cli_dense_slab_resume_over_two_gloo_ranks(tmp_path):
    """A dense run saves; two ranks started as ``torchrun`` would start them
    (env://) resume it as P = 2 slabs; rank 0 reports, and its final state
    is the one the P = 1 slab engine reaches in process."""
    ckpt = str(tmp_path / "s.npz")
    args = ("--preset", "c3_verlet", "--n", "4096", "--steps", "2")
    out = _cli(*args, "--engine", "dense", "--save", ckpt)
    assert out.returncode == 0, out.stderr[-2000:]

    port = _free_port()
    procs = []
    for rank in (0, 1):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2",
                   MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "md_neighbor_list_tpu_torch", "--device",
             "cpu", *args, "--engine", "dense_slab", "--mesh-devices", "2",
             "--resume", ckpt, "--save", str(tmp_path / f"p2_{rank}.npz")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=ROOT))
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-2000:]
    assert "dense_slab: N=4096" in outs[0][0] and outs[1][0] == ""
    assert '"event": "resumed"' in outs[0][1]
    assert not (tmp_path / "p2_1.npz").exists()  # rank 0 alone writes

    out = _cli(*args, "--engine", "dense_slab", "--mesh-devices", "1",
               "--resume", ckpt, "--save", str(tmp_path / "p1.npz"))
    assert out.returncode == 0, out.stderr[-2000:]
    with np.load(tmp_path / "p2_0.npz") as a, np.load(tmp_path
                                                       / "p1.npz") as b:
        np.testing.assert_allclose(a["pos"], b["pos"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(a["vel"], b["vel"], rtol=0, atol=1e-4)


def test_cli_slab_resume_over_two_gloo_ranks(tmp_path):
    """An xla run saves; two ranks started as ``torchrun`` would start them
    resume it with the XLA slab engine at P = 2; rank 0 reports and writes,
    and its final state is the one two ``LocalRing`` ranks in this process
    reach from the same file, bit for bit."""
    ckpt = str(tmp_path / "s.npz")
    args = ("--preset", "c3_verlet", "--n", "4096", "--steps", "20")
    out = _cli(*args, "--engine", "xla", "--save", ckpt)
    assert out.returncode == 0, out.stderr[-2000:]

    port = _free_port()
    procs = []
    for rank in (0, 1):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2",
                   MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "md_neighbor_list_tpu_torch", "--device",
             "cpu", *args, "--engine", "slab", "--mesh-devices", "2",
             "--resume", ckpt, "--save", str(tmp_path / f"p2_{rank}.npz")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=ROOT))
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-2000:]
    assert "slab: N=4096" in outs[0][0] and outs[1][0] == ""
    assert '"event": "resumed"' in outs[0][1]
    done = [e for e in _events(outs[0][1]) if e["event"] == "run_done"][0]
    assert done["pressure"] is None and done["rebuilds"] >= 1
    assert not (tmp_path / "p2_1.npz").exists()  # rank 0 alone writes

    cfg = MDConfig(n=4096, steps=20, mesh_devices=2)
    system, _ = tckpt.load(ckpt, device="cpu")

    def fn(ring):
        sim = SlabSimulator(cfg, device="cpu", ring=ring)
        st = sim.run(sim.build(system), cfg.steps)
        return sim.gather(st), int(st.n_rebuilds)

    (want, rebuilds), _ = run_ranks(2, fn)
    assert rebuilds == done["rebuilds"]
    with np.load(tmp_path / "p2_0.npz") as a:
        for name in ("pos", "vel", "force"):
            np.testing.assert_array_equal(a[name],
                                          getattr(want, name).numpy())
