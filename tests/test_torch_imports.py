"""The port stands alone: it imports neither JAX nor the JAX package, it can
be imported where no CUDA toolchain exists, and its CUDA-default entry points
raise rather than carry on on the CPU."""

import ast
import importlib
import pathlib
import shutil

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "md_neighbor_list_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "md_neighbor_list_tpu")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_import(path):
    for name in _imports(path):
        assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_expected_modules_and_sources_exist():
    names = {str(p.relative_to(PORT)) for p in SOURCES[:-1]}
    for want in ("core/box.py", "core/config.py", "core/system.py",
                 "core/capacity.py", "ops/common.py", "ops/oracle.py",
                 "ops/dense_cells.py", "ops/dense_ref.py",
                 "ops/dense_force.py", "ops/decode.py", "ops/_cuda.py",
                 "ops/incremental.py", "ops/slab_kernels.py",
                 "parallel/__init__.py", "parallel/mesh.py",
                 "parallel/dense_slab.py", "parallel/slab.py",
                 "models/dense_lj.py", "utils/convert.py", "utils/native.py",
                 "ops/binning.py", "ops/pairlist.py", "ops/lj.py",
                 "ops/integrate.py", "models/lj_nve.py",
                 "utils/checkpoint.py", "utils/jsonlog.py", "cli.py",
                 "__main__.py", "api.py", "__init__.py", "entry.py",
                 "parallel/ring_check.py"):
        assert want in names
    for src in ("geom.cuh", "half_sweep.cuh", "expand.cu", "lists_half.cu",
                "force_half.cu", "pe_virial_half.cu", "force_full.cu",
                "merge.cu", "span.cu", "decode.cpp", "force_list.cu",
                "integrate.cu", "list_sparse.cu", "incremental.cu"):
        assert (PORT / "csrc" / src).exists()


def test_every_kernel_has_an_entry_a_counter_and_a_source():
    from md_neighbor_list_tpu_torch.ops import _cuda

    assert set(_cuda._ENTRIES) == set(_cuda.LAUNCHES) == {
        "expand", "lists_half", "forces_half", "forces_half_pe",
        "pe_virial_half", "count_half", "force_full", "force_full_pe",
        "count_full", "merge", "expand_slab", "lists_half_slab",
        "forces_half_slab", "forces_half_slab_pe", "forces_list",
        "list_sparse", "kick_drift_vote", "kick", "mover_keys",
        "window_count"}
    # the device spans' marker kernels (csrc/span.cu), uncounted
    assert _cuda._SPANS == ("span_begin_rebuild", "span_end_rebuild",
                            "span_begin_halflist", "span_end_halflist",
                            "span_begin_increment", "span_end_increment")
    assert not set(_cuda._SPANS) & set(_cuda.LAUNCHES)
    sources = "".join(p.read_text() for p in _cuda._sources()[0])
    for name in (*_cuda._ENTRIES, *_cuda._SPANS):
        assert f"int mdnl_{name}(" in sources, name
    # the host decoder is no CUDA source: nvcc never sees it
    assert all(p.suffix == ".cu" for p in _cuda._sources()[0])


def test_import_needs_no_cuda_toolchain():
    """Every module imports on a machine without triton, nvcc or a GPU: the
    kernels are built at first launch, not at import."""
    for path in SOURCES[:-1]:
        rel = path.relative_to(ROOT).with_suffix("")
        importlib.import_module(".".join(rel.parts).removesuffix(".__init__"))
    import md_neighbor_list_tpu_torch as port

    assert port.__all__ == ["Box", "MDConfig", "PRESETS", "System",
                            "init_lattice", "init_random", "neighbor_list",
                            "pair_list", "DenseSimulator", "Simulator",
                            "SlabSimulator"]
    from md_neighbor_list_tpu_torch.ops import _cuda

    assert _cuda._lib is None  # nothing was built or loaded by importing
    assert set(_cuda.LAUNCHES.values()) == {0}


def test_import_builds_no_host_decoder():
    """``utils/native.py`` builds with g++ at first decode, not at import. A
    fresh interpreter, since other tests of this process do decode."""
    import subprocess
    import sys

    code = ("import md_neighbor_list_tpu_torch as p, sys\n"
            "from md_neighbor_list_tpu_torch.ops import decode\n"
            "from md_neighbor_list_tpu_torch.utils import native\n"
            "assert native._lib is None\n"
            "assert 'jax' not in sys.modules\n"
            "assert 'md_neighbor_list_tpu' not in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)


def test_cuda_default_entry_points_raise_without_a_card():
    """No fallback that hides the device: the default device is the card."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from md_neighbor_list_tpu_torch import (DenseSimulator, MDConfig,
                                            Simulator)
    from md_neighbor_list_tpu_torch.cli import main
    from md_neighbor_list_tpu_torch.core.system import init_lattice

    with pytest.raises(RuntimeError):
        DenseSimulator(MDConfig(n=1728))
    with pytest.raises(RuntimeError, match="CUDA device"):
        Simulator(MDConfig(n=1728))
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["--n", "1728", "--steps", "1"])
    with pytest.raises((RuntimeError, AssertionError)):
        init_lattice(64, 1.0)
    sim = DenseSimulator(MDConfig(n=1728), device="cpu")  # asked for
    assert sim.device.type == "cpu"


def test_api_runs_on_the_card_by_default_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    import numpy as np

    from md_neighbor_list_tpu_torch import neighbor_list, pair_list

    pos = np.random.default_rng(0).uniform(0, 9.0, (300, 3))
    for backend in ("auto", "xla", "dense"):
        with pytest.raises(RuntimeError, match="CUDA device"):
            neighbor_list(pos, 9.0, 2.8, backend=backend)
        with pytest.raises(RuntimeError, match="CUDA device"):
            pair_list(pos, 9.0, 2.8, backend=backend)
    idx, cnt = neighbor_list(pos, 9.0, 2.8, device="cpu")  # asked for
    assert idx.device.type == "cpu" and idx.shape[0] == 300


def test_kernel_wrappers_do_not_build_for_cpu_tensors():
    """On CPU tensors the wrappers take the plain versions and count no
    launch; without nvcc the build itself raises."""
    from md_neighbor_list_tpu_torch.ops import (_cuda, dense_cells, dense_force,
                                                incremental, integrate)
    from torch_port_util import numpy_system, torch_state

    pos, vel, pid = numpy_system(1728, seed=0)
    state, spec, _ = torch_state(pos, vel, pid, 32)
    new, _ = dense_cells.rebuild_dense(state, spec)
    dense_force.dense_lists_half(new.pos, spec, 2.8)
    dense_force.dense_forces_half(new.pos, spec, 2.5)
    dense_force.dense_pe_virial(new.pos, spec, 2.5)
    dense_force.dense_counts_half(new.pos, spec, 2.8)
    dense_force.dense_forces(new.pos, new.valid(), spec, 2.5)
    dense_force.dense_forces(new.pos, new.valid(), spec, 2.5, False)
    dense_force.dense_counts(new.pos, new.valid(), spec, 2.8)
    vel, pos = new.vel.clone(), new.pos.clone()
    flag = torch.zeros((), dtype=torch.bool)
    for skin in (0.3, None):
        integrate.kick_drift_vote(vel, pos, new.vel, new.pos, new.pid, 0.005,
                                  skin, flag)
    integrate.kick(vel, new.vel, new.pid, 0.005, lower=flag)
    incremental.rebuild_dense_incremental(new, spec)
    ext = torch.cat([new.pos, new.pos[:, :spec.mc]], dim=1)
    dense_force.dense_lists_half_slab(ext, spec, 2.8)
    dense_force.dense_forces_half_slab(ext, spec, 2.5, True)
    keys = torch.full((4,), spec.mc * spec.mc, dtype=torch.int32)
    dense_cells.sort_expand(keys, torch.zeros((3, 4)), torch.zeros((3, 4)),
                            torch.arange(4, dtype=torch.int32), spec,
                            key_base=spec.mc * spec.mc)
    assert set(_cuda.LAUNCHES.values()) == {0}
    if shutil.which("nvcc") is None and not (
            pathlib.Path("/usr/local/cuda/bin/nvcc").exists()):
        with pytest.raises(RuntimeError):
            _cuda.library()


def test_slab_engine_runs_on_the_card_by_default_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from md_neighbor_list_tpu_torch import MDConfig
    from md_neighbor_list_tpu_torch.parallel import mesh
    from md_neighbor_list_tpu_torch.parallel.dense_slab import \
        DenseSlabSimulator
    from md_neighbor_list_tpu_torch.parallel.slab import SlabSimulator

    with pytest.raises(RuntimeError, match="CUDA device"):
        DenseSlabSimulator(MDConfig(n=4096, rc=1.5, skin=0.2))
    rings = mesh.LocalRing.ring_of(2)
    with pytest.raises(RuntimeError, match="CUDA device"):
        SlabSimulator(MDConfig(n=4096, rc=1.5, skin=0.2, mesh_devices=2),
                      ring=rings[0])
    sim = SlabSimulator(MDConfig(n=4096, rc=1.5, skin=0.2, mesh_devices=2),
                        device="cpu", ring=rings[1])  # asked for
    assert sim.device.type == "cpu" and sim.ring.rank == 1
    sim = DenseSlabSimulator(MDConfig(n=4096, rc=1.5, skin=0.2),
                             device="cpu")  # asked for
    assert sim.device.type == "cpu" and sim.ring.size == 1
    assert mesh.backend_for("cuda") == "nccl"
    assert mesh.backend_for("cpu") == "gloo"
    with pytest.raises(RuntimeError):
        mesh.rank_device("cuda", 0)
