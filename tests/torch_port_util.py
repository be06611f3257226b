"""Helpers of the ``test_torch_*`` files: the same numpy inputs, made from a
seed, handed to the JAX package and to its PyTorch port on the CPU."""

from __future__ import annotations

import functools
import math
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from md_neighbor_list_tpu.core.box import Box as JBox
from md_neighbor_list_tpu.ops import dense_cells as jdc
from md_neighbor_list_tpu_torch.core.box import Box as TBox
from md_neighbor_list_tpu_torch.ops import dense_cells as tdc

# (n, cap): L = 12 -> mc = 4 with one and two mask words; n = 700 -> mc = 3,
# where every neighbour row and x-cell wraps around the box
CASES = {"mc4_cap32": (1728, 32), "mc4_cap40": (1728, 40),
         "mc3_cap48": (700, 48)}
RS, RC = 2.8, 2.5

# The suite runs in several worker processes at once. The plain versions issue
# many small tensor ops, and PyTorch's intra-op threads of one worker spin
# against those of the others; one thread per worker is several times faster.
torch.set_num_threads(1)


@pytest.fixture(scope="session")
def jax_decoder_build(tmp_path_factory):
    """The JAX package's host decoder (``native/decode.cpp``) built once per
    test process with g++ and that loader's flags into a directory of its
    own. The JAX loader builds in place into ``native/_build/``, shared by
    every process of the suite, so a worker could load a library another
    worker is still writing; it then falls back to numpy for good, which
    orders the slots of a full row differently. Returns the library's path,
    or (None, the compiler's message)."""
    from md_neighbor_list_tpu.utils import native as jnative

    so = tmp_path_factory.mktemp("jax_decoder") / jnative._SO.name
    proc = subprocess.run(
        ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
         str(jnative._SRC), "-o", str(so)], capture_output=True, text=True)
    return (so, "") if proc.returncode == 0 else (None, proc.stderr)


@pytest.fixture
def jax_native_decoder(jax_decoder_build, monkeypatch):
    """Point the JAX package's native loader at ``jax_decoder_build`` for
    one test, with its cached library and error cleared (``monkeypatch``
    restores all three), and load it: a test that compares decoders with
    the JAX side must not decode through a library that another process
    writes, nor silently through numpy. Fails the test if it cannot load."""
    from md_neighbor_list_tpu.utils import native as jnative

    so, message = jax_decoder_build
    if so is None:
        pytest.fail(f"the JAX host decoder did not build: {message}")
    monkeypatch.setattr(jnative, "_SO", so)
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_err", None)
    try:
        jnative.load()
    except jnative.NativeUnavailable as e:
        pytest.fail(f"the JAX host decoder did not load: {e}")


def numpy_system(n: int, seed: int, jitter: float = 0.05, rho: float = 1.0):
    """Jittered simple-cubic lattice and Maxwell velocities, all numpy f32."""
    L = (n / rho) ** (1.0 / 3.0)
    m = math.ceil(n ** (1.0 / 3.0))
    while m**3 < n:
        m += 1
    rng = np.random.default_rng(seed)
    idx = np.arange(n)
    lattice = np.stack([idx % m, (idx // m) % m, idx // (m * m)], -1)
    pos = (lattice + 0.5) * (L / m) + rng.uniform(-jitter, jitter, (n, 3))
    vel = rng.standard_normal((n, 3))
    vel -= vel.mean(axis=0, keepdims=True)
    return ((pos % L).astype(np.float32), vel.astype(np.float32),
            np.arange(n, dtype=np.int32))


def clustered_system(k: int, seed: int, n: int = 700, rs: float = RS):
    """``numpy_system(n)`` (mc = 3 at n = 700) with ``k`` particles moved
    onto a fine jittered lattice inside cell (0, 0, 0) and nobody else left
    in that cell: one cell holds exactly ``k``, pairs stay apart."""
    pos, vel, pid = numpy_system(n, seed)
    L = float(n) ** (1.0 / 3.0)
    cell = L / int(L / rs)
    inside = np.all(pos < cell, axis=1)
    assert k >= inside.sum()
    movers = np.concatenate([np.nonzero(inside)[0],
                             np.nonzero(~inside)[0][:k - inside.sum()]])
    m = math.ceil(k ** (1.0 / 3.0))
    idx = np.arange(k)
    fine = np.stack([idx % m, (idx // m) % m, idx // (m * m)], -1)
    rng = np.random.default_rng(seed + 1)
    pos[movers] = (0.15 + (fine + 0.5) * ((cell - 0.3) / m)
                   + rng.uniform(-0.02, 0.02, (k, 3))).astype(np.float32)
    return pos, vel, pid


def jax_state(pos, vel, pid, cap, rs=RS, rho=1.0):
    box = JBox.from_density(pos.shape[0], rho)
    spec = jdc.make_spec(box, rs, cap)
    state = jdc.from_packed(jnp.asarray(pos), jnp.asarray(vel),
                            jnp.asarray(pid), spec)
    return state, spec, box


def torch_state(pos, vel, pid, cap, rs=RS, rho=1.0):
    box = TBox.from_density(pos.shape[0], rho)
    spec = tdc.make_spec(box, rs, cap)
    state = tdc.from_packed(torch.from_numpy(pos.copy()),
                            torch.from_numpy(vel.copy()),
                            torch.from_numpy(pid.copy()), spec)
    return state, spec, box


@functools.lru_cache(maxsize=None)
def rebuilt_pair(case: str, seed: int = 4):
    """(jax_state, jax_spec, torch_state, torch_spec, pos, box_L) after the
    reference rebuild on both sides (asserted equal elsewhere)."""
    from md_neighbor_list_tpu.ops import dense_ref as jref
    from md_neighbor_list_tpu_torch.ops import dense_ref as tref

    n, cap = CASES[case]
    pos, vel, pid = numpy_system(n, seed)
    js, jspec, _ = jax_state(pos, vel, pid, cap)
    ts, tspec, _ = torch_state(pos, vel, pid, cap)
    return (jref.rebuild_reference(js, jspec), jspec,
            tref.rebuild_reference(ts, tspec), tspec, pos)


def assert_state_equal(tstate, jstate, parked_pos: bool = True):
    """Port state == JAX state, bitwise. ``parked_pos=False`` leaves out the
    positions of empty slots: the JAX expand kernel computes its park
    positions in-kernel, and in interpret mode on the CPU XLA contracts that
    ``base + id * step`` into a fused multiply-add, which lands one ulp off
    ``park_lattice`` in a few slots (the JAX package's own test compares
    valid slots only for the same reason)."""
    valid = np.asarray(jstate.pid) >= 0
    for name, t, j in zip(("pos", "vel", "pid"), tstate, jstate):
        t, j = t.numpy(), np.asarray(j)
        if name == "pos" and not parked_pos:
            t, j = t[:, valid], j[:, valid]
        np.testing.assert_array_equal(t, j, err_msg=name)


def scatter_slots(state, spec, seed: int):
    """``state`` with the slots of every cell permuted at random (a numpy
    seed): each cell keeps its particles, but they sit in slots drawn at
    random rather than in a prefix of the cell, and its empty slots are
    re-parked at their new places (``park_positions``) with zero velocity.
    The park invariant holds; slot order does not."""
    rng = np.random.default_rng(seed)
    cells, cap = spec.rows * spec.mc, spec.cap
    perm = torch.from_numpy(np.argsort(rng.random((cells, cap)), axis=1))
    perm = perm.to(state.pid.device)

    def take(a):  # (..., R, mc, cap): new slot s of a cell holds slot perm[s]
        lead = a.shape[:-3]
        flat = a.reshape(lead + (cells, cap))
        return torch.gather(flat, -1, perm.expand(flat.shape)).reshape(a.shape)

    pid = take(state.pid)
    valid = pid >= 0
    pos = tdc.park_positions(take(state.pos), valid, spec)
    vel = torch.where(valid[None], take(state.vel), 0.0)
    return tdc.DenseState(pos=pos, vel=vel, pid=pid)
