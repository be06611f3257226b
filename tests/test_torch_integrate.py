"""The dense engine's integrator (``ops/integrate.py``) on the CPU: the plain
versions of ``kick_drift_vote`` and ``kick`` against the step's former inline
``add_`` sequence and vote, bit for bit, also with one particle at the
displacement vote's skin/2 trigger; the CPU wrappers take them; and the
step calls each once, the vote only where the configuration votes. The
kernels against the plain versions on the card: ``tests/test_torch_gpu.py``
(``-k integrator``)."""

import numpy as np
import pytest
import torch

from md_neighbor_list_tpu_torch import DenseSimulator, MDConfig
from md_neighbor_list_tpu_torch.ops import _cuda, dense_cells, integrate
from md_neighbor_list_tpu_torch.utils import convert
from torch_port_util import RC, RS, numpy_system, torch_state

SKIN = RS - RC
DT = float(np.float32(0.005))


def former_step_sequence(vel, pos, force, ref_pos, pid, dt, skin):
    """``DenseSimulator._step``'s opening kick, drift and vote as the
    step wrote them inline before the integrator's kernels."""
    vel.add_(force, alpha=0.5 * dt)
    pos.add_(vel, alpha=dt)
    if skin is None:
        return None
    disp = pos - ref_pos
    d2 = torch.sum(disp * disp, dim=0)
    d2max = torch.max(torch.where(pid >= 0, d2, 0.0))
    return 4.0 * d2max > skin * skin


def inputs(n: int, cap: int, seed: int, scale: float):
    """A rebuilt dense state (empty slots parked, zero velocity), forces
    from the seed and zero on empty slots, and ``ref_pos`` the occupied
    slots moved back by normal steps of ``scale`` per axis."""
    pos, vel, pid = numpy_system(n, seed=seed, jitter=0.2)
    state, spec, _ = torch_state(pos, vel, pid, cap)
    state, _ = dense_cells.rebuild_dense(state, spec)
    g = torch.Generator().manual_seed(seed)
    held = state.valid()[None]
    force = torch.where(held, 50.0 * torch.randn(state.pos.shape, generator=g),
                        0.0)
    disp = torch.where(held, scale * torch.randn(state.pos.shape, generator=g),
                       0.0)
    return state, force, state.pos - disp


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32)


@pytest.mark.parametrize("voting", [True, False], ids=["vote", "no_vote"])
@pytest.mark.parametrize("scale", [0.01, 0.08])
@pytest.mark.parametrize("n, cap", [(1728, 40), (700, 37)])
def test_plain_versions_are_the_former_step_sequence(n, cap, scale, voting):
    state, force, ref = inputs(n, cap, 11, scale)
    skin = SKIN if voting else None
    want = [t.clone() for t in (state.vel, state.pos)]
    got = [t.clone() for t in (state.vel, state.pos)]
    want_vote = former_step_sequence(*want, force, ref, state.pid, DT, skin)
    got_vote = integrate.kick_drift_vote_plain(*got, force, ref, state.pid,
                                               DT, skin)
    for a, b in zip(got, want):
        assert torch.equal(bits(a), bits(b))
    if voting:  # both outcomes are exercised
        assert bool(got_vote) == bool(want_vote) == (scale > 0.05)
    else:
        assert got_vote is None
    # another force, zero on empty slots as the park invariant has it
    force2 = torch.where(state.valid()[None], torch.flip(force, dims=(3,)),
                         0.0)
    integrate.kick_plain(got[0], force2, DT)
    want[0].add_(force2, alpha=0.5 * DT)
    assert torch.equal(bits(got[0]), bits(want[0]))


def boundary_displacements(skin: float) -> list[tuple]:
    """Displacements (dx, dy, dz) in f32 around the vote's trigger
    4 |d|^2 > f32(skin^2): along x at f32(skin/2) and its neighbours below
    and above, and along three axes the last dz below the trigger (by the
    vote's f32 arithmetic: each square rounded, summed (x + y) + z) and the
    first above it, with their outer neighbours."""
    f32 = np.float32
    thr, half = f32(skin * skin), f32(skin / 2)

    def over(d):
        sq = [f32(c) * f32(c) for c in d]
        return f32(4) * f32(f32(sq[0] + sq[1]) + sq[2]) > thr

    out = [(x, f32(0), f32(0)) for x in (np.nextafter(half, f32(0)), half,
                                         np.nextafter(half, f32(1)))]
    rng = np.random.default_rng(7)
    for _ in range(6):
        dx, dy = (f32(v) for v in rng.uniform(0.03, 0.08, 2))
        dz = f32(np.sqrt(max(float(thr) / 4 - dx * dx - dy * dy, 0.0)))
        while over((dx, dy, dz)):
            dz = np.nextafter(dz, f32(0))
        while not over((dx, dy, np.nextafter(dz, f32(1)))):
            dz = np.nextafter(dz, f32(1))
        below = dz
        for z in (np.nextafter(below, f32(0)), below,
                  np.nextafter(below, f32(1)),
                  np.nextafter(np.nextafter(below, f32(1)), f32(1))):
            out.append((dx, dy, z))
    return out


def place_at_trigger(state, slot: int, d) -> tuple:
    """(vel, pos, force, ref_pos) of ``state`` at rest with every slot at
    its reference position but ``slot``, displaced by ``d`` from a
    reference at the origin."""
    pos = state.pos.clone().reshape(3, -1)
    ref = pos.clone()
    pos[:, slot] = torch.tensor([float(c) for c in d])
    ref[:, slot] = 0.0
    zero = torch.zeros_like(state.pos)
    return (zero.clone(), pos.reshape(state.pos.shape), zero,
            ref.reshape(state.pos.shape))


def test_vote_at_the_skin_half_trigger():
    """One occupied slot at the trigger and its f32 neighbours, the others
    at rest: the plain vote is the former one in every placement, and along
    x it is the f32 arithmetic's own decision; both outcomes occur."""
    state, _, _ = inputs(1728, 40, 11, 0.0)
    held = torch.nonzero(state.valid().reshape(-1)).reshape(-1)
    f32 = np.float32
    seen = set()
    for slot in (int(held[0]), int(held[-1])):
        for d in boundary_displacements(SKIN):
            vel, pos, force, ref = place_at_trigger(state, slot, d)
            got = integrate.kick_drift_vote_plain(
                vel.clone(), pos.clone(), force, ref, state.pid, DT, SKIN)
            want = former_step_sequence(vel, pos, force, ref, state.pid, DT,
                                        SKIN)
            assert bool(got) == bool(want), d
            if d[1] == 0.0:
                assert bool(got) == bool(
                    f32(4) * (d[0] * d[0]) > f32(SKIN * SKIN))
            seen.add(bool(got))
    assert seen == {False, True}


def test_wrappers_take_the_plain_versions_on_the_cpu():
    state, force, ref = inputs(700, 48, 3, 0.08)
    flag = torch.zeros((), dtype=torch.bool)
    want = [t.clone() for t in (state.vel, state.pos)]
    got = [t.clone() for t in (state.vel, state.pos)]
    before = dict(_cuda.LAUNCHES)
    vote = integrate.kick_drift_vote(*got, force, ref, state.pid, DT, SKIN,
                                     flag)
    want_vote = integrate.kick_drift_vote_plain(*want, force, ref, state.pid,
                                                DT, SKIN)
    assert bool(vote) == bool(want_vote) and vote is not flag
    assert integrate.kick_drift_vote(*got, force, ref, state.pid, DT, None,
                                     flag) is None
    integrate.kick_drift_vote_plain(*want, force, ref, state.pid, DT, None)
    integrate.kick(got[0], force, state.pid, DT, lower=flag)
    integrate.kick_plain(want[0], force, DT)
    for a, b in zip(got, want):
        assert torch.equal(bits(a), bits(b))
    assert not bool(flag) and dict(_cuda.LAUNCHES) == before


@pytest.mark.parametrize("every_step", [False, True],
                         ids=["vote", "every_step"])
def test_step_calls_the_integrator_once_each(every_step, monkeypatch):
    """Each step opens with one ``kick_drift_vote`` (the vote only where
    the configuration votes) and closes with one ``kick``."""
    calls = []
    for name in ("kick_drift_vote", "kick"):
        def counted(*args, _orig=getattr(integrate, name), _name=name,
                    **kwargs):
            calls.append((_name, args[6] if _name == "kick_drift_vote"
                          else None))
            return _orig(*args, **kwargs)
        monkeypatch.setattr(integrate, name, counted)
    cfg = MDConfig(n=1728, dt=0.005, temperature=2.0,
                   rebuild_every_step=every_step)
    pos, vel, pid = numpy_system(1728, seed=5)
    sim = DenseSimulator(cfg, cap=32, device="cpu")
    carry = sim.build(convert.system_from_numpy(
        pos, vel, np.zeros_like(pos), pid, device="cpu"))
    for _ in range(3):
        carry = sim.step_fn(carry)
    skin = None if every_step else cfg.skin
    assert calls == [("kick_drift_vote", skin), ("kick", None)] * 3
