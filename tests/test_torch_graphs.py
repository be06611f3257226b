"""The chunk runner (``utils/graphs.py``) and what capture asks of the
engines' steps, on the CPU: the launch accounting under replay, the eager
branch, a chunk that keeps every tensor of the carry in its storage through
rebuilds (the addresses a captured graph writes to), and the incremental
engine's branch counts against the JAX engine's branch choices. The capture
itself needs a card: ``tests/test_torch_gpu.py``."""

import numpy as np
import pytest
import torch

from md_neighbor_list_tpu.ops import dense_cells as jdc
from md_neighbor_list_tpu.ops import incremental as jinc
from md_neighbor_list_tpu_torch import DenseSimulator, MDConfig, Simulator
from md_neighbor_list_tpu_torch.models.dense_lj import DenseCarry
from md_neighbor_list_tpu_torch.ops import dense_cells as tdc
from md_neighbor_list_tpu_torch.parallel.dense_slab import DenseSlabSimulator
from md_neighbor_list_tpu_torch.parallel.mesh import LocalRing, Ring, run_ranks
from md_neighbor_list_tpu_torch.parallel.slab import SlabSimulator
from md_neighbor_list_tpu_torch.utils import convert, graphs
from torch_port_util import (assert_state_equal, jax_state, numpy_system,
                             ops_build)

HOT = dict(dt=0.005, temperature=2.0)  # a rebuild every few steps


@pytest.mark.parametrize("steps, taken, want, names, named", [
    (100, [3, 2], {"forces_half": 100, "expand": 5, "merge": 2, "lists_half": 0},
     (), {}),
    (7, [0, 0], {"forces_half": 7, "expand": 0, "merge": 0, "lists_half": 0},
     (), {}),
    (0, [0, 0], {"forces_half": 0, "expand": 0, "merge": 0, "lists_half": 0},
     (), {}),
    (1, [1, 1], {"forces_half": 1, "expand": 2, "merge": 1, "lists_half": 0},
     (), {}),
    (100, [3, 2], {"forces_half": 100, "expand": 5, "merge": 2, "lists_half": 0},
     ("rebuilds", None), {"rebuilds": 3, "redos": 0}),
])
def test_accrue_counts_steps_and_branches_taken(steps, taken, want, names,
                                                named):
    """Stubbed counts: the step's launches times the steps, each body's
    times the runs the device counted; other counters untouched. A named
    body's runs go to its counter too, an unnamed body's nowhere."""
    counts = {"forces_half": 0, "expand": 0, "merge": 0, "lists_half": 0}
    counters = {"rebuilds": 0, "redos": 0}
    graphs.accrue(counts, {"forces_half": 1},
                  [{"expand": 1}, {"expand": 1, "merge": 1}], taken, steps,
                  names, counters)
    assert counts == want
    assert counters == {"rebuilds": 0, "redos": 0, **named}
    graphs.accrue(counts, {}, [], [], steps)  # a step that launches nothing
    assert counts == want


@pytest.mark.parametrize("steps", [0, 1, 100])
def test_accrue_adds_what_each_step_adds_to_its_counters(steps):
    """A counter the step raises outside its bodies (``list_forces``) rises
    by what one captured step raised it by, times the steps; launches and
    branch counters as without it."""
    counts = {"forces_list": 0, "expand": 0}
    counters = {"rebuilds": 0, "list_forces": 0}
    graphs.accrue(counts, {"forces_list": 1}, [{"expand": 1}], [3], steps,
                  ("rebuilds",), counters, {"list_forces": 1})
    assert counts == {"forces_list": steps, "expand": 3}
    assert counters == {"rebuilds": 3, "list_forces": steps}


@pytest.mark.parametrize("capturable", [True, False])
def test_runner_on_the_cpu_takes_each_branch_on_the_host(capturable):
    x = torch.zeros((), dtype=torch.int64)
    hits = torch.zeros(2, dtype=torch.int64)

    def step(cond):
        x.add_(1)
        cond(x % 3 == 0, lambda: hits[0].add_(1))
        cond(x % 4 == 0, lambda: hits[1].add_(1))

    runner = graphs.ChunkRunner()
    runner.run(step, 12, [x, hits], capturable=capturable)
    assert int(x) == 12 and hits.tolist() == [4, 3]
    assert runner.captures == 0 and runner.graph is None


def _system(n, seed=5):
    pos, vel, pid = numpy_system(n, seed)
    return convert.system_from_numpy(pos, 1.4 * vel, np.zeros_like(pos), pid,
                                     device="cpu")


def _dense_carry_from_seed(sim, n=13824, seed=21):
    """A carry whose state is the ``from_packed`` seed (nearly every particle
    away from its cell: the mover stream trips the window predicate at
    mc = 8) and whose reference positions are far off, so that the first
    step votes for a rebuild."""
    pos, vel, pid = numpy_system(n, seed)
    st = tdc.from_packed(torch.from_numpy(pos), torch.from_numpy(1.4 * vel),
                         torch.from_numpy(pid), sim.spec)
    return DenseCarry(state=st, force=torch.zeros_like(st.pos),
                      ref_pos=torch.full_like(st.pos, -1e3),
                      n_rebuilds=torch.zeros((), dtype=torch.int32),
                      overflow=torch.zeros((), dtype=torch.bool))


def _slab_run_keeps_its_storage(p: int) -> None:
    """The XLA slab engine on a ``LocalRing`` of P CPU ranks: ``run`` (20
    steps in chunks of 5) works in place on one clone of the state it is
    given, so every chunk writes into the same tensors, and those are the
    state it returns; the given state stays as it was (as the JAX ``run``
    leaves its input); the result is ``step_fn`` applied 20 times, bitwise."""
    cfg = MDConfig(n=4096, **HOT, mesh_devices=p, half_list=False)

    def rank(ring):
        sim = SlabSimulator(cfg, device="cpu", ring=ring)
        start = sim.build(_system(4096))
        given = [t.clone() for t in start]
        seen = []
        chunk = sim._run_chunk

        def spy(st, nsteps):
            seen.append([t.data_ptr() for t in st])
            return chunk(st, nsteps)

        sim._run_chunk = spy
        out = sim.run(start, 20, chunk=5)
        eager = start
        for _ in range(20):
            eager = sim.step_fn(eager)
        return given, start, seen, out, eager

    for given, start, seen, out, eager in run_ranks(p, rank):
        assert all(torch.equal(a, b) for a, b in zip(given, start))
        assert seen == [[t.data_ptr() for t in out]] * 4
        for name, a, b in zip(out._fields, out, eager):
            assert torch.equal(a, b), name
        assert int(out.n_rebuilds) - int(start.n_rebuilds) >= 2
        assert not bool(out.overflow)


@pytest.mark.parametrize("engine", ["dense", "incremental", "xla",
                                    "dense_slab", "slab_p2", "slab_p4"])
def test_run_keeps_every_carry_tensor_in_its_storage(engine):
    """A chunk with two rebuilds or more (for the incremental engine one of
    them the full fallback) writes into the tensors it was given: the same
    ``data_ptr`` for every one, and the carry ``run`` returns is those
    tensors. A captured graph needs exactly this. The XLA slab engine's
    ``run`` does so on a clone of the state it is given
    (``_slab_run_keeps_its_storage``)."""
    if engine.startswith("slab"):
        _slab_run_keeps_its_storage(int(engine[-1]))
        return
    if engine == "xla":
        sim = Simulator(MDConfig(n=1728, **HOT), device="cpu")
        carry = sim.build(_system(1728))
        tensors = lambda c: [*c.system, *c.nbr]  # noqa: E731
        rebuilds = lambda c: int(c.nbr.n_rebuilds)  # noqa: E731
    elif engine == "dense_slab":  # P = 1, no group
        sim = DenseSlabSimulator(MDConfig(n=1728, **HOT), cap=32,
                                 device="cpu")
        carry = sim.build(_system(1728))
        tensors = list
        rebuilds = lambda c: int(c.n_rebuilds)  # noqa: E731
    elif engine == "dense":
        sim = DenseSimulator(MDConfig(n=1728, **HOT), cap=32, device="cpu")
        carry = sim.build(_system(1728))
    else:
        sim = DenseSimulator(MDConfig(n=13824, **HOT), cap=32, device="cpu",
                             incremental=True)
        carry = _dense_carry_from_seed(sim)
    if engine in ("dense", "incremental"):
        tensors = lambda c: [*c.state, c.force, c.ref_pos,  # noqa: E731
                             c.n_rebuilds, c.overflow]
        rebuilds = lambda c: int(c.n_rebuilds)  # noqa: E731
    before = [t.data_ptr() for t in tensors(carry)]
    start = rebuilds(carry)
    steps = 12 if engine == "incremental" else 20
    out = sim.run(carry, steps, chunk=steps)
    assert [t.data_ptr() for t in tensors(out)] == before
    assert all(a is b for a, b in zip(tensors(out), tensors(carry)))
    assert rebuilds(out) - start >= 2
    if engine == "incremental":
        assert (sim.full_fallbacks, sim.incremental_rebuilds) == (1, 1)
        assert int(out.state.valid().sum()) == 13824
    overflow = out.nbr.overflow if engine == "xla" else out.overflow
    assert not bool(overflow)


def _drifted(state, sigma, seed):
    rng = np.random.default_rng(seed)
    dr = rng.normal(0.0, sigma, state.pos.shape).astype(np.float32)
    dr = np.where(state.valid().numpy()[None], dr, np.float32(0.0))
    return state._replace(pos=state.pos + torch.from_numpy(dr))


def test_incremental_branch_counts_follow_the_jax_engine():
    """Three rebuilds of one engine, from a ``from_packed`` seed (its mover
    stream trips the window predicate) and from two drifted states: the
    port's device counters take the branch the JAX engine's ``lax.cond``
    takes on the JAX window predicate, and the state each leaves is that
    branch's JAX state. Both ways of rebuilding count: the step's (in place,
    the branches as flags) and that of ``_rebuild_and_lists``."""
    n, cap = 13824, 32
    sim = DenseSimulator(MDConfig(n=n), cap=cap, device="cpu",
                         incremental=True)
    carry = _dense_carry_from_seed(sim)
    want_taken = [0, 0]
    for k in range(3):
        if k:
            carry = carry._replace(state=tdc.DenseState(
                *(t.clone() for t in _drifted(carry.state, 0.08, k))))
        pos, vel, pid = (t.numpy() for t in carry.state)
        js = jdc.DenseState(pos=pos, vel=vel, pid=pid)
        _, jspec, _ = jax_state(np.zeros((n, 3), np.float32),
                                np.zeros((n, 3), np.float32),
                                np.arange(n, dtype=np.int32), cap)
        inc, inc_of = jinc.rebuild_dense_incremental(js, jspec, True)
        jnew = jdc.rebuild_dense(js, jspec, True)[0] if bool(inc_of) else inc
        want_taken[int(bool(inc_of))] += 1

        new = sim._rebuild_and_lists(carry.state)[0]  # the list build's
        assert_state_equal(new, jnew, parked_pos=False)
        sim._rebuild(carry, None, graphs.eager_cond)  # the step's path
        assert_state_equal(carry.state, jnew, parked_pos=False)
        assert sim._taken.tolist() == [2 * t for t in want_taken]
    assert want_taken == [2, 1]  # the seed trips the predicate, drift not


@pytest.mark.parametrize("incremental", [False, True])
def test_build_step_equals_the_eager_build(incremental):
    """The list build as the card captures it (the caller's state copied into
    the engine's buffers, rebuilt there in place, the incremental engine's
    branches through ``cond``), run here by the chunk runner's eager path:
    state, counts, masks and total bitwise those the ops build
    (``ops_build``), from a state whose mover stream trips the window
    predicate and from a drifted one that does not, with the branch the ops
    take counted once."""
    n, cap = 13824, 32
    sim = DenseSimulator(MDConfig(n=n), cap=cap, device="cpu",
                         incremental=incremental)
    rs = sim.config.rs
    seed = _dense_carry_from_seed(sim).state
    drifted = _drifted(ops_build(seed, sim.spec, rs, incremental)[0], 0.08, 1)
    start = sim._taken.clone()
    for state in (seed, drifted):
        want = ops_build(state, sim.spec, rs, incremental)
        taken = sim._taken.clone()
        got = sim._rebuild_and_lists(state)
        assert (sim._taken - taken).tolist() == want[4]
        for a, b in zip(got[0], want[0]):
            assert torch.equal(a, b)
        for a, b in zip(got[1:], want[1:4]):
            assert torch.equal(a, b)
    if incremental:
        # the seed falls back, the drift is merged
        assert (sim._taken - start).tolist() == [1, 1]
    assert sim._build_runner.captures == 0


# ------------------------------------------- the ring's exchanges and bodies
RING_CALLS = {
    "sum": lambda ring, t: ring.sum(t),
    "max": lambda ring, t: ring.max(t),
    "shift_plus": lambda ring, t: ring.shift_plus(t),
    "shift_minus": lambda ring, t: ring.shift_minus(t, async_op=True),
    "gather": lambda ring, t: ring.gather(t),
}


@pytest.mark.parametrize("kind", ["Ring", "LocalRing"])
@pytest.mark.parametrize("call", list(RING_CALLS))
def test_a_ring_exchange_inside_a_body_raises(kind, call):
    """While a conditional body is captured (the flag ``StepGraph`` sets
    around each body's capture) every ring exchange raises, on both kinds
    of ring: a step's collectives run outside its branches. Outside the
    flag the same call goes through."""
    ring = Ring() if kind == "Ring" else LocalRing.ring_of(1)[0]
    t = torch.ones(3)
    assert not graphs.capturing_body()
    with graphs.body_capture():
        assert graphs.capturing_body()
        with pytest.raises(RuntimeError, match="inside a conditional body"):
            RING_CALLS[call](ring, t)
    assert not graphs.capturing_body()
    RING_CALLS[call](ring, t)


def test_a_branch_inside_a_body_raises():
    """The same flag refuses a ``cond`` inside a body (conditional nodes do
    not nest in a child graph), before anything touches a card."""
    with graphs.body_capture():
        with pytest.raises(RuntimeError, match="branch inside a branch"):
            graphs.StepGraph._node(None, torch.ones((), dtype=torch.bool),
                                   lambda: None)
