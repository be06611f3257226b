"""The check catches a broken timed path: each cell run on the CPU at a small
N with a fault planted underneath comes out with ``correct`` false, and the
sound run with it true. The harness's look for a card is skipped (the run is
driven on the CPU); the rest is the run as on the card."""

import pytest

from mdbench import faults
from mdbench.lib import spec
from mdbench.tests import util

CELLS = {"c4_sorted.nve.quick": "nve", "c4_sorted.build.quick": "build"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return util.quick_cells(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(root, cell):
    r = util.run_small(root, cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_planted_fault_is_caught(root, cell, fault):
    with faults.planted(fault, CELLS[cell]) as switch:
        r = util.run_small(root, cell, on_window=switch.arm)
    assert not r["correct"], (fault, r["checks"])
    assert r["failed"] == r["attempted"]


def test_a_fault_waits_for_the_window(root):
    """Planted but never armed, a fault leaves the run sound: set-up and
    warm-up run the program as it is."""
    with faults.planted("half", "nve"):
        r = util.run_small(root, "c4_sorted.nve.quick")
    assert r["correct"], r["checks"]


def test_unknown_fault_refused():
    with pytest.raises(ValueError):
        with faults.planted("nonsense", "nve"):
            pass


def test_wrong_partners_in_a_build_but_the_last_are_caught(root,
                                                           monkeypatch):
    """One build of the window, not the last, whose masks name a wrong pair
    while its pair total is right: the seeded reservoir keeps that build
    whole, and ``pair_miss`` reads it while ``total_err`` does not."""
    import numpy as np
    from md_neighbor_list_tpu_torch.models import dense_lj
    from mdbench.drivers import build

    cell = spec.load_cell("c4_sorted.build.quick", root=root,
                          benchmark=root.parent / "BENCHMARK.json")
    run = build.Run(cell, util.SEED, "cpu", n=util.N_SMALL)
    run.pick = np.full_like(run.pick, 0.999)  # later builds are not kept
    run.pick[5] = 0.0  # but build 5 takes the reservoir's first place
    orig = dense_lj.DenseSimulator._rebuild_and_lists

    def wrong_partner(self, state):
        out = orig(self, state)
        if run.j == 5:
            out[2].view(-1)[0] ^= 1
        return out
    monkeypatch.setattr(dense_lj.DenseSimulator, "_rebuild_and_lists",
                        wrong_partner)
    for _ in range(12):
        run.unit()
    run.finish()
    assert sorted(run.got) == [1, 5, 11]
    checks = run.check()
    assert checks["pair_miss"] >= 1 and checks["total_err"] == 0, checks


def test_the_reservoir_spreads_over_the_window():
    """Kept builds come from the whole window, few of them are copied, and
    the first ``samples`` builds fill the reservoir."""
    import numpy as np
    from mdbench.drivers import build

    run = build.Run.__new__(build.Run)
    run.samples = 4
    run.pick = np.random.default_rng(3).random(1 << 20)
    slots = [run.slot(j) for j in range(10_000)]
    assert slots[:4] == [0, 1, 2, 3]
    kept = {}
    for j, k in enumerate(slots):
        if k < 4:
            kept[k] = j
    copies = sum(k < 4 for k in slots)
    assert copies < 4 * (1 + np.log(10_000 / 4)) * 1.5
    assert max(kept.values()) > 2_500
