"""The control, the reference in bfloat16 put in the program's place, fails
each cell's check at a size a test run holds: the harness judges its numbers
against the cell's limits and its verdict comes out false, with one of its
numbers far past its limit, while the program's run beside it is correct."""

import pytest

from mdbench.tests import util


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return util.quick_cells(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", ["c4_sorted.build.quick",
                                  "c4_sorted.nve.quick"])
def test_control_fails_the_check(root, cell):
    r = util.run_small(root, cell, control=True)
    assert r["correct"], r["checks"]
    ctl = r["control"]
    assert ctl["correct"] is False, ctl
    assert set(ctl["checks"]) <= set(r["checks"])
    over = {k: c["value"] for k, c in ctl["checks"].items()
            if c["value"] is None or c["value"] > c["limit"]}
    assert over, ctl
    for name, value in over.items():
        assert value >= 3 * max(ctl["checks"][name]["limit"],
                                r["checks"][name]["value"])
    assert list(r)[-2:] == ["window", "checks"]
