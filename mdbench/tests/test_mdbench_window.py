"""The window's rate and tail arithmetic."""

import pytest

from mdbench.lib import window


def test_rate_and_per_unit_are_all_work_over_all_time():
    assert window.rate(6600, 5.0) == 1320.0
    assert window.per_unit_ms(5000, 4.5) == pytest.approx(0.9)
    with pytest.raises(ValueError):
        window.rate(0, 1.0)


def test_percentile_by_nearest_rank_over_every_value():
    v = list(range(1, 101))  # 1..100
    assert window.percentile(v, 95) == 95
    assert window.percentile(v, 100) == 100
    assert window.percentile([3.0], 95) == 3.0
    # one stall in twenty is the p95 of twenty, a median hides it
    assert window.percentile([1.0] * 19 + [9.0], 95) == 1.0
    assert window.percentile([1.0] * 18 + [9.0, 9.0], 95) == 9.0
    with pytest.raises(ValueError):
        window.percentile([], 95)


def test_run_window_counts_whole_units_past_the_deadline(monkeypatch):
    clock = iter(x * 0.4 for x in range(100))
    monkeypatch.setattr(window.time, "perf_counter", lambda: next(clock))
    synced = []
    units, seconds = window.run_window(1.0, lambda: 10,
                                       lambda: synced.append(1))
    # starts at 0.0, units started at 0.4 and 0.8, stopped at 1.2 and the
    # window closes at 1.6 after the final sync
    assert units == 20 and seconds == pytest.approx(1.6)
    assert len(synced) == 2
