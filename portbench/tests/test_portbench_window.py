"""The window's statistics: the rate counts every step over the whole
window, and the tail is taken over every step; the window's events are
sized from the warm-up; the lidar is timed at the width the step ran."""
import time

import numpy as np
import pytest

from portbench import window


def test_rate_counts_all_steps_over_the_whole_window():
    calls = []

    def step(k):
        calls.append(k)
        time.sleep(0.004 if k % 10 else 0.02)      # every tenth step is slow

    t0 = time.perf_counter()
    w = window.measure(step, 0.3, window.HostClock())
    outer = time.perf_counter() - t0
    assert calls == list(range(w.steps)) and len(w.periods_ms) == w.steps
    assert w.wall_s <= outer and w.wall_s >= 0.3
    assert window.env_steps_per_s(w, 64) == pytest.approx(w.steps * 64 / w.wall_s)
    # the periods cover the window: no step's time is left out
    assert sum(w.periods_ms) / 1e3 == pytest.approx(w.wall_s, rel=0.05)


def test_p95_is_taken_over_every_step():
    periods = ([1.0] * 9 + [10.0]) * 10             # every tenth step is slow
    w = window.Window(100, 0.19, periods)
    assert window.step_ms_p95(w) == pytest.approx(np.percentile(periods, 95)) == 10.0
    # a median of blocks, as the port's bench.py takes, would hide the slow steps
    assert np.median([np.median(periods[i:i + 20]) for i in range(0, 100, 20)]) == 1.0
    assert window.quantiles(w) == [1.0, 10.0, 10.0, 10.0]


def test_event_pool_follows_the_warmup_rate():
    assert window.event_pool_size(700.0, 51) == 53614
    assert window.event_pool_size(140.0, 51) > 1.5 * 140 * 51


@pytest.mark.parametrize("name,width,obstacles", [("cfg4-traffic-d1-4096x8", 8, 16),
                                                  ("cfg5-rollout-4096x4", None, 4)])
def test_lidar_operands_are_those_of_the_stepped_width(monkeypatch, name, width, obstacles):
    from portbench import run, trace
    from portbench.tests.helpers import tiny

    out = run.run(tiny(name), 3, 0.2, False, device="cpu")
    rec = out["checked"][1]
    assert rec.pose_width == width
    ops = run.lidar_operands(rec.full_poses, rec.pose_width)
    assert [tuple(t.shape) for t in ops[3:]] == [(8, obstacles)] * 4
    # the reading's arithmetic, with the card's timing stood in by 1 ms
    monkeypatch.setattr(trace, "lidar_ms", lambda scan, operands: 1.0)
    got = run.lidar_readings(rec.full_poses, rec.pose_width, tiny(name).env_config())
    assert got["obstacles"] == obstacles and got["device_ms"] == 1.0
    assert 0 < got["bound_ms"] < 1.0 and got["samples"] > 0
