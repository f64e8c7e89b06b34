"""The readers of the program's read-idle spans and round histogram
(portbench/metrics/) on synthetic readings: a value where the window's
``npc_stats`` holds their keys, None where it does not (the rollout cell,
an eager step, a program without them)."""
import types

import pytest

from portbench import spec


def _r(steps, **stats):
    return types.SimpleNamespace(steps=steps, npc_stats=stats)


def _read(name, r):
    return spec.reader(name)(r)


COUNTS = {"host_reads": 400, "tier_reads": 100, "cleanup_rounds": 300,
          "collision_rounds": 20}


def test_width_read_idle_ms_per_step():
    r = _r(100, **COUNTS, **{"read_idle_s.width": 0.05, "read_idle_s.cleanup": 0.2})
    assert _read("width_read_idle_ms_per_step", r) == pytest.approx(0.5)
    assert _read("width_read_idle_ms_per_step", _r(100, **COUNTS)) is None
    assert _read("width_read_idle_ms_per_step", _r(100)) is None


def test_npc_read_idle_ms_per_step():
    r = _r(100, **COUNTS, **{"read_idle_s.width": 0.05, "read_idle_s.cleanup": 0.2,
                             "read_idle_s.cascade": 0.1})
    assert _read("npc_read_idle_ms_per_step", r) == pytest.approx(3.0)
    r = _r(50, **{"read_idle_s.cascade": 0.1})
    assert _read("npc_read_idle_ms_per_step", r) == pytest.approx(2.0)
    assert _read("npc_read_idle_ms_per_step", _r(100, **COUNTS)) is None
    assert _read("npc_read_idle_ms_per_step", _r(100, **{"read_idle_s.width": 0.05})) is None


def test_npc_rounds_p95():
    # 100 ticks: 60 at 3 rounds, 34 at 4, 5 at 7, 1 at 12; sorted, the 95th
    # percentile lies at index 94.05, between the first 7 and the second
    r = _r(100, **COUNTS, npc_rounds_at_3=60, npc_rounds_at_4=34, npc_rounds_at_7=5,
           npc_rounds_at_12=1, npc_rounds_at_9=0)
    assert _read("npc_rounds_p95", r) == pytest.approx(7.0)
    r = _r(4, npc_rounds_at_2=3, npc_rounds_at_6=1)
    assert _read("npc_rounds_p95", r) == pytest.approx(2.0 + 0.85 * 4.0)
    assert _read("npc_rounds_p95", _r(100, **COUNTS)) is None
    assert _read("npc_rounds_p95", _r(0, npc_rounds_at_3=0)) is None
