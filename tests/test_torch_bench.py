"""The port's bench line against bench.py's, on the CPU without running the
bench (it refuses without a card: tests/test_torch_entry.py): the pinned
reference rate read from BASELINE.json for every configuration it holds,
the fallbacks, the fields and their rounding, and the metric's labels."""
import json
import os

import pytest

import bench as jax_bench
from marl_traffic_intersection_tpu_torch import bench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "BASELINE.json")) as f:
    PINNED = json.load(f)["measured_reference"]
CONFIGS = [(False, 1.0, 4), (False, 1.0, 1), (True, 0.5, 1), (True, 1.0, 1), (True, 2.0, 8),
           (True, 4.0, 1)]
# bench.py's JSON line (bench.py:176-186)
FIELDS = ["metric", "value", "unit", "vs_baseline", "repeats", "dispersion_pct",
          "baseline_ref_steps_per_s"]


@pytest.mark.parametrize("traffic,density,agents", CONFIGS)
def test_reference_rate_is_bench_pys_pinned_one(traffic, density, agents):
    want = jax_bench._pinned_reference(traffic, density, agents)
    assert want is not None
    assert bench.reference_rate(traffic, density, agents) == want


def test_reference_rate_values_and_fallbacks(tmp_path):
    assert bench.reference_rate(False, 1.0, 4) == PINNED["no_traffic_agents4"] == 3004.4
    assert bench.reference_rate(True, 1.0, 1) == PINNED["traffic_d1.0"] == 12800.5
    # no pinned entry, no file, a broken file: the reference's design rate
    assert bench.reference_rate(True, 3.0, 1) == bench.DESIGN_RATE == 60.0
    assert bench.reference_rate(False, 1.0, 4, path=str(tmp_path / "none.json")) == 60.0
    bad = tmp_path / "bad.json"
    bad.write_text("{")
    assert bench.reference_rate(False, 1.0, 4, path=str(bad)) == 60.0


def test_line_has_bench_pys_fields_and_rounding():
    vals = [12000.123, 13000.987, 12500.54]
    line = bench.result_line("m", vals, 3004.4)
    assert list(line) == FIELDS
    # bench.py rounds value and repeats to 0.1 and dispersion_pct to 0.01,
    # and takes vs_baseline from the unrounded median
    assert line["value"] == 12500.5 and line["repeats"] == [12000.1, 13001.0, 12500.5]
    assert line["vs_baseline"] == round(12500.54 / 3004.4, 2) == 4.16
    assert line["baseline_ref_steps_per_s"] == 3004.4
    assert line["dispersion_pct"] == round(100.0 * (13000.987 - 12000.123) / 12500.54, 2) == 8.01
    json.dumps(line)


@pytest.mark.parametrize("cleanup", ["slot", "wave"])
@pytest.mark.parametrize("npc_mode", ["exact", "fast"])
def test_metric_labels_npc_cleanup_and_the_exact_chain(cleanup, npc_mode):
    """The npc_cleanup label as bench.py's; ", exact_trig" always, since the
    port's step is the exact float chain whatever the knobs."""
    m = bench.metric_name(1024, 1, traffic=True, npc_mode=npc_mode, density=1.0,
                          npc_cleanup=cleanup)
    cleanup_label = ", npc_cleanup=wave" if cleanup == "wave" else ""
    assert m == (f"traffic-mode env-steps/s (1024 envs x 1 agents, density 1.0, "
                 f"npc_mode={npc_mode}{cleanup_label}), exact_trig")
    assert bench.metric_name(4096, 4) == \
        "batched env-steps/s (4096 envs x 4 agents, lidar on), exact_trig"


def test_main_takes_the_knobs_into_the_bench(monkeypatch, capsys):
    """main() with a card faked: BENCH_NPC_CLEANUP reaches bench() and the
    metric, and the line carries the pinned rate."""
    seen = {}

    def fake_bench(num_envs, num_agents, iters, inner, repeats, profile=False, **knobs):
        seen.update(knobs, num_envs=num_envs, repeats=repeats)
        return [1024.0 * 60.0, 1024.0 * 61.0], None

    monkeypatch.setattr(bench.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(bench.torch.cuda, "get_device_name", lambda i=0: "card")
    monkeypatch.setattr(bench, "card_line", lambda: "card, 700.00 W")
    monkeypatch.setattr(bench, "bench", fake_bench)
    for k, v in {"BENCH_MODE": "traffic", "BENCH_NPC_MODE": "exact", "BENCH_NPC_CLEANUP": "wave",
                 "BENCH_REPEATS": "2"}.items():
        monkeypatch.setenv(k, v)
    bench.main()
    line = json.loads(capsys.readouterr().out.splitlines()[0])
    assert seen == dict(traffic=True, npc_mode="exact", density=1.0, npc_cleanup="wave",
                        num_envs=1024, repeats=2)
    assert line["metric"].endswith("npc_mode=exact, npc_cleanup=wave), exact_trig")
    assert line["baseline_ref_steps_per_s"] == 12800.5
    assert line["vs_baseline"] == round(1024.0 * 60.5 / 12800.5, 2)
    assert line["device"] == "card" and line["card"] == "card, 700.00 W"


def test_main_refuses_to_retime_the_reference(monkeypatch):
    """BENCH_RETIME_REF=1 asks for a C++ timing the port cannot make: main()
    refuses before it runs anything, rather than divide by the fallback."""
    monkeypatch.setattr(bench.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(bench, "bench", lambda *a, **k: pytest.fail("the bench ran"))
    monkeypatch.setenv("BENCH_RETIME_REF", "1")
    with pytest.raises(SystemExit, match="BENCH_RETIME_REF"):
        bench.main()
