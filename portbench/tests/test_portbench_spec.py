"""A new cell made only of new files under configs/, traffic/ and
metrics/ is found by name and run, with its new per-layer metric."""
import json
import shutil

from portbench import run, spec
from portbench.tests.helpers import tiny

NEW_METRIC = '''"""Env rows stepped per window step (a count the harness already reads)."""


def read(r):
    return float(r.num_envs)
'''


def test_a_cell_of_new_files_is_found_and_run(tmp_path):
    shutil.copytree(spec.PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    base = tiny("cfg5-rollout-4096x4")
    (tmp_path / "portbench" / "configs" / "cfg5_small.json").write_text(
        json.dumps(dict(base.config, num_agents=2)))
    (tmp_path / "portbench" / "traffic" / "rollout_short.json").write_text(
        json.dumps(base.traffic))
    (tmp_path / "portbench" / "metrics" / "rows_per_step.py").write_text(NEW_METRIC)
    bench["configs"].append({"name": "cfg5_small", "source": "a test",
                             "file": "portbench/configs/cfg5_small.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "cfg5_small-short", "config": "cfg5_small",
                               "traffic": "rollout_short", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "rows_per_step", "unit": "rows", "better": "higher",
                               "source": "program_counter", "layer": "batch and auto-reset",
                               "moves": "env_steps_per_s", "workloads": ["cfg5_small-short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load("cfg5_small-short", root=tmp_path)
    assert cell.config["num_agents"] == 2 and cell.traffic == base.traffic
    assert [m["name"] for m in cell.per_layer] == ["rows_per_step"]
    assert [m["name"] for m in cell.end_to_end] == ["env_steps_per_s", "peak_mem_mib",
                                                    "setup_s"]
    out = run.run(cell, 5, 0.2, True, device="cpu")
    assert out["line"]["correct"]
    assert out["line"]["metrics"]["rows_per_step"] == {"value": 8.0, "unit": "rows"}
    # the committed cells do not report it
    assert "rows_per_step" not in [m["name"] for m in spec.load("cfg5-rollout-4096x4").per_layer]
