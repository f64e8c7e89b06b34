"""The port's entry points: evaluate (on the CPU, when asked; the traffic
configs too) and bench (which refuses without a card, in either mode)."""
import json
import os
import subprocess
import sys

import pytest
import torch

from marl_traffic_intersection_tpu_torch import bench, evaluate

from . import _torch_port  # noqa: F401  (one torch thread per test worker)


@pytest.mark.parametrize("policy,config", [("random", 3), ("mlp", 1)])
def test_evaluate_cpu_prints_eval_keys(policy, config, capsys):
    evaluate.main(["--config", str(config), "--vector", "8", "--max-steps", "30",
                   "--policy", policy, "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    keys = {"config", "vector", "policy", "npc_mode", "episodes", "successes",
            "success_rate_per_episode", "crashes_vehicle", "crashes_object",
            "mean_ep_len", "mean_ep_reward", "env_steps", "env_steps_per_s", "secs"}
    assert keys <= set(line)
    assert line["env_steps"] == 8 * 30 and line["device"] == "cpu"


def test_evaluate_traffic_config_raises():
    """BASELINE config 2 runs with NPC traffic on the CPU and reports its NPC
    mode; an NPC mode the env does not know raises."""
    line = evaluate.evaluate(config=2, num_envs=4, max_steps=20, device="cpu", npc_mode="fast")
    assert line["npc_mode"] == "fast" and line["env_steps"] == 80
    with pytest.raises(ValueError, match="npc_mode"):
        evaluate.evaluate(config=4, num_envs=2, max_steps=1, device="cpu", npc_mode="tiered")


def test_evaluate_config4_exact_module_flag(capsys):
    evaluate.main(["--config", "4", "--vector", "2", "--max-steps", "12", "--npc-mode", "exact",
                   "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["npc_mode"] == "exact" and line["config"] == 4 and line["env_steps"] == 24


@pytest.mark.parametrize("mode", ["default", "traffic"])
def test_bench_refuses_without_a_card(monkeypatch, mode):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("BENCH_MODE", mode)
    with pytest.raises(SystemExit, match="no CUDA"):
        bench.main()


def test_evaluate_module_runs():
    r = subprocess.run([sys.executable, "-m", "marl_traffic_intersection_tpu_torch.evaluate",
                        "--vector", "4", "--max-steps", "5", "--device", "cpu"],
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.strip())["episodes"] >= 1
