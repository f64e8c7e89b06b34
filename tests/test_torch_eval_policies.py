"""The port's evaluate with a shipped policy against the repo's eval.py."""
import contextlib
import io
import json
import sys

import eval as jax_eval
from marl_traffic_intersection_tpu_torch import evaluate

from . import _torch_port  # noqa: F401  (one torch thread per test worker)


def test_shipped_mlp_policy_on_config_1_matches_eval_py(monkeypatch):
    """policy_mlp_cfg1 on BASELINE config 1: every episode of the port's
    batched evaluation succeeds with no crash, and its mean episode length is
    the one the repo's eval.py measures with the JAX package."""
    got = evaluate.evaluate(config=1, num_envs=2, max_steps=100, policy="checkpoint",
                            device="cpu", checkpoint="artifacts/policy_mlp_cfg1",
                            model_kind="mlp")
    monkeypatch.setattr(sys, "argv", ["eval.py", "--config", "1", "--policy", "checkpoint",
                                      "--checkpoint", "artifacts/policy_mlp_cfg1",
                                      "--episodes", "2", "--max-steps", "100",
                                      "--device", "cpu"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jax_eval.main()
    want = json.loads(out.getvalue().strip().splitlines()[-1])
    assert want["successes"] == want["episodes"] == 2
    assert got["episodes"] == 2 and got["successes"] == 2
    assert got["success_rate_per_episode"] == 1.0
    assert got["crashes_vehicle"] == got["crashes_object"] == 0
    assert want["crashes_vehicle"] == want["crashes_object"] == 0
    assert got["mean_ep_len"] == want["mean_ep_len"] == 71.0
