"""The port's evaluate (batched and single-env) and play against the repo's
eval.py."""
import contextlib
import io
import json
import sys

import pytest

import eval as jax_eval
from marl_traffic_intersection_tpu_torch import evaluate, play

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


def _eval_py(monkeypatch, *argv):
    """The repo's eval.py's JSON line for ``argv``."""
    monkeypatch.setattr(sys, "argv", ["eval.py", *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jax_eval.main()
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_single_env_scripted_loop_matches_eval_py(monkeypatch, capsys):
    """evaluate --episodes 2 --policy scripted (eval.py's Stanley driver on
    the route table) on config 1: both episodes succeed, with eval.py's
    event-counted stats; the episode reward, summed from floats the JAX
    default chain rounds otherwise (ROADMAP queue 3, H3), within 1e-6."""
    argv = ["--config", "1", "--episodes", "2", "--policy", "scripted", "--device", "cpu"]
    evaluate.main(argv)
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = _eval_py(monkeypatch, *argv)
    assert got["successes"] == got["episodes"] == 2 and got["device"] == "cpu"
    for k in ("config", "episodes", "policy", "successes", "agents_succeeded_frac",
              "crashes_vehicle", "crashes_object", "mean_ep_len"):
        assert got[k] == want[k], k
    assert abs(got["mean_ep_reward"] - want["mean_ep_reward"]) <= 1e-6 * abs(want["mean_ep_reward"])


def test_single_env_loop_runs_every_policy_kind():
    """The GRU carries its hidden state and resets it at life boundaries;
    random and the seeded mlp run too; scripted refuses the batched mode."""
    got = evaluate.episodes(config=3, num_episodes=1, max_steps=40, policy="checkpoint",
                            device="cpu", checkpoint="policy_gru_multi", model_kind="gru")
    assert got["mean_ep_len"] == 40.0 and got["policy"] == "checkpoint"
    for policy in ("random", "mlp"):
        got = evaluate.episodes(config=2, num_episodes=1, max_steps=20, policy=policy,
                                device="cpu")
        assert got["mean_ep_len"] <= 20.0 and got["episodes"] == 1
    with pytest.raises(SystemExit):
        evaluate.main(["--policy", "scripted", "--device", "cpu"])
    with pytest.raises(SystemExit):
        evaluate.main(["--episodes", "1", "--vector", "2", "--device", "cpu"])


def test_play_script_writes_a_gif(tmp_path, capsys):
    from PIL import Image

    out = tmp_path / "demo.gif"
    play.main(["--script", "--steps", "20", "--device", "cpu", "--out", str(out)])
    assert "wrote" in capsys.readouterr().out
    with Image.open(out) as gif:
        assert gif.n_frames == 7 and gif.size == (750, 750)
    out2 = tmp_path / "gru.gif"
    play.main(["--script", "--steps", "6", "--device", "cpu", "--out", str(out2), "--agents",
               "2", "--checkpoint", "policy_gru_cfg1", "--model", "gru"])
    assert out2.is_file()
