"""The port's distributed learners on the CPU over gloo, against one
process: each test spawns a process group (``dryrun.spawn``) whose ranks run
``tests/_torch_dist.py``.

  * 60 env steps with traffic at world 2 are bit-equal to world 1, while
    the ranks narrow their NPC pools to different widths;
  * one float32 PPO, recurrent-PPO and SAC update at dp 2 and dp 2 x tp 2
    agrees with world 1 within PARAM_TOL (the largest differences measured
    are in CHANGES.md), and the SAC batch the ranks assemble equals the whole
    ring's rows bit for bit;
  * a dp 2 x tp 2 ``train --checkpoint`` snapshot resumes in one process
    with whole parameters, and under torchrun at the same mesh continues the
    uninterrupted run exactly.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from marl_traffic_intersection_tpu_torch import train
from marl_traffic_intersection_tpu_torch.dryrun import spawn
from marl_traffic_intersection_tpu_torch.models import make_model
from marl_traffic_intersection_tpu_torch.utils.checkpoint import restore_checkpoint

from . import _torch_dist
from . import _torch_port  # noqa: F401  (one torch thread per test worker)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# float32 update at world W against world 1: the sums of the gradient
# average, the advantage statistics, the global norm and the row-parallel
# products run in other orders
PARAM_TOL = 1e-5
MOMENT_TOL = 1e-4       # Adam's moments, relative to their largest
METRIC_TOL = 1e-5


def _max_diff(a: dict, b: dict) -> float:
    assert a.keys() == b.keys()
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def test_traffic_env_at_world_2_is_bit_equal_to_world_1(tmp_path):
    out = tmp_path / "env.pt"
    spawn(_torch_dist.env_world_vs_one, 2, (str(out),), timeout=180)
    r = torch.load(out)
    assert all(not d for d in r["diffs"]), [(t, d) for t, d in enumerate(r["diffs"]) if d][:3]
    # 60 steps, as the JAX package's test: the ranks' pools first part in
    # width near step 58
    assert len(r["diffs"]) == 60 and r["npcs"] > 0
    w0, w1 = r["widths"]
    print(f"NPC widths by step, rank 0: {w0}\nrank 1: {w1}")
    assert any(a != b for a, b in zip(w0, w1)), "the ranks never picked different widths"


def _check_learner(r, kind):
    got, want = r["got"], r["want"]
    assert got["update_count"] == want["update_count"]
    (gm, go), (wm, wo) = got["state"], want["state"]
    diff = _max_diff(gm, wm)
    mdiff = max(float((go[i][k] - wo[i][k]).abs().max() / wo[i][k].abs().max())
                for i in wo for k in ("exp_avg", "exp_avg_sq"))
    mets = max(abs(got["metrics"][k] - want["metrics"][k]) for k in want["metrics"])
    print(f"{kind}: parameters within {diff:.3g}, Adam moments within {mdiff:.3g} of their "
          f"largest, metrics within {mets:.3g}")
    assert diff <= PARAM_TOL and mdiff <= MOMENT_TOL and mets <= METRIC_TOL
    assert [a.shape for a in got["carry"]] == [b.shape for b in want["carry"]]


@pytest.mark.parametrize("kind,world,tp", [("mlp", 2, 1), ("mlp", 4, 2), ("gru", 2, 1)])
def test_ppo_update_agrees_with_world_1(tmp_path, kind, world, tp):
    out = tmp_path / "ppo.pt"
    spawn(_torch_dist.ppo_world_vs_one, world, (str(out), kind, tp), timeout=180)
    _check_learner(torch.load(out), f"{kind} dp {world // tp} x tp {tp}")


def test_sac_update_agrees_with_world_1(tmp_path):
    out = tmp_path / "sac.pt"
    spawn(_torch_dist.sac_world_vs_one, 4, (str(out), 2), timeout=180)
    r = torch.load(out)
    for a, b in zip(r["sample"], r["ring_at"]):
        assert torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))
    got, want = r["got"], r["want"]
    diff = max(_max_diff(got["nets"][k], want["nets"][k]) for k in ("actor", "critic", "target"))
    diff = max(diff, float((got["nets"]["log_alpha"] - want["nets"]["log_alpha"]).abs()))
    mets = max(abs(got["metrics"][k] - want["metrics"][k]) for k in want["metrics"])
    print(f"sac dp 2 x tp 2: parameters within {diff:.3g}, metrics within {mets:.3g}")
    assert diff <= PARAM_TOL and mets <= METRIC_TOL


SMALL = ["--device", "cpu", "--num-envs", "8", "--agents", "2", "--rollout-len", "8",
         "--log-every", "1"]


def _torchrun(nproc, *args):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(nproc), "-m", "marl_traffic_intersection_tpu_torch.train", "--distributed",
           *SMALL, *[str(a) for a in args]]
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=240,
                       env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr[-3000:]
    return [json.loads(ln) for ln in r.stdout.splitlines() if ln.startswith("{")]


def test_checkpoint_at_dp2_tp2_resumes_anywhere(tmp_path, capsys):
    """4 updates at dp 2 x tp 2 equal 2 plus 2 auto-resumed at the same mesh,
    bit for bit; the snapshot holds whole parameters and resumes in one
    process."""
    whole = _torchrun(4, "--tp", 2, "--updates", 4, "--checkpoint", tmp_path / "a")
    first = _torchrun(4, "--tp", 2, "--updates", 2, "--checkpoint", tmp_path / "b")
    rest = _torchrun(4, "--tp", 2, "--updates", 4, "--checkpoint", tmp_path / "b")
    timing = ("secs", "env_steps_per_s", "rollout_s", "update_s")
    strip = lambda ln: {k: v for k, v in ln.items() if k not in timing}
    assert [ln["update"] for ln in whole] == [0, 1, 2, 3]
    assert [strip(ln) for ln in first + rest] == [strip(ln) for ln in whole]
    a, b = restore_checkpoint(tmp_path / "a"), restore_checkpoint(tmp_path / "b")
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    assert {k: v.shape for k, v in a["model"].items()} == \
        {k: v.shape for k, v in make_model("mlp").state_dict().items()}
    assert a["obs"].shape == (8, 2, 127) and a["env_state"]["ego.x"].shape == (8, 2)
    train.main(SMALL + ["--updates", "1", "--resume", str(tmp_path / "a")])
    logs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert [ln["update"] for ln in logs] == [4]
