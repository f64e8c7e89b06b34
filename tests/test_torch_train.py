"""The port's train entry point on the CPU: finite losses, exact resume,
curriculum stages, the curriculum parser against the repo's train.py, and
the throughput meter and trace context it builds on."""
import json

import pytest
import torch

import train as jax_train
from marl_traffic_intersection_tpu.utils.profiling import StepsPerSecond as JaxStepsPerSecond
from marl_traffic_intersection_tpu_torch import evaluate, train
from marl_traffic_intersection_tpu_torch.utils.checkpoint import restore_checkpoint
from marl_traffic_intersection_tpu_torch.utils.profiling import StepsPerSecond, trace_profile

from . import _torch_port  # noqa: F401  (one torch thread per test worker)

SMALL = ["--device", "cpu", "--num-envs", "4", "--agents", "2", "--rollout-len", "8",
         "--log-every", "1"]
TIMING = ("secs", "env_steps_per_s", "rollout_s", "update_s")


def _run(capsys, *args):
    """train.main's JSON log lines, by update."""
    train.main(SMALL + [str(a) for a in args])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    return {ln["update"]: ln for ln in lines if "update" in ln}


@pytest.mark.parametrize("model,extra", [("mlp", []), ("central", ["--norm-reward"])])
def test_resumed_run_continues_the_uninterrupted_one_exactly(tmp_path, capsys, model, extra):
    """4 updates in one run equal 2 updates plus 2 after an auto-resume, bit
    for bit on every logged metric and on the final model and Adam state."""
    whole = _run(capsys, "--updates", 4, "--model", model, "--checkpoint", tmp_path / "a", *extra)
    first = _run(capsys, "--updates", 2, "--model", model, "--checkpoint", tmp_path / "b", *extra)
    rest = _run(capsys, "--updates", 4, "--model", model, "--checkpoint", tmp_path / "b", *extra)
    assert sorted(whole) == [0, 1, 2, 3] and sorted(first) == [0, 1] and sorted(rest) == [2, 3]
    for u, line in {**first, **rest}.items():
        assert {k: v for k, v in line.items() if k not in TIMING} == \
               {k: v for k, v in whole[u].items() if k not in TIMING}, u
        assert line["device"] == "cpu"
        assert all(torch.isfinite(torch.tensor(line[k])) for k in ("pg_loss", "v_loss"))
    a, b = restore_checkpoint(tmp_path / "a"), restore_checkpoint(tmp_path / "b")
    # the resumed run's minibatch counter restarts at 0, as train.py's does:
    # 2 updates x 16 minibatches after the resume
    assert a["update"] == b["update"] == 4 and a["update_count"] == 64
    assert b["update_count"] == 32
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    for i, st in a["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, b["optimizer"]["state"][i][k]), (i, k)
    assert torch.equal(a["obs"], b["obs"])


def test_warm_start_curriculum_and_evaluate(tmp_path, capsys):
    """Two curriculum stages carry the policy over; an explicit --resume runs
    the full budget on top of the restored counter; evaluate reads the
    checkpoint."""
    logs = _run(capsys, "--curriculum", "agents=1@1;agents=2,lr=1e-4@1",
                "--checkpoint", tmp_path / "c")
    assert sorted(logs) == [0, 1]
    logs = _run(capsys, "--updates", 1, "--resume", tmp_path / "c", "--checkpoint", tmp_path / "d")
    assert sorted(logs) == [2]
    assert restore_checkpoint(tmp_path / "d")["update"] == 3
    evaluate.main(["--config", "3", "--vector", "4", "--max-steps", "10", "--device", "cpu",
                   "--policy", "checkpoint", "--checkpoint", str(tmp_path / "d")])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["policy"] == "checkpoint" and line["env_steps"] == 40


@pytest.mark.parametrize("spec", ["agents=1@40;agents=2@40;agents=4@80",
                                  "density=0.2@50;density=1.0@100",
                                  " traffic=1,lr=1e-4@3; ent-coef=0.02,rollout_len=32@2;",
                                  "traffic=false@1"])
def test_parse_curriculum_matches_train_py(spec):
    assert train.parse_curriculum(spec) == jax_train.parse_curriculum(spec)


@pytest.mark.parametrize("spec", ["agents=2", "foo=1@2"])
def test_parse_curriculum_rejects_what_train_py_rejects(spec):
    with pytest.raises(ValueError):
        jax_train.parse_curriculum(spec)
    with pytest.raises(ValueError):
        train.parse_curriculum(spec)




@pytest.mark.parametrize("spec", ["traffic=1,density=0.2@1", "agents=1@1;traffic=1,density=2@1"])
def test_traffic_curriculum_runs(capsys, spec):
    """Stages that switch traffic on and change its density each build their
    env and run their update."""
    train.main(SMALL + ["--curriculum", spec])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    logs = [ln for ln in lines if "update" in ln]
    stages = [ln for ln in lines if "stage" in ln]
    assert len(logs) == len(spec.split(";"))
    assert all(torch.isfinite(torch.tensor(ln["pg_loss"])) for ln in logs)
    if stages:
        assert [s["traffic"] for s in stages] == [False, True]
        assert stages[1]["density"] == 2.0


def test_traffic_resumed_run_continues_exactly(tmp_path, capsys):
    """--traffic: 4 updates equal 2 plus 2 after an auto-resume, bit for bit,
    the NPC pool and the spawn draws included."""
    extra = ["--traffic", "--density", "3.0", "--npc-mode", "exact"]
    whole = _run(capsys, "--updates", 4, "--checkpoint", tmp_path / "a", *extra)
    _run(capsys, "--updates", 2, "--checkpoint", tmp_path / "b", *extra)
    rest = _run(capsys, "--updates", 4, "--checkpoint", tmp_path / "b", *extra)
    for u, line in rest.items():
        assert {k: v for k, v in line.items() if k not in TIMING} == \
               {k: v for k, v in whole[u].items() if k not in TIMING}, u
    a, b = restore_checkpoint(tmp_path / "a"), restore_checkpoint(tmp_path / "b")
    npc = [k for k in a["env_state"] if k.startswith("npc.")]
    assert len(npc) == 10 and a["env_state"]["npc.next_uid"].sum() > 0
    for k in npc + ["lidar"]:
        assert torch.equal(a["env_state"][k], b["env_state"][k]), k
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    assert torch.equal(a["obs"], b["obs"])


def test_steps_per_second_counts_like_the_jax_meter():
    """Both meters drop the first (warm-up) tick and count the rest."""
    ours, theirs = StepsPerSecond(steps_per_tick=10), JaxStepsPerSecond(steps_per_tick=10)
    for meter in (ours, theirs):
        assert meter.value == 0.0
        meter.tick()
        assert meter.value == 0.0
        meter.tick()
        meter.tick(5)
    assert ours._ticks == theirs._ticks == 15 and ours.value > 0


def test_trace_profile_writes_a_chrome_trace(tmp_path):
    path = tmp_path / "traces" / "block.json"
    with trace_profile(str(path)):
        torch.ones(8).add_(1)
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "aten::add_" for e in events)


def test_profile_flag_traces_the_last_update(tmp_path, capsys):
    """--profile writes the last update's Chrome trace and prints its summary;
    every log line splits its update into rollout and update seconds."""
    trace = tmp_path / "train.json.gz"
    train.main(SMALL + ["--updates", "2", "--profile", str(trace)])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    logs = [ln for ln in lines if "update" in ln]
    profs = [ln["profile"] for ln in lines if "profile" in ln]
    assert [ln["update"] for ln in logs] == [0, 1] and len(profs) == 1
    assert all(ln["rollout_s"] > 0 and ln["update_s"] > 0 for ln in logs)
    assert profs[0]["window_ms_per_step"] > 0 and profs[0]["kernel_launches_per_step"] == 0
    assert trace.stat().st_size > 0
