"""The train-step entry (portbench/learner.py) on the CPU at a tiny size: 8
envs x 2 agents, rollout 8, 2 epochs x 2 minibatches, the published 256-256
widths. The plain references follow the port's eager ``train_step``, a run
ends correct, the controls and every planted fault end not correct, a graph
captured in the window is counted, and the new metrics' readers and FLOP
count read what they should."""
import json
import os
import subprocess
import sys
import types

import pytest
import torch

from marl_traffic_intersection_tpu_torch.core import env as env_module
from marl_traffic_intersection_tpu_torch.parallel.ppo import LOSS_METRICS, PPOLearner
from portbench import learner, learner_control, roofline, run, spec
from portbench.reference import ppo as ref_ppo
from portbench.run import FOREIGN

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELL = "cfg5-ppo-4096x4"


def tiny(envs=8, agents=2, rollout=8, epochs=2, minibatches=2, max_steps=8) -> spec.Cell:
    """The train-step cell at a tiny size; with ``max_steps`` <= ``envs`` and
    the staggered phases some episode ends in every step."""
    cell = spec.load(CELL)
    cell.config = dict(cell.config, num_envs=envs, num_agents=agents, max_steps=max_steps)
    lc = cell.config["learner"]
    cell.config["learner"] = dict(lc, ppo=dict(lc["ppo"], rollout_len=rollout,
                                               update_epochs=epochs,
                                               num_minibatches=minibatches))
    cell.traffic = dict(cell.traffic, check=dict(envs=2, ending=2), span_steps=2,
                        profile_steps=1)
    return cell


def _run(seed=4, trace=False):
    return run.run(tiny(), seed, 0.2, trace, device="cpu")


@pytest.mark.parametrize("seed", (3, 2 ** 40 + 7))
def test_the_references_follow_the_eager_train_step(seed):
    out = _run(seed)
    readings = out["notes"]["check"]["readings"]
    assert out["line"]["correct"] and out["line"]["failed"] == 0
    # the trajectory's env data bit for bit, episode ends among the checked rows
    assert all(readings[k] == 0 for k in learner.ENV_LIMITS) and readings["gae"] == 0
    assert readings["episode_ends"] > 0
    # the rollout's forward at the program's parameters is the reference's to the bit
    ck = out["checked"]
    assert all(torch.equal(p[k], r[k]) for p, r in zip(learner.program_acts(ck), learner.acts(ck))
               for k in ("raw", "value", "logp", "last_value"))
    assert all(readings[k] <= lim for k, lim in learner.LIMITS.items())
    assert readings["adam_steps"] == 0 and readings["moments"] <= learner.LIMITS["moments"]
    assert out["line"]["attempted"] == out["notes"]["window"]["steps"] * 8 * 8


def test_a_traced_run_reports_the_cells_per_layer_metrics():
    out = _run(5, trace=True)
    assert out["line"]["correct"]
    names = {m["name"] for m in spec.load(CELL).per_layer}
    assert {"mfu_train", "rollout_ms_per_update", "learn_ms_per_update"} <= names
    got = out["line"]["metrics"]
    # the CPU has no graphs, no device operations and no lidar op to time
    assert set(got) == {"mfu_train", "rollout_ms_per_update", "learn_ms_per_update"}
    assert 0 < got["mfu_train"]["value"] < 100 and got["rollout_ms_per_update"]["value"] > 0
    assert list(out["line"])[-1] == "checks"


class _Capturing:
    """A train step whose ``graphs`` property builds a new dict at each read,
    as the program's graphed step does, and which captures a graph of its
    own at its fourth call, the window's first (three calls set up)."""

    def __init__(self, step):
        self.inner, self.calls, self.made = step, 0, {}

    def __call__(self, *args, **kw):
        self.calls += 1
        self.made.setdefault("rollout", types.SimpleNamespace(capture_s=0.25))
        if self.calls == 4:
            self.made["update_actor_off"] = types.SimpleNamespace(capture_s=0.25)
        return self.inner(*args, **kw)

    @property
    def graphs(self):
        return dict(self.made)


def test_a_capture_in_the_window_is_counted(monkeypatch):
    monkeypatch.setattr(PPOLearner, "jit_train_step", lambda self: _Capturing(self.train_step))
    out = _run(5, trace=True)
    assert out["line"]["correct"]
    assert out["notes"]["window"]["graphs"] == [1, 2]
    assert out["line"]["metrics"]["captures_in_window"]["value"] == 1.0
    assert out["line"]["metrics"]["capture_s"]["value"] == 0.25


@pytest.mark.parametrize("kind", ("bf16_master", "fp8_forward", "adam_reset"))
def test_the_controls_fail(kind):
    ck = _run(6)["checked"]
    got = learner_control.readings(ck, learner_control.reference(ck), kind)
    assert any(got[k] > learner.LIMITS[k] for k in got), got


def _skipped(orig):
    def broken(self, *args):
        return iter(list(orig(self, *args))[:-1])
    return broken


def _reused(orig):
    def broken(self, *args):
        draw, first = self.perm_fn, []
        self.perm_fn = lambda n: first[0] if first else first.append(draw(n)) or first[0]
        try:
            yield from orig(self, *args)
        finally:
            self.perm_fn = draw
    return broken


class _NoBiasAdam(torch.optim.Optimizer):
    """Adam without its bias corrections."""

    def __init__(self, params, lr, eps=1e-8, betas=(0.9, 0.999)):
        super().__init__(params, dict(lr=lr, eps=eps, betas=betas))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                st = self.state[p]
                if not st:
                    st["exp_avg"], st["exp_avg_sq"] = torch.zeros_like(p), torch.zeros_like(p)
                st["exp_avg"].mul_(b1).add_(p.grad, alpha=1 - b1)
                st["exp_avg_sq"].mul_(b2).addcmul_(p.grad, p.grad, value=1 - b2)
                p.sub_(group["lr"] * st["exp_avg"] / (st["exp_avg_sq"].sqrt() + group["eps"]))


def _init_with(dtype, adam):
    """``PPOLearner.init`` with the model's parameters in ``dtype`` and ``adam``."""
    def make(_):
        def broken(self):
            from marl_traffic_intersection_tpu_torch.parallel.ppo import TrainState
            model = self.model.to(self.device, dtype)
            return TrainState(model, adam(model.parameters(), lr=self.cfg.lr, eps=1e-8))
        return broken
    return make


def _unchanged(orig):
    def broken(self, ts, traj, advs, rets):
        return ts, {k: torch.zeros(()) for k in LOSS_METRICS}
    return broken


def _half(orig):
    def broken(self, model, batch, actor_on=1.0):
        return orig(self, model, tuple(x[:, :x.shape[1] // 2] for x in batch), actor_on)
    return broken


def _reward_altered(orig):
    def broken(self, *args, **kw):
        state, out = orig(self, *args, **kw)
        reward = out.reward.clone()
        reward[:, 0] = torch.nextafter(reward[:, 0], torch.tensor(float("inf")))
        return state, out._replace(reward=reward)
    return broken


def _moments_reset(orig):
    """Adam's moments zeroed after each call but the first, as a state
    re-zeroed on the host between calls would leave them (after the first
    call ``grad`` would see it too)."""
    calls = []

    def broken(self, *args, **kw):
        out = orig(self, *args, **kw)
        calls.append(1)
        for st in out[0].optimizer.state.values() if len(calls) > 1 else ():
            st["exp_avg"].zero_()
            st["exp_avg_sq"].zero_()
        return out
    return broken


def _fresh_adam(orig):
    """A fresh Adam at the start of each call (its state dropped)."""
    def broken(self, ts, *args, **kw):
        ts.optimizer.state.clear()
        return orig(self, ts, *args, **kw)
    return broken


FAULTS = {
    "minibatch_skipped": (PPOLearner, "_minibatches", _skipped),
    "permutation_reused": (PPOLearner, "_minibatches", _reused),
    "adam_without_bias_correction": (PPOLearner, "init", _init_with(torch.float32, _NoBiasAdam)),
    "bf16_master_weights": (PPOLearner, "init", _init_with(torch.bfloat16, torch.optim.Adam)),
    "state_unchanged": (PPOLearner, "_update", _unchanged),
    "half_the_batch_left_out": (PPOLearner, "_loss", _half),
    "an_answer_altered": (env_module.IntersectionEnv, "step", _reward_altered),
    "moments_reset_between_calls": (PPOLearner, "train_step", _moments_reset),
    "fresh_adam_each_call": (PPOLearner, "train_step", _fresh_adam),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_train_step_is_not_correct(monkeypatch, fault):
    owner, name, make = FAULTS[fault]
    monkeypatch.setattr(owner, name, make(getattr(owner, name)))
    out = _run(7)
    assert not out["line"]["correct"]
    assert any(c["value"] > c["limit"] for c in out["line"]["checks"].values())


def test_the_flop_count_and_the_readers():
    lc = spec.load(CELL).config["learner"]
    per_sample = ref_ppo.policy("mlp").flops_per_sample(lc["widths"])
    assert per_sample == 197_632
    flops = roofline.train_step_flops(per_sample, 4096 * 4, 64, 4)
    assert flops == 197_632 * 16_384 * (65 + 3 * 4 * 64)
    assert flops == pytest.approx(2.697e12, rel=1e-3)
    update = roofline.update_flops(per_sample, 4096 * 4, 64, 4)
    assert update == 197_632 * 16_384 * 3 * 4 * 64
    r = types.SimpleNamespace(update_flops=update, peak_flops=989.4e12, steps=300, wall_s=50.0,
                              splits=[{"rollout_s": 0.1, "update_s": 0.06},
                                      {"rollout_s": 0.12, "update_s": 0.05}],
                              profiled_flops=2 * flops,
                              profile={"busy_s": 0.3, "steps": 128, "device_ops": 100,
                                       "device_s": 0.29, "window_s": 0.4})
    # the update's FLOPs over the learner's own span, not over the window
    assert spec.reader("mfu_train")(r) == pytest.approx(100 * update / 0.055 / 989.4e12)
    assert spec.reader("step_mfu")(r) == pytest.approx(100 * 2 * flops / 0.3 / 989.4e12)
    assert spec.reader("rollout_ms_per_update")(r) == pytest.approx(110.0)
    assert spec.reader("learn_ms_per_update")(r) == pytest.approx(55.0)
    # per env step: the profile's steps are counted in env steps (TrainStep.reader_fields)
    assert spec.reader("device_ms_per_step")(r) == pytest.approx(290 / 128)
    assert spec.reader("kernels_per_step")(r) == pytest.approx(100 / 128)
    empty = types.SimpleNamespace(steps=10, wall_s=1.0, splits=[], profile=None)
    assert all(spec.reader(n)(empty) is None for n in (
        "mfu_train", "step_mfu", "rollout_ms_per_update", "learn_ms_per_update"))


def test_the_env_cells_take_no_learner_keys():
    assert "learner" not in spec.load(CELL).env_config()
    assert spec.load("cfg5-rollout-4096x4").traffic.get("entry") is None


_RUN = """
import json, sys, torch
torch.set_num_threads(2)
from portbench.tests.test_portbench_learner import _run
assert _run(3)["line"]["correct"]
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

_REFERENCE = """
import json, sys
from portbench.reference import ppo
from portbench.reference.policies import mlp
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


@pytest.mark.parametrize("code,foreign", [
    (_RUN, set(FOREIGN)), (_REFERENCE, set(FOREIGN) | {"marl_traffic_intersection_tpu_torch"})])
def test_no_jax_and_a_reference_of_its_own(code, foreign):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-3000:]
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not names & foreign, names & foreign


@pytest.mark.cuda
@pytest.mark.parametrize("trace", (0, 1))
def test_the_cell_runs_correct_on_the_card(trace):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    out = subprocess.run(bench["command"] + ["--workload", CELL, "--seed", str(2 ** 31 + 19),
                                             "--seconds", "2", "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    cell = spec.load(CELL)
    assert set(line["metrics"]) == {m["name"] for m in (cell.per_layer if trace
                                                         else cell.end_to_end)}
    assert list(line)[-1] == "checks"
    tail = out.stderr.strip().splitlines()[-len(learner.LIMITS):]
    assert [t.split()[1] for t in tail] == list(learner.LIMITS)
