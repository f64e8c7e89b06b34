"""Entries found by name, and the policy-step entry (entries/policy_step.py)
on the CPU at a tiny size: 8 envs x 8 agents, a short warm-up, every env row
checked. Every committed traffic file resolves to the class it named before;
an unknown entry raises; a new entry is a new file; the plain reference of
the ``central`` family follows the program's model; a run ends correct, and
the controls and every planted fault end not correct."""
import json
import os
import shutil
import subprocess
import sys
import types

import pytest
import torch
from torch.nn import functional as F

from marl_traffic_intersection_tpu_torch.models import central as program_central
from marl_traffic_intersection_tpu_torch.models.central import CentralizedActorCritic
from marl_traffic_intersection_tpu_torch.utils import checkpoint
from portbench import learner, run, spec
from portbench.entries import policy_step
from portbench.reference import ppo as ref_ppo
from portbench.reference.policies import central
from portbench.run import FOREIGN
from portbench.tests.helpers import tiny

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELL = "cfg4-traffic-d1-4096x8-policy"
KW = {"hidden": [256, 256], "embed": 128, "act_dim": 2}
# the classes the committed traffic files named before entries were files
BEFORE = {"rollout": run.EnvStep, "npc-d1": run.EnvStep, "ppo": learner.TrainStep}

NEW_ENTRY = '''"""An entry that a test writes: the env step, counting its steps."""
from ..run import EnvStep


class Entry(EnvStep):
    counted = 0

    def one(self, k=None):
        super().one(k)
        self.counted += 1

    def window_notes(self):
        return dict(super().window_notes(), counted=self.counted)
'''


def _run(seed=4, trace=False, **kw):
    return run.run(tiny(CELL, **kw), seed, 0.2, trace, device="cpu")


def _rel(a, b):
    return float(torch.linalg.vector_norm((a - b).double())
                 / torch.linalg.vector_norm(b.double()))


WORKLOADS = {w["name"]: w["traffic"] for w in json.loads(
    (spec.ROOT / "BENCHMARK.json").read_text())["workloads"]}


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_every_traffic_file_resolves_to_its_entry(workload):
    got = run.entry_of(spec.load(workload))
    if WORKLOADS[workload] in BEFORE:
        assert got is BEFORE[WORKLOADS[workload]]
    else:
        assert got is policy_step.Entry and issubclass(got, run.EnvStep)


@pytest.mark.parametrize("name", ["no_such_entry", "../run", "entries.env_step", "", 3])
def test_an_unknown_entry_raises(name):
    cell = tiny("cfg5-rollout-4096x4")
    cell.traffic = dict(cell.traffic, entry=name)
    with pytest.raises(ValueError):
        run.entry_of(cell)


def test_a_new_entry_is_a_new_file(tmp_path):
    shutil.copytree(spec.PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    (tmp_path / "portbench" / "entries" / "counted_step.py").write_text(NEW_ENTRY)
    cell = tiny("cfg5-rollout-4096x4")
    cell.root, cell.traffic = tmp_path, dict(cell.traffic, entry="counted_step")
    Entry = run.entry_of(cell)
    assert issubclass(Entry, run.EnvStep) and Entry.__module__ == "portbench.entries.counted_step"
    out = run.run(cell, 5, 0.2, False, device="cpu")
    assert out["line"]["correct"]
    assert out["notes"]["window"]["counted"] >= out["notes"]["window"]["steps"] > 0
    # the checkout's own entries do not hold it
    cell.root = spec.ROOT
    with pytest.raises(ValueError):
        run.entry_of(cell)


def _program_model(params):
    model = CentralizedActorCritic()
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(params[name])
    return model.eval()


@pytest.mark.parametrize("source", ["seeded", "policy_central_cfg4", "policy_central_multi"])
def test_the_reference_follows_the_programs_model(source):
    if source == "seeded":
        params = central.init(KW, torch.Generator().manual_seed(9), "cpu")
        model = _program_model(params)
    else:
        params = central.load(policy_step.export_path(spec.ROOT, source), KW)
        model = checkpoint.load_policy(source, "central", "cpu")[0]
    assert {k: tuple(p.shape) for k, p in model.named_parameters()} == central.shapes(KW)
    obs = torch.randn((16, 8, 127), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        mean, log_std, value = model(obs)
    want = central.forward(params, obs, ref_ppo.product_at(torch.bfloat16), KW)
    assert _rel(mean, want[0]) <= policy_step.POLICY_LIMITS["mean"]
    assert _rel(value, want[2]) <= policy_step.POLICY_LIMITS["mean"]
    assert torch.equal(log_std, want[1])


def test_the_forwards_flops():
    # actor 127-256-256-2, critic 127-128, 256-256, 256-1: multiply-adds x 2
    assert central.flops_per_sample(KW) == 2 * (127 * 256 + 256 * 256 + 256 * 2
                                                 + 127 * 128 + 256 * 256 + 256) == 361_216


def test_the_export_is_read_by_flax_names_and_shapes():
    with pytest.raises(ValueError):
        central.load(policy_step.export_path(spec.ROOT, "policy_central_cfg4"),
                     dict(KW, embed=64))
    with pytest.raises(ValueError):
        central.load(policy_step.export_path(spec.ROOT, "policy_mlp_cfg1"), KW)


@pytest.mark.parametrize("seed", (3, 2 ** 40 + 7))
def test_a_run_is_correct_and_the_controls_are_not(seed):
    out = _run(seed)
    line, readings = out["line"], out["notes"]["check"]["readings"]
    assert line["correct"] and line["failed"] == 0
    assert readings["obs_in"] == 0 and readings["mean"] <= policy_step.POLICY_LIMITS["mean"]
    assert list(line["checks"]) == list(policy_step.Entry.LIMITS)
    ref, rec, _, _, pol = out["checked"]
    obs = policy_step.reference_obs(ref, rec)
    want = policy_step.reference_outputs(pol, obs)
    for kind in policy_step.VARIANTS:
        got = policy_step.numbers(policy_step.reference_outputs(pol, obs, kind), want)
        assert any(got[n] > policy_step.POLICY_LIMITS[n] for n in got), (kind, got)
    # a forward that sums its products in another order passes
    got = policy_step.numbers(policy_step.reference_outputs(pol, obs, policy_step.SOUND), want)
    assert all(got[n] <= policy_step.POLICY_LIMITS[n] for n in got), got


def test_a_traced_run_reports_the_policys_time():
    out = _run(5, trace=True)
    got = out["line"]["metrics"]
    assert out["line"]["correct"] and got["act_ms_per_step"]["value"] > 0
    assert len(out["notes"]["trace"]["act_ms"]) == tiny(CELL).traffic["span_steps"]
    names = {m["name"] for m in spec.load(CELL).per_layer}
    assert {"act_ms_per_step", "step_mfu", "host_reads_per_step", "wide_step_share",
            "npc_rounds_per_step.rate", "npc_rounds_p95.rate"} <= names
    # the NPC counters read as in the env cell; a tiny batch steps at the narrow width
    assert got["npc_rounds_per_step.rate"]["value"] >= 0 and got["wide_step_share"]["value"] == 0
    # the CPU has no trace to read a share of the peak from
    assert "step_mfu" not in got
    # the cell reports no step tail: its share of wide steps swings it (PERF.md)
    assert [m["name"] for m in spec.load(CELL).end_to_end] == ["env_steps_per_s", "peak_mem_mib",
                                                               "setup_s"]


def test_the_cells_readers_on_synthetic_readings():
    stats = {"cleanup_rounds": 30, "collision_rounds": 6, "npc_rounds_at_4": 7,
             "npc_rounds_at_9": 1, "step_width_8": 6, "step_width_16": 2, "step_width_32": 0}
    r = types.SimpleNamespace(steps=8, npc_stats=stats, act_ms=[0.25, 0.75])
    assert spec.reader("wide_step_share")(r) == 25.0
    assert spec.reader("act_ms_per_step")(r) == 0.5
    for name in ("npc_rounds_per_step", "npc_rounds_p95"):
        assert spec.reader(f"{name}.rate")(r) == spec.reader(name)(r) is not None
    empty = types.SimpleNamespace(steps=8, npc_stats={}, act_ms=None)
    assert all(spec.reader(n)(empty) is None for n in (
        "wide_step_share", "act_ms_per_step", "npc_rounds_per_step.rate", "npc_rounds_p95.rate"))


def _fp8_dense(layer, x, dtype):
    return F.linear(ref_ppo.round_fp8(x).to(dtype), ref_ppo.round_fp8(layer.weight).to(dtype),
                    layer.bias.to(dtype))


def _plant(monkeypatch, fault):
    if fault == "other_policy":
        load = checkpoint.load_policy
        monkeypatch.setattr(checkpoint, "load_policy", lambda name, kind, dev:
                            load(policy_step.OTHER_POLICY, kind, dev))
    elif fault == "no_tanh":
        monkeypatch.setattr(policy_step.Entry, "actions_of",
                            lambda self, obs: (self.mean_fn(obs),) * 2)
    elif fault == "bank_actions":
        g = torch.Generator().manual_seed(1)

        def bank(self, obs):
            return self.mean_fn(obs), torch.randn(obs.shape[:-1] + (2,), generator=g)
        monkeypatch.setattr(policy_step.Entry, "actions_of", bank)
    elif fault == "fp8_forward":
        monkeypatch.setattr(program_central, "dense", _fp8_dense)


@pytest.mark.parametrize("fault", ["other_policy", "no_tanh", "bank_actions", "fp8_forward"])
def test_a_broken_policy_is_not_correct(monkeypatch, fault):
    _plant(monkeypatch, fault)
    out = _run(6)
    line = out["line"]
    assert not line["correct"] and line["failed"] > 0
    # the env's numbers pass: the env steps the actions the program stepped
    assert all(line["checks"][k]["value"] == 0 for k in ("ego", "lidar", "npc", "obs"))
    assert any(line["checks"][k]["value"] > line["checks"][k]["limit"]
               for k in ("mean", "action"))


def test_a_policy_run_loads_no_jax_and_the_reference_nothing_of_the_program():
    code = """
import json, sys, torch
torch.set_num_threads(2)
from portbench.reference.policies import central
from portbench.reference import ppo
loaded = sorted({m.split(".")[0] for m in sys.modules})
from portbench import run
from portbench.tests.helpers import tiny
out = run.run(tiny("%s"), 3, 0.2, False, device="cpu")
assert out["line"]["correct"], out["line"]
print(json.dumps([loaded, sorted({m.split(".")[0] for m in sys.modules})]))
""" % CELL
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-3000:]
    reference, after_run = (set(x) for x in json.loads(out.stdout.strip().splitlines()[-1]))
    assert not reference & (set(FOREIGN) | {"marl_traffic_intersection_tpu_torch"})
    assert "marl_traffic_intersection_tpu_torch" in after_run
    assert not after_run & set(FOREIGN), after_run & set(FOREIGN)


@pytest.mark.cuda
@pytest.mark.parametrize("trace", (0, 1))
def test_the_policy_cell_runs_correct_on_the_card(trace):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    command = bench["command"] + ["--workload", CELL, "--seed", str(2 ** 31 + 19),
                                  "--seconds", "2", "--trace", str(trace)]
    out = subprocess.run(command, cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    cell = spec.load(CELL)
    names = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(line["metrics"]) == names if not trace else set(line["metrics"]) <= names
    if trace:
        assert {"act_ms_per_step", "step_mfu"} <= set(line["metrics"])
    tail = out.stderr.strip().splitlines()[-len(policy_step.Entry.LIMITS):]
    assert [t.split()[1] for t in tail] == list(policy_step.Entry.LIMITS)
