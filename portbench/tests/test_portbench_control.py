"""The check fails what it must: the controls (control.py) and a run whose
timed path is broken underneath, once for each fault a cell can have. The
runs skip the harness's look for a card and drive the rest of a run on the
CPU at a tiny size, every env row checked (one row and the envs whose
episode ends, for the faults of the auto-reset merge). A cell runs on one
chip, so it has no exchange between chips to leave out."""
import pytest
import torch

from marl_traffic_intersection_tpu_torch.core import env as env_module
from marl_traffic_intersection_tpu_torch.envs.vector import VectorEnv
from portbench import check, control, run
from portbench.tests.helpers import CELLS, tiny


def _run(name, seed=4, envs=8, warmup=5, **kw):
    return run.run(tiny(name, envs=envs, warmup=warmup, **kw), seed, 0.2, False, device="cpu")


@pytest.mark.parametrize("name", CELLS)
def test_controls_fail_and_the_program_passes(name):
    # torch's sin and cos on the CPU differ from glibc's on few angles:
    # enough envs and steps that some come up
    out = _run(name, envs=32, warmup=30)
    assert out["line"]["correct"] and out["line"]["failed"] == 0
    program = control.readings(out["checked"], "program")
    assert all(program[k] == 0 for k in check.LIMITS if k != "start")
    for kind in ("bf16", "torch_libm"):
        got = control.readings(out["checked"], kind)
        assert not check.verdict(dict(got, start=0)), (kind, got)


@pytest.mark.parametrize("name", CELLS)
def test_every_checked_step_holds_an_auto_reset(name):
    # one row drawn; the envs the check adds as ending their episode reset
    out = _run(name, check_envs=1, max_steps=8)
    readings = out["notes"]["check"]["readings"]
    assert out["line"]["correct"] and readings["steps"] == 2
    assert readings["episode_ends"] >= readings["steps"]


def _unchanged(step):
    def broken(self, state, *args, **kw):
        _, out = step(self, state, *args, **kw)
        return state, out
    return broken


def _half(step):
    def broken(self, state, *args, **kw):
        new, out = step(self, state, *args, **kw)
        B = state.ego.x.shape[0]
        left = torch.arange(B) >= B // 2

        def keep(old, now):
            if old is None:
                return None
            if torch.is_tensor(old):
                if old.dim() == 0 or old.shape[0] != B:
                    return now
                return torch.where(left.reshape((B,) + (1,) * (old.dim() - 1)), old, now)
            return check.rebuild(old, [keep(a, b) for a, b in zip(old, now)])
        return keep(state, new), out
    return broken


def _altered(scan):
    def broken(*args, **kw):
        out = scan(*args, **kw).clone()
        out[:, 0, 0] = torch.nextafter(out[:, 0, 0], torch.tensor(float("inf")))
        return out
    return broken


def _routes_of_another_env(rest):
    """The auto-reset merge gives each fresh episode its neighbour's routes."""
    def broken(self, state, actions, draws, *args, **kw):
        spawn, routes = draws
        return rest(self, state, actions, (spawn, routes.roll(1, 0)), *args, **kw)
    return broken


def _stale_routes(rest):
    """The auto-reset merge keeps the routes of its first call, as a static
    buffer never refreshed would."""
    first = {}

    def broken(self, state, actions, draws, *args, **kw):
        spawn, routes = draws
        first.setdefault("routes", routes.clone())
        return rest(self, state, actions, (spawn, first["routes"]), *args, **kw)
    return broken


FAULTS = {
    "state_unchanged": ("IntersectionEnv.step", _unchanged),
    "half_the_batch_left_out": ("IntersectionEnv.step", _half),
    "an_answer_altered": ("lidar_scan", _altered),
    "merge_routes_of_another_env": ("VectorEnv._rest", _routes_of_another_env),
    "merge_routes_stale": ("VectorEnv._rest", _stale_routes),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    target, make = FAULTS[fault]
    kw = {}
    if target == "lidar_scan":
        monkeypatch.setattr(env_module, "lidar_scan", make(env_module.lidar_scan))
    elif target == "VectorEnv._rest":
        monkeypatch.setattr(VectorEnv, "_rest", make(VectorEnv._rest))
        # one row drawn: only the envs the check picks as ending their
        # episode show the merge (some env ends in every step)
        kw = dict(check_envs=1, max_steps=8)
    else:
        monkeypatch.setattr(env_module.IntersectionEnv, "step",
                            make(env_module.IntersectionEnv.step))
    out = _run(name, **kw)
    assert not out["line"]["correct"]
    assert out["line"]["failed"] > 0
    assert any(c["value"] > c["limit"] for c in out["line"]["checks"].values())
