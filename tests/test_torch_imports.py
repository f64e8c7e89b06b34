"""The port imports neither JAX nor the JAX package, and runs on the CPU when
asked; without a card and without ``device``, its entry points raise."""
import os
import subprocess
import sys

import pytest
import torch

from . import _torch_port  # noqa: F401  (one torch thread per test worker)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED = """
import sys
for name in ("jax", "flax", "optax", "orbax", "marl_traffic_intersection_tpu"):
    sys.modules[name] = None
import numpy as np
import torch
import marl_traffic_intersection_tpu_torch as P
from marl_traffic_intersection_tpu_torch import convert, evaluate, bench, train  # noqa: F401
from marl_traffic_intersection_tpu_torch import serve, train_sac  # noqa: F401
from marl_traffic_intersection_tpu_torch import models, parallel, utils  # noqa: F401
from marl_traffic_intersection_tpu_torch.parallel import recurrent_ppo, sac  # noqa: F401
from marl_traffic_intersection_tpu_torch.utils.checkpoint import load_policy, load_sac
from marl_traffic_intersection_tpu_torch.core import npc  # noqa: F401
from marl_traffic_intersection_tpu_torch.envs.normalize import RewardNormVecEnv
from marl_traffic_intersection_tpu_torch.parallel.ppo import PPOConfig, PPOLearner
env = P.IntersectionEnv(P.EnvConfig(num_agents=4), device="cpu")
venv = P.VectorEnv(env, num_envs=3)
state, obs = venv.reset()
for _ in range(3):
    state, out = venv.step(state, torch.zeros(3, 4, 2))
assert out.obs.shape == (3, 4, 127) and bool(torch.isfinite(out.obs).all())
learner = PPOLearner(RewardNormVecEnv(venv), models.make_model("mlp"),
                     PPOConfig(rollout_len=4, update_epochs=1, num_minibatches=2))
ts = learner.init()
state, obs = learner.env.reset()
ts, state, obs, metrics = learner.train_step(ts, state, obs)
assert ts.update_count == 2 and all(bool(torch.isfinite(v)) for v in metrics.values())
# the shipped policies load from their numpy exports, with no orbax
for name, kind in (("policy_gru_cfg1", "gru"), ("policy_sac_multi", "sac"),
                   ("artifacts/policy_attn_multi", "attention")):
    model, mean_fn = load_policy(name, kind)
actor, critic = load_sac("policy_sac_cfg1")
glearner = parallel.RecurrentPPOLearner(venv, models.make_model("gru"),
                                        PPOConfig(rollout_len=4, update_epochs=1,
                                                  num_minibatches=2))
ts = glearner.init()
state, obs = venv.reset()
ts, state, obs, h, metrics = glearner.train_step(ts, state, obs, glearner.initial_hidden())
assert ts.update_count == 2 and h.shape == (3, 4, 128)
slearner = sac.SACLearner(venv, sac.SACConfig(buffer_capacity=48, warmup=12, batch_size=4,
                                              steps_per_call=2), actor, critic)
sts = slearner.init()
sts, state, obs, metrics = slearner.train_step(sts, state, obs)
assert sts.update_count == 2 and all(bool(torch.isfinite(v)) for v in metrics.values())
# the single-env API, the renderer, the native engine, play and the warm start
from marl_traffic_intersection_tpu_torch import compat, play, warm_start_central  # noqa: F401
from marl_traffic_intersection_tpu_torch.envs import events, gymnasium_compat  # noqa: F401
from marl_traffic_intersection_tpu_torch.envs.gym import GymIntersectionEnv
from marl_traffic_intersection_tpu_torch.native import NativeEngine  # noqa: F401
from marl_traffic_intersection_tpu_torch.render import draw  # noqa: F401
from marl_traffic_intersection_tpu_torch.utils.checkpoint import load_train_state
for backend in ("torch", "native"):
    genv = GymIntersectionEnv({"num_agents": 2, "device": "cpu", "backend": backend})
    gobs, info = genv.step(np.zeros((2, 2), np.float32))[::4]
    assert gobs.shape == (2, 127) and info["step"] == 1
assert len(genv.env.cars) == 2 and compat.Car.from_env_state(venv.reset()[0], 1).alive
assert load_train_state("policy_mlp_cfg1", "mlp").update == 750
blocked = ("jax", "flax", "optax", "orbax", "marl_traffic_intersection_tpu")
assert not any(m.split(".")[0] in blocked for m in sys.modules if sys.modules[m] is not None)
print("ok")
"""


def test_port_imports_no_jax_and_steps_on_cpu():
    r = subprocess.run([sys.executable, "-c", _BLOCKED], cwd=ROOT, capture_output=True,
                       text=True, timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr[-3000:]


def test_entry_points_need_a_card_unless_told_cpu(monkeypatch, tmp_path):
    import marl_traffic_intersection_tpu_torch as P
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        P.IntersectionEnv(P.EnvConfig())
    assert P.IntersectionEnv(P.EnvConfig(), device="cpu").device.type == "cpu"
    from marl_traffic_intersection_tpu_torch import train
    small = ["--num-envs", "2", "--agents", "1", "--rollout-len", "4", "--updates", "1"]
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(small)
    train.main(small + ["--device", "cpu"])
    from marl_traffic_intersection_tpu_torch import evaluate, train_sac
    sac_small = ["--num-envs", "2", "--agents", "1", "--calls", "1", "--steps-per-call", "1",
                 "--capacity", "8", "--batch-size", "2", "--warmup", "0"]
    for main, argv in ((train_sac.main, sac_small),
                       (evaluate.main, ["--vector", "2", "--max-steps", "2", "--policy",
                                        "checkpoint", "--checkpoint", "policy_sac_cfg1",
                                        "--model", "sac"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv)
        main(argv + ["--device", "cpu"])
    # the single-env API and its entry points
    from marl_traffic_intersection_tpu_torch import play
    from marl_traffic_intersection_tpu_torch.envs.gym import GymIntersectionEnv
    from marl_traffic_intersection_tpu_torch.envs.gymnasium_compat import GymnasiumVectorEnv
    with pytest.raises(RuntimeError, match="CUDA"):
        GymIntersectionEnv({"num_agents": 1})
    with pytest.raises(RuntimeError, match="CUDA"):
        GymnasiumVectorEnv(2)
    assert GymIntersectionEnv({"device": "cpu"}).device.type == "cpu"
    for main, argv in ((evaluate.main, ["--episodes", "1", "--max-steps", "3"]),
                       (play.main, ["--script", "--steps", "1", "--out", str(tmp_path / "p.gif")]),
                       (train.main, small + ["--resume", "policy_mlp_cfg1"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv)
        main(argv + ["--device", "cpu"])


@pytest.mark.parametrize("kw", [dict(exact_trig=True), dict(exact_obs=True)])
def test_config_outside_the_slice_raises(kw):
    """The exactness flags are in the slice now: accepted and recorded
    (tests/test_torch_env_config1.py holds their runs bit-identical); the
    config's checks still raise on an unknown mode beside them."""
    import marl_traffic_intersection_tpu_torch as P
    cfg = P.EnvConfig(**kw)
    assert all(getattr(cfg, k) is True for k in kw)
    with pytest.raises(ValueError, match="npc_mode"):
        P.EnvConfig(npc_mode="tiered", **kw)


@pytest.mark.parametrize("kw", [dict(traffic_flow=True), dict(lidar_impl="interval"),
                                dict(lidar_impl="sweep", traffic_flow=True, npc_mode="fast")])
def test_traffic_and_lidar_variants_build_and_step(kw):
    """Every lidar variant runs kernel K1 (its plain version on the CPU)."""
    import marl_traffic_intersection_tpu_torch as P
    env = P.IntersectionEnv(P.EnvConfig(num_agents=2, **kw), device="cpu")
    state, obs = env.reset(num_envs=2)
    # the traffic route whose spawn point lies farthest from the egos
    sp = env.spawn_xy[env.traffic_ids.long()]
    gap = torch.cdist(sp, torch.stack([state.ego.x[0], state.ego.y[0]], -1)).amin(1)
    rc = gap.argmax().to(torch.int32).expand(2)
    if env.config.traffic_flow:     # the spawn draw is the caller's (VectorEnv's)
        with pytest.raises(ValueError, match="spawn"):
            env.step(state, torch.zeros(2, 2, 2))
    state, out = env.step(state, torch.zeros(2, 2, 2), spawn=(torch.ones(2, dtype=torch.bool), rc))
    assert out.obs.shape == (2, 2, 127) and bool(torch.isfinite(out.obs).all())
    assert state.npc.alive.shape == (2, 32 if env.config.traffic_flow else 0)
    assert bool(out.spawned.all()) == env.config.traffic_flow


@pytest.mark.parametrize("kw", [dict(npc_mode="tiered"), dict(npc_cleanup="all"),
                                dict(lidar_impl="dense")])
def test_config_rejects_unknown_modes(kw):
    import marl_traffic_intersection_tpu_torch as P
    with pytest.raises(ValueError, match=next(iter(kw))):
        P.EnvConfig(traffic_flow=True, **kw)
