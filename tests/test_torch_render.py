"""The port's renderer (render/draw.py) against the JAX package's, pixel for
pixel on the same state, and the gym wrapper's API (the counterparts of
tests/test_gym_render.py), on the CPU. The JAX renderer reads any state
whose leaves numpy can take, so it is handed the port's state moved to the
host (``compat.host_state``)."""
import numpy as np
import pytest

from marl_traffic_intersection_tpu import EnvConfig as JaxEnvConfig
from marl_traffic_intersection_tpu import IntersectionEnv as JaxEnv
from marl_traffic_intersection_tpu.render.draw import Renderer as JaxRenderer
from marl_traffic_intersection_tpu_torch.compat import host_state
from marl_traffic_intersection_tpu_torch.envs.gym import GymIntersectionEnv
from marl_traffic_intersection_tpu_torch.render.draw import Renderer

FLAGS = [dict(), dict(show_lidar=True), dict(show_lane_ids=True, show_hud=False),
         dict(show_route=False, show_lidar=True)]


@pytest.mark.parametrize("config", [
    {"num_agents": 3, "use_team_reward": True},
    {"traffic_flow": True, "traffic_density": 50.0, "seed": 3},
    {"num_agents": 2, "num_lanes": 2}])
def test_frames_equal_the_jax_renderers(config):
    env = GymIntersectionEnv({**config, "device": "cpu", "render_mode": "rgb_array",
                              "show_lidar": True})
    env.reset(seed=1)
    rng = np.random.RandomState(0)
    renderer = Renderer(env._core)
    jax_renderer = JaxRenderer(JaxEnv(JaxEnvConfig(num_lanes=env.num_lanes)))
    frames = 0
    for t in range(60):
        a = np.stack([rng.uniform(0.2, 1.0, env.num_agents),
                      rng.uniform(-0.5, 0.5, env.num_agents)], 1).astype(np.float32)
        env.step(a[0] if env.traffic_flow else a)
        if t % 20 != 19:
            continue
        for flags in FLAGS:
            got = renderer.render(env.state, **flags)
            want = jax_renderer.render(host_state(env.state), **flags)
            assert got.shape == want.shape == (750, 750, 3) and got.dtype == np.uint8
            np.testing.assert_array_equal(got, want, err_msg=f"step {t} {flags}")
            frames += 1
    assert frames == 3 * len(FLAGS)
    np.testing.assert_array_equal(env.render(), renderer.render(env.state, show_lidar=True))
    if env.traffic_flow:
        assert bool(env.state.npc.alive.any())


def test_gym_multi_agent_api():
    env = GymIntersectionEnv({"num_agents": 3, "num_lanes": 3, "device": "cpu"})
    obs, info = env.reset()
    assert obs.shape == (3, 127)
    obs, rew, term, trunc, info = env.step(np.zeros((3, 2), np.float32))
    assert obs.shape == (3, 127) and rew.shape == (3,)
    assert set(info) == {"step", "rewards", "collisions", "agents_alive",
                         "terminated", "truncated", "done", "status"}
    assert info["step"] == 1 and info["agents_alive"] == 3
    assert info["status"] == ["ALIVE"] * 3 and info["collisions"] == {1: "ALIVE", 2: "ALIVE",
                                                                      3: "ALIVE"}
    assert isinstance(info["rewards"], list)


def test_gym_traffic_single_agent_shapes():
    env = GymIntersectionEnv({"traffic_flow": True, "traffic_density": 5.0, "num_agents": 3,
                              "device": "cpu"})
    obs, info = env.reset()
    assert obs.shape == (127,) and env.num_agents == 1
    obs, rew, term, trunc, info = env.step(np.array([0.5, 0.0], np.float32))
    assert obs.shape == (127,) and isinstance(rew, float) and isinstance(info["rewards"], float)


def test_gym_action_shape_validation():
    env = GymIntersectionEnv({"num_agents": 2, "device": "cpu"})
    with pytest.raises(ValueError, match="N,2"):
        env.step(np.zeros((3,), np.float32))


def test_gym_reward_config_plumbing():
    env = GymIntersectionEnv({"num_agents": 1, "device": "cpu",
                              "reward_config": {"stuck_penalty": -1.0, "progress_scale": 0.0,
                                                "action_smoothness_scale": 0.0}})
    env.reset()
    obs, rew, *_ = env.step(np.zeros((1, 2), np.float32))
    assert float(rew[0]) == -1.0            # stationary -> stuck penalty only


def test_renderer_headless_frame_and_hud():
    env = GymIntersectionEnv({"num_agents": 2, "render_mode": "rgb_array", "show_lidar": True,
                              "device": "cpu"})
    env.reset()
    env.step(np.zeros((2, 2), np.float32))
    frame = env.render()
    assert frame.shape == (750, 750, 3) and frame.dtype == np.uint8
    assert (frame[375, 375] == np.array([60, 60, 60])).all()
    no_hud = env._renderer.render(env.state, show_hud=False)
    assert (frame[:60, :160] != no_hud[:60, :160]).any()
    assert isinstance(env._renderer, Renderer)
    env.close()
    assert env._renderer is None
    assert GymIntersectionEnv({"device": "cpu"}).render() is None    # no render_mode
