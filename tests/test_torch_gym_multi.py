"""The port's GymIntersectionEnv against the JAX package's on BASELINE
config 3 (3 agents, the team reward), bit for bit; tests/test_torch_gym.py
says how the JAX side is stepped."""
import dataclasses

from .test_torch_gym import run_episode

CONFIG3 = {"num_agents": 3, "use_team_reward": True, "max_steps": 240,
           "ego_routes": [("IN_6", "OUT_2"), ("IN_1", "OUT_7"), ("IN_4", "OUT_7")]}


def test_config3_three_agents_with_the_team_reward():
    steps, jg, pg, infos = run_episode(CONFIG3, [1.0 / 60.0] * 300, seed=7)
    assert steps == 240                        # truncated at max_steps
    statuses = {s for info in infos for s in info["status"]}
    assert len(statuses) > 1, statuses
    for a, b in zip(jg.env.cars, pg.env.cars):
        assert (dataclasses.astuple(a.state), a.path_index, a.alive, a.steering_angle) == \
               (dataclasses.astuple(b.state), b.path_index, b.alive, b.steering_angle)
