"""The port's GymIntersectionEnv against the JAX package's on BASELINE
config 2 (one ego, NPC traffic at density 0.5), bit for bit, with the spawn
draws the JAX step makes from its key injected into the port's wrapper
(torch cannot replay jax.random's stream, H7); the NPC pool is held every
step. tests/test_torch_gym.py says how the JAX side is stepped."""
import dataclasses

import numpy as np

from .test_torch_gym import run_episode

CONFIG2 = {"traffic_flow": True, "traffic_density": 0.5, "ego_routes": [("IN_6", "OUT_2")],
           "max_steps": 2000}


def test_config2_traffic_episode_with_the_jax_spawn_draws():
    steps, jg, pg, _ = run_episode(CONFIG2, [1.0 / 60.0] * 100, seed=0, spawn_draws=True,
                                check_npcs=True)
    assert steps == 100
    alive = [int(np.asarray(s.npc.alive).sum()) for s in jg.states]
    assert max(alive) >= 1, alive          # NPCs spawned and drove
    a, b = jg.env.traffic_cars, pg.env.traffic_cars
    assert [dataclasses.astuple(c.state) for c in a] == [dataclasses.astuple(c.state) for c in b]
