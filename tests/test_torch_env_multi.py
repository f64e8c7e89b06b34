"""The port's env (CPU) in lockstep with the JAX package with several agents:
BASELINE config 3 (3 agents, team reward, eval.py:22-23) and 8 agents with
respawn (tests/test_env.py:107-111). Reference chain: bit-equal everywhere;
JAX default chain: discrete state and lidar bit-equal."""
import pytest

from ._torch_port import lockstep_single

CONFIG3 = [("IN_6", "OUT_2"), ("IN_1", "OUT_7"), ("IN_4", "OUT_7")]
EIGHT = [("IN_1", "OUT_7"), ("IN_2", "OUT_8"), ("IN_4", "OUT_7"), ("IN_5", "OUT_11"),
         ("IN_7", "OUT_1"), ("IN_8", "OUT_2"), ("IN_10", "OUT_1"), ("IN_11", "OUT_5")]


def test_config3_team_reward_exact_chain():
    lockstep_single(CONFIG3, 300, use_team_reward=True)


def test_eight_agents_respawn_exact_chain():
    lockstep_single(EIGHT, 250)


@pytest.mark.parametrize("routes,team", [(CONFIG3, True), (EIGHT, False)])
def test_multi_agent_default_chain_discrete_state_and_lidar(routes, team):
    lockstep_single(routes, 200, exact_obs=False, use_team_reward=team)


def test_no_respawn_terminates_default_chain():
    """Head-on routes crash into each other; without respawn the episode
    terminates on the first done (tests/test_env.py:94-97)."""
    lockstep_single([("IN_1", "OUT_7"), ("IN_7", "OUT_1")], 120, exact_obs=False,
                    respawn_enabled=False, seed=3)
