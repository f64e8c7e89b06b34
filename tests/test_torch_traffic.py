"""The port's env with NPC traffic (CPU) in lockstep with the JAX package:
BASELINE config 2 (1 agent, density 0.5, eval.py:20-21), spawn draws
injected into both sides (torch cannot replay jax.random), a forced spawn
try every 31 steps so that the pool stays busy. Every NpcState field, the
discrete state, lidar, rewards and all 127 obs floats, bit for bit on the
reference chain (tests/_torch_port.py)."""
from ._torch_port import lockstep_traffic


def test_config2_traffic_lockstep_exact_chain():
    assert lockstep_traffic([("IN_6", "OUT_2")], 300, 0.5, spawn_every=31) > 200
