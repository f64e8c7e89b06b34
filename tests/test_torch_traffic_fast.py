"""The fast (synchronous) NPC mode: the port (CPU) in lockstep with the JAX
package's fast mode at density 2.0, 2 agents, spawn draws injected into both
sides and a forced try every 15 steps; NpcState, discrete state, lidar,
rewards and obs bit for bit on the reference chain (the JAX side with its
dense lidar, ``lidar_impl="xla"``, bit-equal to its interval march)."""
from ._torch_port import lockstep_traffic


def test_fast_mode_traffic_lockstep_exact_chain():
    assert lockstep_traffic([("IN_6", "OUT_2"), ("IN_1", "OUT_7")], 200, 2.0, seed=5,
                            npc_mode="fast", spawn_every=15, lidar_impl="xla") > 150
