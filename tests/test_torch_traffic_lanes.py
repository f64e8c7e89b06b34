"""The 2-lane world with NPC traffic (its own intents and corner arcs,
tests/test_npc.py:93-102): the port (CPU) in lockstep with the JAX package
at density 1.0 in the exact mode, spawn draws injected into both sides and a
forced try every 20 steps; everything bit for bit on the reference chain.
The JAX side marches its dense lidar (``lidar_impl="xla"``), bit-equal to
the interval march "auto" picks (tests/test_lidar_fuzz.py)."""
from ._torch_port import lockstep_traffic


def test_two_lane_traffic_lockstep_exact_chain():
    assert lockstep_traffic([("IN_6", "OUT_2"), ("IN_1", "OUT_3")], 200, 1.0, seed=3,
                            num_lanes=2, spawn_every=20, lidar_impl="xla") > 150
