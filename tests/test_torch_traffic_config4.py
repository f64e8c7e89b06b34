"""BASELINE config 4 (8 agents, density 1.0, eval.py:24) with NPC traffic:
the port (CPU) in lockstep with the JAX package, spawn draws injected into
both sides. The egos cruise straight on (throttle 0.5), which clears their
spawn points for the NPCs, and a spawn is tried every 10 steps; egos crash
into NPCs and walls and respawn. NpcState, discrete state, lidar (K1's
plain version at M = 8 + 32 slots), rewards and obs, bit for bit. The JAX
side marches its dense lidar (``lidar_impl="xla"``, bit-equal to the
interval march that "auto" picks with traffic, tests/test_lidar_fuzz.py),
which traces faster; config 2's test keeps "auto"."""
from ._torch_port import lockstep_traffic

EIGHT = [("IN_1", "OUT_7"), ("IN_2", "OUT_8"), ("IN_4", "OUT_7"), ("IN_5", "OUT_11"),
         ("IN_7", "OUT_1"), ("IN_8", "OUT_2"), ("IN_10", "OUT_1"), ("IN_11", "OUT_5")]


def test_config4_traffic_lockstep_exact_chain():
    assert lockstep_traffic(EIGHT, 150, 1.0, seed=13, throttle=0.5, spawn_every=10,
                            lidar_impl="xla") > 80
