"""The benchmark's plain reference of the intersection simulator.

A frozen copy of the simulation's semantics in plain PyTorch on the CPU, with
the host's glibc for every float32 transcendental (libm.py), as the
reference C++ simulator computes them: route tables (routes.py), bicycle
physics and SAT collisions (physics.py), road geometry (geometry.py), the
dense lidar march (lidar.py), the NPC pool with the reference's serial
controller and collision loops (npc.py), the env step and observation
(env.py) and the auto-reset merge (vector.py).

It imports nothing of the program under test and takes no table or state
that the program made; the benchmark hands it the inputs it drew itself and
the program's state before a checked step, and compares what it computes
with what the program produced (portbench/check.py).
"""
