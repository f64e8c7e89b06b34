"""The port's benchmark: ``python3 -m portbench.run --workload <cell> --seed
<n> --seconds <s> --trace <0|1>`` runs one cell of BENCHMARK.json once
(run.py). The system under test is marl_traffic_intersection_tpu_torch;
nothing here imports JAX or the JAX package, and the reference
(reference/) imports nothing of the program."""
