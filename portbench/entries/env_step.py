"""The env step's entry, the default: the program's batched env step with
auto-reset, ``VectorEnv.jit_step()``, fed from the traffic's banks
(portbench/run.py)."""
from ..run import EnvStep as Entry  # noqa: F401
