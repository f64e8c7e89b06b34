"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program. Module names are compared by
their whole top-level name: the port's name begins with the JAX package's."""
import json
import os
import subprocess
import sys

from portbench.run import FOREIGN

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PORT = "marl_traffic_intersection_tpu_torch"

_RUN = """
import json, sys, torch
torch.set_num_threads(2)
from portbench import run
from portbench.tests.helpers import tiny
for name in ("cfg5-rollout-4096x4", "cfg4-traffic-d1-4096x8"):
    out = run.run(tiny(name), 3, 0.2, True, device="cpu")
    assert out["line"]["correct"], out
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

_REFERENCE = """
import json, sys
from portbench.reference import constants, env, geometry, libm, lidar, npc, physics, routes
from portbench.reference import vector
from portbench import check, roofline
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_not_the_jax_package():
    names = _top_level(_RUN)
    assert PORT in names
    assert not names & set(FOREIGN), names & set(FOREIGN)


def test_the_reference_imports_nothing_of_the_program():
    names = _top_level(_REFERENCE)
    assert not names & (set(FOREIGN) | {PORT}), names & (set(FOREIGN) | {PORT})
