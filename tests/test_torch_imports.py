"""The port imports neither JAX nor the JAX package, and runs on the CPU when
asked; without a card and without ``device``, its entry points raise."""
import os
import subprocess
import sys

import pytest
import torch

from . import _torch_port  # noqa: F401  (one torch thread per test worker)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED = """
import sys
sys.modules["jax"] = None
sys.modules["marl_traffic_intersection_tpu"] = None
import torch
import marl_traffic_intersection_tpu_torch as P
from marl_traffic_intersection_tpu_torch import convert, evaluate, bench  # noqa: F401
env = P.IntersectionEnv(P.EnvConfig(num_agents=4), device="cpu")
venv = P.VectorEnv(env, num_envs=3)
state, obs = venv.reset()
for _ in range(3):
    state, out = venv.step(state, torch.zeros(3, 4, 2))
assert out.obs.shape == (3, 4, 127) and bool(torch.isfinite(out.obs).all())
assert not any(m == "jax" or m.startswith("jax.") or m.startswith("marl_traffic_intersection_tpu.")
               for m in sys.modules if sys.modules[m] is not None)
print("ok")
"""


def test_port_imports_no_jax_and_steps_on_cpu():
    r = subprocess.run([sys.executable, "-c", _BLOCKED], cwd=ROOT, capture_output=True,
                       text=True, timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr[-3000:]


def test_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    import marl_traffic_intersection_tpu_torch as P
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        P.IntersectionEnv(P.EnvConfig())
    assert P.IntersectionEnv(P.EnvConfig(), device="cpu").device.type == "cpu"


@pytest.mark.parametrize("kw", [dict(traffic_flow=True), dict(exact_trig=True),
                                dict(exact_obs=True), dict(lidar_impl="interval"),
                                dict(lidar_impl="sweep")])
def test_config_outside_the_slice_raises(kw):
    import marl_traffic_intersection_tpu_torch as P
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        P.EnvConfig(**kw)
