"""The port's ActorCriticMLP against the flax one, on the shipped weights.

``mlp_params_from_flax`` loads artifacts/policy_mlp_multi (read by the JAX
package's utils/checkpoint.load_policy). In float32 both sides agree within
1e-5 (summation order of the matmuls differs). In bfloat16 they agree
within the tolerance stated below: flax rounds the matmul output to bf16
before adding the bias in bf16, torch's bf16 linear adds the bias before its
single rounding, so each layer can differ by a bf16 ulp (2^-8 relative).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_traffic_intersection_tpu.models.actor_critic import ActorCriticMLP as FlaxMLP
from marl_traffic_intersection_tpu.utils.checkpoint import load_policy
from marl_traffic_intersection_tpu_torch import ActorCriticMLP
from marl_traffic_intersection_tpu_torch.convert import mlp_params_from_flax

from . import _torch_port  # noqa: F401  (one torch thread per test worker)

ART = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "artifacts", "policy_mlp_multi")
# bf16: 4 ulps of the largest outputs on these inputs (|mean| < 4.3, ulp
# 2^-6 there; |value| < 26, ulp 2^-3), measured at most 1 ulp apart
BF16_ATOL = 0.06


@pytest.fixture(scope="module")
def params():
    return load_policy(ART, "mlp")[1]


def _obs(n=512, seed=0):
    return np.random.RandomState(seed).uniform(-1.0, 1.0, (n, 127)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_matches_flax(params, dtype):
    obs = _obs()
    fm = FlaxMLP(compute_dtype=getattr(jnp, dtype))
    jm, jl, jv = (np.asarray(a) for a in fm.apply(params, obs))
    tm = mlp_params_from_flax(params, ActorCriticMLP(compute_dtype=getattr(torch, dtype)))
    with torch.no_grad():
        pm, pl, pv = (a.numpy() for a in tm(torch.from_numpy(obs)))
    tol = 1e-5 if dtype == "float32" else BF16_ATOL
    np.testing.assert_allclose(pm, jm, atol=tol, rtol=0)
    np.testing.assert_allclose(pv, jv, atol=tol * 10 if dtype == "bfloat16" else tol, rtol=0)
    np.testing.assert_allclose(pl, jl, atol=1e-6, rtol=0)


def test_mlp_shapes_and_act(params):
    tm = mlp_params_from_flax(params)      # widths read from the tree
    assert [m.out_features for m in tm.torso] == [256, 256]
    obs = torch.from_numpy(_obs(6)).reshape(2, 3, 127)
    mean, log_std, value = tm(obs)
    assert mean.shape == (2, 3, 2) and value.shape == (2, 3) and log_std.shape == (2,)
    assert mean.dtype == value.dtype == torch.float32
    a = tm.act(obs)
    assert torch.equal(a, torch.tanh(mean))
    assert a.abs().max() <= 1.0


def test_fresh_mlp_log_std_starts_at_zero():
    assert torch.allclose(ActorCriticMLP()(torch.zeros(1, 127))[1], torch.zeros(2), atol=1e-6)


def test_mlp_params_from_flax_rejects_wrong_width(params):
    with pytest.raises(ValueError):
        mlp_params_from_flax(params, ActorCriticMLP(hidden=(128, 128)))
