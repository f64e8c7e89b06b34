"""The port's env (CPU) in lockstep with the JAX package on BASELINE config 1.

2000 steps of random actions (tests/test_env.py's policy). Against the JAX
reference chain (exact_obs, compiled without XLA's algebraic simplifier, see
tests/_torch_port.py) every state leaf, reward and all 127 obs floats are
bit-equal at every step; against the JAX default chain, discrete state and
lidar are.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_traffic_intersection_tpu_torch import VectorEnv

from ._torch_port import EXACT_COMPILE, assert_bits, lockstep_single, policy_random, port_env

CONFIG1 = [("IN_6", "OUT_2")]


def test_config1_exact_chain_2000_steps():
    lockstep_single(CONFIG1, 2000)


def test_config1_default_chain_discrete_state_and_lidar():
    lockstep_single(CONFIG1, 2000, exact_obs=False)


def test_xla_divides_by_a_constant_through_its_reciprocal():
    """Why the reference chain is compiled without algsimp (ROADMAP queue 3,
    H8): on the CPU, XLA turns ``v / 54`` into ``v * (1/54)``, which differs
    from the reference's IEEE division on some inputs; without the pass the
    division is IEEE, as the port's."""
    v = np.random.RandomState(0).uniform(0.0, 8.0, 20000).astype(np.float32)
    ieee = (v / np.float32(54.0)).view(np.int32)
    fn = jax.jit(lambda a: a / np.float32(54.0)).lower(jnp.asarray(v))
    default = np.asarray(fn.compile()(v)).view(np.int32)
    exact = np.asarray(fn.compile(compiler_options=EXACT_COMPILE)(v)).view(np.int32)
    assert (default != ieee).any()
    assert (exact == ieee).all()


@pytest.mark.parametrize("flags", [dict(exact_trig=True), dict(exact_obs=True),
                                   dict(exact_trig=True, exact_obs=True)])
def test_exactness_flags_select_the_same_chain(flags):
    """The port always runs the reference chain: with the exactness flags on,
    a 60-step run of 4 envs x 3 agents (random actions, auto-resets at step
    20) is bit-identical to the run with them off."""
    runs = []
    for kw in ({}, flags):
        env = port_env(3, max_steps=20, **kw)
        venv = VectorEnv(env, num_envs=4, seed=3)
        state, obs = venv.reset()
        rng = np.random.RandomState(8)
        hist = [obs]
        for _ in range(60):
            a = np.stack([policy_random(rng, 3) for _ in range(4)])
            state, out = venv.step(state, torch.from_numpy(a))
            hist += [out.obs, out.reward, out.status, state.lidar, *state.ego]
        runs.append(hist)
    assert len(runs[0]) == len(runs[1])
    for i, (a, b) in enumerate(zip(*runs)):
        assert_bits(f"tensor {i}", a, b)
