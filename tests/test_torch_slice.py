"""The whole slice with a policy in the loop: 16 envs x 4 agents x 200 steps.

The flax MLP (shipped weights, bf16) turns observations into actions, which
drive both the JAX VectorEnv and the port's; so bf16 rounding differences
between the frameworks cannot steer the runs apart. Env outputs are held bit
for bit (reference chain); the port's own MLP actions agree with flax's
within the bf16 tolerance of tests/test_torch_mlp.py. The JAX observations
are rebuilt afterwards from the states (tests/_torch_port.py); the policy
reads the port's observations during the run, which the final comparison
proves equal to the JAX ones.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from marl_traffic_intersection_tpu.envs.vector import VectorEnv as JaxVectorEnv
from marl_traffic_intersection_tpu.models.actor_critic import ActorCriticMLP as FlaxMLP
from marl_traffic_intersection_tpu.utils.checkpoint import load_policy
from marl_traffic_intersection_tpu_torch import ActorCriticMLP, VectorEnv
from marl_traffic_intersection_tpu_torch.convert import mlp_params_from_flax

from ._torch_port import EXACT_COMPILE, _jax_reset_state, compare_runs, jax_env, port_env
from .test_torch_mlp import ART, BF16_ATOL

B, N, STEPS = 16, 4, 200


def test_policy_in_the_loop_slice():
    params = load_policy(ART, "mlp")[1]
    fmlp = FlaxMLP()
    jact = jax.jit(lambda o: jnp.tanh(fmlp.apply(params, o)[0]))
    tmlp = mlp_params_from_flax(params, ActorCriticMLP())

    jenv = jax_env(N, max_steps=120)
    jvenv = JaxVectorEnv(jenv, num_envs=B)
    jvenv._observed = lambda st: jnp.zeros(st.lidar.shape[:2] + (127,), jnp.float32)
    js = _jax_reset_state(jvenv, 3)
    jstep = jax.jit(jvenv.step).lower(js, jnp.zeros((B, N, 2))).compile(
        compiler_options=EXACT_COMPILE)

    ids = {"rid": torch.from_numpy(np.array(js.ego.route_id))}
    pvenv = VectorEnv(port_env(N, max_steps=120), num_envs=B,
                      route_sampler=lambda k: ids["rid"][:k])
    ps, obs = pvenv.reset()
    reset = (js, obs)

    jax_steps, port_steps, act_err = [], [], 0.0
    for _ in range(STEPS):
        a = np.array(jact(obs.numpy()))
        act_err = max(act_err, float(np.abs(tmlp.act(obs).numpy() - a).max()))
        js, jout = jstep(js, jnp.asarray(a))
        ids["rid"] = torch.from_numpy(np.array(js.ego.route_id))
        ps, pout = pvenv.step(ps, torch.from_numpy(a))
        obs = pout.obs
        jax_steps.append((js, jout))
        port_steps.append((ps, pout))
    compare_runs(jax_steps, port_steps, True, jenv, reset=reset)
    # tanh is 1-Lipschitz: action differences are bounded by the mean's
    assert act_err <= BF16_ATOL, act_err
