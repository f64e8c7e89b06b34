"""The port's RewardNormVecEnv against the JAX package's, with auto-reset.

8 envs x 2 agents x 48 steps, episodes truncated at 20 steps, warmup 16
samples (8 ticks), so the scale switches on and the return accumulator is cut
at every reset. The JAX side draws the reset routes and they are replayed into
the port (tests/_torch_port.py). Obs, statuses, dones and the int32 sample
count are bit-equal. The normalized rewards and the running statistics agree
within ``NORM_RTOL``: ``rsqrt`` is not correctly rounded on either side and
XLA-CPU may fuse the Welford update's products into fused multiply-adds
(ROADMAP queue 3, H3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from marl_traffic_intersection_tpu.envs.normalize import NormState as JaxNormState
from marl_traffic_intersection_tpu.envs.normalize import RewardNormVecEnv as JaxRewardNorm
from marl_traffic_intersection_tpu.envs.vector import VectorEnv as JaxVectorEnv
from marl_traffic_intersection_tpu_torch import VectorEnv
from marl_traffic_intersection_tpu_torch.envs.normalize import RewardNormVecEnv

from ._torch_port import EXACT_COMPILE, _jax_reset_state, assert_bits, jax_env, observe_all, port_env

B, N, STEPS, WARMUP = 8, 2, 48, 16
NORM_RTOL = 1e-5


def test_reward_norm_matches_jax_with_replayed_routes():
    jenv = jax_env(N, max_steps=20)
    jvenv = JaxVectorEnv(jenv, num_envs=B)
    jvenv._observed = lambda st: jnp.zeros(st.lidar.shape[:2] + (127,), jnp.float32)
    jnorm = JaxRewardNorm(jvenv, warmup=WARMUP)
    es = _jax_reset_state(jvenv, 4)
    js = JaxNormState(env_state=es, ret=jnp.zeros((B, N)), count=jnp.zeros((B,), jnp.int32),
                      mean=jnp.zeros((B,)), m2=jnp.zeros((B,)))
    jstep = jax.jit(jnorm.step).lower(js, jnp.zeros((B, N, 2))).compile(
        compiler_options=EXACT_COMPILE)

    ids = {"rid": torch.from_numpy(np.array(es.ego.route_id))}
    pnorm = RewardNormVecEnv(VectorEnv(port_env(N, max_steps=20), num_envs=B,
                                       route_sampler=lambda k: ids["rid"][:k]), warmup=WARMUP)
    ps, pobs0 = pnorm.reset()
    assert ps.count.dtype == torch.int32

    rng = np.random.RandomState(8)
    states, port_obs, resets, scaled = [es], [pobs0], 0, 0
    for t in range(STEPS):
        a = np.stack([rng.uniform(-0.3, 1.0, (B, N)), rng.uniform(-1, 1, (B, N))],
                     -1).astype(np.float32)
        js, jout = jstep(js, jnp.asarray(a))
        ids["rid"] = torch.from_numpy(np.array(js.env_state.ego.route_id))
        ps, pout = pnorm.step(ps, torch.from_numpy(a))
        where = f"(step {t})"
        for name in ("status", "done", "terminated", "truncated"):
            assert_bits(name, np.asarray(getattr(jout, name)), getattr(pout, name), where)
        assert_bits("count", np.asarray(js.count), ps.count, where)
        np.testing.assert_allclose(pout.reward.numpy(), np.asarray(jout.reward), rtol=NORM_RTOL,
                                   atol=1e-7, err_msg=where)
        for name in ("ret", "mean", "m2"):
            np.testing.assert_allclose(getattr(ps, name).numpy(), np.asarray(getattr(js, name)),
                                       rtol=NORM_RTOL, atol=1e-6, err_msg=f"{name} {where}")
        resets += int(np.asarray(jout.terminated | jout.truncated).sum())
        scaled += int((np.asarray(js.count) >= WARMUP).sum())
        states.append(js.env_state)
        port_obs.append(pout.obs)
    assert resets >= B and scaled > 0
    assert_bits("obs", observe_all(jenv, states), np.stack([o.numpy() for o in port_obs]),
                "(axis 0 = step, reset first)")
