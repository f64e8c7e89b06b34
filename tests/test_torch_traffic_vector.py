"""The port's VectorEnv with NPC traffic (CPU) against the JAX package's:
16 envs x 2 agents x 150 steps at density 3.0, episodes truncated at 50
steps, so every env auto-resets to an empty NPC pool twice or more. The JAX
VectorEnv draws the reset routes and the spawn decisions from its keys; both
are replayed into the port through its injectable samplers. The JAX run uses
the full-width NPC pool (``npc_tier=0``) and the dense lidar march
(``lidar_impl="xla"``), each bit-equal to its default (tests/test_npc_tier.py,
tests/test_lidar_fuzz.py) and quicker to trace. Every NpcState field every
step, and every leaf and output of the run, bit for bit on the reference
chain."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from marl_traffic_intersection_tpu.core.constants import DT_DEFAULT
from marl_traffic_intersection_tpu.core.npc import spawn_decision
from marl_traffic_intersection_tpu.envs.vector import VectorEnv as JaxVectorEnv
from marl_traffic_intersection_tpu_torch import VectorEnv

from ._torch_port import (_jax_reset_state, assert_npc_bits, compare_runs,
                          ieee_constant_division, jax_env, port_env)

B, N, STEPS, DENSITY = 16, 2, 150, 3.0


def test_vector_env_traffic_replayed_resets_and_spawns_bit_equal():
    kw = dict(traffic_flow=True, traffic_density=DENSITY, max_steps=50, npc_tier=0,
              lidar_impl="xla")
    jenv = jax_env(N, **kw)
    jvenv = JaxVectorEnv(jenv, num_envs=B)
    jvenv._observed = lambda st: jnp.zeros(st.lidar.shape[:2] + (127,), jnp.float32)
    js = _jax_reset_state(jvenv, 4)
    with ieee_constant_division():
        lowered = jax.jit(jvenv.step).lower(js, jnp.zeros((B, N, 2), jnp.float32))
    jstep = lowered.compile()
    T = int(jenv.table.traffic_route_ids.shape[0])
    # the draw the JAX step makes from each env's key (core/env.py:298-301)
    draw = jax.jit(jax.vmap(lambda k: spawn_decision(
        jax.random.split(k)[1], T, DENSITY, jnp.float32(DT_DEFAULT))))

    replay = {"rid": torch.from_numpy(np.array(js.ego.route_id))}
    pvenv = VectorEnv(port_env(N, **kw), num_envs=B,
                      route_sampler=lambda k: replay["rid"][:k],
                      spawn_sampler=lambda k: (replay["try"][:k], replay["route"][:k]))
    ps, pobs0 = pvenv.reset()

    rng = np.random.RandomState(8)
    jax_steps, port_steps, resets, spawns = [], [], 0, 0
    for t in range(STEPS):
        a = np.stack([rng.uniform(-0.3, 1.0, (B, N)), rng.uniform(-1, 1, (B, N))],
                     -1).astype(np.float32)
        do_try, route = draw(js.key)
        replay["try"] = torch.from_numpy(np.array(do_try))
        replay["route"] = torch.from_numpy(np.array(route))
        js, jout = jstep(js, jnp.asarray(a))
        replay["rid"] = torch.from_numpy(np.array(js.ego.route_id))
        ps, pout = pvenv.step(ps, torch.from_numpy(a))
        assert_npc_bits(js.npc, ps.npc, f"step {t}")
        assert np.array_equal(np.asarray(jout.spawned), pout.spawned.numpy()), t
        resets += int(np.asarray(jout.terminated | jout.truncated).sum())
        spawns += int(np.asarray(jout.spawned).sum())
        jax_steps.append((js, jout))
        port_steps.append((ps, pout))
    assert resets >= 2 * B and spawns >= 40, (resets, spawns)
    compare_runs(jax_steps, port_steps, True, jenv, reset=(_jax_reset_state(jvenv, 4), pobs0))
