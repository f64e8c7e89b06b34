"""NPC slot-prefix narrowing: the port's VectorEnv (CPU) in lockstep with
the JAX package's, both at their default ``npc_tier=-1``, on the case of
tests/test_npc_tier.py:48 (density 8.0, 12 slots, 8 envs x 2 agents, 160
steps), where the width flips both ways. The JAX reset routes and per-env
spawn draws are replayed into the port through its injectable samplers."""
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
from .test_torch_npc_tier import _assert_both_programs

B, N, STEPS, DENSITY, SLOTS = 8, 2, 160, 8.0, 12


def test_narrowed_vector_env_lockstep_with_jax_default_tier():
    """The case of tests/test_npc_tier.py:48 through both packages' default
    ``npc_tier=-1``: the JAX reset routes and per-env spawn draws replayed
    into the port; every NpcState field every step, then every leaf, output
    and observation of the run on the reference chain. The JAX side marches
    its dense lidar (``lidar_impl="xla"``, bit-equal to its default,
    tests/test_lidar_fuzz.py), which traces faster."""
    kw = dict(traffic_flow=True, traffic_density=DENSITY, max_npcs=SLOTS, max_steps=10 ** 6,
              lidar_impl="xla")
    jenv = jax_env(N, **kw)
    jvenv = JaxVectorEnv(jenv, num_envs=B)
    jvenv._observed = lambda st: jnp.zeros(st.lidar.shape[:2] + (127,), jnp.float32)
    js = _jax_reset_state(jvenv, 1)
    with ieee_constant_division():
        jstep = jax.jit(jvenv.step).lower(js, jnp.zeros((B, N, 2), jnp.float32)).compile()
    T = int(jenv.table.traffic_route_ids.shape[0])
    draw = jax.jit(jax.vmap(lambda k: spawn_decision(
        jax.random.split(k)[1], T, DENSITY, jnp.float32(DT_DEFAULT))))

    replay = {"rid": torch.from_numpy(np.array(js.ego.route_id))}
    penv = port_env(N, **kw)
    pvenv = VectorEnv(penv, num_envs=B,
                      route_sampler=lambda k: replay["rid"][:k],
                      spawn_sampler=lambda k: (replay["try"][:k], replay["route"][:k]))
    ps, pobs0 = pvenv.reset()
    rng = np.random.RandomState(2)
    jax_steps, port_steps = [], []
    for t in range(STEPS):
        a = rng.uniform(-1, 1, (B, N, 2)).astype(np.float32)
        do_try, route = draw(js.key)
        replay["try"] = torch.from_numpy(np.array(do_try))
        replay["route"] = torch.from_numpy(np.array(route))
        js, jout = jstep(js, jnp.asarray(a))
        replay["rid"] = torch.from_numpy(np.array(js.ego.route_id))
        ps, pout = pvenv.step(ps, torch.from_numpy(a))
        assert_npc_bits(js.npc, ps.npc, f"step {t}")
        jax_steps.append((js, jout))
        port_steps.append((ps, pout))
    _assert_both_programs(penv.npc_stats, SLOTS, STEPS, pool_fills=True)
    compare_runs(jax_steps, port_steps, True, jenv, reset=(_jax_reset_state(jvenv, 1), pobs0))
